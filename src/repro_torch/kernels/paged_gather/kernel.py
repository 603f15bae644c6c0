"""Wrapper of the CUDA paged KV gather (``csrc/paged_gather.cu``).

Replaces ``repro/kernels/paged_gather/paged_gather_kernel.py::
paged_gather_pallas``.  One block per (slot, page) copies the page's
bytes with 16-byte vectors, page ids clamped to [0, N-1]; bound by the
bytes it reads and writes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

#: kernel launches since the last reset (see ``dispatch.launch_counts``)
launches = 0


def paged_gather_cuda(pages: torch.Tensor,
                      page_table: torch.Tensor) -> torch.Tensor:
    """pages (N, psz, ...) of any dtype, page_table (S, P) int32, both
    contiguous on one CUDA device.  Returns the dense view (S, P*psz,
    ...)."""
    global launches
    if pages.device.type != "cuda" or page_table.device != pages.device:
        raise ValueError(f"paged_gather kernel needs CUDA tensors on one "
                         f"device, got {pages.device} and "
                         f"{page_table.device}")
    if page_table.dtype != torch.int32:
        raise TypeError(f"page_table must be int32, got {page_table.dtype}")
    if pages.dim() < 2 or page_table.dim() != 2:
        raise ValueError(f"need pages (N, psz, ...) and page_table (S, P), "
                         f"got {tuple(pages.shape)} and "
                         f"{tuple(page_table.shape)}")
    if not (pages.is_contiguous() and page_table.is_contiguous()):
        raise ValueError("paged_gather kernel needs contiguous inputs")
    n, psz = pages.shape[:2]
    s, p = page_table.shape
    if n < 1 or n >= 2 ** 31 or s * p >= 2 ** 31:
        raise ValueError(f"unsupported shapes {tuple(pages.shape)} and "
                         f"{tuple(page_table.shape)}")
    out = torch.empty((s, p * psz) + tuple(pages.shape[2:]),
                      dtype=pages.dtype, device=pages.device)
    page_bytes = psz * math.prod(pages.shape[2:]) * pages.element_size()
    if out.numel() == 0:
        return out
    lib = build.load_library()
    with torch.cuda.device(pages.device):
        stream = torch.cuda.current_stream(pages.device).cuda_stream
        err = lib.paged_gather_launch(
            pages.data_ptr(), page_table.data_ptr(), out.data_ptr(), n,
            s * p, page_bytes, stream)
    if err:
        raise RuntimeError(f"paged_gather kernel launch failed: cudaError "
                           f"{err}")
    launches += 1
    return out
