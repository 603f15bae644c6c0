"""Wrapper of the CUDA difficulty estimator (``csrc/difficulty.cu``).

Replaces ``repro/kernels/difficulty/difficulty_kernel.py::
difficulty_pallas``.  An image whose bytes fit a block's shared memory
is staged there whole with asynchronous copies, its one read of device
memory; gray, the channel means, the squared deviations and both 3x3
stencils then run on shared memory, and one block reduction ends it.
Larger images (224x224x3) take one block per image straight from device
memory.  The kernel is bound by the B*H*W*C*4 bytes of the batch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: kernel launches since the last reset (see ``dispatch.launch_counts``)
launches = 0


def difficulty_cuda(images: torch.Tensor, *, tau_edge: float,
                    var_scale: float, grad_scale: float, w1: float,
                    w2: float, w3: float) -> torch.Tensor:
    """images (B, H, W, C) float32, contiguous, on a CUDA device, with
    H, W >= 3.  Returns (B, 4) float32 = (a_edge, a_var, a_grad, alpha)."""
    global launches
    if images.device.type != "cuda":
        raise ValueError(f"difficulty kernel needs a CUDA tensor, got "
                         f"{images.device}")
    if images.dtype != torch.float32:
        raise TypeError(f"difficulty kernel takes float32 images, got "
                        f"{images.dtype}")
    if images.dim() != 4:
        raise ValueError(f"need images (B, H, W, C), got "
                         f"{tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("difficulty kernel needs a contiguous NHWC tensor")
    b, h, w, c = images.shape
    if h < 3 or w < 3 or c < 1 or h * w * c >= 2 ** 31 or b >= 2 ** 31:
        raise ValueError(f"unsupported image shape {(h, w, c)}")
    out = torch.empty((b, 4), dtype=torch.float32, device=images.device)
    if b == 0:
        return out
    lib = build.load_library()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.difficulty_launch(
            images.data_ptr(), out.data_ptr(), b, h, w, c, tau_edge,
            var_scale, grad_scale, w1, w2, w3, stream)
    if err:
        raise RuntimeError(f"difficulty kernel launch failed: cudaError {err}")
    launches += 1
    return out
