"""Wrapper of the CUDA exit head (``csrc/exit_head.cu``).

Replaces ``repro/kernels/exit_head/exit_head_kernel.py::
exit_head_gate_pallas``.  The design follows the table's dtype alone:

- bfloat16: tensor cores.  A first small kernel writes hn (fp32 rmsnorm
  times scale) as three bf16 terms (hi, mid, lo: together the 24 bits
  of fp32, so the products keep fp32 accuracy) into a workspace this
  wrapper allocates; the main kernel streams the (V, D) table through a
  three-stage TMA ring and runs three ``wgmma`` passes over each table
  tile, one per term.  The tensor cores' own fp32 sums drop low bits
  over D = 2048, so each 64-wide K tile's sum is promoted into an fp32
  register sum.  Bound on an H100: the table read (0.039 ms at
  V = 32000, D = 2048) up to B ~ 100 rows, the tensor cores beyond.
- float32 and float16: fp32 FMAs outside the tensor cores, with a
  vocabulary slice and a row tile a block (0.125 ms at B = 64).

Either way each block writes a partial (max, sum, first argmax) per
(row, vocabulary slice) into scratch this wrapper allocates, and a merge
kernel of the same launch reduces them to (conf, pred, fire).  One call
is one counted launch, whatever kernels it runs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: kernel launches since the last reset (see ``dispatch.launch_counts``)
launches = 0

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def exit_head_gate_cuda(h: torch.Tensor, scale: torch.Tensor,
                        table: torch.Tensor, thresholds: torch.Tensor, *,
                        eps: float = 1e-6):
    """h (B, D), scale (D,), table (V, D) in one of float32 / float16 /
    bfloat16, thresholds (B,) float32; all contiguous on one CUDA device.
    Returns (conf float32, pred int32, fire int32), each (B,)."""
    global launches
    dev = h.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (scale, table, thresholds)):
        raise ValueError(f"exit_head kernel needs CUDA tensors on one "
                         f"device, got {h.device}, {scale.device}, "
                         f"{table.device} and {thresholds.device}")
    if h.dtype not in _DTYPES or scale.dtype != h.dtype \
            or table.dtype != h.dtype:
        raise TypeError(f"exit_head kernel takes h, scale and table of one "
                        f"dtype in {list(_DTYPES)}, got {h.dtype}, "
                        f"{scale.dtype} and {table.dtype}")
    if thresholds.dtype != torch.float32:
        raise TypeError(f"thresholds must be float32, got "
                        f"{thresholds.dtype}")
    if h.dim() != 2 or table.dim() != 2 or table.shape[1] != h.shape[1] \
            or scale.shape != h.shape[1:] \
            or thresholds.shape != h.shape[:1]:
        raise ValueError(f"need h (B, D), scale (D,), table (V, D) and "
                         f"thresholds (B,), got {tuple(h.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(table.shape)} and "
                         f"{tuple(thresholds.shape)}")
    if not all(t.is_contiguous() for t in (h, scale, table, thresholds)):
        raise ValueError("exit_head kernel needs contiguous inputs")
    b, d = h.shape
    v = table.shape[0]
    if d < 1 or v < 1 or b >= 2 ** 31 or v * d >= 2 ** 62:
        raise ValueError(f"unsupported shape B={b}, D={d}, V={v}")
    conf = torch.empty(b, dtype=torch.float32, device=dev)
    pred = torch.empty(b, dtype=torch.int32, device=dev)
    fire = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return conf, pred, fire
    lib = build.load_library()
    dtype = _DTYPES[h.dtype]
    plan = (ctypes.c_int64 * 2)()
    err = lib.exit_head_plan(b, d, v, dtype, plan)
    if err:
        raise RuntimeError(f"exit_head plan refused B={b}, D={d}, V={v}: "
                           f"error {err}")
    n_slices, split_bytes = plan
    part_f = torch.empty((2, b, n_slices), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, n_slices), dtype=torch.int32, device=dev)
    # the bf16 design's hn terms (none for the SIMT design)
    split = torch.empty(split_bytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.exit_head_launch(
            h.data_ptr(), scale.data_ptr(), table.data_ptr(),
            thresholds.data_ptr(), conf.data_ptr(), pred.data_ptr(),
            fire.data_ptr(), part_f.data_ptr(), part_i.data_ptr(),
            split.data_ptr(), b, d, v, dtype, eps, stream)
    if err < 0:
        raise RuntimeError(f"exit_head: cuTensorMapEncodeTiled refused the "
                           f"table: CUresult {-err}")
    if err:
        raise RuntimeError(f"exit_head kernel launch failed: cudaError {err}")
    launches += 1
    return conf, pred, fire
