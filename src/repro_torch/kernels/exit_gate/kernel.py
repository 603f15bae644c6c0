"""Wrapper of the CUDA exit gate (``csrc/exit_gate.cu``).

Replaces ``repro/kernels/exit_gate/exit_gate_kernel.py::exit_gate_pallas``.
The C launcher picks one of three routes from V (``plan``):

- ``short`` (classifier heads, V up to 64): 16 lanes per row, the row
  in registers; bound by its launch.
- ``warp`` (V up to 2048): one warp per row, the row in registers (4, 8
  or 16 16-byte vectors a lane, by V); bound by the B*V*itemsize bytes
  it reads once the rows fill the card.
- ``split`` (LM vocabularies): V cut into 16 KB chunks, one block per
  (row, chunk) writes a partial into a workspace this wrapper allocates,
  and a merge kernel of the same launch reduces a row's partials; bound
  by the bytes it reads.

One call is one counted launch, whatever kernels it runs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: kernel launches since the last reset (see ``dispatch.launch_counts``)
launches = 0

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

#: route names, by the number ``exit_gate_plan`` gives
ROUTES = ("short", "warp", "split")


def plan(rows: int, v: int, dtype: torch.dtype):
    """(route name, workspace bytes, columns) that the C launcher gives
    logits (rows, v) of ``dtype``; columns is the most one unit of the
    route holds at this V (a short row, a warp row of its class of
    vectors a lane, a split chunk)."""
    out = (ctypes.c_int64 * 3)()
    err = build.load_library().exit_gate_plan(rows, v, _DTYPES[dtype], out)
    if err:
        raise ValueError(f"exit_gate kernel refuses logits {(rows, v)}")
    return ROUTES[out[0]], out[1], out[2]


def exit_gate_cuda(logits: torch.Tensor, thresholds: torch.Tensor):
    """logits (B, V) float32/float16/bfloat16, thresholds (B,) float32,
    both contiguous on one CUDA device.  Returns (conf, entropy, pred,
    fire): float32, float32, int32, int32, each (B,)."""
    global launches
    if logits.device.type != "cuda" or thresholds.device != logits.device:
        raise ValueError(f"exit_gate kernel needs CUDA tensors on one "
                         f"device, got {logits.device} and "
                         f"{thresholds.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"exit_gate kernel takes {list(_DTYPES)} logits, "
                        f"got {logits.dtype}")
    if thresholds.dtype != torch.float32:
        raise TypeError(f"thresholds must be float32, got "
                        f"{thresholds.dtype}")
    if logits.dim() != 2 or thresholds.shape != logits.shape[:1]:
        raise ValueError(f"need logits (B, V) and thresholds (B,), got "
                         f"{tuple(logits.shape)} and "
                         f"{tuple(thresholds.shape)}")
    if not (logits.is_contiguous() and thresholds.is_contiguous()):
        raise ValueError("exit_gate kernel needs contiguous inputs")
    b, v = logits.shape
    if v < 1 or b >= 2 ** 31 or v >= 2 ** 31:
        raise ValueError(f"unsupported logits shape {(b, v)}")
    dev = logits.device
    conf = torch.empty(b, dtype=torch.float32, device=dev)
    ent = torch.empty(b, dtype=torch.float32, device=dev)
    pred = torch.empty(b, dtype=torch.int32, device=dev)
    fire = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return conf, ent, pred, fire
    _, nbytes, _ = plan(b, v, logits.dtype)
    # the split route's partials (none for the other routes)
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.exit_gate_launch(
            logits.data_ptr(), thresholds.data_ptr(), conf.data_ptr(),
            ent.data_ptr(), pred.data_ptr(), fire.data_ptr(),
            work.data_ptr(), b, v, _DTYPES[logits.dtype], stream)
    if err:
        raise RuntimeError(f"exit_gate kernel launch failed: cudaError {err}")
    launches += 1
    return conf, ent, pred, fire
