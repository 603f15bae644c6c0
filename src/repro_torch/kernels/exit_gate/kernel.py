"""Wrapper of the CUDA exit gate (``csrc/exit_gate.cu``).

Replaces ``repro/kernels/exit_gate/exit_gate_kernel.py::exit_gate_pallas``.
One warp per row streams the logits once with an online max / sum /
argmax / entropy term, so any vocabulary width works; the kernel is
bound by the B*V*itemsize bytes it reads, and at the classifier's V = 10
by its launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: kernel launches since the last reset (see ``dispatch.launch_counts``)
launches = 0

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


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
    lib = build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.exit_gate_launch(
            logits.data_ptr(), thresholds.data_ptr(), conf.data_ptr(),
            ent.data_ptr(), pred.data_ptr(), fire.data_ptr(), b, v,
            _DTYPES[logits.dtype], stream)
    if err:
        raise RuntimeError(f"exit_gate kernel launch failed: cudaError {err}")
    launches += 1
    return conf, ent, pred, fire
