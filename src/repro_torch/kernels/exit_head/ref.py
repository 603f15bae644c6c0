"""Plain torch version of the fused LM exit head.

The same chain as the JAX reference (``repro/kernels/exit_head/ref.py``),
op for op: rmsnorm in fp32 with the normalised row cast back to the
model dtype, the unembedding ``einsum`` in that dtype, conf as
``max(softmax(logits.float()))`` with the softmax written out as JAX
computes it (``exit_gate.ref.shifted_exp``), the first argmax and the
strict Alg. 1 compare.  The CUDA kernel keeps the normalised row and the logits in
fp32, so on bf16 inputs the two agree to bf16 rounding, not bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.exit_gate.ref import shifted_exp


def ref_exit_head_gate(h, scale, table, thresholds, *, eps: float = 1e-6):
    """h (B, D), scale (D,) rmsnorm weight, table (V, D) unembedding,
    thresholds (B,).  Returns (conf (B,) f32, pred (B,) i32,
    fire (B,) i32)."""
    dtype = h.dtype
    x = h.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    hn = (x * scale.float()).to(dtype)
    logits = torch.einsum("...d,vd->...v", hn, table)
    _, e, s = shifted_exp(logits.float())
    conf = (e / s).amax(dim=-1)
    pred = logits.argmax(dim=-1).to(torch.int32)
    fire = (conf > thresholds).to(torch.int32)
    return conf, pred, fire
