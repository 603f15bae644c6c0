"""Plain torch version of the fused exit gate.

The same chain as the JAX reference (``repro/kernels/exit_gate/ref.py``),
op for op: ``conf`` is ``max(softmax(...))`` like
``core.routing.confidence_from_logits`` and NOT ``exp(log_softmax)``,
which differs in the low bits; ``pred`` is the first argmax and ``fire``
the strict Alg. 1 compare.
"""
from __future__ import annotations

import torch


def ref_exit_gate(logits: torch.Tensor, thresholds: torch.Tensor):
    """logits (B, V); thresholds (B,).  Returns (conf, entropy, pred,
    fire): float32, float32, int32, int32, each (B,)."""
    lf = logits.float()
    conf = torch.softmax(lf, dim=-1).amax(dim=-1)
    logp = torch.log_softmax(lf, dim=-1)
    ent = -(logp.exp() * logp).sum(dim=-1)
    pred = lf.argmax(dim=-1).to(torch.int32)
    fire = (conf > thresholds).to(torch.int32)
    return conf, ent, pred, fire
