"""Plain torch version of the fused exit gate.

The same chain as the JAX reference (``repro/kernels/exit_gate/ref.py``),
op for op, with ``jax.nn.softmax`` and ``jax.nn.log_softmax`` written
out as they compute: the logits less their max, exponentiated and
summed.  ``conf`` is ``max(softmax(...))`` like
``core.routing.confidence_from_logits`` and NOT ``exp(log_softmax)``,
which differs in the low bits; ``pred`` is the first argmax and ``fire``
the strict Alg. 1 compare.  (``torch.softmax`` on the CPU adds each row
in long serial runs, which at LM vocabularies put it more than 1e-6 off
JAX's chain; ``torch.sum`` adds pairwise, as XLA does.)
"""
from __future__ import annotations

import torch


def shifted_exp(lf: torch.Tensor):
    """The logits less their row max, their exp, and the row sums of
    their exp: ``jax.nn.softmax``'s chain, which ``core.routing`` and the
    plain exit head share.  The max carries no gradient, as in
    ``jax.nn.log_softmax``."""
    shifted = lf - lf.amax(dim=-1, keepdim=True).detach()
    e = shifted.exp()
    return shifted, e, e.sum(dim=-1, keepdim=True)


def ref_softmax_confidence(logits: torch.Tensor):
    """(conf, pred) over (..., V): the gate without a threshold."""
    lf = logits.float()
    _, e, s = shifted_exp(lf)
    return (e / s).amax(dim=-1), lf.argmax(dim=-1).to(torch.int32)


def ref_exit_gate(logits: torch.Tensor, thresholds: torch.Tensor):
    """logits (B, V); thresholds (B,).  Returns (conf, entropy, pred,
    fire): float32, float32, int32, int32, each (B,)."""
    lf = logits.float()
    shifted, e, s = shifted_exp(lf)
    conf = (e / s).amax(dim=-1)
    logp = shifted - s.log()
    ent = -(logp.exp() * logp).sum(dim=-1)
    pred = lf.argmax(dim=-1).to(torch.int32)
    fire = (conf > thresholds).to(torch.int32)
    return conf, ent, pred, fire
