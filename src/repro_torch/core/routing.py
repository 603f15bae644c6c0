"""Batched DART routing — the glue between models and the DART policy.

Masked-mode routing runs Alg. 1 on the stacked confidences of every
exit; the stage-segmented compacted mode lives in
``repro_torch.engine``.  Classifier confidence is the max softmax
probability (paper), computed here as ``max(softmax)`` with the softmax
written out as ``jax.nn.softmax`` computes it (``torch.softmax`` adds a
CPU row in long serial runs, more than 1e-6 off JAX's chain at LM
vocabularies); the serving engine's compacted path takes it from the
fused exit-gate kernel.  ``multi_exit_xent`` is the Eq. 18 training loss.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import thresholds as TH
from repro_torch.kernels.exit_gate.ref import shifted_exp


@dataclasses.dataclass(frozen=True)
class DartParams:
    """Runtime routing parameters (learned offline, adapted online)."""
    tau: Any                     # (E-1,) base thresholds
    coef: Any                    # (E-1,) or (B, E-1) coefficients
    beta_diff: float = 0.3
    beta_opt: float = 0.5

    @staticmethod
    def default(n_exits: int, tau: float = 0.7):
        return DartParams(tau=torch.full((n_exits - 1,), tau),
                          coef=torch.ones(n_exits - 1))


def log_softmax(logits):
    """fp32 ``jax.nn.log_softmax`` over the last axis."""
    shifted, _, s = shifted_exp(logits.float())
    return shifted - s.log()


def confidence_from_logits(logits):
    """Max softmax probability per sample.  logits: (..., V) -> (...)."""
    _, e, s = shifted_exp(logits.float())
    return (e / s).amax(dim=-1)


def entropy_from_logits(logits):
    """Shannon entropy (BranchyNet's criterion)."""
    logp = log_softmax(logits)
    return -(logp.exp() * logp).sum(dim=-1)


def route(conf_stack, alpha, dart: DartParams):
    """Alg. 1: adapt thresholds (Eq. 19) and pick the first firing exit.

    conf_stack: (E, B); alpha: (B,), on one device.  Returns dict with
    exit_idx, conf, eff_thresholds, alpha."""
    dev = conf_stack.device
    tau = torch.as_tensor(dart.tau, dtype=torch.float32, device=dev)
    coef = torch.as_tensor(dart.coef, dtype=torch.float32, device=dev)
    eff = TH.adapt_thresholds(tau, coef, alpha, dart.beta_diff)
    exit_idx, conf = TH.select_exit(conf_stack, eff)
    return {"exit_idx": exit_idx, "conf": conf, "eff_thresholds": eff,
            "alpha": alpha}


def multi_exit_xent(exit_logits, labels, *, policy_weight: float = 0.01,
                    exit_weights=None):
    """L = sum_i w_i CE(y, y_i) + lambda L_policy, w_i = i/N (Eq. 18).

    exit_logits: (E, B, C); labels: (B,) integers.  The policy term
    pushes each early head toward the last one's loss:
    ``sum(max(ce_i - ce_last, 0))``.  Returns (loss, {"ce_per_exit":
    (E,)})."""
    e = exit_logits.shape[0]
    if exit_weights is None:
        exit_weights = [(i + 1) / e for i in range(e)]
    logp = log_softmax(exit_logits)
    idx = torch.as_tensor(labels, device=logp.device).long()
    gold = logp.gather(-1, idx[None, :, None].expand(e, -1, 1))[..., 0]
    ces = -gold.mean(dim=-1)                                # (E,)
    w = torch.as_tensor(exit_weights, dtype=torch.float32,
                        device=logp.device)
    total = (w * ces).sum()
    policy = (torch.clamp(ces[:-1] - ces[-1], min=0.0).sum() if e > 1
              else 0.0)
    return total + policy_weight * policy, {"ce_per_exit": ces}


def routed_macs(exit_idx, cum_macs):
    """Per-sample MACs actually spent under the routing."""
    cum = torch.as_tensor(cum_macs, device=exit_idx.device)
    return cum[exit_idx.long()]
