"""Batched DART routing — the glue between models and the DART policy.

Masked-mode routing runs Alg. 1 on the stacked confidences of every
exit; the stage-segmented compacted mode lives in
``repro_torch.engine``.  Classifier confidence is the max softmax
probability (paper), computed here as ``max(softmax)``; the serving
engine's compacted path takes it from the fused exit-gate kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import thresholds as TH


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


def confidence_from_logits(logits):
    """Max softmax probability per sample.  logits: (..., V) -> (...)."""
    return torch.softmax(logits.float(), dim=-1).amax(dim=-1)


def entropy_from_logits(logits):
    """Shannon entropy (BranchyNet's criterion)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
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


def routed_macs(exit_idx, cum_macs):
    """Per-sample MACs actually spent under the routing."""
    cum = torch.as_tensor(cum_macs, device=exit_idx.device)
    return cum[exit_idx.long()]
