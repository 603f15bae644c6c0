"""String-keyed strategy registries for the port's DART engine.

* ``CONFIDENCE``  — raw exit outputs -> (E, B) confidence scores.
* ``DIFFICULTY``  — model inputs -> (B,) difficulty scores in [0, 1];
  ``"image"`` goes through ``kernels.dispatch`` (the CUDA kernel on a
  card, the plain chain on the CPU).
* ``OPTIMIZERS``  — calibration data -> ``PolicyResult`` (section II.B).

This port carries the strategies of the classifier path and the LM
decode path (``"lm-token"``); any other name raises the same
``KeyError`` as an unknown one.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import difficulty as DIFF
from repro_torch.core import policy as POL
from repro_torch.core import routing as R

CONFIDENCE: dict[str, Callable] = {}
DIFFICULTY: dict[str, Callable] = {}
OPTIMIZERS: dict[str, Callable] = {
    "joint_dp": POL.optimize_joint_dp,
    "brute_force": POL.optimize_brute_force,
    "independent": POL.optimize_independent,
}


def _register(table: dict, name: str):
    def deco(fn):
        table[name] = fn
        return fn
    return deco


def _get(table: dict, kind: str, name: str):
    if name not in table:
        raise KeyError(f"unknown {kind} strategy {name!r}; "
                       f"known: {sorted(table)}")
    return table[name]


def get_confidence(name: str) -> Callable:
    return _get(CONFIDENCE, "confidence", name)


def get_difficulty(name: str) -> Callable:
    return _get(DIFFICULTY, "difficulty", name)


def get_optimizer(name: str) -> Callable:
    return _get(OPTIMIZERS, "optimizer", name)


@_register(CONFIDENCE, "softmax-max")
def _conf_softmax_max(logits, **kw):
    """Max softmax probability (the paper's classifier criterion)."""
    return R.confidence_from_logits(logits)


@_register(CONFIDENCE, "entropy")
def _conf_entropy(logits, **kw):
    """exp(-H(p)) — entropy mapped onto (0, 1], larger = more confident
    (BranchyNet's criterion under the common gate protocol)."""
    return torch.exp(-R.entropy_from_logits(logits))


@_register(CONFIDENCE, "lm-token")
def _conf_lm_token(logits, **kw):
    """Next-token max softmax probability (CALM-style LM criterion)."""
    return R.confidence_from_logits(logits)


@_register(DIFFICULTY, "image")
def _diff_image(inputs, cfg: DIFF.DifficultyConfig = DIFF.DEFAULT, **kw):
    """Eq. 8 image difficulty through the kernel dispatch."""
    from repro_torch.kernels import dispatch as KD
    return KD.image_difficulty(inputs, cfg)


@_register(DIFFICULTY, "zero")
def _diff_zero(inputs, cfg: DIFF.DifficultyConfig = DIFF.DEFAULT, **kw):
    """Difficulty-unaware ablation: alpha = 0 (Eq. 19 collapses to c*tau)."""
    return torch.zeros(inputs.shape[0], dtype=torch.float32,
                       device=inputs.device)
