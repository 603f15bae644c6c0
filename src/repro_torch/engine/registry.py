"""String-keyed strategy registries for the port's DART engine.

* ``CONFIDENCE``  — raw exit outputs -> (E, B) confidence scores.
* ``DIFFICULTY``  — model inputs -> (B,) difficulty scores in [0, 1];
  ``"image"`` goes through ``kernels.dispatch`` (the CUDA kernel on a
  card, the plain chain on the CPU).
* ``OPTIMIZERS``  — calibration data -> ``PolicyResult`` (section II.B
  solvers and the Table I baselines ``static``, ``branchynet`` and
  ``rl_agent``).

Baselines that do not natively route on adapted confidence thresholds
(BranchyNet, RL-Agent) project their policy onto the Eq. 19 runtime form
and keep their native router under ``diagnostics["router"]`` (a
``CalibrationData -> exit_idx`` callable), which ``route_policy`` uses
for offline evaluation.

This port carries the strategies of the classifier path and the LM
decode path (``"lm-token"``); any other name raises the same
``KeyError`` as an unknown one.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import baselines as BL
from repro_torch.core import difficulty as DIFF
from repro_torch.core import policy as POL
from repro_torch.core import routing as R
from repro_torch.core import thresholds as TH
from repro_torch.core.policy import CalibrationData, PolicyResult

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


# ---------------------------------------------------------------------------
# Table I baselines (repro/engine/registry.py, numpy on the host)
# ---------------------------------------------------------------------------

def _objective(data: CalibrationData, idx, beta_opt: float) -> float:
    n = data.conf.shape[0]
    acc = float(data.correct[np.arange(n), idx].mean())
    cost = float(np.asarray(data.cum_costs)[idx].mean())
    return acc - beta_opt * cost


def _simulate(conf, alpha, tau, coef, beta_diff) -> np.ndarray:
    return TH.simulate_routing(conf, alpha, tau, coef, beta_diff).numpy()


@_register(OPTIMIZERS, "static")
def optimize_static(data: CalibrationData, *, beta_opt=0.5,
                    **kw) -> PolicyResult:
    """Table I "Static": never exit early (tau = 1: conf > 1 never fires)."""
    e = data.n_exits
    idx = BL.static_route(data.conf)
    return PolicyResult(
        tau=np.ones(e - 1), coef=np.ones(e - 1), beta_diff=0.0,
        objective=_objective(data, idx, beta_opt), method="static",
        diagnostics={"router": lambda d: BL.static_route(d.conf)})


@_register(OPTIMIZERS, "branchynet")
def optimize_branchynet(data: CalibrationData, *, beta_opt=0.5,
                        **kw) -> PolicyResult:
    """Table I "BranchyNet": fixed entropy thresholds, no difficulty term.

    Fits on ``data.entropy`` when available (the original criterion) and
    projects onto confidence space by matching per-exit firing quantiles;
    without entropy it degrades to a fixed-confidence-threshold fit."""
    e = data.n_exits
    if data.entropy is not None:
        pol = BL.fit_branchynet(data.entropy, data.correct,
                                np.asarray(data.cum_costs),
                                beta_opt=beta_opt)
        idx = pol.route(data.entropy)
        tau = np.empty(e - 1)
        for i in range(e - 1):
            fire_frac = float(
                (data.entropy[:, i] < pol.entropy_thresholds[i]).mean())
            tau[i] = np.quantile(data.conf[:, i],
                                 min(max(1.0 - fire_frac, 0.0), 1.0))

        def router(d):
            if d.entropy is None:       # entropy-less holdout: Eq. 19 form
                return _simulate(d.conf, np.zeros_like(d.alpha), tau,
                                 np.ones(e - 1), 0.0)
            return pol.route(d.entropy)
        diag = {"router": router, "policy": pol}
    else:
        grid = np.quantile(data.conf[:, :-1],
                           [0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95])
        ones, zeros = np.ones(e - 1), np.zeros_like(data.alpha)
        best = (-np.inf, None)
        for t in grid:
            cand = np.full(e - 1, t)
            j = _objective(data, _simulate(data.conf, zeros, cand, ones,
                                           0.0), beta_opt)
            if j > best[0]:
                best = (j, cand)
        tau = best[1]
        idx = _simulate(data.conf, zeros, tau, ones, 0.0)
        diag = {"router": lambda d: _simulate(
            d.conf, np.zeros_like(d.alpha), tau, np.ones(e - 1), 0.0)}
    return PolicyResult(tau=tau, coef=np.ones(e - 1), beta_diff=0.0,
                        objective=_objective(data, idx, beta_opt),
                        method="branchynet", diagnostics=diag)


@_register(OPTIMIZERS, "rl_agent")
def optimize_rl_agent(data: CalibrationData, *, beta_opt=0.5, epochs=20,
                      n_conf_bins=10, seed=0, **kw) -> PolicyResult:
    """Table I "RL-Agent": tabular Q-learning policy, projected onto
    per-exit confidence thresholds (smallest bin whose exit-action value
    dominates for every bin above it)."""
    pol = BL.fit_rl_agent(data, beta_opt=beta_opt, epochs=epochs,
                          n_conf_bins=n_conf_bins, seed=seed)
    e = data.n_exits
    edges = np.linspace(0.0, 1.0, n_conf_bins + 1)
    tau = np.ones(e - 1)
    for i in range(e - 1):
        cstar = n_conf_bins
        for c in range(n_conf_bins - 1, -1, -1):
            if pol.q[i, c, 1] >= pol.q[i, c, 0]:
                cstar = c
            else:
                break
        tau[i] = edges[cstar] if cstar < n_conf_bins else 1.0
    idx = pol.route(data.conf)
    return PolicyResult(
        tau=tau, coef=np.ones(e - 1), beta_diff=0.0,
        objective=_objective(data, idx, beta_opt), method="rl_agent",
        diagnostics={"router": lambda d: pol.route(d.conf), "policy": pol})


def route_policy(pol: PolicyResult, data: CalibrationData) -> np.ndarray:
    """Offline-route a calibration/holdout set under a fitted policy.

    Uses the policy's native router when it has one (entropy criterion,
    Q-table, ...); otherwise simulates Alg. 1 with the Eq. 19 projection."""
    if pol.diagnostics and "router" in pol.diagnostics:
        return np.asarray(pol.diagnostics["router"](data))
    return _simulate(data.conf, data.alpha, pol.tau, pol.coef,
                     pol.beta_diff)
