"""DART threshold machinery — Eq. 12 (quantile candidates), Eq. 19
(difficulty-aware adaptation) and Algorithm 1 (adaptive exit decision).

Batched torch functions; the serving engine and the policy search call
straight into these.  ``simulate_routing`` and ``objective`` compute in
float32, as the JAX reference does with 64-bit mode off: the policy
search compares objectives with ``> best + 1e-12``, so float64 could
choose other thresholds.
"""
from __future__ import annotations

import numpy as np
import torch


def candidate_thresholds(confidences, qs=None):
    """Eq. 12: tau_i^cand = quantile(C_i, q), q in {0.1, ..., 0.9}.

    confidences: (n_samples,) conf values observed at one exit on the
    calibration set.  Returns (9,) candidates (host-side, numpy)."""
    qs = np.arange(0.1, 0.91, 0.1) if qs is None else np.asarray(qs)
    return np.quantile(np.asarray(confidences), qs)


def adapt_thresholds(tau, coef, alpha, beta_diff):
    """Eq. 19 + clamp: tau'_i = clip(c_i * tau_i + beta_diff * alpha, 0, 1).

    tau:   (E-1,) learned base thresholds
    coef:  (E-1,) adaptive coefficients (or (B, E-1) per-sample/class)
    alpha: (B,) per-input difficulty
    Returns (B, E-1) effective thresholds."""
    tau_adapted = coef * tau                       # element-wise (Alg.1 l.3)
    if tau_adapted.dim() == 1:
        tau_adapted = tau_adapted[None, :]
    eff = tau_adapted + beta_diff * alpha[:, None]
    return torch.clamp(eff, 0.0, 1.0)


def stage_threshold(tau_s, coef_s, alpha, beta_diff, lo=0.0, hi=1.0):
    """Eq. 19 for ONE gate: tau'_s = clip(c_s*tau_s + beta_diff*alpha,
    lo, hi) — the per-stage form of the compacted serving path."""
    return torch.clamp(coef_s * tau_s + beta_diff * alpha, lo, hi)


def select_exit(conf_stack, eff_thresholds):
    """Algorithm 1 lines 4-12, batched.

    conf_stack:      (E, B)   confidence at every exit (final included)
    eff_thresholds:  (B, E-1) difficulty-aware thresholds
    Returns (exit_idx (B,), exited_conf (B,)).  The final exit always
    accepts (line 12)."""
    _, b = conf_stack.shape
    fires = conf_stack[:-1].T > eff_thresholds          # (B, E-1)
    fires = torch.cat([fires, torch.ones((b, 1), dtype=torch.bool,
                                         device=fires.device)], dim=1)
    exit_idx = fires.to(torch.uint8).argmax(dim=1)      # first True
    exited_conf = conf_stack.T.gather(1, exit_idx[:, None])[:, 0]
    return exit_idx, exited_conf


def ruled_out_stages(tau, coef, beta_diff, alpha_lo, conf_max=1.0):
    """Which gates can provably NEVER fire for any input with difficulty
    >= ``alpha_lo`` under the current policy (host-side).  Confidence
    functionals bounded by ``conf_max`` never beat an unclipped Eq. 19
    threshold that reaches it, and with beta_diff >= 0 the threshold is
    monotone in alpha.  Returns a (E-1,) bool mask — True = sound to
    skip."""
    tau = np.asarray(tau, np.float64)
    coef = np.asarray(coef, np.float64)
    if float(beta_diff) < 0.0:      # threshold no longer monotone in alpha
        return np.zeros(tau.shape, bool)
    return (coef * tau + float(beta_diff) * float(alpha_lo)
            >= float(conf_max))


def min_exit_bound(tau, coef, beta_diff, alpha_lo, conf_max=1.0):
    """Largest m such that gates 0..m-1 are all ruled out for every input
    with difficulty >= ``alpha_lo``.  0 = nothing can be skipped."""
    m = 0
    for r in ruled_out_stages(tau, coef, beta_diff, alpha_lo, conf_max):
        if not r:
            break
        m += 1
    return m


def exit_distribution(exit_idx, n_exits):
    """pi_i — empirical exit distribution (Eq. 10's pi)."""
    onehot = torch.nn.functional.one_hot(exit_idx.long(), n_exits)
    return onehot.float().mean(dim=0)


def expected_cost(exit_idx, cum_costs):
    """Mean computational cost under the routing (C_i = cumulative cost up
    to exit i, e.g. MACs)."""
    cum = torch.as_tensor(cum_costs, dtype=torch.float32,
                          device=exit_idx.device)
    return cum[exit_idx.long()].mean()


def _f32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def simulate_routing(conf_matrix, alpha, tau, coef, beta_diff):
    """Vectorized Alg. 1 over a calibration set, in float32 on the host.

    conf_matrix: (n, E); alpha: (n,); tau/coef: (E-1,).
    Returns exit_idx (n,)."""
    eff = adapt_thresholds(_f32(tau), _f32(coef), _f32(alpha), beta_diff)
    return select_exit(_f32(conf_matrix).T, eff)[0]


def objective(conf_matrix, alpha, correct_matrix, cum_costs, tau, coef,
              beta_diff, beta_opt):
    """Eq. 10: J(tau) = sum_i pi_i(tau)[A_i - beta_opt*C_i], evaluated
    empirically in float32.

    correct_matrix: (n, E) 0/1 — was exit i's prediction correct.
    cum_costs: (E,) normalized cumulative cost."""
    idx = simulate_routing(conf_matrix, alpha, tau, coef, beta_diff).long()
    acc = _f32(correct_matrix).gather(1, idx[:, None])[:, 0]
    cost = _f32(cum_costs)[idx]
    return (acc - beta_opt * cost).mean()
