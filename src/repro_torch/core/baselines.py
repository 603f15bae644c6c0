"""Baselines from the paper's Table I: Static, BranchyNet, RL-Agent.

* Static      — no early exits; always the final head.
* BranchyNet  — fixed per-exit thresholds on softmax *entropy*
  (Teerapittayanon et al. 2016): exit when H(p) < T_i.  No difficulty
  awareness, no coefficients, thresholds tuned once.
* RL-Agent    — tabular Q-learning exit policy over (exit, conf_bin)
  states (Taheri et al. 2025 lineage): learned from calibration episodes
  with an accuracy−cost reward, no difficulty input.

A numpy-only copy of the JAX package's ``core/baselines.py``; the
Q-learning draws from ``np.random.RandomState(seed)`` in the same order,
so the fitted Q-table is the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.policy import CalibrationData


# ---------------------------------------------------------------------------
# Static
# ---------------------------------------------------------------------------

def static_route(conf_matrix: np.ndarray) -> np.ndarray:
    """Everything exits at the final head."""
    n, e = conf_matrix.shape
    return np.full((n,), e - 1, dtype=np.int64)


# ---------------------------------------------------------------------------
# BranchyNet
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BranchyNetPolicy:
    entropy_thresholds: np.ndarray       # (E-1,)

    def route(self, entropy_matrix: np.ndarray) -> np.ndarray:
        """entropy_matrix: (n, E).  First exit with H < T_i, else final."""
        n, e = entropy_matrix.shape
        fires = entropy_matrix[:, :-1] < self.entropy_thresholds[None, :]
        fires = np.concatenate([fires, np.ones((n, 1), bool)], axis=1)
        return np.argmax(fires, axis=1)


def fit_branchynet(entropy_matrix: np.ndarray, correct: np.ndarray,
                   cum_costs: np.ndarray, *, beta_opt=0.5,
                   grid=None) -> BranchyNetPolicy:
    """Tune one global entropy scale on the calibration set (BranchyNet
    tunes T by screening a scalar grid; thresholds are *fixed* afterwards
    — the paper's criticism)."""
    n, e = entropy_matrix.shape
    if grid is None:
        grid = np.quantile(entropy_matrix[:, :-1],
                           [0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8])
    best = (-np.inf, None)
    for t in grid:
        pol = BranchyNetPolicy(np.full((e - 1,), t))
        idx = pol.route(entropy_matrix)
        acc = correct[np.arange(n), idx].mean()
        cost = cum_costs[idx].mean()
        j = acc - beta_opt * cost
        if j > best[0]:
            best = (j, pol)
    return best[1]


# ---------------------------------------------------------------------------
# RL-Agent (tabular Q-learning)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RLAgentPolicy:
    q: np.ndarray                        # (E, C, 2) Q[exit, conf_bin, action]
    n_conf_bins: int

    def route(self, conf_matrix: np.ndarray) -> np.ndarray:
        n, e = conf_matrix.shape
        cb = np.clip((conf_matrix * self.n_conf_bins).astype(int), 0,
                     self.n_conf_bins - 1)
        out = np.full((n,), e - 1, dtype=np.int64)
        decided = np.zeros((n,), bool)
        for i in range(e - 1):
            act = self.q[i, cb[:, i], 1] >= self.q[i, cb[:, i], 0]
            take = act & ~decided
            out[take] = i
            decided |= take
        return out


def fit_rl_agent(data: CalibrationData, *, beta_opt=0.5, n_conf_bins=10,
                 epochs=20, lr=0.2, gamma=1.0, eps=0.2,
                 seed=0) -> RLAgentPolicy:
    """Tabular Q-learning (Watkins) on calibration episodes.

    State (exit i, conf bin); actions {0: continue, 1: exit}.
    Reward on exit: correct_i − β_opt·C_i; continuing pays the marginal
    cost at the final forced exit."""
    rs = np.random.RandomState(seed)
    n, e = data.conf.shape
    cb = np.clip((data.conf * n_conf_bins).astype(int), 0, n_conf_bins - 1)
    q = np.zeros((e, n_conf_bins, 2))
    costs = np.asarray(data.cum_costs, float)
    for ep in range(epochs):
        order = rs.permutation(n)
        for s in order:
            for i in range(e):
                c = cb[s, i]
                if i == e - 1:
                    r = data.correct[s, i] - beta_opt * costs[i]
                    q[i, c, 1] += lr * (r - q[i, c, 1])
                    q[i, c, 0] += lr * (r - q[i, c, 0])   # forced exit
                    break
                explore = rs.rand() < eps
                a = rs.randint(2) if explore \
                    else int(q[i, c, 1] >= q[i, c, 0])
                if a == 1:
                    r = data.correct[s, i] - beta_opt * costs[i]
                    q[i, c, 1] += lr * (r - q[i, c, 1])
                    break
                nxt = np.max(q[i + 1, cb[s, i + 1]])
                q[i, c, 0] += lr * (gamma * nxt - q[i, c, 0])
    return RLAgentPolicy(q=q, n_conf_bins=n_conf_bins)
