"""DART joint exit-policy optimization — paper section II.B (Eqs. 10-12).

A host-side numpy copy of the JAX package's ``core/policy.py`` (the
calibration container, the joint value-iteration solver, the brute-force
oracle and the independent baseline), routed through the port's float32
``thresholds``.  The cascade solvers wait for the cascade slice.

Maximizes  J(tau) = sum_i pi_i(tau)*[A_i - beta_opt*C_i]  (Eq. 10) over
the whole threshold vector jointly, via backward induction on the state
space ``s = (exit_index, alpha_bin, confidence_bin)`` with the Q-update
of Eq. 11, then projects the per-(exit, alpha_bin) solution onto the
Eq. 19 runtime form over the Eq. 12 quantile candidates and polishes it
by coordinate ascent on the true objective.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core import thresholds as TH


@dataclasses.dataclass
class CalibrationData:
    """Per-sample calibration measurements.

    conf:     (n, E) confidence of each exit's prediction
    correct:  (n, E) 1.0 if exit i's prediction is correct
    alpha:    (n,)   difficulty scores (Eq. 8)
    cum_costs:(E,)   cumulative normalized compute up to each exit
                     (full network = 1.0)
    labels:   (n,) optional class ids (for class-aware adaptation)
    entropy:  (n, E) optional per-exit softmax entropy (lets entropy-
                     criterion baselines like BranchyNet fit faithfully)
    """
    conf: np.ndarray
    correct: np.ndarray
    alpha: np.ndarray
    cum_costs: np.ndarray
    labels: np.ndarray | None = None
    entropy: np.ndarray | None = None

    @property
    def n_exits(self) -> int:
        return self.conf.shape[1]

    def split(self, frac=0.8, seed=0):
        n = self.conf.shape[0]
        rs = np.random.RandomState(seed)
        perm = rs.permutation(n)
        k = int(n * frac)
        tr, va = perm[:k], perm[k:]
        pick = lambda idx: CalibrationData(
            self.conf[idx], self.correct[idx], self.alpha[idx],
            self.cum_costs, None if self.labels is None else self.labels[idx],
            None if self.entropy is None else self.entropy[idx])
        return pick(tr), pick(va)


@dataclasses.dataclass
class PolicyResult:
    tau: np.ndarray              # (E-1,) base thresholds
    coef: np.ndarray             # (E-1,) coefficients (init 1.0)
    beta_diff: float
    objective: float             # empirical J on the calibration set
    method: str
    dp_thresholds: np.ndarray | None = None   # (E-1, A) per-α-bin DP solution
    diagnostics: dict | None = None


def _bin_edges(n_bins):
    return np.linspace(0.0, 1.0, n_bins + 1)


def _digitize(x, n_bins):
    return np.clip((np.asarray(x) * n_bins).astype(int), 0, n_bins - 1)


def _empirical_tables(data: CalibrationData, n_alpha_bins, n_conf_bins,
                      smooth=1.0):
    """Accuracy table Â[i,a,c] and transition kernel P[i,a,c,c']."""
    n, e = data.conf.shape
    ab = _digitize(data.alpha, n_alpha_bins)
    cb = _digitize(data.conf, n_conf_bins)                 # (n, E)

    acc = np.zeros((e, n_alpha_bins, n_conf_bins))
    cnt = np.zeros_like(acc)
    np.add.at(cnt, (slice(None),), 0)  # no-op, keeps shape clear
    for i in range(e):
        np.add.at(cnt[i], (ab, cb[:, i]), 1.0)
        np.add.at(acc[i], (ab, cb[:, i]), data.correct[:, i])
    # hierarchical fallback: (i,a,c) -> (i,c) -> (i)
    acc_ic = np.zeros((e, n_conf_bins))
    cnt_ic = np.zeros_like(acc_ic)
    for i in range(e):
        np.add.at(cnt_ic[i], cb[:, i], 1.0)
        np.add.at(acc_ic[i], cb[:, i], data.correct[:, i])
    acc_i = data.correct.mean(axis=0)                      # (E,)
    acc_ic_s = (acc_ic + smooth * acc_i[:, None]) / (cnt_ic + smooth)
    acc_s = (acc + smooth * acc_ic_s[:, None, :]) / (cnt + smooth)

    # transitions i -> i+1
    trans = np.zeros((e - 1, n_alpha_bins, n_conf_bins, n_conf_bins))
    tcnt = np.zeros_like(trans)
    for i in range(e - 1):
        np.add.at(tcnt[i], (ab, cb[:, i], cb[:, i + 1]), 1.0)
        np.add.at(trans[i], (ab, cb[:, i], cb[:, i + 1]), 1.0)
    # fallback kernel: P(c' | i) marginal
    marg = np.zeros((e - 1, n_conf_bins))
    for i in range(e - 1):
        np.add.at(marg[i], cb[:, i + 1], 1.0)
        marg[i] /= max(marg[i].sum(), 1.0)
    denom = tcnt.sum(axis=-1, keepdims=True)
    trans_s = (trans + smooth * marg[:, None, None, :]) \
        / (denom + smooth)
    return acc_s, trans_s


def optimize_joint_dp(data: CalibrationData, *, beta_opt=0.5, gamma=1.0,
                      n_alpha_bins=4, n_conf_bins=10, beta_diff=0.3,
                      fit_beta_diff=False, smooth=1.0) -> PolicyResult:
    """Backward-induction value iteration over (exit, α_bin, conf_bin)."""
    e = data.n_exits
    acc, trans = _empirical_tables(data, n_alpha_bins, n_conf_bins, smooth)
    costs = np.asarray(data.cum_costs, float)

    v = np.zeros((e, n_alpha_bins, n_conf_bins))
    exit_decision = np.zeros((e - 1, n_alpha_bins, n_conf_bins), bool)
    v[e - 1] = acc[e - 1] - beta_opt * costs[e - 1]        # forced exit
    for i in range(e - 2, -1, -1):
        q_exit = acc[i] - beta_opt * costs[i]              # (A, C)
        q_cont = gamma * np.einsum("acd,ad->ac", trans[i], v[i + 1])
        exit_decision[i] = q_exit >= q_cont
        v[i] = np.maximum(q_exit, q_cont)

    # per-(exit, α_bin) threshold: smallest conf bin from which the policy
    # always exits (monotone suffix projection)
    edges = _bin_edges(n_conf_bins)
    dp_thr = np.ones((e - 1, n_alpha_bins))
    for i in range(e - 1):
        for a in range(n_alpha_bins):
            dec = exit_decision[i, a]
            cstar = n_conf_bins
            for c in range(n_conf_bins - 1, -1, -1):
                if dec[c]:
                    cstar = c
                else:
                    break
            dp_thr[i, a] = edges[cstar] if cstar < n_conf_bins else 1.0

    # project onto Eq. 19 runtime form using Eq. 12 candidates
    ab = _digitize(data.alpha, n_alpha_bins)
    occupancy = np.bincount(ab, minlength=n_alpha_bins).astype(float)
    occupancy /= max(occupancy.sum(), 1.0)
    alpha_mid = (_bin_edges(n_alpha_bins)[:-1]
                 + _bin_edges(n_alpha_bins)[1:]) / 2

    betas = [beta_diff] if not fit_beta_diff else \
        [0.0, 0.1, 0.2, 0.3, 0.4, 0.5]
    best = None
    ones = np.ones(e - 1)

    def joint_j(tau, bd):
        return float(TH.objective(data.conf, data.alpha, data.correct,
                                  data.cum_costs, tau, ones, bd, beta_opt))

    def polish(tau, bd, sweeps=2):
        """Coordinate ascent on the TRUE joint objective (Eq. 10) over the
        Eq. 12 candidates, starting from the DP projection.  This keeps
        threshold interdependence (each coordinate move is scored against
        the full routing) and repairs projection losses from the binned
        value iteration."""
        tau = tau.copy()
        best_j = joint_j(tau, bd)
        for _ in range(sweeps):
            improved = False
            for i in range(e - 1):
                for c in TH.candidate_thresholds(data.conf[:, i]):
                    t = tau.copy()
                    t[i] = c
                    j = joint_j(t, bd)
                    if j > best_j + 1e-12:
                        best_j, tau = j, t
                        improved = True
            if not improved:
                break
        return tau, best_j

    for bd in betas:
        tau = np.zeros(e - 1)
        for i in range(e - 1):
            cands = TH.candidate_thresholds(data.conf[:, i])
            # choose the candidate minimizing weighted sq. error to DP
            err = [(occupancy * (c + bd * alpha_mid - dp_thr[i]) ** 2).sum()
                   for c in cands]
            tau[i] = cands[int(np.argmin(err))]
        tau, j = polish(tau, bd)
        if best is None or j > best[0]:
            best = (j, tau, bd)
    j, tau, bd = best
    return PolicyResult(tau=tau, coef=ones, beta_diff=bd,
                        objective=j, method="joint_dp",
                        dp_thresholds=dp_thr,
                        diagnostics={"value": v, "acc_table": acc})


def optimize_brute_force(data: CalibrationData, *, beta_opt=0.5,
                         beta_diff=0.3, max_combos=20000) -> PolicyResult:
    """Exhaustive joint search over the Eq. 12 candidate grid (oracle)."""
    e = data.n_exits
    cand = [TH.candidate_thresholds(data.conf[:, i]) for i in range(e - 1)]
    total = int(np.prod([len(c) for c in cand]))
    if total > max_combos:
        raise ValueError(f"brute force too large: {total}")
    best = (-np.inf, None)
    ones = np.ones(e - 1)
    for combo in itertools.product(*cand):
        tau = np.asarray(combo)
        j = float(TH.objective(data.conf, data.alpha, data.correct,
                               data.cum_costs, tau, ones, beta_diff,
                               beta_opt))
        if j > best[0]:
            best = (j, tau)
    return PolicyResult(tau=best[1], coef=ones, beta_diff=beta_diff,
                        objective=best[0], method="brute_force")


def optimize_independent(data: CalibrationData, *, beta_opt=0.5,
                         beta_diff=0.3) -> PolicyResult:
    """The baseline DART argues against: each exit's threshold tuned in
    isolation (others pinned at their median candidate)."""
    e = data.n_exits
    tau = np.array([np.median(TH.candidate_thresholds(data.conf[:, i]))
                    for i in range(e - 1)])
    ones = np.ones(e - 1)
    for i in range(e - 1):
        best = (-np.inf, tau[i])
        for c in TH.candidate_thresholds(data.conf[:, i]):
            t = tau.copy()
            t[i] = c
            j = float(TH.objective(data.conf, data.alpha, data.correct,
                                   data.cum_costs, t, ones, beta_diff,
                                   beta_opt))
            if j > best[0]:
                best = (j, c)
        tau[i] = best[1]
    j = float(TH.objective(data.conf, data.alpha, data.correct,
                           data.cum_costs, tau, ones, beta_diff, beta_opt))
    return PolicyResult(tau=tau, coef=ones, beta_diff=beta_diff,
                        objective=j, method="independent")
