"""Admission-time exit-depth prediction.

DART's premise is that difficulty is knowable *before* paying for the
backbone (Eq. 8 runs on raw inputs).  Following Dong, Mao & Zhang
(arXiv:2206.07269, "Resource-Constrained Edge AI with Early Exit
Prediction"), a tiny pre-backbone predictor can therefore commit to an
exit depth at ADMISSION time; and per EENet, ruling a stage out up
front means its exit head + gate launches need never run.

:class:`ExitDepthPredictor` is that predictor: one online logistic
head per (difficulty class, gate) over the Eq. 8 difficulty

    P(exit <= s | alpha, class) = sigmoid(w0[c, s] + w1[c, s] * alpha)

trained by per-completion SGD from the telemetry the scheduler already
folds into ``EngineState`` (realized exit stages arrive for free in
``_complete``), plus a per-class exit-histogram EMA used as a quantile
band.  Three consumers:

* **head-skip** — :meth:`min_exit` hands the engines a per-bucket
  ``min_exit`` argument.  ``conservative`` mode only rules a gate
  out when Eq. 19 *provably* can't fire it (the engine's
  ``min_exit_bound``: unclipped threshold >= the confidence bound) —
  decisions stay bit-identical to the eager oracle.  ``aggressive``
  mode additionally skips gates whose learned fire probability is
  below ``eps`` — opt-in, measured, NOT bit-identical.
* **depth-aware packing** — :meth:`depth_band` gives the scheduler a
  predicted-depth lane component so a bucket's rows exit together.
* **SLO quoting** — :meth:`predict_depth` feeds the admission
  planner's per-request latency quote (predicted depth x per-stage
  service EMA).

Everything is host-side numpy: the predictor adds no device
round-trip to admission.  All methods are thread-safe (submit threads
and the dispatcher thread both touch the predictor).  A copy of the JAX
package's ``serving/predict.py``.
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.core import difficulty as DIFF

MODES = ("conservative", "aggressive")


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


class ExitDepthPredictor:
    """Per-class online logistic/quantile exit-depth heads.

        pred = ExitDepthPredictor(engine.n_exits)
        pred.observe(alpha, exit_idx)          # completion telemetry
        pred.predict_depth(0.4)                # float expected stage
        pred.depth_band(0.4)                   # int lane component
        pred.min_exit(engine, alpha_lo=0.35)   # head-skip bound

    ``priors`` (optional) is a callable returning the admission
    planner's per-class depth EMAs (``AdmissionPlanner.priors``); cold
    heads blend toward it until they have seen ``prior_strength``
    observations of their class.
    """

    def __init__(self, n_exits: int, edges=DIFF.DEFAULT_EDGES, *,
                 mode: str = "conservative", lr: float = 0.25,
                 ema_decay: float = 0.98, eps: float = 0.02,
                 min_obs: int = 32, prior_strength: float = 8.0,
                 band_hysteresis: float = 0.25, priors=None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
        if n_exits < 1:
            raise ValueError("n_exits must be >= 1")
        self.n_exits = int(n_exits)
        self.edges = tuple(edges)
        self.n_classes = len(self.edges) + 1
        self.mode = mode
        self.lr = float(lr)
        self.ema_decay = float(ema_decay)
        self.eps = float(eps)
        self.min_obs = int(min_obs)
        self.prior_strength = float(prior_strength)
        self.band_hysteresis = float(band_hysteresis)
        self._priors = priors
        self._band_cache: dict = {}     # class -> sticky lane band
        g = max(self.n_exits - 1, 1)
        # logistic heads: P(exit <= s) = sigmoid(w0 + w1 * alpha)
        self.w0 = np.zeros((self.n_classes, g), np.float64)
        self.w1 = np.zeros((self.n_classes, g), np.float64)
        # per-class exit histogram EMA (quantile band / aggressive bound)
        self.hist = np.zeros((self.n_classes, self.n_exits), np.float64)
        self.n_obs = np.zeros(self.n_classes, np.int64)
        self.hits = 0
        self.misses = 0
        self.skip_calls = 0      # min_exit() invocations (buckets)
        self.skip_stages = 0     # total gates skipped across buckets
        self._lock = threading.Lock()

    # -- training ---------------------------------------------------------
    def observe(self, alpha, exit_idx) -> None:
        """Fold realized (difficulty, exit stage) pairs — chunked
        minibatch SGD on each class's gate heads + histogram EMA.
        Hit/miss is scored against the band predicted BEFORE the
        update.  observe() rides the scheduler's completion path, so it
        is vectorized per class: it must stay cheaper than the
        head-skip launches it pays for."""
        alpha = np.atleast_1d(np.asarray(alpha, np.float64))
        exit_idx = np.clip(
            np.atleast_1d(np.asarray(exit_idx, np.int64)),
            0, self.n_exits - 1)
        classes = np.atleast_1d(DIFF.difficulty_class(alpha, self.edges))
        with self._lock:
            for c in np.unique(classes):
                m = classes == c
                self._observe_class(int(c), alpha[m], exit_idx[m])

    def _observe_class(self, c: int, a, e) -> None:
        band = self._band_batch(c, a)
        n_hit = int(np.sum(band == e))
        self.hits += n_hit
        self.misses += len(e) - n_hit
        if self.n_exits > 1:
            s = np.arange(self.n_exits - 1)
            y = (e[:, None] <= s[None, :]).astype(np.float64)
            # minibatches of 8: p refreshes every chunk, so the update
            # keeps the per-sample loop's self-limiting dynamics (the
            # gradient vanishes as p saturates toward y) at ~1/8 the
            # host cost
            for i in range(0, len(e), 8):
                ac, yc = a[i:i + 8], y[i:i + 8]
                p = _sigmoid(self.w0[c] + self.w1[c] * ac[:, None])
                grad = p - yc
                self.w0[c] -= self.lr * grad.sum(axis=0)
                self.w1[c] -= self.lr * (grad * ac[:, None]).sum(axis=0)
        mean_onehot = np.bincount(e, minlength=self.n_exits) / len(e)
        if self.n_obs[c]:
            d = self.ema_decay ** len(e)
            self.hist[c] = d * self.hist[c] + (1.0 - d) * mean_onehot
        else:
            self.hist[c] = mean_onehot
        self.n_obs[c] += len(e)

    def _band_batch(self, c: int, a) -> np.ndarray:
        """Vectorized :meth:`_band_locked` over one class's batch (one
        prior fetch for the whole batch)."""
        if self.n_exits == 1:
            depth = np.zeros_like(a)
        else:
            p_le = _sigmoid(self.w0[c] + self.w1[c] * a[:, None])
            depth = np.sum(1.0 - p_le, axis=1)
            prior = self._prior_depth(c)
            if prior is not None:
                w = self.n_obs[c] / (self.n_obs[c] + self.prior_strength)
                depth = w * depth + (1.0 - w) * prior
        return np.clip(np.round(depth), 0,
                       self.n_exits - 1).astype(np.int64)

    # -- inference --------------------------------------------------------
    def _depth_locked(self, alpha: float, c: int) -> float:
        """Expected exit stage: E[depth] = sum_s P(exit > s), blended
        toward the planner prior while the class head is cold."""
        if self.n_exits == 1:
            return 0.0
        p_le = _sigmoid(self.w0[c] + self.w1[c] * alpha)
        depth = float(np.sum(1.0 - p_le))
        prior = self._prior_depth(c)
        if prior is None:
            return depth
        n = float(self.n_obs[c])
        w = n / (n + self.prior_strength)
        return w * depth + (1.0 - w) * prior

    def _prior_depth(self, c: int):
        if self._priors is None:
            return None
        pri = self._priors()
        if isinstance(pri, dict):
            pri = pri.get(c)
        elif pri is not None and c < len(pri):
            pri = pri[c]
        else:
            pri = None
        return None if pri is None else float(pri)

    def _band_locked(self, alpha: float, c: int) -> int:
        d = self._depth_locked(alpha, c)
        return int(np.clip(round(d), 0, self.n_exits - 1))

    def predict_depth(self, alpha: float) -> float:
        """Predicted (fractional) exit stage for one Eq. 8 difficulty."""
        a = float(np.mean(np.asarray(alpha, np.float64)))
        c = int(DIFF.difficulty_class(a, self.edges))
        with self._lock:
            return self._depth_locked(a, c)

    def depth_band(self, alpha: float) -> int:
        """Predicted exit stage rounded to a lane id — the scheduler
        appends this to the difficulty-class lane key so a flushed
        bucket's rows exit together.

        The band is STICKY per class (it only switches when the
        predicted depth moves ``band_hysteresis`` past the rounding
        boundary): a depth hovering at a boundary would otherwise keep
        two live lanes for one class, and the resulting consolidation
        fragmentation costs more than the band distinction is worth."""
        return self.admit_info(alpha)[1]

    def admit_info(self, alpha: float) -> tuple:
        """``(predicted depth, sticky lane band)`` under ONE lock and
        one prior fetch — the admission fast path.  Calling
        :meth:`predict_depth` then :meth:`depth_band` separately
        computes the same head twice; admission rides every submit, so
        the combined call is what the scheduler uses."""
        a = float(np.mean(np.asarray(alpha, np.float64)))
        c = int(DIFF.difficulty_class(a, self.edges))
        with self._lock:
            d = self._depth_locked(a, c)
            cur = self._band_cache.get(c)
            if cur is not None \
                    and abs(d - cur) <= 0.5 + self.band_hysteresis:
                return d, cur
            band = int(np.clip(round(d), 0, self.n_exits - 1))
            self._band_cache[c] = band
            return d, band

    def min_exit(self, engine, alpha_lo: float = 0.0) -> int:
        """The per-bucket head-skip bound handed to ``engine.infer`` /
        ``engine.generate``.

        conservative: exactly the engine's sound Eq. 19 rule-out bound
        (bit-identical decisions).  aggressive: additionally skip gates
        the class histogram says fire with probability < ``eps``
        (requires ``min_obs`` observations; may change decisions)."""
        m = int(engine.min_exit_bound(alpha_lo))
        if self.mode == "aggressive":
            c = int(DIFF.difficulty_class(float(alpha_lo), self.edges))
            with self._lock:
                if self.n_obs[c] >= self.min_obs:
                    cum = np.cumsum(
                        self.hist[c] / max(self.hist[c].sum(), 1e-9))
                    learned = 0
                    for s in range(self.n_exits - 1):
                        if cum[s] < self.eps:
                            learned = s + 1
                        else:
                            break
                    m = max(m, learned)
        with self._lock:
            self.skip_calls += 1
            self.skip_stages += m
        return m

    def state_dict(self) -> dict:
        """Learned heads + histograms, JSON-serializable (lists, not
        arrays)."""
        with self._lock:
            return {"w0": self.w0.tolist(), "w1": self.w1.tolist(),
                    "hist": self.hist.tolist(),
                    "n_obs": self.n_obs.tolist(),
                    "hits": self.hits, "misses": self.misses,
                    "skip_calls": self.skip_calls,
                    "skip_stages": self.skip_stages,
                    "band_cache": {str(k): v for k, v
                                   in self._band_cache.items()}}

    def load_state_dict(self, state: dict) -> None:
        w0 = np.asarray(state["w0"], np.float64)
        if w0.shape != self.w0.shape:
            raise ValueError(
                f"snapshot head shape {w0.shape} != {self.w0.shape}")
        with self._lock:
            self.w0 = w0
            self.w1 = np.asarray(state["w1"], np.float64)
            self.hist = np.asarray(state["hist"], np.float64)
            self.n_obs = np.asarray(state["n_obs"], np.int64)
            self.hits = int(state["hits"])
            self.misses = int(state["misses"])
            self.skip_calls = int(state["skip_calls"])
            self.skip_stages = int(state["skip_stages"])
            self._band_cache = {int(k): int(v) for k, v
                                in state["band_cache"].items()}

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            n = self.hits + self.misses
            return {
                "mode": self.mode,
                "observed": int(self.n_obs.sum()),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / n if n else None,
                "skip_calls": self.skip_calls,
                "skip_stages": self.skip_stages,
                "per_class_obs": [int(v) for v in self.n_obs],
            }
