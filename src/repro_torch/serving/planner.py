"""AdmissionPlanner — difficulty-aware cost prediction at enqueue.

The paper's Eq. 8 estimator is cheap enough (≈79 KFLOPs/image, §III.B)
to run at ADMISSION time, before the model sees the input.  Every
request gets

* ``alpha``          — its Eq. 8 difficulty, estimated once here by the
  engine's estimator (on a card, the ``difficulty`` kernel) and handed
  to the engine at dispatch (``infer(..., alpha=...)``), so the
  estimator never runs twice;
* a difficulty CLASS — ``digitize(mean alpha, edges)``; the scheduler
  lanes requests per class, so buckets stay cost-homogeneous;
* ``predicted_cost`` — expected normalized MACs/sample, from the
  telemetry prior: a per-class EMA of the exit depths the scheduler
  actually observed (cold start: depth grows linearly in alpha, the
  Eq. 19 first-order effect of difficulty on thresholds).

Admission runs on the caller's thread and on the default stream, as
the dispatcher's forward passes do.  Its copy of alpha to the host
waits for what is queued there, but the forward passes of this slice's
models are bound by their launches, so little is ever queued: on the
H100 an admission with a 64-row ResNet-18 bucket in flight took no
longer on the default stream than on a stream of its own, which costs
more when idle (PERF.md, serving).  A model whose buckets keep the
device busier than the host would make that wait real.

Under ``degrade-alpha`` backpressure the planner re-admits the request
with a scaled-down alpha: Eq. 19 lowers every gate's threshold for
easier inputs, so the request exits earlier and costs less — graceful
quality degradation instead of queue growth.

A copy of the JAX package's ``serving/planner.py``; its sharded-engine
branch waits for the multi-device slice.
"""
from __future__ import annotations

import threading

import numpy as np

from repro_torch.core import adaptive as AD
from repro_torch.core import difficulty as DIFF


class AdmissionPlanner:
    def __init__(self, engine, edges=DIFF.DEFAULT_EDGES,
                 ema_decay: float = 0.9):
        self.engine = engine
        self.edges = np.asarray(edges, np.float32)
        self.n_classes = len(self.edges) + 1
        self.ema_decay = float(ema_decay)
        self._depth_ema = [None] * self.n_classes
        self._stage_ms = None      # per-stage service-time EMA (quotes)
        self._lock = threading.Lock()
        cum = np.asarray(engine.cum_costs, np.float64)
        self._cum_norm = cum / cum[-1]
        # Exit-count prior from telemetry: an engine that has already
        # served seeds the cold-start depth prediction from its section
        # II.C window instead of the linear-in-alpha guess.
        self._global_depth = None
        if int(engine.state.served):
            self._global_depth = float(
                AD.window_exit_depth(engine.state.adaptive, engine.acfg))

    # ------------------------------------------------------------------
    def admit(self, x: np.ndarray):
        """(alpha (n,), difficulty class, predicted cost/sample)."""
        alpha = self.engine._alpha(self.engine._input(x)).cpu().numpy()
        return (alpha,) + self.classify(alpha)

    def classify(self, alpha: np.ndarray):
        """(difficulty class, predicted cost) for an already-known alpha
        (the degrade-alpha re-admission path)."""
        a = float(np.mean(alpha))
        dclass = int(DIFF.difficulty_class(a, self.edges))
        return dclass, self.predicted_cost(a, dclass)

    def predicted_cost(self, alpha_mean: float, dclass: int) -> float:
        """Expected normalized MACs/sample: telemetry-prior exit depth
        (per-class EMA, falling back to the engine's window-wide depth,
        then to linear-in-alpha) run through the engine's cumulative
        cost curve."""
        with self._lock:
            depth = self._depth_ema[dclass]
            if depth is None:
                depth = self._global_depth
        if depth is None:
            depth = alpha_mean * (self.engine.n_exits - 1)
        return float(np.interp(depth, np.arange(self.engine.n_exits),
                               self._cum_norm))

    def observe(self, exit_idx: np.ndarray, alpha: np.ndarray) -> None:
        """Fold served outcomes back into the per-class depth priors."""
        exit_idx = np.asarray(exit_idx)
        dclass = np.asarray(DIFF.difficulty_class(
            np.asarray(alpha, np.float32), self.edges))
        d_all = float(np.mean(exit_idx))
        with self._lock:
            self._global_depth = d_all if self._global_depth is None else \
                self.ema_decay * self._global_depth \
                + (1.0 - self.ema_decay) * d_all
            for c in np.unique(dclass):
                d = float(np.mean(exit_idx[dclass == c]))
                prev = self._depth_ema[int(c)]
                self._depth_ema[int(c)] = d if prev is None else \
                    self.ema_decay * prev + (1.0 - self.ema_decay) * d

    def priors(self) -> list:
        """Current per-class expected exit depth (None = never seen)."""
        with self._lock:
            return list(self._depth_ema)

    # ------------------------------------------------------------------
    # snapshot (serving-state checkpoint): the learned priors a restarted
    # server should NOT have to re-learn from a cold stream
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """The learned priors and the service EMA, JSON-serializable."""
        with self._lock:
            return {"depth_ema": list(self._depth_ema),
                    "global_depth": self._global_depth,
                    "stage_ms": self._stage_ms}

    def load_state_dict(self, state: dict) -> None:
        with self._lock:
            depth = list(state["depth_ema"])
            if len(depth) != self.n_classes:
                raise ValueError(
                    f"snapshot has {len(depth)} depth classes, "
                    f"planner has {self.n_classes}")
            self._depth_ema = depth
            self._global_depth = state["global_depth"]
            self._stage_ms = state["stage_ms"]

    # ------------------------------------------------------------------
    # admission-time SLO quoting: predicted depth x per-stage service
    # EMA — a latency quote in ms, not a MACs fraction.  The
    # ``predicted_cost`` MACs prior stays intact; quotes are an
    # additional signal.
    # ------------------------------------------------------------------
    def observe_service(self, service_ms: float,
                        depth_mean: float) -> None:
        """Fold one completed bucket's realized service time into the
        per-stage service EMA.  ``depth_mean`` is the bucket's mean
        realized exit stage, so a bucket that exited at stage d paid
        for d+1 stages."""
        per = float(service_ms) / (float(depth_mean) + 1.0)
        with self._lock:
            self._stage_ms = per if self._stage_ms is None else \
                self.ema_decay * self._stage_ms \
                + (1.0 - self.ema_decay) * per

    def quote_ms(self, depth: float) -> float | None:
        """Latency quote for a request predicted to exit at (fractional)
        stage ``depth``: (depth+1) stages x the per-stage service EMA.
        None until a completed bucket has seeded the EMA."""
        with self._lock:
            if self._stage_ms is None:
                return None
            return (float(depth) + 1.0) * self._stage_ms

    def stage_ms(self) -> float | None:
        """The per-stage service-time EMA feeding quotes (ms)."""
        with self._lock:
            return self._stage_ms
