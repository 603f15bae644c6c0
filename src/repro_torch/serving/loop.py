"""ServingLoop — the async, SLO-aware dispatcher over ``DartEngine``.

``AsyncDartServer`` turns a ``DartEngine`` into a server: callers
``submit(x, deadline_ms, priority)`` and get a future; a background
dispatcher consolidates queued requests into ``BatchCompactor`` buckets
and flushes each bucket through ONE ``engine.infer`` call.  The
lifecycle of a request:

    submit ──admit──▶ lane queue ──flush──▶ in-flight ──resolve──▶ future
           (Eq. 8 α,    (per difficulty   (one infer call  (host outputs,
            cost         class; back-      per bucket)      latency fold,
            prediction)  pressure)                          prior update)

Flush policy (size-or-deadline):

* **deadline** — a lane flushes when its earliest deadline minus the
  estimated service time (EMA of recent bucket latencies + margin)
  would otherwise expire while waiting.
* **size**     — a lane flushes at the consolidation target
  (``max_batch``), or early when it exactly fills a power-of-two bucket
  at ≥ half the target: waiting longer could only grow padding waste,
  never shrink it.
* **hold**     — no BEST-EFFORT (deadline-less) request waits longer
  than ``flush_ms`` even on an idle stream.  Deadline'd requests are
  deliberately excluded: their SLO already bounds the wait, and holding
  them until deadline pressure (or a full bucket) maximizes
  consolidation at exactly the loads where it pays.

The lane queues, the flush policy, the dispatcher thread and shutdown
live in ``_BucketScheduler``, which the LM decode sessions
(``serving/lm_session.py``) share; ``AsyncDartServer`` adds admission
planning, the pipelined dispatch and completion.

The loop keeps up to ``pipeline_depth`` buckets dispatched and not yet
completed, and completes (resolving futures, folding latency telemetry
into ``EngineState``) when the pipeline is full or there is nothing left
to dispatch.  The scheduling decisions are the JAX package's
(``repro/serving/loop.py``); on the port the masked ``infer`` already
waits for its exits (it reads them to count MACs), so buckets in flight
do not overlap yet.  Completion copies a bucket's result tensors to the
host in one transfer.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.core import daes as DAES
from repro_torch.core import difficulty as DIFF
from repro_torch.obs import OBS
from repro_torch.obs import adapters as OBS_A
from repro_torch.obs import log as OBS_LOG
from repro_torch.serving.planner import AdmissionPlanner
from repro_torch.serving.predict import ExitDepthPredictor
from repro_torch.serving.queue import RequestQueue
from repro_torch.serving.request import (DispatchError, Request,
                                         RequestRejected)

#: result keys sliced per request out of a consolidated engine call
_RESULT_KEYS = ("pred", "conf", "exit_idx", "alpha", "macs")


def _host(out: dict) -> dict:
    """The result keys of one engine call as numpy arrays, the device
    tensors among them (masked mode) copied to the host in ONE transfer:
    float64 holds every float32 value and every exit or class index
    exactly."""
    dev = [k for k in _RESULT_KEYS if isinstance(out[k], torch.Tensor)]
    vals = {k: np.asarray(out[k]) for k in _RESULT_KEYS if k not in dev}
    if dev:
        packed = torch.stack([out[k].double() for k in dev]).cpu()
        for k, row in zip(dev, packed):
            vals[k] = row.to(out[k].dtype).numpy()
    return {k: vals[k] for k in _RESULT_KEYS}


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Knobs of the async scheduler (see module docstring for the flush
    semantics).

    max_batch:      consolidation target, samples per flushed bucket
    flush_ms:       max hold time for a non-full lane
    margin_ms:      scheduling slack subtracted from every deadline
    max_queue:      per-lane backpressure limit, in requests
    policy:         "shed" | "reject" | "degrade-alpha"
    degrade_factor: alpha scale applied under degrade-alpha
    min_fill:       min fill fraction before growing into a larger bucket
    mode:           engine inference mode for dispatched buckets
    pipeline_depth: max dispatched, not yet completed buckets
    edges:          difficulty-class boundaries on Eq. 8 alpha
    sample_ndim:    rank of ONE sample (submit auto-batches bare samples)
    starve_ms:      continuous slot refill only — how long the most
                    urgent queued request may be passed over for lack
                    of capacity before freed slots are reserved for it
                    (see ``RequestQueue.pop_next``)
    predict:        admission-time exit-depth prediction — "off" |
                    "conservative" (head-skip only where Eq. 19
                    provably can't fire: bit-identical decisions) |
                    "aggressive" (additionally skip gates the learned
                    histogram says never fire — opt-in, measured).
                    On, requests get predicted-depth lanes, an
                    admission latency quote, and per-bucket head-skip
                    (see ``repro_torch.serving.predict``)
    """
    max_batch: int = 64
    flush_ms: float = 5.0
    margin_ms: float = 1.0
    max_queue: int = 256
    policy: str = "shed"
    degrade_factor: float = 0.5
    min_fill: float = 0.5
    mode: str = "masked"
    pipeline_depth: int = 2
    edges: tuple = DIFF.DEFAULT_EDGES
    sample_ndim: int = 3
    starve_ms: float = 50.0
    predict: str = "off"


class _BucketScheduler:
    """Lane-queue and dispatcher-thread machinery shared by the
    classifier scheduler (:class:`AsyncDartServer`) and the LM decode
    sessions (:mod:`repro_torch.serving.lm_session`).

    Subclasses implement ``_admit`` (build a Request) and ``_dispatch``
    (serve a flushed run of requests); the base owns admission, flush
    timing, the worker thread, and shutdown."""

    def __init__(self, cfg: SchedulerConfig, *, clock=time.monotonic,
                 start: bool = True):
        self.cfg = cfg
        self._clock = clock
        # Effective consolidation target: cfg.max_batch clamped to what
        # ONE dispatch can serve as a single padded shape — flushing
        # more than the engine's largest bucket would make bucket_key
        # raise mid-flush and wedge the dispatcher.
        self.max_batch = max(1, min(cfg.max_batch, self._max_batch_cap()))
        self.queue = RequestQueue(max_queue=cfg.max_queue,
                                  policy=cfg.policy)
        self._rid = itertools.count()
        self._cv = threading.Condition()
        self._stop = False
        self._closed = False
        self._service_s = 0.0        # EMA of bucket service time
        self.last_error: Exception | None = None
        self.counters = {"submitted": 0, "completed": 0, "degraded": 0,
                         "flush_deadline": 0, "flush_size": 0,
                         "flush_hold": 0, "flush_forced": 0}
        self._thread = None
        if OBS.enabled:
            OBS_A.bind_scheduler(self)
        if start:
            self.start()

    # -- subclass hooks -------------------------------------------------
    def _admit(self, x, deadline_ms, priority, *, now, **kw) -> Request:
        """Build the Request.  ``now`` is stamped at the START of
        submit(), so admission work (the Eq. 8 estimate) counts toward
        the request's latency and deadline like any other service
        time."""
        raise NotImplementedError

    def _dispatch(self, reqs: list, reason: str) -> None:
        raise NotImplementedError

    def _engine_call(self, fn):
        """Run one engine call.  ``fn(engine) -> result``; the default
        binds the scheduler's single engine.  The resilience layer
        (:class:`~repro_torch.serving.resilience.EnginePool`) overrides
        this to add engine selection, retry/backoff and hedging without
        the dispatch site knowing."""
        return fn(self.engine)

    def _on_dispatch_error(self, reqs: list, exc: Exception) -> bool:
        """Dispatch-failure hook: return True when the requests were
        re-routed (e.g. requeued by the pool after an engine death) and
        must NOT have their futures failed.  Default: unhandled."""
        return False

    def _drain_one(self) -> bool:
        """Complete one in-flight bucket if any; False when idle."""
        return False

    def _bucket_key(self, n: int) -> int:
        """Padded dispatch shape for n samples.  Must be TOTAL (never
        raise): oversized single requests pass through take() and are
        dispatched unpadded."""
        return n

    def _max_batch_cap(self) -> int:
        """Largest sample count one dispatch can serve as one shape."""
        return self.cfg.max_batch

    def _has_inflight(self) -> bool:
        return False

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=type(self).__name__)
        self._thread.start()

    def submit(self, x, deadline_ms: float | None = None,
               priority: int = 0, **kw) -> Future:
        """Enqueue one request; resolves to its per-request result dict
        (or raises RequestShed/RequestRejected under backpressure)."""
        t0 = self._clock()
        req = self._admit(x, deadline_ms, priority, now=t0, **kw)
        # The closed check and the push share the cv lock with close():
        # a request either lands before _closed is set (close's flush
        # serves it) or is rejected — never silently stranded in a lane
        # no worker will ever flush.
        with self._cv:
            if self._closed:
                req.fail(RequestRejected("scheduler is closed"))
                return req.future
            action = self.queue.push(req)
            self.counters["submitted"] += 1
            self._cv.notify()
        if OBS.enabled:
            OBS_A.record_admit(self, req, action, t0, self._clock())
        return req.future

    def close(self, wait: bool = True) -> None:
        """Stop admitting, serve everything already queued, join."""
        with self._cv:
            self._closed = True
            self._stop = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        if wait:
            self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- scheduling -----------------------------------------------------
    def _select_flush(self, now: float):
        """(lane, reason, force) of the most urgent flush-ready lane,
        or None.  Urgency: deadline pressure ≻ size ≻ hold."""
        slack = (self.cfg.margin_ms / 1e3) + self._service_s
        best = None                       # (rank, tiebreak, lane, reason)
        for key in self.queue.keys():
            n_q = self.queue.samples(key)
            if not n_q:
                continue
            edl = self.queue.earliest_deadline(key)
            held = self.queue.oldest_undeadlined(key)
            if edl is not None and edl - now <= slack:
                cand = (0, edl, key, "deadline")
            elif n_q >= self.max_batch or (
                    2 * n_q >= self.max_batch
                    and self._bucket_key(n_q) == n_q):
                cand = (1, -n_q, key, "size")
            elif held is not None \
                    and now - held >= self.cfg.flush_ms / 1e3:
                cand = (2, held, key, "hold")
            else:
                continue
            if best is None or cand < best:
                best = cand
        if best is None:
            return None
        _, _, key, reason = best
        return key, reason, reason == "deadline"

    def _wait_timeout(self, now: float) -> float | None:
        """Seconds until the next deadline/hold event (None = wait for
        a submit notification)."""
        slack = (self.cfg.margin_ms / 1e3) + self._service_s
        nxt = None
        for key in self.queue.keys():
            edl = self.queue.earliest_deadline(key)
            held = self.queue.oldest_undeadlined(key)
            for t in ((edl - slack) if edl is not None else None,
                      (held + self.cfg.flush_ms / 1e3)
                      if held is not None else None):
                if t is not None and (nxt is None or t < nxt):
                    nxt = t
        if nxt is None:
            return None
        return max(nxt - now, 1e-4)

    def pump(self) -> bool:
        """One scheduling decision: flush the most urgent ready lane, or
        complete one in-flight bucket.  Returns False when idle.
        (The worker thread loops this; tests drive it directly.)"""
        sel = self._select_flush(self._clock())
        if sel is not None:
            key, reason, force = sel
            reqs = self.queue.take(key, self.max_batch,
                                   self._bucket_key,
                                   min_fill=self.cfg.min_fill, force=force)
            if reqs:
                self.counters[f"flush_{reason}"] += 1
                self._dispatch_safe(reqs, reason)
                return True
        return self._drain_one()

    def _dispatch_safe(self, reqs: list, reason: str) -> None:
        """A bad bucket must not kill the dispatcher: an exception from
        the engine fails THIS bucket's futures and the loop lives on
        (a shape-mismatched input would otherwise strand every pending
        future behind a dead daemon thread)."""
        if OBS.enabled:
            OBS_A.record_bucket(self, reqs, reason, self._clock())
        try:
            self._dispatch(reqs, reason)
        except Exception as e:                     # noqa: BLE001
            if self._on_dispatch_error(reqs, e):
                return                             # re-routed, not failed
            self.counters["dispatch_errors"] = \
                self.counters.get("dispatch_errors", 0) + 1
            self.last_error = e
            OBS_LOG.error("dispatch", "bucket dispatch failed", exc=e,
                          reason=reason, lane=reqs[0].lane,
                          n_requests=len(reqs),
                          rids=[r.rid for r in reqs[:8]])
            err = e if isinstance(e, DispatchError) else DispatchError(
                "dispatch", reqs[0].lane, [r.rid for r in reqs], e)
            for r in reqs:
                r.fail(err)

    def flush(self) -> None:
        """Force-dispatch every queued request and complete all
        in-flight work (shutdown / test barrier)."""
        while True:
            keys = self.queue.keys()
            if not keys:
                break
            for key in keys:
                while True:
                    reqs = self.queue.take(key, self.max_batch,
                                           self._bucket_key, force=True)
                    if not reqs:
                        break
                    self.counters["flush_forced"] += 1
                    self._dispatch_safe(reqs, "forced")
        while self._drain_one():
            pass

    def _run(self) -> None:
        while True:
            with self._cv:
                if not self._stop:
                    busy = not self.queue.empty
                    self._cv.wait(self._wait_timeout(self._clock())
                                  if busy else
                                  (0.002 if self._has_inflight()
                                   else None))
                if self._stop:
                    return
            try:
                while self.pump():
                    if self._stop:
                        return
            except Exception as e:                 # noqa: BLE001
                # Dispatch errors are contained by _dispatch_safe; this
                # catches scheduler bugs so the thread survives (queued
                # work still fails fast through _dispatch_safe rather
                # than hanging behind a dead loop).
                self.last_error = e
                OBS_LOG.error("scheduler", "scheduler loop error",
                              exc=e, scheduler=type(self).__name__)
                time.sleep(0.01)



class AsyncDartServer(_BucketScheduler):
    """The difficulty-aware async request scheduler over a DartEngine.

        engine = DartEngine.from_config(cfg, params, ...)
        server = AsyncDartServer(engine)
        fut = server.submit(x, deadline_ms=50)
        out = fut.result()          # same keys as engine.infer + latency
        server.stats()              # engine stats + p50/p95/p99 + misses
        server.close()

    Under a fixed policy, scheduler decisions never change routing
    decisions: completed outputs are those of serving each request alone
    through ``engine.infer`` (with section II.C adaptation on,
    reordering shifts where the periodic updates fall).  On a card, a
    kernel that fails to launch fails its bucket's futures with
    :class:`DispatchError`; nothing falls back to the plain versions."""

    def __init__(self, engine, cfg: SchedulerConfig = SchedulerConfig(),
                 *, clock=time.monotonic, start: bool = True):
        self.engine = engine
        self.planner = AdmissionPlanner(engine, edges=cfg.edges)
        self.predictor = None if cfg.predict == "off" else \
            ExitDepthPredictor(engine.n_exits, edges=cfg.edges,
                               mode=cfg.predict,
                               priors=self.planner.priors)
        # Per-lane Eq. 9 telemetry: static reference = the full network
        self.daes = DAES.LaneDaesAccumulator(
            static_macs=float(np.asarray(engine.cum_costs)[-1]))
        self._inflight: deque = deque()
        super().__init__(cfg, clock=clock, start=start)

    # -- hooks ----------------------------------------------------------
    def _max_batch_cap(self) -> int:
        return self.engine.compactor.max_bucket

    def _bucket_key(self, n: int) -> int:
        """Padded dispatch shape for n samples.  TOTAL (never raises):
        an oversized single request passes through take() and is
        dispatched unpadded."""
        if n > self.engine.compactor.max_bucket:
            return n
        return self.engine.bucket_key(n)

    def _admit(self, x, deadline_ms, priority, *, now) -> Request:
        x = np.asarray(x)
        if x.ndim == self.cfg.sample_ndim:
            x = x[None]
        alpha, lane, cost = self.planner.admit(x)
        if self.cfg.policy == "degrade-alpha" \
                and self.queue.depth(lane) >= self.cfg.max_queue:
            alpha = alpha * self.cfg.degrade_factor
            lane, cost = self.planner.classify(alpha)
            self.counters["degraded"] += 1
        payload = {}
        if self.predictor is not None:
            depth, band = self.predictor.admit_info(float(np.mean(alpha)))
            quote = self.planner.quote_ms(depth)
            if (quote is not None and deadline_ms is not None
                    and self.cfg.policy == "degrade-alpha"
                    and quote > deadline_ms):
                # the quote says this request cannot make its SLO at
                # its predicted depth: degrade it at admission instead
                # of letting it miss
                alpha = alpha * self.cfg.degrade_factor
                lane, cost = self.planner.classify(alpha)
                self.counters["degraded"] += 1
                depth, band = self.predictor.admit_info(
                    float(np.mean(alpha)))
                quote = self.planner.quote_ms(depth)
            # predicted-depth lane component: a flushed bucket's rows
            # are predicted to exit together
            lane = (lane, band)
            payload = {"quote_ms": quote, "depth": depth}
            if quote is not None:
                cost = quote    # predicted_cost becomes the SLO quote
        return Request(
            rid=next(self._rid), x=x, n=x.shape[0], alpha=alpha,
            lane=lane, predicted_cost=cost, priority=priority,
            t_submit=now,
            deadline_s=None if deadline_ms is None
            else now + deadline_ms / 1e3,
            future=Future(), payload=payload)

    # -- dispatch -------------------------------------------------------
    def _infer_batch(self, reqs: list, x, alpha) -> dict:
        """ONE engine call for a flushed run of requests.  Masked
        dispatches pad to the bucket, so every consolidation size inside
        a bucket runs one shape; compacted mode buckets its stages
        internally.  A single request larger than the biggest bucket
        goes through unpadded (bucket_key would raise BatchTooLarge on
        it)."""
        pad_to = self.engine.bucket_key(x.shape[0]) \
            if self.cfg.mode == "masked" \
            and x.shape[0] <= self.engine.compactor.max_bucket else None
        min_exit = 0
        if self.predictor is not None:
            # the bucket's smallest difficulty bounds every row (Eq. 19
            # is monotone in alpha), so one min_exit covers the bucket
            min_exit = self.predictor.min_exit(self.engine,
                                               float(np.min(alpha)))
        return self._engine_call(
            lambda eng: eng.infer(x, mode=self.cfg.mode, record=True,
                                  alpha=alpha, pad_to=pad_to,
                                  min_exit=min_exit))

    def _dispatch(self, reqs: list, reason: str) -> None:
        x = np.concatenate([r.x for r in reqs])
        alpha = np.concatenate([r.alpha for r in reqs])
        t0 = self._clock()
        out = self._infer_batch(reqs, x, alpha)
        # Service EMA from the dispatch call itself: it feeds the
        # deadline slack, so it must not absorb pipeline idle time (a
        # deferred completion would look like a slow engine).
        service = self._clock() - t0
        self._service_s = service if not self._service_s else \
            0.8 * self._service_s + 0.2 * service
        self._inflight.append((reqs, out, t0))
        while len(self._inflight) > self.cfg.pipeline_depth:
            self._complete_safe(*self._inflight.popleft())

    def _drain_one(self) -> bool:
        if not self._inflight:
            return False
        self._complete_safe(*self._inflight.popleft())
        return True

    def _has_inflight(self) -> bool:
        return bool(self._inflight)

    def _complete_safe(self, reqs, out, t_dispatch) -> None:
        try:
            self._complete(reqs, out, t_dispatch)
        except Exception as e:                     # noqa: BLE001
            self.last_error = e
            self.counters["complete_errors"] = \
                self.counters.get("complete_errors", 0) + 1
            OBS_LOG.error("complete", "bucket completion failed",
                          exc=e, lane=reqs[0].lane,
                          rids=[r.rid for r in reqs[:8]])
            err = e if isinstance(e, DispatchError) else DispatchError(
                "complete", reqs[0].lane, [r.rid for r in reqs], e)
            for r in reqs:
                r.fail(err)

    # -- completion -----------------------------------------------------
    def _complete(self, reqs, out, t_dispatch) -> None:
        vals = _host(out)
        now = self._clock()
        ends = np.cumsum([r.n for r in reqs])
        lats, missed, results = [], [], []
        for r, a, z in zip(reqs, np.concatenate([[0], ends[:-1]]), ends):
            res = {k: v[a:z] for k, v in vals.items()}
            lat_ms = (now - r.t_submit) * 1e3
            miss = r.deadline_s is not None and now > r.deadline_s
            res.update(latency_ms=lat_ms, deadline_missed=miss,
                       predicted_cost=r.predicted_cost, lane=r.lane)
            lats.append(lat_ms)
            missed.append(miss)
            results.append(res)
        # Telemetry folds BEFORE any future resolves: a caller woken by
        # fut.result() must find its request already in
        # stats()["requests"] (the documented pattern).
        self.engine.record_requests(lats, missed)
        self.planner.observe(vals["exit_idx"], vals["alpha"])
        if self.predictor is not None:
            self.predictor.observe(vals["alpha"], vals["exit_idx"])
            self.engine.record_quotes(
                [r.payload.get("quote_ms") for r in reqs], lats)
            self.planner.observe_service(
                (now - t_dispatch) * 1e3, float(np.mean(vals["exit_idx"])))
        for r, res in zip(reqs, results):
            self.daes.observe(r.lane, res["conf"], res["macs"],
                              res["alpha"])
        self.counters["completed"] += len(reqs)
        if OBS.enabled:
            OBS_A.record_completed(self, reqs, results, t_dispatch, now)
        for r, res in zip(reqs, results):
            r.resolve(res)

    # -- metering -------------------------------------------------------
    def stats(self) -> dict:
        """Engine stats (incl. ``requests`` latency percentiles + miss
        rate, folded into EngineState) + scheduler-level counters."""
        s = self.engine.stats()
        s["scheduler"] = {
            **self.counters,
            "shed": self.queue.shed, "rejected": self.queue.rejected,
            "queued": {k: self.queue.depth(k) for k in self.queue.keys()},
            "inflight": len(self._inflight),
            "depth_prior": self.planner.priors(),
            "service_ms_ema": self._service_s * 1e3,
        }
        if self.predictor is not None:
            s["scheduler"]["predictor"] = self.predictor.stats()
            s["scheduler"]["stage_ms_ema"] = self.planner.stage_ms()
        s["daes"] = self.daes.rows()
        return s
