"""repro_torch.obs.adapters — wire the serving signals into the
registry and the tracer.

Two kinds of adapter, matching the two ways data flows:

* **push-side** ``record_*`` helpers, called from the scheduler hot path
  ONLY behind an ``if OBS.enabled`` check.  They see values the serving
  code already holds on the host (numpy outputs at completion, host
  counters): no extra device syncs.
* **pull-side** ``bind_*`` collectors, registered once per object and
  run at SCRAPE time: ``EngineState`` telemetry, per-lane DAES from
  ``LaneDaesAccumulator``, queue depths from ``RequestQueue``, the
  continuous LM session's slot-pool and page occupancy and its queue's
  starvation reservations, the
  engine pool's health, ladder rung and event counters, and the
  kernels' launch counts from ``repro_torch.kernels.dispatch``.
  Collectors hold weakrefs, so a garbage-collected server unregisters
  itself.

The metric families and labels are the JAX package's
(``repro/obs/adapters.py``), with one exception: the JAX package exports
its kernels' backend decisions (``dart_kernel_dispatch_total{kernel,
backend}``, counted when a function is traced), the port the launches
of its hand-written kernels (``dart_kernel_launches_total{kernel}``).
The queue's ``starved`` event (capacity the slot refill held back for a
senior request) is exported by the continuous session, the one
scheduler that refills slots; the JAX package exports it, at 0, for
every scheduler.
"""
from __future__ import annotations

import time
import weakref

import numpy as np

from repro_torch.obs import OBS
from repro_torch.obs.metrics import LATENCY_BUCKETS_MS

__all__ = ["record_admit", "record_bucket", "record_completed",
           "record_lm_bucket", "record_slot_admit", "record_slot_exit",
           "record_retry", "record_hedge", "record_requeue", "record_fault",
           "bind_scheduler", "bind_dispatch", "bind_pool"]


def _lane(lane) -> str:
    return str(lane)


def _latency_hist(reg):
    return reg.histogram("dart_request_latency_ms",
                         "end-to-end request latency by lane",
                         ("lane",), buckets=LATENCY_BUCKETS_MS)


# ---------------------------------------------------------------------------
# push side (hot path; callers guard with OBS.enabled)
# ---------------------------------------------------------------------------

def record_admit(sched, req, action: str, t0: float, t1: float) -> None:
    """One admitted (or dropped-at-admission) request: the ``admit``
    span covers the admission work itself (the Eq. 8 estimate)."""
    lane = _lane(req.lane)
    alpha = float(np.mean(req.alpha)) if req.n else 0.0
    OBS.tracer.record("admit", ts=t0, dur=t1 - t0, rid=req.rid,
                      lane=req.lane, n=req.n, alpha=alpha,
                      predicted_cost=float(req.predicted_cost),
                      priority=req.priority, action=action)
    reg = OBS.registry
    reg.counter("dart_requests_total", "requests submitted by lane",
                ("lane",)).inc(1, lane=lane)
    if action in ("shed", "rejected"):
        OBS.tracer.record("shed" if action == "shed" else "reject",
                          ts=t1, rid=req.rid, lane=req.lane, n=req.n)
        reg.counter("dart_requests_dropped_total",
                    "requests dropped at admission (backpressure)",
                    ("lane", "action")).inc(1, lane=lane, action=action)


def record_bucket(sched, reqs: list, reason: str, now: float) -> None:
    """One flushed bucket: which lane, how many requests/samples, and
    WHY it flushed (deadline pressure / size / hold / forced)."""
    OBS.tracer.record("bucket", ts=now, lane=reqs[0].lane,
                      n_requests=len(reqs),
                      n_samples=sum(r.n for r in reqs), reason=reason)
    OBS.registry.counter("dart_flushes_total", "bucket flushes by reason",
                         ("reason",)).inc(1, reason=reason)


def record_completed(server, reqs: list, results: list, t_dispatch: float,
                     now: float) -> None:
    """Completed requests of one bucket: spans ``queue_wait`` (submit ->
    dispatch) and ``compiled_step`` (dispatch -> completed), plus the
    ``exit`` span joining the host view (predicted cost, deadline slack)
    with the realized exit depths the engine computed."""
    reg, tr = OBS.registry, OBS.tracer
    hist = _latency_hist(reg)
    comp = reg.counter("dart_requests_completed_total",
                       "requests completed by lane", ("lane",))
    miss_c = reg.counter("dart_deadline_miss_total",
                         "deadline misses by lane", ("lane",))
    exits = reg.counter("dart_exits_total",
                        "served samples by cascade member and exit stage",
                        ("member", "stage"))
    for r, res in zip(reqs, results):
        lane = _lane(r.lane)
        exit_idx = np.asarray(res["exit_idx"]).ravel()
        slack = None if r.deadline_s is None else r.deadline_s - now
        tr.record("queue_wait", ts=r.t_submit,
                  dur=max(t_dispatch - r.t_submit, 0.0),
                  rid=r.rid, lane=r.lane)
        tr.record("compiled_step", ts=t_dispatch,
                  dur=max(now - t_dispatch, 0.0), rid=r.rid, lane=r.lane,
                  n=r.n)
        tr.record("exit", ts=now, rid=r.rid, lane=r.lane,
                  exits=exit_idx.tolist(), members=[0] * len(exit_idx),
                  predicted_cost=float(r.predicted_cost),
                  realized_cost=float(np.mean(np.asarray(res["macs"]))),
                  deadline_slack_s=slack,
                  deadline_missed=bool(res["deadline_missed"]))
        hist.observe(float(res["latency_ms"]), lane=lane)
        comp.inc(1, lane=lane)
        if res["deadline_missed"]:
            miss_c.inc(1, lane=lane)
        # one engine: every sample is member 0's
        for s in np.unique(exit_idx):
            exits.inc(int(np.sum(exit_idx == s)), member="0",
                      stage=str(int(s)))


def record_lm_bucket(session, reqs: list, stage_slices: list, t0: float,
                     now: float) -> None:
    """One flushed LM decode bucket: per-request spans with realized
    per-token exit stages."""
    reg, tr = OBS.registry, OBS.tracer
    hist = _latency_hist(reg)
    comp = reg.counter("dart_requests_completed_total",
                       "requests completed by lane", ("lane",))
    toks = reg.counter("dart_lm_tokens_total", "decoded tokens", ())
    for r, stages in zip(reqs, stage_slices):
        lane = _lane(r.lane)
        stages = np.asarray(stages)
        tr.record("queue_wait", ts=r.t_submit,
                  dur=max(t0 - r.t_submit, 0.0), rid=r.rid, lane=r.lane)
        tr.record("compiled_step", ts=t0, dur=max(now - t0, 0.0),
                  rid=r.rid, lane=r.lane, n=r.n)
        tr.record("exit", ts=now, rid=r.rid, lane=r.lane,
                  exits=stages.ravel().tolist(),
                  n_tokens=int(stages.size),
                  predicted_cost=float(r.predicted_cost),
                  deadline_slack_s=None if r.deadline_s is None
                  else r.deadline_s - now)
        hist.observe((now - r.t_submit) * 1e3, lane=lane)
        comp.inc(1, lane=lane)
        toks.inc(int(stages.size))


def record_slot_admit(session, req, now: float) -> None:
    """Continuous batching: a request entered the slot pool — the
    ``slot`` span carries its slot ids and the pool pressure."""
    OBS.tracer.record("slot", ts=now, dur=0.0, rid=req.rid,
                      lane=req.lane, slots=session.decoder.slots_of(req.rid),
                      pages_in_use=session.decoder.allocator.in_use,
                      queue_wait_s=max(now - req.t_submit, 0.0))


def record_slot_exit(session, req, stages, lat_ms: float, miss: bool,
                     now: float) -> None:
    """Continuous batching: a request left the slot pool finished."""
    reg, tr = OBS.registry, OBS.tracer
    lane = _lane(req.lane)
    stages = np.asarray(stages)
    tr.record("exit", ts=now, rid=req.rid, lane=req.lane,
              exits=stages.ravel().tolist(), n_tokens=int(stages.size),
              deadline_missed=bool(miss),
              deadline_slack_s=None if req.deadline_s is None
              else req.deadline_s - now)
    _latency_hist(reg).observe(lat_ms, lane=lane)
    reg.counter("dart_requests_completed_total",
                "requests completed by lane", ("lane",)).inc(1, lane=lane)
    if miss:
        reg.counter("dart_deadline_miss_total",
                    "deadline misses by lane", ("lane",)).inc(1, lane=lane)
    reg.counter("dart_lm_tokens_total", "decoded tokens",
                ()).inc(int(stages.size))


def record_retry(engine: str, attempt: int) -> None:
    """One retried dispatch (the engine pool re-running a bucket on
    another engine after a failure)."""
    OBS.tracer.record("retry", ts=time.monotonic(), engine=engine,
                      attempt=attempt)
    OBS.registry.counter("dart_retries_total",
                         "bucket dispatch retries by engine",
                         ("engine",)).inc(1, engine=engine)


def record_hedge(slow: str, to: str) -> None:
    """One hedged re-dispatch: the straggler-policy deadline expired on
    ``slow`` and the bucket was duplicated onto ``to``."""
    OBS.tracer.record("hedge", ts=time.monotonic(), slow=slow, to=to)
    OBS.registry.counter("dart_hedges_total",
                         "hedged straggler re-dispatches by slow engine",
                         ("engine",)).inc(1, engine=slow)


def record_requeue(n_requests: int) -> None:
    """One dead-engine bucket requeue (backpressure-bypassing)."""
    OBS.tracer.record("requeue", ts=time.monotonic(),
                      n_requests=n_requests)
    OBS.registry.counter("dart_requeues_total",
                         "requests requeued after losing their engine",
                         ()).inc(n_requests)


def record_fault(point: str, kind: str, engine) -> None:
    """One injected fault firing (chaos runs only)."""
    OBS.tracer.record("fault", ts=time.monotonic(), point=point,
                      kind=kind, engine=engine)
    OBS.registry.counter("dart_faults_injected_total",
                         "chaos faults injected by cut point and kind",
                         ("point", "kind")).inc(1, point=point, kind=kind)


# ---------------------------------------------------------------------------
# pull side (scrape-time collectors)
# ---------------------------------------------------------------------------

def bind_scheduler(sched, name: str | None = None) -> None:
    """Register a scrape-time collector exporting everything the
    scheduler (and the engine behind it) already knows.  Weakly bound:
    the collector unregisters itself once the scheduler is collected."""
    if name is None:
        name = type(sched).__name__
    ref = weakref.ref(sched)

    def collect(reg):
        obj = ref()
        if obj is None:
            return "dead"
        _collect_scheduler(reg, obj, name)
        return None

    OBS.registry.register_collector(collect)


def _collect_scheduler(reg, sched, name: str) -> None:
    # scheduler counters (submitted/completed/flush_*/degraded/...)
    ev = reg.counter("dart_scheduler_events_total",
                     "scheduler counters by event", ("event",))
    for k, v in sched.counters.items():
        ev.set_total(v, event=k)
    q = sched.queue
    decoder = getattr(sched, "decoder", None)
    ev.set_total(q.shed, event="shed")
    ev.set_total(q.rejected, event="rejected")
    if decoder is not None:
        ev.set_total(q.starved, event="starved")
    depth = reg.gauge("dart_queue_depth", "queued requests by lane",
                      ("lane",))
    for k in q.keys():
        depth.set(q.depth(k), lane=_lane(k))
    if hasattr(sched, "_inflight"):
        reg.gauge("dart_inflight",
                  "dispatched, unmaterialized buckets").set(
            len(sched._inflight))
    reg.gauge("dart_service_ms_ema", "EMA of bucket service time").set(
        sched._service_s * 1e3)

    # per-lane DAES (Eq. 9) from the streaming accumulator
    daes = getattr(sched, "daes", None)
    if daes is not None:
        for lane, row in daes.rows().items():
            for col in ("daes", "speedup", "power_eff", "acc_pct", "n"):
                reg.gauge(f"dart_lane_{col}",
                          f"per-lane {col} (Eq. 9 telemetry)",
                          ("lane",)).set(float(row[col]), lane=_lane(lane))

    # admission-planner depth priors
    planner = getattr(sched, "planner", None)
    if planner is not None:
        gd = reg.gauge("dart_depth_prior",
                       "admission planner expected exit depth",
                       ("member", "dclass"))
        for c, d in enumerate(planner.priors()):
            if d is not None:
                gd.set(d, member="0", dclass=str(c))

    # exit-depth predictor: hit/miss + head-skip counters
    predictor = sched.predictor
    if predictor is not None:
        ps = predictor.stats()
        pe = reg.counter("dart_predictor_events_total",
                         "exit-depth predictor counters by event",
                         ("event",))
        for k in ("hits", "misses", "skip_calls", "skip_stages",
                  "observed"):
            pe.set_total(ps[k], event=k)
        if ps["hit_rate"] is not None:
            reg.gauge("dart_predictor_hit_rate",
                      "fraction of requests whose predicted depth band "
                      "matched the realized exit").set(ps["hit_rate"])
        # admission-quote error (quote vs realized latency), from the
        # EngineState quote counters
        qs = sched.engine.state
        qn = int(qs.quote_count)
        if qn:
            reg.gauge("dart_quote_mean_abs_err_ms",
                      "mean |admission quote - realized latency|"
                      ).set(float(qs.quote_err_ms_sum) / qn)
            reg.gauge("dart_quote_mean_ms",
                      "mean admission-time latency quote").set(
                float(qs.quote_ms_sum) / qn)

    _collect_engine(reg, sched.engine, name)

    # continuous decoder slot/page occupancy
    if decoder is not None:
        for k, v in decoder.occupancy().items():
            reg.gauge(f"dart_{k}",
                      "continuous-batching pool occupancy").set(v)


def _collect_engine(reg, engine, name: str) -> None:
    st = engine.stats()
    reg.counter("dart_engine_served_total", "samples served by engine",
                ("engine",)).set_total(st["served"], engine=name)
    reg.gauge("dart_engine_mean_macs", "mean normalized MACs per sample",
              ("engine",)).set(st["mean_macs"], engine=name)
    exits = reg.counter("dart_engine_exits_total",
                        "EngineState exit histogram by stage",
                        ("engine", "stage"))
    for s, c in enumerate(np.asarray(st["exit_counts"]).ravel()):
        exits.set_total(int(c), engine=name, stage=str(s))
    req = st.get("requests")
    if req:
        lm = req["latency_ms"]
        g = reg.gauge("dart_engine_latency_ms",
                      "EngineState latency-ring percentiles",
                      ("engine", "quantile"))
        for qk in ("p50", "p95", "p99", "mean"):
            g.set(lm[qk], engine=name, quantile=qk)
        reg.gauge("dart_engine_miss_rate", "deadline miss rate",
                  ("engine",)).set(req["miss_rate"], engine=name)
    # The eager engines compile nothing: no trace counts, and the
    # recompile alert stays 0 (the JAX eager engine exports the same)
    reg.counter("dart_trace_total", "compiled-step traces by cache key",
                ("engine", "key"))
    reg.counter("dart_recompiles_total",
                "re-traces of an already-compiled step key "
                "(alertable: should stay 0)",
                ("engine",)).set_total(0, engine=name)


def bind_pool(pool) -> None:
    """Register a scrape-time collector for an
    :class:`~repro_torch.serving.resilience.EnginePool`: per-engine
    health gauges (2 healthy / 1 degraded / 0 dead-or-drained), the
    chaos / retry / hedge / requeue / quarantine totals, the
    degradation-ladder rung, and the straggler-policy hedge deadline.
    Weakly bound, like ``bind_scheduler``."""
    ref = weakref.ref(pool)

    def collect(reg):
        obj = ref()
        if obj is None:
            return "dead"
        from repro_torch.serving.resilience import HEALTH_LEVEL
        st = obj.stats()
        health = reg.gauge("dart_engine_health",
                           "pool engine health (2 healthy / 1 degraded "
                           "/ 0 dead or drained)", ("engine",))
        for name, state in st["engines"].items():
            health.set(HEALTH_LEVEL[state], engine=name)
        reg.gauge("dart_degradation_rung",
                  "graceful-degradation ladder rung (0 = full service)"
                  ).set(st["rung"])
        ev = reg.counter("dart_pool_events_total",
                         "engine-pool counters by event", ("event",))
        for k in ("calls", "retries", "hedges", "requeues",
                  "quarantined", "deaths", "stragglers", "joins",
                  "drains"):
            ev.set_total(st[k], event=k)
        reg.counter("dart_retries_total",
                    "bucket dispatch retries by engine",
                    ("engine",)).set_total(st["retries"], engine="_pool")
        reg.counter("dart_hedges_total",
                    "hedged straggler re-dispatches by slow engine",
                    ("engine",)).set_total(st["hedges"], engine="_pool")
        reg.counter("dart_faults_injected_total",
                    "chaos faults injected by cut point and kind",
                    ("point", "kind")).set_total(
            st["faults_injected"], point="_all", kind="_all")
        if st["straggler_deadline_ms"] is not None:
            reg.gauge("dart_hedge_deadline_ms",
                      "straggler-policy rolling-median hedge deadline"
                      ).set(st["straggler_deadline_ms"])
        return None

    OBS.registry.register_collector(collect)


def bind_dispatch(reg) -> None:
    """Export the launches of the hand-written kernels
    (``repro_torch.kernels.dispatch.launch_counts``)."""

    def collect(reg):
        from repro_torch.kernels import dispatch as KD
        fam = reg.counter("dart_kernel_launches_total",
                          "hand-written kernel launches", ("kernel",))
        for kernel, c in KD.launch_counts().items():
            fam.set_total(c, kernel=kernel)
        return None

    reg.register_collector(collect)
