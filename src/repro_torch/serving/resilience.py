"""Fault-tolerant serving: the chaos-injected engine pool with
retry/hedge dispatch, elastic membership, and the graceful-degradation
ladder.  The port of the JAX package's ``serving/resilience.py`` for the
classifier engine.

:class:`EnginePool` wraps one-or-more same-config engines behind the
scheduler's ``_engine_call`` seam.  Every dispatched bucket becomes a
``pool.call(fn)``:

    pick healthy engine ─▶ run on pool worker ─▶ validate ─▶ return
          │ (round-robin)      │ straggler deadline       │ non-finite
          │                    │ exceeded? HEDGE to       │ conf / bad
          │ engine dead /      │ another healthy engine,  │ exit stage:
          │ exception: bounded │ first result wins        │ quarantine,
          └ retry w/ backoff ◀─┴──────────────────────────┴ retry

* **Health** (healthy → degraded → dead) is driven by call outcomes
  plus a :class:`~repro_torch.runtime.fault.HeartbeatMonitor` (beats
  fire on call completion and from an idle-beater; a wedged engine call
  starves its engine's beats and the monitor declares it dead).  A
  success on a degraded engine restores it.
* **Hedging** uses :class:`~repro_torch.runtime.fault.StragglerPolicy` — a
  rolling-median deadline over observed call times, NOT a fixed
  timeout.  First-result-wins; futures resolve exactly once because
  the pool returns one result per call and the scheduler resolves each
  request future behind a ``done()`` guard.
* **Elastic membership**: :meth:`EnginePool.drain` removes an engine
  from routing (not a failure); :meth:`EnginePool.join` restores a
  (possibly new) engine from an ``EngineState`` checkpoint
  (``restore_with_migration``), warms the bucket shapes the pool has
  served, and only then takes traffic.
* **Degradation ladder** — as live capacity shrinks the pool escalates
  (each rung logged, gauged, and REVERSED on recovery):

    =====  ======================  ===================================
    rung   actuator                mechanism
    =====  ======================  ===================================
    1      degrade-alpha           dispatch-time alpha scale: Eq. 19
                                   lowers every gate's threshold for
                                   easier inputs → earlier exits
    2      threshold scaling       ``state.with_policy(tau * scale)``
                                   on every live engine → shallower
                                   exits for ALL traffic
    3      max-depth cap           tau sentinel (−1e3) from the cap
                                   stage on: the clipped Eq. 19
                                   threshold is 0, softmax-max conf is
                                   strictly positive, so the gate
                                   always fires — no sample runs past
                                   the cap
    4      shed lowest priority    submit-time shed below the priority
                                   floor
    =====  ======================  ===================================

* **Snapshots**: :meth:`PooledDartServer.snapshot` atomically persists
  planner / predictor / threshold state next to the engine checkpoint;
  a restarted server resumes its learned priors via
  :meth:`restore_snapshot` instead of cold-starting.

Chaos cut points (``runtime/chaos.py``) fire at dispatch (call entry),
step (inside the worker, around the engine call), complete
(completion) and checkpoint_load (snapshot restore / join).

On a card an engine call returns once its kernels are launched, not
done.  The worker therefore copies the call's result keys to the host
(one transfer, ``loop._host``, the copy completion makes anyway) before
the call counts as done: validation then sees the values the device
computed, and the straggler clock times the device's work, not its
launches.  Every engine of a pool launches on its thread's current
stream, the default stream, as the single-engine server does: the
faults are injected on the host, so a wedged engine holds no stream,
and state that one thread writes and another reads (the ladder's
thresholds, snapshots, ``stats()``) needs no cross-stream event.

The cascade and LM-session schedulers are not ported yet
(``pooled_cascade_server`` and ``pooled_lm_session`` raise).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from concurrent.futures import wait as futures_wait

import numpy as np

from repro_torch.obs import OBS
from repro_torch.obs import adapters as OBS_A
from repro_torch.obs import log as OBS_LOG
from repro_torch.runtime.chaos import (FaultInjector, InjectedEngineDeath,
                                       NullInjector)
from repro_torch.runtime.fault import HeartbeatMonitor, StragglerPolicy
from repro_torch.serving.loop import (_RESULT_KEYS, AsyncDartServer,
                                      SchedulerConfig, _host)
from repro_torch.serving.request import InvalidEngineOutput, RequestShed

HEALTHY, DEGRADED, DEAD, DRAINED = "healthy", "degraded", "dead", "drained"
#: health states that still take traffic
_LIVE = (HEALTHY, DEGRADED)
#: numeric encoding for the ``dart_engine_health`` gauge
HEALTH_LEVEL = {DEAD: 0, DRAINED: 0, DEGRADED: 1, HEALTHY: 2}

#: tau sentinel for the rung-3 max-depth cap: clip(coef*(−1e3) +
#: beta_diff*alpha, 0, 1) = 0 for any sane policy, and softmax-max
#: confidence is strictly > 0, so the capped gate ALWAYS fires.
_TAU_ALWAYS_FIRE = -1e3
#: rung-1 dispatch-time alpha multiplier
DEGRADED_ALPHA_SCALE = 0.5
#: rung-2 threshold scale
DEGRADED_TAU_SCALE = 0.5
#: rung-3 cap stage as a fraction of the gated stages
DEPTH_CAP_FRAC = 0.5
#: rung 4 sheds submits with priority below this floor
SHED_PRIORITY_FLOOR = 1
#: missed-beat deadline of the pool's heartbeat monitor
HEARTBEAT_TIMEOUT_S = 5.0


class NoHealthyEngines(RuntimeError):
    """Every pool engine is dead or drained — the scheduler requeues
    the bucket (bounded) instead of failing it outright."""


class EngineWedged(RuntimeError):
    """A call exceeded the hard cap on every engine that tried it —
    the engines were marked dead and the bucket is re-routed."""


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs of the engine pool.

    retries:            extra attempts per call after the first
    backoff_s:          base retry backoff (doubles per attempt)
    hedge:              enable straggler hedging
    hedge_factor:       StragglerPolicy deadline = factor x rolling
                        median call time (no hedging until the policy
                        has observations)
    straggler_window:   rolling-median window, in calls
    call_timeout_s:     hard per-call cap — past it the engine is
                        declared wedged (dead) and the call re-routes
    requeue_limit:      max NoHealthyEngines requeues per request
    requeue_backoff_s:  real sleep before a requeue retry

    The ladder's actuators and the heartbeat deadline are the module
    constants above; output validation is always on.
    """
    retries: int = 2
    backoff_s: float = 0.002
    hedge: bool = True
    hedge_factor: float = 3.0
    straggler_window: int = 20
    call_timeout_s: float = 30.0
    requeue_limit: int = 3
    requeue_backoff_s: float = 0.005


def validate_output(out, n_exits=None) -> None:
    """Output-validation quarantine: raise :class:`InvalidEngineOutput`
    on non-finite confidence or out-of-range exit stages — a poisoned
    bucket must fail structurally, not leak NaNs into telemetry."""
    if isinstance(out, dict):
        if "conf" in out:
            conf = np.asarray(out["conf"])
            if not np.all(np.isfinite(conf)):
                raise InvalidEngineOutput(
                    f"non-finite confidence in engine output "
                    f"({int(np.sum(~np.isfinite(conf)))} bad values)")
        if "exit_idx" in out and n_exits:
            e = np.asarray(out["exit_idx"])
            if e.size and (e.min() < 0 or e.max() >= n_exits):
                raise InvalidEngineOutput(
                    f"exit stage out of range [0, {n_exits}): "
                    f"[{e.min()}, {e.max()}]")
    elif isinstance(out, tuple) and len(out) == 2 and n_exits:
        stages = np.asarray(out[1])
        if stages.size and (stages.min() < 0 or stages.max() >= n_exits):
            raise InvalidEngineOutput(
                f"decode exit stage out of range [0, {n_exits}): "
                f"[{stages.min()}, {stages.max()}]")


def _on_host(out):
    """An engine call's result keys as host arrays (one transfer): the
    call is done only once the device's work is."""
    if isinstance(out, dict) and all(k in out for k in _RESULT_KEYS):
        return {**out, **_host(out)}
    return out


def _corrupt(out):
    """Apply a ``nan_output`` injection: the corruption the validator
    must catch (dict outputs get NaN confidence, LM tuples get an
    impossible exit stage)."""
    if isinstance(out, dict) and "conf" in out:
        bad = np.full_like(np.asarray(out["conf"], np.float32), np.nan)
        return {**out, "conf": bad}
    if isinstance(out, tuple) and len(out) == 2:
        stages = np.asarray(out[1])
        return out[0], np.full_like(stages, np.iinfo(np.int32).max)
    return out


class EnginePool:
    """One-or-more same-config engines behind one ``call()`` seam.

        pool = EnginePool({"e0": eng0, "e1": eng1})
        srv = PooledDartServer(pool, SchedulerConfig(...))
        ...
        pool.drain("e1"); pool.join("e1", eng1, snapshot=ckpt_dir)
        pool.close()

    Engines must be built from the SAME config and parameters: a retry
    or hedge re-runs the identical pure function, so whichever engine
    answers, the result is bit-identical.
    """

    def __init__(self, engines: dict, cfg: ResilienceConfig | None = None,
                 *, injector: FaultInjector | None = None,
                 heartbeat: bool = True):
        if not engines:
            raise ValueError("EnginePool needs at least one engine")
        self.engines = dict(engines)
        self.cfg = cfg or ResilienceConfig()
        self.injector = injector or NullInjector()
        self.health = {n: HEALTHY for n in self.engines}
        self.straggler = StragglerPolicy(
            factor=self.cfg.hedge_factor,
            window=self.cfg.straggler_window)
        self.counters = {"calls": 0, "retries": 0, "hedges": 0,
                         "requeues": 0, "quarantined": 0, "deaths": 0,
                         "stragglers": 0, "joins": 0, "drains": 0}
        self._lock = threading.RLock()
        self._rr = 0
        self._rung = 0
        self.rung_history: list = []
        self.alpha_scale = 1.0
        self.shed_floor: int | None = None
        self._events: list = []
        #: (monotonic s, event, engine) of every death, drain and join,
        #: and of the pool's first successful call after a death
        #: ("success"): recovery time reads off it
        self.timeline: list = []
        self._await_success = False
        self._inflight: dict = {n: 0 for n in self.engines}
        self._orig_tau: dict = {}
        self._warm_shapes: set = set()
        self.warm_mode = "masked"
        for eng in self._policy_targets(self.engines.values()):
            self._remember_tau(eng)
        self._exec = ThreadPoolExecutor(
            max_workers=max(2, len(self.engines)),
            thread_name_prefix="engine-pool")
        self._closed = False
        self.monitor = None
        self._beater = None
        if heartbeat:
            self.monitor = HeartbeatMonitor(
                list(self.engines), timeout_s=HEARTBEAT_TIMEOUT_S,
                on_failure=self._on_missed_beats)
            self._beater = threading.Thread(target=self._beat_idle,
                                            daemon=True,
                                            name="engine-pool-beater")
            self._beater.start()
        if OBS.enabled:
            OBS_A.bind_pool(self)
            if self.injector.on_fire is None:
                self.injector.on_fire = OBS_A.record_fault

    # -- introspection ----------------------------------------------------
    @property
    def primary(self):
        """The engine backing admission planning / bucket keys /
        telemetry (the first live engine, falling back to the first)."""
        with self._lock:
            for n, eng in self.engines.items():
                if self.health[n] in _LIVE:
                    return eng
            return next(iter(self.engines.values()))

    @property
    def rung(self) -> int:
        return self._rung

    def n_live(self) -> int:
        with self._lock:
            return sum(1 for s in self.health.values() if s in _LIVE)

    def stats(self) -> dict:
        with self._lock:
            return {
                "engines": dict(self.health),
                "rung": self._rung,
                "rung_history": list(self.rung_history),
                "alpha_scale": self.alpha_scale,
                "shed_floor": self.shed_floor,
                "faults_injected": len(self.injector.trace),
                "straggler_deadline_ms":
                    self.straggler.deadline() * 1e3
                    if self.straggler.times else None,
                **self.counters,
            }

    def consume_events(self) -> list:
        """Drain the per-call event record (retry/hedge/quarantine/...)
        — the pooled scheduler uses a non-empty record to mark the
        bucket's requests as fault-touched."""
        with self._lock:
            ev, self._events = self._events, []
            return ev

    # -- the call seam ----------------------------------------------------
    def call(self, fn):
        """Run ``fn(engine)`` on a healthy engine with bounded retry,
        straggler hedging and output validation.  Raises
        :class:`NoHealthyEngines` when nothing can take traffic."""
        with self._lock:
            self.counters["calls"] += 1
        last_exc: Exception | None = None
        tried: set = set()
        for attempt in range(self.cfg.retries + 1):
            name = self._pick(exclude=tried)
            if name is None:
                name = self._pick()          # all tried: allow re-tries
            if name is None:
                raise NoHealthyEngines(
                    f"no live engine for call "
                    f"(health={dict(self.health)})") from last_exc
            tried.add(name)
            if attempt:
                with self._lock:
                    self.counters["retries"] += 1
                    self._events.append("retry")
                if OBS.enabled:
                    OBS_A.record_retry(name, attempt)
                time.sleep(self.cfg.backoff_s * (2 ** (attempt - 1)))
            try:
                return self._attempt(name, fn)
            except Exception as e:             # noqa: BLE001
                last_exc = e
        raise last_exc

    def _attempt(self, name: str, fn):
        self.injector.fire("dispatch", engine=name)
        fut = self._exec.submit(self._run_on, name, fn)
        pending = {fut: name}
        deadline = self.straggler.deadline()
        if self.cfg.hedge and math.isfinite(deadline):
            try:
                return fut.result(timeout=deadline)
            except FuturesTimeout:
                with self._lock:
                    self.counters["stragglers"] += 1
                alt = self._pick(exclude={name})
                if alt is not None:
                    with self._lock:
                        self.counters["hedges"] += 1
                        self._events.append("hedge")
                    if OBS.enabled:
                        OBS_A.record_hedge(name, alt)
                    OBS_LOG.event("pool", "hedging straggler bucket",
                                  slow=name, to=alt,
                                  deadline_ms=deadline * 1e3)
                    pending[self._exec.submit(self._run_on, alt, fn)] = alt
            except Exception:
                raise
        # first result wins; a hard cap bounds a fully wedged call
        t_end = time.monotonic() + self.cfg.call_timeout_s
        last_exc: Exception | None = None
        while pending:
            done, _ = futures_wait(set(pending),
                                   timeout=max(t_end - time.monotonic(),
                                               1e-3),
                                   return_when=FIRST_COMPLETED)
            if not done:
                for wedged in pending.values():
                    self._mark_dead(wedged, reason="wedged")
                raise EngineWedged(
                    f"call exceeded {self.cfg.call_timeout_s}s on "
                    f"{sorted(pending.values())}") from last_exc
            for f in done:
                pending.pop(f)
                try:
                    return f.result()
                except Exception as e:         # noqa: BLE001
                    last_exc = e
        raise last_exc

    def _run_on(self, name: str, fn):
        """One engine execution on a pool worker: step-point injection,
        the engine call, nan corruption + validation, bookkeeping."""
        eng = self.engines[name]
        with self._lock:
            self._inflight[name] += 1
        t0 = time.monotonic()
        try:
            action = self.injector.fire("step", engine=name)
            out = _on_host(fn(eng))
            if action == "nan_output":
                out = _corrupt(out)
            validate_output(out, getattr(self.primary, "n_exits", None))
        except InvalidEngineOutput as e:
            with self._lock:
                self.counters["quarantined"] += 1
                self._events.append("quarantine")
            self._note_failure(name, e)
            raise
        except Exception as e:                 # noqa: BLE001
            self._note_failure(name, e)
            raise
        finally:
            with self._lock:
                self._inflight[name] -= 1
        dt = time.monotonic() - t0
        self.straggler.record(dt)
        self._mark_success(name)
        return out

    # -- health -----------------------------------------------------------
    def _pick(self, exclude=frozenset()) -> str | None:
        with self._lock:
            live = [n for n in self.engines
                    if self.health[n] in _LIVE and n not in exclude]
            prefer = [n for n in live if self.health[n] == HEALTHY]
            cands = prefer or live
            if not cands:
                return None
            self._rr += 1
            return cands[self._rr % len(cands)]

    def _mark_success(self, name: str) -> None:
        if self.monitor is not None:
            self.monitor.beat(name)
        with self._lock:
            if self._await_success:
                self._await_success = False
                self._note_event("success", name)
            if self.health.get(name) == DEGRADED:
                self.health[name] = HEALTHY
                OBS_LOG.event("pool", "engine recovered", engine=name)
        self._update_ladder()

    def _note_failure(self, name: str, exc: Exception) -> None:
        if isinstance(exc, InjectedEngineDeath):
            self._mark_dead(name, reason="injected death")
            return
        with self._lock:
            cur = self.health.get(name)
            if cur == HEALTHY:
                self.health[name] = DEGRADED
                OBS_LOG.event("pool", "engine degraded", engine=name,
                              error=f"{type(exc).__name__}: {exc}")
            elif cur == DEGRADED:
                self.health[name] = DEAD
                self.counters["deaths"] += 1
                self._note_event("death", name)
                OBS_LOG.event("pool", "engine died", engine=name,
                              error=f"{type(exc).__name__}: {exc}")
        self._update_ladder()

    def _mark_dead(self, name: str, *, reason: str) -> None:
        with self._lock:
            if self.health.get(name) == DEAD:
                return
            self.health[name] = DEAD
            self.counters["deaths"] += 1
            self._events.append("death")
            self._note_event("death", name)
        OBS_LOG.event("pool", "engine declared dead", engine=name,
                      reason=reason)
        self._update_ladder()

    def _note_event(self, event: str, name: str) -> None:
        """Append to the timeline (the caller holds the lock)."""
        self.timeline.append((time.monotonic(), event, name))
        if event == "death":
            self._await_success = True

    def recovery_s(self) -> list:
        """Per death: seconds from it to the pool's next successful
        call (None while none has followed)."""
        with self._lock:
            tl = list(self.timeline)
        out = []
        for i, (t, event, _) in enumerate(tl):
            if event == "death":
                nxt = [u for u, e, _ in tl[i + 1:] if e == "success"]
                out.append(nxt[0] - t if nxt else None)
        return out

    def _on_missed_beats(self, name: str) -> None:
        """HeartbeatMonitor callback (fires OUTSIDE its lock): an
        engine that stopped beating while a call is in flight on it is
        wedged — declare it dead so dispatch re-routes."""
        with self._lock:
            if self.health.get(name) not in _LIVE:
                return
        self._mark_dead(name, reason="missed heartbeats")

    def _beat_idle(self) -> None:
        """Beat every live engine with no in-flight call: only an
        engine actually stuck inside a call can miss its deadline."""
        period = HEARTBEAT_TIMEOUT_S / 4
        while not self._closed:
            with self._lock:
                idle = [n for n in self.engines
                        if self.health[n] in _LIVE
                        and not self._inflight[n]]
            for n in idle:
                if self.monitor is not None:
                    self.monitor.beat(n)
            time.sleep(period)

    # -- elastic membership ----------------------------------------------
    def drain(self, name: str) -> None:
        """Remove an engine from routing (planned decommission, not a
        failure: no death count, no callback)."""
        with self._lock:
            if name not in self.engines:
                raise KeyError(name)
            self.health[name] = DRAINED
            self.counters["drains"] += 1
            self._note_event("drain", name)
        if self.monitor is not None:
            self.monitor.remove_worker(name)
        OBS_LOG.event("pool", "engine drained", engine=name)
        self._update_ladder()

    def join(self, name: str, engine=None, *, snapshot: str | None = None,
             warm: bool = True) -> None:
        """(Re-)admit an engine: restore its ``EngineState`` from the
        snapshot checkpoint (``restore_with_migration`` under the
        ``checkpoint_load`` cut point), warm the bucket shapes the pool
        has served, THEN take traffic."""
        if engine is not None:
            self.engines[name] = engine
        elif name not in self.engines:
            raise KeyError(name)
        eng = self.engines[name]
        self.injector.fire("checkpoint_load", engine=name)
        if snapshot is not None:
            eng.restore_state(os.path.join(snapshot, "engine"))
        self._remember_tau_targets(eng)
        if warm:
            self._warm(eng)
        with self._lock:
            self.health[name] = HEALTHY
            self._inflight.setdefault(name, 0)
            self._inflight[name] = 0
            self.counters["joins"] += 1
            self._note_event("join", name)
        if self.monitor is not None:
            self.monitor.add_worker(name)
        OBS_LOG.event("pool", "engine joined", engine=name,
                      warmed=len(self._warm_shapes) if warm else 0,
                      snapshot=snapshot)
        self._update_ladder()

    def note_example(self, x) -> None:
        """Record a dispatched batch shape so a joining engine can warm
        the same bucket shapes before taking traffic."""
        x = np.asarray(x)
        with self._lock:
            self._warm_shapes.add(
                (x.shape, str(x.dtype), self.warm_mode))

    def _warm(self, eng) -> None:
        infer = getattr(eng, "infer", None)
        if infer is None:
            return
        with self._lock:
            shapes = sorted(self._warm_shapes, key=str)
        for shape, dtype, mode in shapes:
            try:
                infer(np.zeros(shape, dtype), mode=mode, record=False)
            except Exception as e:             # noqa: BLE001
                OBS_LOG.error("pool", "bucket warm failed", exc=e,
                              shape=list(shape))

    # -- the degradation ladder ------------------------------------------
    def _ladder_rung_for(self, n_live: int) -> int:
        n = len(self.engines)
        if n_live == 0:
            return 4
        lost = 1.0 - n_live / n
        return int(np.clip(np.ceil(lost * 4.0), 0, 4))

    def _update_ladder(self) -> None:
        with self._lock:
            rung = self._ladder_rung_for(
                sum(1 for s in self.health.values() if s in _LIVE))
            if rung == self._rung:
                return
            prev, self._rung = self._rung, rung
            self.rung_history.append(
                {"from": prev, "to": rung,
                 "health": dict(self.health)})
            self.alpha_scale = DEGRADED_ALPHA_SCALE \
                if rung >= 1 else 1.0
            self.shed_floor = SHED_PRIORITY_FLOOR \
                if rung >= 4 else None
            live = [self.engines[n] for n in self.engines
                    if self.health[n] in _LIVE]
        self._apply_policy(live, rung)
        OBS_LOG.event("pool",
                      "degradation ladder moved" if rung > prev
                      else "degradation ladder reversed",
                      rung=rung, prev=prev,
                      alpha_scale=self.alpha_scale,
                      shed_floor=self.shed_floor)

    def _policy_targets(self, engines):
        """Engines whose Eq. 19 thresholds the ladder actuates (the port
        has no cascade engine yet, whose members the JAX package also
        actuates)."""
        for eng in engines:
            if hasattr(eng, "set_policy"):
                yield eng

    def _remember_tau(self, eng) -> None:
        # keyed by the engine itself: the id of a replaced engine could
        # be reused by its successor
        if eng not in self._orig_tau:
            self._orig_tau[eng] = \
                eng.state.tau.cpu().numpy().astype(np.float32)

    def _remember_tau_targets(self, eng) -> None:
        for t in self._policy_targets([eng]):
            self._remember_tau(t)

    def _apply_policy(self, live_engines, rung: int) -> None:
        """Install the rung's threshold transform on every live engine
        (rung < 2 restores the original tau — the reversal path).
        ``set_policy`` takes the engine's state lock, so a call folding
        its telemetry on a pool worker cannot put the old tau back."""
        for eng in self._policy_targets(live_engines):
            self._remember_tau(eng)
            tau = self._orig_tau[eng].copy()
            if rung >= 2:
                tau = tau * DEGRADED_TAU_SCALE
            if rung >= 3 and tau.size:
                cap = int(np.clip(
                    np.floor(tau.size * DEPTH_CAP_FRAC),
                    0, tau.size - 1))
                tau[cap:] = _TAU_ALWAYS_FIRE
            eng.set_policy(tau=tau)

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        self._closed = True
        if self.monitor is not None:
            self.monitor.close()
        if self._beater is not None:
            self._beater.join(timeout=2.0)
        self._exec.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _PooledSchedulerMixin:
    """The scheduler-side half of pooling, mixed into the classifier
    scheduler and the bucketed LM session (the JAX package mixes it
    into its cascade scheduler too): routes ``_engine_call`` through the pool,
    turns NoHealthyEngines into a bounded backpressure-bypassing
    requeue, sheds below the rung-4 priority floor, fires the
    ``complete`` cut point, and tracks which rids any fault touched."""

    def _install_pool(self, pool: EnginePool) -> None:
        # runs BEFORE the scheduler __init__ (dispatch hooks need the
        # pool the moment the daemon starts) — don't touch self.cfg here
        self.pool = pool
        self.touched_rids: set = set()
        self._snap_stop: threading.Event | None = None
        self._snap_thread = None

    # -- dispatch routing -------------------------------------------------
    def _engine_call(self, fn):
        return self.pool.call(fn)

    def _dispatch(self, reqs: list, reason: str) -> None:
        rids = [r.rid for r in reqs]
        if self.pool.rung:
            self.touched_rids.update(rids)
        try:
            super()._dispatch(reqs, reason)
        finally:
            if self.pool.consume_events():
                self.touched_rids.update(rids)

    def _on_dispatch_error(self, reqs: list, exc: Exception) -> bool:
        if not isinstance(exc, (NoHealthyEngines, EngineWedged)):
            return False
        limit = self.pool.cfg.requeue_limit
        if any(r.payload.get("requeues", 0) >= limit for r in reqs):
            return False                       # bounded: fail the bucket
        for r in reqs:
            r.payload["requeues"] = r.payload.get("requeues", 0) + 1
            self.touched_rids.add(r.rid)
            self.queue.requeue(r)
        self.counters["requeued"] = \
            self.counters.get("requeued", 0) + len(reqs)
        with self.pool._lock:
            self.pool.counters["requeues"] += len(reqs)
        if OBS.enabled:
            OBS_A.record_requeue(len(reqs))
        OBS_LOG.event("pool", "bucket requeued (no live engine)",
                      n_requests=len(reqs), rids=[r.rid for r in reqs[:8]],
                      error=type(exc).__name__)
        time.sleep(self.pool.cfg.requeue_backoff_s)
        return True

    # -- rung-4 shed ------------------------------------------------------
    def submit(self, x, deadline_ms=None, priority: int = 0, **kw):
        floor = self.pool.shed_floor
        if floor is not None and priority < floor:
            from concurrent.futures import Future
            fut: Future = Future()
            fut.set_exception(RequestShed(
                f"degradation ladder rung {self.pool.rung}: shedding "
                f"priority {priority} < floor {floor}"))
            self.counters["shed_degraded"] = \
                self.counters.get("shed_degraded", 0) + 1
            return fut
        return super().submit(x, deadline_ms, priority, **kw)

    # -- completion cut point ---------------------------------------------
    def _complete(self, reqs, out, t_dispatch) -> None:
        self.pool.injector.fire("complete")
        super()._complete(reqs, out, t_dispatch)

    # -- serving-state snapshots ------------------------------------------
    def snapshot(self, path: str, step: int = 0) -> None:
        """Atomic serving-state checkpoint: EngineState (thresholds,
        §II.C window, telemetry) via the engine's own checkpointer plus
        the host-side planner/predictor priors as JSON (tmp + rename)."""
        os.makedirs(path, exist_ok=True)
        self.engine.save_state(os.path.join(path, "engine"), step)
        meta: dict = {"step": int(step)}
        if hasattr(self.planner, "state_dict"):
            meta["planner"] = self.planner.state_dict()
        if getattr(self, "predictor", None) is not None:
            meta["predictor"] = self.predictor.state_dict()
        tmp = os.path.join(path, "serving_state.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(path, "serving_state.json"))

    def restore_snapshot(self, path: str) -> int:
        """Resume learned serving priors from :meth:`snapshot` (fires
        the ``checkpoint_load`` cut point; every live engine restores
        the same EngineState through ``restore_with_migration``)."""
        self.pool.injector.fire("checkpoint_load")
        step = 0
        seen: set = set()
        for name, eng in self.pool.engines.items():
            if self.pool.health[name] not in _LIVE or id(eng) in seen:
                continue
            seen.add(id(eng))
            step = eng.restore_state(os.path.join(path, "engine"))
            self.pool._remember_tau_targets(eng)
        with open(os.path.join(path, "serving_state.json")) as f:
            meta = json.load(f)
        if "planner" in meta and hasattr(self.planner, "load_state_dict"):
            self.planner.load_state_dict(meta["planner"])
        if "predictor" in meta and getattr(self, "predictor", None) \
                is not None:
            self.predictor.load_state_dict(meta["predictor"])
        OBS_LOG.event("pool", "serving state restored", path=path,
                      step=meta.get("step", step))
        return int(meta.get("step", step))

    def start_snapshots(self, path: str, every_s: float) -> None:
        """Periodic snapshot daemon (explicitly opted into)."""
        self._snap_stop = threading.Event()

        def _loop():
            n = 0
            while not self._snap_stop.wait(every_s):
                n += 1
                try:
                    self.snapshot(path, step=n)
                except Exception as e:         # noqa: BLE001
                    OBS_LOG.error("pool", "periodic snapshot failed",
                                  exc=e, path=path)
        self._snap_thread = threading.Thread(
            target=_loop, daemon=True, name="serving-snapshots")
        self._snap_thread.start()

    def close(self, wait: bool = True) -> None:
        if self._snap_stop is not None:
            self._snap_stop.set()
            self._snap_thread.join(timeout=2.0)
            self._snap_stop = None
        super().close(wait)

    # -- metering ---------------------------------------------------------
    def stats(self) -> dict:
        s = super().stats()
        s["pool"] = self.pool.stats()
        s["pool"]["touched_rids"] = len(self.touched_rids)
        return s


class PooledDartServer(_PooledSchedulerMixin, AsyncDartServer):
    """:class:`AsyncDartServer` over an :class:`EnginePool` — same
    submit/stats/close surface; admission planning, bucket keys and
    telemetry ride the pool's primary engine, dispatch rides
    ``pool.call`` with retry/hedge/requeue, and the degradation ladder
    scales dispatch-time alpha (rung 1) on top of the pool's threshold
    actuators."""

    def __init__(self, pool: EnginePool,
                 cfg: SchedulerConfig = SchedulerConfig(), **kw):
        self._install_pool(pool)
        pool.warm_mode = cfg.mode
        super().__init__(pool.primary, cfg, **kw)

    def _infer_batch(self, reqs: list, x, alpha):
        self.pool.note_example(x)
        scale = self.pool.alpha_scale
        if scale != 1.0:
            # rung 1, degrade-alpha: Eq. 19 thresholds drop for easier
            # inputs, so the whole bucket exits earlier
            alpha = np.asarray(alpha) * scale
            self.touched_rids.update(r.rid for r in reqs)
        return super()._infer_batch(reqs, x, alpha)


def pooled_cascade_server(pool: EnginePool,
                          cfg: SchedulerConfig = SchedulerConfig(), **kw):
    """The pooled cascade scheduler waits for the cascade slice."""
    raise NotImplementedError(
        "the cascade scheduler is not ported yet (ROADMAP queue 1, "
        "item 7)")


def pooled_lm_session(pool: EnginePool, cfg=None, **kw):
    """Pooled bucketed LM decode session: ``generate`` calls ride
    ``pool.call`` (retry, hedge and requeue as for classifier
    buckets)."""
    from repro_torch.serving.lm_session import LMDecodeSession

    class PooledLMSession(_PooledSchedulerMixin, LMDecodeSession):
        def __init__(self, pool, cfg, **kw):
            self._install_pool(pool)
            super().__init__(pool.primary, cfg, **kw)
    return PooledLMSession(pool, cfg, **kw)
