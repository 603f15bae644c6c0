"""Deterministic fault injection for the serving path.

Chaos testing only earns its keep when a failure found once can be
found again: every fault here is driven by a seeded, serializable
:class:`FaultPlan` replayed through named CUT POINTS on the serving hot
path, and the injector records an injection TRACE so two runs of the
same plan over the same call sequence can be diffed for identity.

Cut points (where :meth:`FaultInjector.fire` is called from):

* ``dispatch``        — a bucket is about to be routed to an engine
  (``EnginePool.call`` entry).
* ``step``            — inside one engine's execution (the pool's
  per-engine worker, around ``engine.infer``).
* ``complete``        — a materialized bucket is about to resolve
  futures.
* ``checkpoint_load`` — a serving-state snapshot restore
  (``resilience.restore_snapshot`` / ``EnginePool.join``).

A copy of the JAX package's ``runtime/chaos.py`` (numpy only): the same
seed gives the same plan and the same JSON in both packages.

Fault kinds and what the pool does with the returned action:

* ``engine_death`` — raises :class:`InjectedEngineDeath` out of the cut
  point; the pool marks the engine dead and retries/requeues.
* ``straggler``    — sleeps ``delay_s`` inside the cut point; the
  pool's :class:`~repro_torch.runtime.fault.StragglerPolicy` deadline then
  triggers a hedged re-dispatch.
* ``nan_output``   — returned as an action; the pool corrupts the
  engine output (non-finite confidence), which the output-validation
  quarantine must catch before it poisons telemetry.
* ``queue_stall``  — sleeps ``delay_s`` at the cut point WITHOUT
  marking anything unhealthy: models a wedged queue/host, visible only
  through latency.

Everything is host-side and dependency-free; the injector is
thread-safe (pool workers fire concurrently) and the NULL injector is
a no-op cheap enough to leave on the hot path.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np

CUT_POINTS = ("dispatch", "step", "complete", "checkpoint_load")
KINDS = ("engine_death", "straggler", "nan_output", "queue_stall")


class InjectedFault(RuntimeError):
    """Base class for exceptions raised by the fault injector."""


class InjectedEngineDeath(InjectedFault):
    """An injected engine death: the pool must mark the engine dead,
    requeue its in-flight work and serve it elsewhere."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """ONE planned fault.

    kind:    one of :data:`KINDS`
    point:   cut point it fires at (:data:`CUT_POINTS`)
    at:      fires on the ``at``-th invocation (0-based) of that cut
             point — counted per (point, engine) when ``engine`` is
             set, per point globally when it is None
    engine:  target engine name, or None for "whichever engine hits
             the trigger count"
    delay_s: hold time for ``straggler`` / ``queue_stall``
    """
    kind: str
    point: str
    at: int
    engine: str | None = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; known: {KINDS}")
        if self.point not in CUT_POINTS:
            raise ValueError(
                f"unknown cut point {self.point!r}; known: {CUT_POINTS}")
        if self.at < 0:
            raise ValueError("at must be >= 0")


class FaultPlan:
    """A replayable schedule of :class:`FaultSpec`\\ s.

    Plans are VALUE objects: build one by hand (targeted tests), via
    :meth:`generate` (seeded random schedules for the property test /
    chaos benchmark), or round-trip through :meth:`to_json` /
    :meth:`from_json`.  The same plan driven through the same sequence
    of :meth:`FaultInjector.fire` calls yields the same injections —
    that is the determinism contract CI checks.
    """

    def __init__(self, specs=()):
        self.specs = tuple(specs)

    def __iter__(self):
        return iter(self.specs)

    def __len__(self):
        return len(self.specs)

    @classmethod
    def generate(cls, seed: int, *, n_faults: int = 4,
                 engines=("e0", "e1"), kinds=KINDS,
                 points=("dispatch", "step", "complete"),
                 horizon: int = 32, max_delay_s: float = 0.05,
                 targeted_p: float = 0.75) -> "FaultPlan":
        """Seeded random plan: ``n_faults`` faults over the first
        ``horizon`` invocations of the allowed cut points.  Same seed
        (and kwargs) => same plan, always."""
        rng = np.random.RandomState(seed)
        specs = []
        for _ in range(int(n_faults)):
            kind = str(kinds[rng.randint(len(kinds))])
            point = str(points[rng.randint(len(points))])
            engine = None
            if engines and rng.random_sample() < targeted_p:
                engine = str(engines[rng.randint(len(engines))])
            specs.append(FaultSpec(
                kind=kind, point=point, at=int(rng.randint(horizon)),
                engine=engine,
                delay_s=float(rng.random_sample()) * max_delay_s
                if kind in ("straggler", "queue_stall") else 0.0))
        return cls(specs)

    # -- serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(s) for s in self.specs])

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls([FaultSpec(**d) for d in json.loads(text)])


class FaultInjector:
    """Fires a :class:`FaultPlan` at named cut points and records what
    it did.

        inj = FaultInjector(FaultPlan.generate(seed=7))
        action = inj.fire("dispatch", engine="e0")   # None or a kind

    ``fire`` raises :class:`InjectedEngineDeath` for ``engine_death``,
    sleeps through ``straggler``/``queue_stall`` (still returning the
    kind so the caller can account for it), and returns ``nan_output``
    for the caller to apply (only the caller knows the output shape).

    ``trace`` is the replay record: one dict per injection, in firing
    order: replaying a plan twice over a scripted call sequence gives
    identical traces.  Each fault in
    the plan fires at most once.
    """

    def __init__(self, plan: FaultPlan | None = None, *,
                 sleep=time.sleep, on_fire=None):
        self.plan = plan or FaultPlan()
        self._sleep = sleep
        #: optional callback(point, kind, engine) per injection, fired
        #: outside the lock (the pool wires obs counters through it)
        self.on_fire = on_fire
        self._counts: dict = {}        # (point, engine-or-None) -> calls
        self._fired: set = set()       # indices into plan.specs
        self.trace: list[dict] = []
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self.plan.specs)

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def fire(self, point: str, engine: str | None = None) -> str | None:
        """Advance the (point, engine) trigger counters and inject the
        first unfired matching fault, if any.  Returns the injected
        kind (or None); raises for ``engine_death``."""
        if point not in CUT_POINTS:
            raise ValueError(
                f"unknown cut point {point!r}; known: {CUT_POINTS}")
        delay = None
        with self._lock:
            n_global = self._counts.get((point, None), 0)
            self._counts[(point, None)] = n_global + 1
            n_engine = None
            if engine is not None:
                n_engine = self._counts.get((point, engine), 0)
                self._counts[(point, engine)] = n_engine + 1
            hit = None
            for i, s in enumerate(self.plan.specs):
                if i in self._fired or s.point != point:
                    continue
                if s.engine is None:
                    if s.at != n_global:
                        continue
                elif s.engine != engine or s.at != n_engine:
                    continue
                hit = (i, s)
                break
            if hit is None:
                return None
            i, s = hit
            self._fired.add(i)
            self.trace.append({
                "seq": len(self.trace), "point": point, "engine": engine,
                "kind": s.kind, "at": s.at, "spec": i})
            if s.kind in ("straggler", "queue_stall"):
                delay = s.delay_s
        if self.on_fire is not None:
            self.on_fire(point, s.kind, engine)
        # sleep OUTSIDE the lock: a straggler hold must not serialize
        # concurrent fire() calls from other pool workers
        if delay is not None:
            self._sleep(delay)
            return s.kind
        if s.kind == "engine_death":
            raise InjectedEngineDeath(
                f"injected engine death at {point} "
                f"(engine={engine!r}, call #{s.at})")
        return s.kind                  # nan_output: caller applies it


class NullInjector(FaultInjector):
    """The default injector: no plan, ``fire`` is a cheap no-op that
    still validates the cut-point name (typos in cut points must fail
    tests, not silently never fire)."""

    def __init__(self):
        super().__init__(FaultPlan())

    def fire(self, point: str, engine: str | None = None) -> None:
        if point not in CUT_POINTS:
            raise ValueError(
                f"unknown cut point {point!r}; known: {CUT_POINTS}")
        return None
