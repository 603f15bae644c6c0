"""The port's fault-tolerant serving (``repro_torch.serving.resilience``,
``repro_torch.runtime.{chaos,fault}``) on the CPU.

Held against the JAX package: fault plans and their JSON for the same
seeds, the injector's firing sequences, ``ShardPlan.reassign``,
``StragglerPolicy``, the degradation ladder's rung for each live count,
``validate_output`` and the Prometheus text of ``bind_pool``.  Then the
JAX package's pool tests on the port's engines (retry past a death, NaN
quarantine, hedging, bounded requeue, the ladder engaging and reversing,
drain/join, the snapshot round-trip, a wedged engine), and the chaos
property over a fixed list of seeds.

The chaos property holds the port's pool to the port's own single-engine
eager oracle, NOT to the JAX package's pool: the JAX package's chaos
test (``tests/test_resilience.py``) fails on every run, because it
compares a request served inside a consolidated bucket with the same
request served alone, and XLA's results differ in the last bit between
batch shapes.  torch's CPU convolutions do too, so the oracle here is
the lone engine's ``infer`` of the bucket as it was dispatched (its
images, admission alpha and padding): what ``AsyncDartServer`` over one
engine returns for it.  Untouched requests must equal that bit for bit,
and the JAX eager ``DartEngine`` on the converted weights, fed the same
bucket, outside counted gate-edge rows.

No test depends on how long anything takes: a straggler is held on an
event until the hedge has answered, and every wait is bounded."""
import json
import threading
import time

import numpy as np
import pytest
import torch

import repro.obs as jobs
from _torch_serving import BUCKETS, CAL_ATOL, EDGE, host, make_pair
from repro.runtime import chaos as jchaos
from repro.runtime import fault as jfault
from repro.serving import resilience as jres
from repro_torch import obs
from repro_torch.engine import DartEngine
from repro_torch.obs import metrics as M
from repro_torch.runtime import fault
from repro_torch.runtime.chaos import (FaultInjector, FaultPlan, FaultSpec,
                                       InjectedEngineDeath, NullInjector)
from repro_torch.serving import (AsyncDartServer, DispatchError, EnginePool,
                                 NoHealthyEngines, PooledDartServer,
                                 RequestShed, ResilienceConfig,
                                 SchedulerConfig)
from repro_torch.serving import resilience as res

torch.set_num_threads(1)

#: the chaos property's seeds (fixed: a case that fails once fails again)
CHAOS_SEEDS = (0, 1, 2, 3, 4, 5, 6, 7)
#: bound on every wait for a future (seconds)
WAIT_S = 30.0


@pytest.fixture(scope="module")
def pair():
    """JAX and port AlexNet-tiny engines on one set of weights, tau at
    each exit's calibration median (rows exit at every stage)."""
    return make_pair("alexnet-tiny")


def _engine(pair):
    """A fresh port engine on the pair's weights and policy."""
    eng = DartEngine.from_config(pair.eng.cfg, pair.eng.params,
                                 device="cpu", buckets=BUCKETS, adapt=False)
    eng.state = pair.states[1]
    return eng


def _rcfg(**kw):
    kw.setdefault("backoff_s", 0.001)
    kw.setdefault("requeue_backoff_s", 0.001)
    return ResilienceConfig(**kw)


def _server(pool, **cfg):
    cfg.setdefault("edges", ())
    cfg.setdefault("max_batch", 4)
    return PooledDartServer(pool, SchedulerConfig(**cfg), start=False)


def _drive(srv, futs, rounds=400):
    for _ in range(rounds):
        if all(f.done() for f in futs):
            return
        srv.flush()
        time.sleep(0.002)
    raise AssertionError("futures did not resolve while driving")


class _Dummy:
    """A pool member for the tests of the pool's bookkeeping alone."""


# ---------------------------------------------------------------------------
# the host-side pieces, against the JAX package
# ---------------------------------------------------------------------------

PLAN_KW = [dict(n_faults=6), dict(n_faults=3, horizon=8, max_delay_s=0.02),
           dict(n_faults=9, engines=("a", "b", "c"), targeted_p=0.5),
           dict(n_faults=4, engines=(), points=("step",)),
           dict(n_faults=5, kinds=("straggler", "queue_stall"))]


@pytest.mark.parametrize("seed", (0, 11, 23, 9999))
@pytest.mark.parametrize("kw", range(len(PLAN_KW)))
def test_fault_plan_and_json_match_jax(seed, kw):
    plan = FaultPlan.generate(seed, **PLAN_KW[kw])
    jplan = jchaos.FaultPlan.generate(seed, **PLAN_KW[kw])
    assert plan.to_json() == jplan.to_json()
    assert FaultPlan.from_json(jplan.to_json()).specs == plan.specs
    assert len(plan) == len(jplan) and list(plan) == list(
        FaultPlan.from_json(plan.to_json()))


def test_fault_spec_validation_matches_jax():
    for args in (("melted", "step", 0), ("straggler", "nowhere", 0),
                 ("straggler", "step", -1)):
        with pytest.raises(ValueError) as e:
            FaultSpec(*args)
        with pytest.raises(ValueError) as je:
            jchaos.FaultSpec(*args)
        assert str(e.value) == str(je.value)


def _scripted_fire(inj):
    """A fixed fire() sequence (what a scheduler run would produce)."""
    out = []
    for _ in range(12):
        for eng in ("e0", "e1"):
            for point in ("dispatch", "step", "complete"):
                try:
                    out.append(inj.fire(point, engine=eng))
                except (InjectedEngineDeath,
                        jchaos.InjectedEngineDeath) as e:
                    out.append((type(e).__name__, str(e)))
    return out, inj.trace, inj.counts()


@pytest.mark.parametrize("seed", (5, 23, 42))
def test_injector_firing_sequences_match_jax(seed):
    """The same plan through the same fire() calls: the same returns,
    deaths, trace and counters as the JAX injector; a replay gives the
    same trace; each fault fires once."""
    text = FaultPlan.generate(seed, n_faults=8, horizon=12).to_json()
    slept, jslept = [], []
    got = _scripted_fire(FaultInjector(FaultPlan.from_json(text),
                                       sleep=slept.append))
    want = _scripted_fire(jchaos.FaultInjector(
        jchaos.FaultPlan.from_json(text), sleep=jslept.append))
    assert got == want and slept == jslept
    assert len(got[1]) > 0
    assert _scripted_fire(FaultInjector(FaultPlan.from_json(text),
                                        sleep=lambda _: None))[1] == got[1]
    assert len({t["spec"] for t in got[1]}) == len(got[1])


def test_targeted_spec_counts_per_engine_and_fires_once():
    inj = FaultInjector(FaultPlan([
        FaultSpec("nan_output", "step", 1, engine="e1")]))
    assert inj.fire("step", engine="e0") is None
    assert inj.fire("step", engine="e1") is None
    assert inj.fire("step", engine="e1") == "nan_output"
    assert inj.fire("step", engine="e1") is None
    assert inj.counts()[("step", "e1")] == 3
    assert not NullInjector().enabled and inj.enabled
    with pytest.raises(ValueError, match="unknown cut point"):
        NullInjector().fire("dispach")


def test_shard_plan_and_straggler_policy_match_jax():
    idx = np.arange(67)
    workers = ["a", "b", "c", "d"]
    plan, jplan = (m.ShardPlan.even(workers, idx) for m in (fault, jfault))
    for straggler in workers:
        got, want = plan.reassign(straggler), jplan.reassign(straggler)
        assert list(got.assignments) == list(want.assignments)
        for w in want.assignments:
            np.testing.assert_array_equal(got.assignments[w],
                                          want.assignments[w])
        np.testing.assert_array_equal(
            np.sort(np.concatenate(list(got.assignments.values()))), idx)
    pol, jpol = (m.StragglerPolicy(factor=3.0, window=5)
                 for m in (fault, jfault))
    assert pol.deadline() == jpol.deadline() == float("inf")
    for dt in np.random.RandomState(0).rand(12) * 0.1:
        pol.record(float(dt))
        jpol.record(float(dt))
        assert pol.deadline() == jpol.deadline()
        for probe in (0.05, 0.2, 0.4):
            assert pol.is_straggling(probe) == jpol.is_straggling(probe)


@pytest.mark.parametrize("n", range(1, 7))
def test_ladder_rung_for_each_live_count_matches_jax(n):
    names = [f"e{i}" for i in range(n)]
    pool = EnginePool({k: _Dummy() for k in names}, heartbeat=False)
    jpool = jres.EnginePool({k: _Dummy() for k in names}, heartbeat=False)
    try:
        for live in range(n + 1):
            assert pool._ladder_rung_for(live) == jpool._ladder_rung_for(
                live)
        # and the ladder as deaths come one by one
        for k in names:
            pool._mark_dead(k, reason="test")
            jpool._mark_dead(k, reason="test")
            assert pool.rung == jpool.rung
            assert (pool.alpha_scale, pool.shed_floor) == (
                jpool.alpha_scale, jpool.shed_floor)
        assert [h["to"] for h in pool.rung_history] == [
            h["to"] for h in jpool.rung_history]
    finally:
        pool.close()
        jpool.close()


VALIDATE_CASES = [
    {"conf": np.array([0.5, 0.9]), "exit_idx": np.array([0, 1])},
    {"conf": np.array([0.5, np.nan])},
    {"conf": np.array([np.inf, np.nan, 0.1])},
    {"conf": np.array([0.5]), "exit_idx": np.array([7])},
    {"conf": np.array([0.5]), "exit_idx": np.array([-1, 2])},
    {"exit_idx": np.array([], np.int64)},
    (np.zeros((1, 2), np.int32), np.array([[9]], np.int32)),
    (np.zeros((1, 2), np.int32), np.array([[1, 2]], np.int32)),
    "not an output"]


@pytest.mark.parametrize("i", range(len(VALIDATE_CASES)))
def test_validate_output_matches_jax(i):
    def outcome(fn):
        try:
            fn(VALIDATE_CASES[i], n_exits=3)
            return None
        except Exception as e:                 # noqa: BLE001
            return type(e).__name__, str(e)
    assert outcome(res.validate_output) == outcome(jres.validate_output)


@pytest.fixture
def both_obs():
    for o in (obs, jobs):
        o.reset()
        o.configure(enabled=True)
    yield
    for o in (obs, jobs):
        o.reset()


def _pool_families(text):
    keep = ("dart_engine_health", "dart_degradation_rung",
            "dart_pool_events_total", "dart_retries_total",
            "dart_hedges_total", "dart_faults_injected_total",
            "dart_hedge_deadline_ms", "dart_requeues_total")
    return {n: f for n, f in M.parse_prometheus(text).items() if n in keep}


def test_bind_pool_text_matches_jax(both_obs):
    """The same pool events on both sides: the same Prometheus families,
    labels and values (health, rung, event totals, retries, hedges,
    faults, the hedge deadline)."""
    from repro.obs import adapters as jOBS_A
    from repro_torch.obs import adapters as OBS_A
    plan = FaultPlan([FaultSpec("nan_output", "dispatch", 0),
                      FaultSpec("straggler", "step", 1, delay_s=0.0)])
    pools = []
    for m, A, Inj, P in ((res, OBS_A, FaultInjector, FaultPlan),
                         (jres, jOBS_A, jchaos.FaultInjector,
                          jchaos.FaultPlan)):
        inj = Inj(P.from_json(plan.to_json()), sleep=lambda _: None)
        pool = m.EnginePool({k: _Dummy() for k in ("a", "b", "c", "d")},
                            injector=inj, heartbeat=False)
        pools.append(pool)
        pool._mark_dead("b", reason="test")
        pool.drain("c")
        pool._note_failure("a", RuntimeError("x"))
        for dt in (0.01, 0.02, 0.03):
            pool.straggler.record(dt)
        for point in ("dispatch", "step", "step"):
            inj.fire(point, engine="a")
        pool.counters["calls"] += 5
        A.record_retry("a", 1)
        A.record_hedge("a", "d")
        A.record_requeue(3)
    text, jtext = obs.OBS.registry.render(), jobs.OBS.registry.render()
    got, want = _pool_families(text), _pool_families(jtext)
    assert set(want) == {"dart_engine_health", "dart_degradation_rung",
                         "dart_pool_events_total", "dart_retries_total",
                         "dart_hedges_total", "dart_faults_injected_total",
                         "dart_hedge_deadline_ms", "dart_requeues_total"}
    assert got == want
    for p in pools:
        p.close()


# ---------------------------------------------------------------------------
# structured failures: the daemon survives a bad bucket
# ---------------------------------------------------------------------------

class _Boom(RuntimeError):
    pass


def test_dispatch_failure_fails_its_bucket_and_the_daemon_lives(pair):
    eng = _engine(pair)
    x = pair.images[:4]
    with AsyncDartServer(eng, SchedulerConfig(max_batch=4,
                                              flush_ms=1.0)) as srv:
        orig, calls = srv._engine_call, []

        def call(fn):
            calls.append(1)
            if len(calls) == 1:
                raise _Boom("injected dispatch failure")
            return orig(fn)
        srv._engine_call = call
        with pytest.raises(DispatchError) as ei:
            srv.submit(x[:2]).result(timeout=WAIT_S)
        assert ei.value.stage == "dispatch"
        assert isinstance(ei.value.cause, _Boom)
        assert srv._thread.is_alive()
        assert srv.submit(x[2:]).result(timeout=WAIT_S)["pred"].shape == (2,)
    assert srv.counters["dispatch_errors"] == 1


def test_complete_failure_is_structured(pair):
    srv = AsyncDartServer(_engine(pair), SchedulerConfig(max_batch=4),
                          start=False)
    orig, calls = srv._complete, []

    def complete(reqs, out, t0):
        calls.append(1)
        if len(calls) == 1:
            raise _Boom("injected completion failure")
        return orig(reqs, out, t0)
    srv._complete = complete
    f1 = srv.submit(pair.images[:2])
    _drive(srv, [f1])
    with pytest.raises(DispatchError) as ei:
        f1.result(timeout=WAIT_S)
    assert ei.value.stage == "complete"
    f2 = srv.submit(pair.images[2:4])
    _drive(srv, [f2])
    assert f2.result(timeout=WAIT_S)["pred"].shape == (2,)
    assert srv.counters["complete_errors"] == 1
    srv.close()


# ---------------------------------------------------------------------------
# EnginePool mechanics
# ---------------------------------------------------------------------------

def test_pool_retries_past_injected_death_and_ladder_engages(pair):
    e0, e1 = _engine(pair), _engine(pair)
    inj = FaultInjector(FaultPlan([
        FaultSpec("engine_death", "step", 0, engine="e0")]))
    pool = EnginePool({"e0": e0, "e1": e1}, _rcfg(), injector=inj,
                      heartbeat=False)
    srv = _server(pool)
    futs = [srv.submit(pair.images[2 * i:2 * i + 2]) for i in range(4)]
    _drive(srv, futs)
    for f in futs:
        assert f.result(timeout=WAIT_S)["pred"].shape == (2,)
    p = srv.stats()["pool"]
    assert p["deaths"] == 1 and p["retries"] >= 1
    assert p["faults_injected"] == 1
    assert p["rung"] == 2 and p["engines"]["e0"] == "dead"
    assert p["touched_rids"] >= 2
    # the timeline: e0's death, then the pool's next success, on e1
    assert [(e, n) for _, e, n in pool.timeline] == [("death", "e0"),
                                                     ("success", "e1")]
    (rec,) = pool.recovery_s()
    assert rec is not None and rec >= 0
    srv.close()
    pool.close()


def test_pool_quarantines_nan_output_and_serves_from_peer(pair):
    e0, e1 = _engine(pair), _engine(pair)
    inj = FaultInjector(FaultPlan([FaultSpec("nan_output", "step", 0)]))
    pool = EnginePool({"e0": e0, "e1": e1}, _rcfg(), injector=inj,
                      heartbeat=False)
    srv = _server(pool)
    f = srv.submit(pair.images[:2])
    _drive(srv, [f])
    out = f.result(timeout=WAIT_S)
    assert np.all(np.isfinite(out["conf"]))      # the NaN never leaked
    p = srv.stats()["pool"]
    assert p["quarantined"] == 1 and p["retries"] == 1
    assert p["touched_rids"] == 1
    assert sorted(p["engines"].values()) == ["degraded", "healthy"]
    srv.close()
    pool.close()


def test_pool_hedges_straggler_first_result_wins(pair):
    """The straggler is held on an event until the hedge has answered:
    the call returns the peer's result while the first engine is still
    held."""
    e0, e1 = _engine(pair), _engine(pair)
    x = pair.images[:2]
    release = threading.Event()
    inj = FaultInjector(FaultPlan([FaultSpec("straggler", "step", 0,
                                             delay_s=WAIT_S)]),
                        sleep=release.wait)
    pool = EnginePool({"e0": e0, "e1": e1},
                      _rcfg(hedge_factor=3.0, straggler_window=10),
                      injector=inj, heartbeat=False)
    for _ in range(6):
        pool.straggler.record(0.02)              # a 60 ms hedge deadline
    try:
        out = pool.call(lambda eng: eng.infer(x, mode="masked",
                                              record=False))
        held = not release.is_set()
    finally:
        release.set()
    assert held
    assert out["pred"].shape == (2,) and isinstance(out["pred"], np.ndarray)
    alone = e1.infer(x, mode="masked", record=False)
    np.testing.assert_array_equal(out["conf"], alone["conf"].numpy())
    st = pool.stats()
    assert st["hedges"] == 1 and st["stragglers"] == 1
    assert st["straggler_deadline_ms"] is not None
    pool.close()


def test_requeue_is_bounded_when_nothing_is_live(pair):
    pool = EnginePool({"e0": _engine(pair), "e1": _engine(pair)},
                      _rcfg(requeue_limit=3), heartbeat=False)
    pool._mark_dead("e0", reason="test")
    pool._mark_dead("e1", reason="test")
    srv = _server(pool)
    # priority above the rung-4 shed floor: reaches the requeue path
    f = srv.submit(pair.images[:2], priority=5)
    srv.flush()
    with pytest.raises(DispatchError) as ei:
        f.result(timeout=WAIT_S)
    assert isinstance(ei.value.cause, NoHealthyEngines)
    assert srv.counters["requeued"] == 3
    assert srv.stats()["pool"]["requeues"] == 3
    srv.close()
    pool.close()


def test_ladder_rungs_engage_and_reverse(pair):
    """Four pool slots over one engine: three dead -> rung 3 scales tau
    and caps the depth (the gate past the cap always fires, in both
    modes); the fourth dead -> rung 4 sheds below the floor; joins
    reverse everything."""
    e0 = _engine(pair)
    orig_tau = e0.state.tau.numpy().copy()
    pool = EnginePool({n: e0 for n in "abcd"}, _rcfg(), heartbeat=False)
    srv = _server(pool)
    for name in "abc":
        pool._mark_dead(name, reason="test")
    assert pool.rung == 3
    tau = e0.state.tau.numpy()
    cap = int(np.floor(tau.size * res.DEPTH_CAP_FRAC))
    np.testing.assert_allclose(tau[:cap], orig_tau[:cap]
                               * res.DEGRADED_TAU_SCALE, rtol=1e-6)
    assert (tau[cap:] == res._TAU_ALWAYS_FIRE).all()
    assert pool.alpha_scale == res.DEGRADED_ALPHA_SCALE
    x = pair.images
    for mode in ("masked", "compacted"):
        out = e0.infer(x, mode=mode, record=False)
        assert host(out["exit_idx"]).max() <= cap, mode
    pool._mark_dead("d", reason="test")
    assert pool.rung == 4 and pool.shed_floor is not None
    with pytest.raises(RequestShed):
        srv.submit(x[:2], priority=0).result(timeout=WAIT_S)
    assert srv.counters["shed_degraded"] == 1
    for name in "abcd":
        pool.join(name, warm=False)
    assert pool.rung == 0 and pool.shed_floor is None
    assert pool.alpha_scale == 1.0
    np.testing.assert_array_equal(e0.state.tau.numpy(), orig_tau)
    hist = [h["to"] for h in pool.rung_history]
    assert hist[-1] == 0 and max(hist) == 4
    srv.close()
    pool.close()


def test_rung_change_during_a_call_keeps_the_rungs_tau(pair, monkeypatch):
    """A rung that moves while a call on a pool worker is between its
    read of the engine's state and its write (held on an Event inside
    the telemetry fold) is not undone by that write: after the call the
    engine's tau is the rung's, the call's rows are counted, and the
    host copy of the policy follows."""
    from repro_torch.core import adaptive
    e0 = DartEngine.from_config(pair.eng.cfg, pair.eng.params,
                                device="cpu", buckets=BUCKETS, adapt=True)
    e0.state = pair.states[1]
    orig_tau = e0.state.tau.numpy().copy()
    pool = EnginePool({"e0": e0, "e1": _engine(pair)}, _rcfg(hedge=False),
                      heartbeat=False)
    entered, release = threading.Event(), threading.Event()
    record_batch = adaptive.record_batch

    def held(*a, **kw):
        entered.set()
        assert release.wait(WAIT_S)
        return record_batch(*a, **kw)
    monkeypatch.setattr(adaptive, "record_batch", held)
    x = pair.images[:4]
    out = {}
    call = threading.Thread(target=lambda: out.update(pool.call(
        lambda _eng: e0.infer(x, mode="compacted", record=True))))
    call.start()
    assert entered.wait(WAIT_S)
    drain = threading.Thread(target=pool.drain, args=("e1",))
    drain.start()
    t0 = time.monotonic()
    while pool.rung != 2 and time.monotonic() - t0 < WAIT_S:
        time.sleep(0.001)
    assert pool.rung == 2
    release.set()
    call.join(WAIT_S)
    drain.join(WAIT_S)
    assert not call.is_alive() and not drain.is_alive()
    assert out["pred"].shape == (4,)
    tau = e0.state.tau.numpy()
    np.testing.assert_allclose(tau, orig_tau * res.DEGRADED_TAU_SCALE,
                               rtol=1e-6)
    assert int(e0.state.served) == int(pair.states[1].served) + 4
    np.testing.assert_array_equal(e0._policy_host()[0], tau)
    pool.close()


def test_drain_is_not_a_failure_and_join_restores_from_snapshot(pair,
                                                                tmp_path):
    """drain: no death, rung 2; join(snapshot=) restores the snapshot's
    EngineState into the joining engine, warms the served bucket shapes
    (counted apart from served calls) and takes traffic again."""
    e0, e1 = _engine(pair), _engine(pair)
    pool = EnginePool({"e0": e0, "e1": e1}, _rcfg(), heartbeat=False)
    srv = _server(pool)
    futs = [srv.submit(pair.images[2 * i:2 * i + 2]) for i in range(4)]
    _drive(srv, futs)
    snap = str(tmp_path / "snap")
    srv.snapshot(snap, step=3)
    pool.drain("e1")
    st = pool.stats()
    assert st["engines"]["e1"] == "drained"
    assert st["deaths"] == 0 and st["drains"] == 1 and pool.rung == 2
    fresh = _engine(pair)
    warmed = []
    orig = fresh.infer
    fresh.infer = lambda *a, **k: warmed.append(a[0].shape) or orig(*a, **k)
    pool.join("e1", fresh, snapshot=snap)
    assert pool.engines["e1"] is fresh
    assert pool.stats()["engines"]["e1"] == "healthy"
    assert pool.rung == 0 and pool.stats()["joins"] == 1
    assert warmed and all(s[0] == 4 for s in warmed)
    assert int(fresh.state.served) == int(srv.engine.state.served) > 0
    assert [(e, n) for _, e, n in pool.timeline] == [("drain", "e1"),
                                                     ("join", "e1")]
    assert pool.recovery_s() == []
    f = srv.submit(pair.images[10:12])
    _drive(srv, [f])
    assert f.result(timeout=WAIT_S)["pred"].shape == (2,)
    srv.close()
    pool.close()


def test_snapshot_roundtrip_restores_learned_priors(pair, tmp_path):
    pool = EnginePool({"e0": _engine(pair), "e1": _engine(pair)}, _rcfg(),
                      heartbeat=False)
    srv = _server(pool, predict="conservative")
    futs = [srv.submit(pair.images[2 * i:2 * i + 2]) for i in range(6)]
    _drive(srv, futs)
    [f.result(timeout=WAIT_S) for f in futs]
    snap = str(tmp_path / "snap")
    srv.snapshot(snap, step=7)
    learned = (srv.planner.state_dict(), srv.predictor.state_dict())
    state = srv.engine.state
    srv.close()
    pool.close()
    with open(f"{snap}/serving_state.json") as f:
        assert json.load(f)["step"] == 7

    pool2 = EnginePool({"e0": _engine(pair), "e1": _engine(pair)}, _rcfg(),
                       heartbeat=False)
    srv2 = _server(pool2, predict="conservative")
    assert srv2.planner.state_dict() != learned[0]
    assert srv2.restore_snapshot(snap) == 7
    assert (srv2.planner.state_dict(), srv2.predictor.state_dict()) \
        == learned
    for eng in pool2.engines.values():
        assert int(eng.state.served) == int(state.served)
        assert torch.equal(eng.state.lat_ms, state.lat_ms)
    srv2.close()
    pool2.close()


def test_wedged_engine_is_declared_dead_and_call_rerouted(pair):
    e0, e1 = _engine(pair), _engine(pair)
    x = pair.images[:2]
    e1.infer(x, mode="masked", record=False)
    pool = EnginePool({"e0": e0, "e1": e1},
                      _rcfg(call_timeout_s=3.0, hedge=False, retries=2),
                      heartbeat=False)
    release = threading.Event()

    def wedge_or_serve(eng):
        if eng is e0:
            release.wait(WAIT_S)                 # a stuck engine call
            raise RuntimeError("was wedged")
        return eng.infer(x, mode="masked", record=False)
    pool._rr = len(pool.engines) - 1             # the first pick is e0
    try:
        out = pool.call(wedge_or_serve)
    finally:
        release.set()
    assert out["pred"].shape == (2,)
    assert pool.stats()["engines"]["e0"] == "dead"
    pool.close()


def test_heartbeat_monitor_declares_a_silent_worker_dead():
    """The silent worker is declared dead within a bounded wait; the
    callback may re-enter the monitor."""
    failures = []
    mon = None

    def on_failure(w):
        failures.append(w)
        mon.add_worker(w + "-replacement")
        mon.remove_worker(w + "-replacement")

    mon = fault.HeartbeatMonitor(["w0", "w1"], timeout_s=2.0,
                                 on_failure=on_failure)
    t0 = time.monotonic()
    while "w1" not in failures and time.monotonic() - t0 < WAIT_S:
        mon.beat("w0")
        time.sleep(0.01)
    mon.close()
    assert "w1" in failures and "w1" in mon.dead
    assert "w1-replacement" not in mon.workers()


def test_cascade_and_lm_pools_wait_for_their_slices():
    """The cascade pool waits for item 7; the LM pool came with item 5
    (test_torch_lm_session.py drives it through an engine death)."""
    pool = EnginePool({"a": _Dummy()}, heartbeat=False)
    with pytest.raises(NotImplementedError, match="item 7"):
        res.pooled_cascade_server(pool)
    pool.close()
    from repro_torch.configs.tinyllama_1_1b import REDUCED
    from repro_torch.core.routing import DartParams
    from repro_torch.engine.lm import LMDecodeEngine
    from repro_torch.models.transformer_lm import lm_init
    eng = LMDecodeEngine(REDUCED, lm_init(REDUCED, device="cpu"),
                         DartParams.default(REDUCED.n_exits), device="cpu")
    pool = EnginePool({"l0": eng}, heartbeat=False)
    sess = res.pooled_lm_session(pool, start=False)
    assert sess.pool is pool and sess.engine is eng
    sess.close()
    pool.close()


# ---------------------------------------------------------------------------
# the chaos property
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_streams_resolve_exactly_once_and_match_oracle(pair, seed):
    """Seeded request streams x seeded fault plans: every future resolves
    exactly once (a result or a structured error); untouched requests
    equal the port's single-engine oracle on their bucket bit for bit,
    and JAX's eager engine on it outside counted gate-edge rows (see the
    module docstring for why not JAX's pool)."""
    rs = np.random.RandomState(seed)
    # about as many engine calls as the horizon, so that most faults fire
    plan = FaultPlan.generate(seed, n_faults=int(rs.randint(2, 7)),
                              engines=("e0", "e1"), horizon=8,
                              max_delay_s=0.02)
    e0, e1, oracle = _engine(pair), _engine(pair), _engine(pair)
    pool = EnginePool({"e0": e0, "e1": e1}, _rcfg(call_timeout_s=10.0),
                      injector=FaultInjector(plan), heartbeat=False)
    srv = _server(pool, max_batch=int(rs.choice([4, 8])))
    buckets = {}                                 # rid -> the last dispatch
    infer_batch = srv._infer_batch

    def logged(reqs, x, alpha):
        for i, r in enumerate(reqs):
            buckets[r.rid] = (reqs, x, alpha, i)
        return infer_batch(reqs, x, alpha)
    srv._infer_batch = logged
    n_req = int(rs.randint(12, 24))
    spans, futs, resolutions = [], [], []
    for rid in range(n_req):
        n = int(rs.randint(1, 4))
        a = int(rs.randint(0, len(pair.images) - n))
        spans.append((a, n))
        f = srv.submit(pair.images[a:a + n])
        f.add_done_callback(lambda _f, rid=rid: resolutions.append(rid))
        futs.append(f)
    _drive(srv, futs, rounds=600)
    assert sorted(resolutions) == list(range(n_req))     # exactly once
    p = srv.stats()["pool"]
    assert p["faults_injected"] <= len(plan)
    assert p["deaths"] <= 2
    assert p["quarantined"] <= p["retries"] + 1
    n_checked = n_rows = n_edge = 0
    for rid, f in enumerate(futs):
        exc = f.exception(timeout=1)
        if exc is not None:
            assert isinstance(exc, (DispatchError, RequestShed))
            continue
        out = f.result()
        assert np.all(np.isfinite(out["conf"]))
        if rid in srv.touched_rids:
            continue
        reqs, x, alpha, i = buckets[rid]
        lo = sum(r.n for r in reqs[:i])
        sl = slice(lo, lo + reqs[i].n)
        pad_to = oracle.bucket_key(x.shape[0])
        ref = oracle.infer(x, mode="masked", record=False, alpha=alpha,
                           pad_to=pad_to)
        for k in ("pred", "exit_idx", "conf", "alpha"):
            np.testing.assert_array_equal(out[k], host(ref[k])[sl],
                                          err_msg=k)
        jref = pair.jeng.infer(x, mode="masked", record=False, alpha=alpha,
                               pad_to=pad_to)
        conf = ref["conf_stack"].numpy()[:-1].T[sl]
        edge = np.abs(conf - ref["eff_thresholds"].numpy()[sl]).min(
            axis=1) < EDGE
        for k in ("pred", "exit_idx"):
            np.testing.assert_array_equal(out[k][~edge],
                                          host(jref[k])[sl][~edge],
                                          err_msg=k)
        np.testing.assert_allclose(out["conf"], host(jref["conf"])[sl],
                                   atol=CAL_ATOL, rtol=0)
        n_checked += 1
        n_rows += reqs[i].n
        n_edge += int(edge.sum())
    # the comparison ran, and few of its rows sat on a gate's edge
    assert n_checked >= 1
    assert n_edge <= max(1, n_rows // 10)
    srv.close()
    pool.close()
    pair.reset()
