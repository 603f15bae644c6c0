"""The LM decode sessions of the port on the CPU: ``LMDecodeSession``
(bucketed ``generate`` calls laned by ``(prompt_len, n_new)``),
``LMContinuousSession`` (slot refill over ``ContinuousLMDecoder``) and
``pooled_lm_session``, against the JAX package's sessions and the port's
own eager oracle.

Both packages take the same weights (the JAX init, converted) and the
same prompts; the scheduler clocks are fake and the sessions are driven
with ``start=False`` and ``pump()``.  Scheduling is held to JAX's
exactly: the flushes (reason, request ids, lane), the slot spans (slot
ids, pages in use, queue wait), the pool's occupancy and the
``starved`` reservations.  Tokens and exit stages: a session's equal
its engine's eager ``generate`` on the bucket it dispatched, exactly;
against JAX's eager ``generate``, equal outside rows whose first
divergent step the port's oracle flags (top-2 logit gap < GAP or
|conf - tau'| < EDGE at the deciding stage: float32 logits of the two
packages differ in the low bits), with the flagged rows counted.  The
JAX continuous decoder is never the oracle for tokens: it zeroes a host
buffer its asynchronous step may still read (ROADMAP queue 3), so its
routing varies from run to run; its slot timing, which no token
changes, is compared.
"""
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.core.routing import DartParams as JaxDart
from repro.engine import LMDecodeEngine as JaxEngine
from repro.models import layers as jL
from repro.models import transformer_lm as jTLM
from repro.parallel.sharding import unzip
from repro.serving import SchedulerConfig as JaxConfig
from repro_torch import convert
from repro_torch import obs
from repro_torch.core.routing import DartParams
from repro_torch.data import datasets as DS
from repro_torch.engine.lm import LMDecodeEngine
from repro_torch.models.transformer_lm import LMConfig
from repro_torch.obs import metrics as M
from repro_torch.runtime.chaos import FaultInjector, FaultPlan, FaultSpec
from repro_torch.runtime.trainer import TrainConfig, Trainer
from repro_torch.serving import (EnginePool, LMContinuousSession,
                                 LMDecodeSession, ResilienceConfig,
                                 SchedulerConfig, pooled_lm_session)
from repro_torch.serving.request import RequestRejected

torch.set_num_threads(1)

# the JAX package's session-test model (test_continuous_batching.py)
KW = dict(name="lm-sess-t", n_layers=4, d_model=32, n_heads=2,
          n_kv_heads=1, d_ff=64, vocab=32, exit_layers=(0, 2), max_seq=64,
          remat=False)
CFG = LMConfig(**KW)
JCFG = jTLM.LMConfig(**KW)
POOL = dict(n_slots=4, page_size=4, max_len=16)
BETA = 1e-3
GAP = 1e-4
EDGE = 1e-5
WAIT_S = 30.0


def _fold(key, name):
    """``repro.models.layers.rng`` with a hash-free fold per token."""
    for token in name.split("/"):
        key = jax.random.fold_in(key, zlib.crc32(token.encode()) % (2**31 - 1))
    return key


@pytest.fixture(scope="module")
def weights():
    """(JAX values, port tree) of one hash-free JAX init."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jL, "rng", _fold)
        values = jax.device_get(unzip(jTLM.lm_init(jax.random.key(0),
                                                   JCFG))[0])
    return values, convert.from_jax_params(values, CFG, device="cpu")


@pytest.fixture(scope="module")
def tau(weights):
    """Per-gate tau at the median of each gate's conf in a probing run
    (tau = 2: nothing fires there), lowered by the typical difficulty
    term, so rows leave at every stage.  Untrained, conf sits near 1/V:
    BETA is small so that the difficulty term does not put every tau'
    above every conf."""
    eng = LMDecodeEngine(CFG, weights[1], _dart(np.full(2, 2.0)),
                         device="cpu")
    conf = {0: [], 1: []}

    def probe(t, s, active, h, logits, c, eff):
        if s < 2:
            conf[s].append(c.numpy())
    eng._generate_eager(np.random.RandomState(0).randint(
        0, CFG.vocab, (8, 5)), 6, probe=probe)
    return np.array([np.median(np.concatenate(conf[s])) - BETA * 0.3
                     for s in (0, 1)], np.float32)


def _dart(tau, coef=(1.0, 1.0), beta=BETA):
    return DartParams(tau=torch.as_tensor(tau, dtype=torch.float32),
                      coef=torch.as_tensor(coef, dtype=torch.float32),
                      beta_diff=beta)


def _jdart(tau, coef=(1.0, 1.0), beta=BETA):
    return JaxDart(tau=jnp.asarray(tau, jnp.float32),
                   coef=jnp.asarray(coef, jnp.float32), beta_diff=beta)


def _engine(weights, tau, **kw):
    return LMDecodeEngine(CFG, weights[1], _dart(tau, **kw), device="cpu")


def _jengine(weights, tau, **kw):
    return JaxEngine(JCFG, weights[0], _jdart(tau, **kw))


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _log_dispatches(sess):
    """Record every dispatched bucket: (reason, rids, lane) and its
    prompts."""
    log = []
    inner = sess._dispatch_safe

    def logged(reqs, reason):
        log.append(((reason, [r.rid for r in reqs], reqs[0].lane),
                    np.concatenate([r.x for r in reqs]),
                    reqs[0].payload["n_new"]))
        return inner(reqs, reason)
    sess._dispatch_safe = logged
    return log


def _probe_oracle(eng, prompts, n_new, max_len=None):
    """The port's eager oracle with the flag rule's inputs per (row,
    step, stage): (conf, tau', top-2 gap)."""
    diag = {}

    def probe(t, s, active, h, logits, conf, eff):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        e = np.full(len(active), np.nan) if eff is None else eff.numpy()
        for k, r in enumerate(active):
            diag[(int(r), t, s)] = (float(conf[k]), float(e[k]),
                                    float(gap[k]))
    out = eng._generate_eager(prompts, n_new, max_len=max_len, probe=probe)
    return out, diag


def _flags(want, got, diag):
    """For each row where ``got`` leaves ``want``: whether the oracle
    flags its first divergent step."""
    (wt, ws), (gt, gs) = want, got
    flags = []
    for r in range(wt.shape[0]):
        bad = np.nonzero((wt[r] != gt[r]) | (ws[r] != gs[r]))[0]
        if not len(bad):
            continue
        t = int(bad[0])
        s = int(min(ws[r, t], gs[r, t]))
        conf, eff, gap = diag[(r, t, s)]
        flags.append(bool(gap < GAP or abs(conf - eff) < EDGE))
    return flags


# ---------------------------------------------------------------------------
# the bucketed session
# ---------------------------------------------------------------------------

#: (prompt_len, n_new, deadline_ms, clock advance after submit)
BURST = [(5, 4, None, 0.0), (5, 4, 30.0, 0.001), (7, 3, None, 0.0),
         (5, 4, None, 0.002), (7, 3, 5.0, 0.0), (5, 6, None, 0.001),
         (5, 4, None, 0.0), (7, 3, None, 0.004), (5, 4, 50.0, 0.0),
         (5, 6, None, 0.003)]


def _run_bucketed(sess, clock, prompts):
    futs = []
    for (s0, n_new, dl, dt), p in zip(BURST, prompts):
        futs.append(sess.submit(p, deadline_ms=dl, n_new=n_new))
        clock.advance(dt)
        sess.pump()
    for _ in range(50):
        clock.advance(0.002)
        while sess.pump():
            pass
    sess.close()
    return [f.result(timeout=WAIT_S) for f in futs]


def test_bucketed_session_flushes_and_tokens_match_jax(weights, tau):
    """The same burst through both packages' ``LMDecodeSession`` on fake
    clocks: the same flushes (reason, rids, lane), each request's tokens
    and stages its bucket's ``generate`` on the port exactly, and JAX's
    outside flagged rows; the same request telemetry."""
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, CFG.vocab, (int(rs.randint(1, 3)), s0))
               for s0, _, _, _ in BURST]
    cfg = dict(max_batch=4, flush_ms=2.0, policy="reject")
    clock, jclock = FakeClock(), FakeClock()
    eng = _engine(weights, tau)
    sess = eng.session(SchedulerConfig(**cfg), clock=clock, start=False)
    jsess = _jengine(weights, tau).session(JaxConfig(**cfg), clock=jclock,
                                           start=False)
    log, jlog = _log_dispatches(sess), _log_dispatches(jsess)
    outs = _run_bucketed(sess, clock, prompts)
    jouts = _run_bucketed(jsess, jclock, prompts)
    assert [e[0] for e in log] == [e[0] for e in jlog]
    assert {e[0][0] for e in log} >= {"deadline", "size", "hold"}
    oracle = _engine(weights, tau)
    flags, rows = [], 0
    for (_, rids, _), bucket, n_new in log:
        want, diag = _probe_oracle(oracle, bucket, n_new)
        got_t = np.concatenate([outs[i]["tokens"] for i in rids])
        got_s = np.concatenate([outs[i]["stages"] for i in rids])
        np.testing.assert_array_equal(got_t, want[0])
        np.testing.assert_array_equal(got_s, want[1])
        jgot = (np.concatenate([jouts[i]["tokens"] for i in rids]),
                np.concatenate([jouts[i]["stages"] for i in rids]))
        flags += _flags(want, jgot, diag)
        rows += len(bucket)
    assert all(flags), f"unflagged divergence from JAX: {flags}"
    assert len(flags) <= rows // 4, (len(flags), rows)
    for o, jo in zip(outs, jouts):
        assert o["lane"] == jo["lane"]
        assert o["latency_ms"] == pytest.approx(jo["latency_ms"], abs=1e-9)
        assert o["deadline_missed"] == jo["deadline_missed"]
    st, jst = sess.stats(), jsess.stats()
    assert st["scheduler"] == jst["scheduler"]
    assert st["requests"]["requests"] == jst["requests"]["requests"] == 10
    assert st["requests"]["deadline_miss"] == jst["requests"][
        "deadline_miss"]
    assert eng.stats()["requests"]["requests"] == 10


def test_session_serves_port_trained_weights_as_direct_generate():
    """JAX's test_serving.py LM case on the port: five ``Trainer`` steps
    of an LM, then four callers share one consolidated ``generate``
    call equal to serving the four prompts directly."""
    lc = LMConfig(name="lm-sess", n_layers=4, d_model=32, n_heads=2,
                  n_kv_heads=1, d_ff=64, vocab=32, exit_layers=(1,),
                  max_seq=32, remat=False)
    data = DS.DatasetConfig(name="tokens", n_train=128)
    tr = Trainer(lc, TrainConfig(batch_size=8, steps=5, lr=3e-3), data,
                 device="cpu")
    tr.run()
    dart = DartParams(tau=torch.tensor([0.3]), coef=torch.ones(1),
                      beta_diff=0.15)
    prompts, _ = DS.make_batch(data, range(4), kind="tokens", seq_len=9,
                               vocab=lc.vocab)
    ref_tok, ref_stg = LMDecodeEngine(lc, tr.params, dart,
                                      device="cpu").generate(prompts, 6)
    eng = LMDecodeEngine(lc, tr.params, dart, device="cpu")
    sess = eng.session(start=False, clock=FakeClock())
    futs = [sess.submit(prompts[i], n_new=6) for i in range(4)]
    sess.close()                            # flushes one consolidated call
    outs = [f.result(timeout=WAIT_S) for f in futs]
    np.testing.assert_array_equal(
        np.concatenate([o["tokens"] for o in outs]), ref_tok)
    np.testing.assert_array_equal(
        np.concatenate([o["stages"] for o in outs]), ref_stg)
    assert sess.counters["flush_forced"] == 1
    assert sess.stats()["requests"]["requests"] == 4


def test_conservative_session_runs_every_gate_and_matches_oracle(weights):
    """JAX's test_exit_predict.py LM case: a policy whose first gate can
    never fire (coef[0] tau[0] = 1.08 >= 1 at alpha >= 0) gives
    ``min_exit_bound`` 1 in both packages.  The port's session with
    prediction on skips no head (JAX skips them only on its sharded
    path), so its predictor reports no skip, and each bucket equals the
    eager oracle."""
    tau, coef, beta = (0.9, 0.1), (1.2, 1.0), 0.3
    eng = LMDecodeEngine(CFG, weights[1], _dart(tau, coef, beta),
                         device="cpu")
    jeng = JaxEngine(JCFG, weights[0], _jdart(tau, coef, beta))
    assert eng.min_exit_bound(0.0) == jeng.min_exit_bound(0.0) == 1
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, CFG.vocab, (3, 7)),
               rs.randint(0, CFG.vocab, (2, 7))]
    np.testing.assert_allclose(eng.prompt_alpha(prompts[0]),
                               jeng.prompt_alpha(prompts[0]), atol=1e-6)
    sess = eng.session(SchedulerConfig(max_batch=8, flush_ms=1.0,
                                       policy="reject",
                                       predict="conservative"),
                       clock=FakeClock(), start=False)
    log = _log_dispatches(sess)
    futs = [sess.submit(p, deadline_ms=60_000, n_new=6) for p in prompts]
    sess.close()
    outs = [f.result(timeout=WAIT_S) for f in futs]
    assert sess.predictor.stats()["skip_calls"] == 0
    assert sess.predictor.stats()["skip_stages"] == 0
    oracle = LMDecodeEngine(CFG, weights[1], _dart(tau, coef, beta),
                            device="cpu")
    for (_, rids, lane), bucket, n_new in log:
        assert len(lane) == 3                  # + the predicted band
        tok, stg = oracle.generate(bucket, n_new)
        np.testing.assert_array_equal(
            np.concatenate([outs[i]["tokens"] for i in rids]), tok)
        np.testing.assert_array_equal(
            np.concatenate([outs[i]["stages"] for i in rids]), stg)


# ---------------------------------------------------------------------------
# the continuous session
# ---------------------------------------------------------------------------

def _stream(seed, n_reqs, view_len):
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n_reqs):
        b = int(rs.randint(1, 3))
        s0 = int(rs.randint(2, 8))
        n_new = int(rs.randint(1, view_len - s0 + 2))
        reqs.append((rs.randint(0, CFG.vocab, (b, s0)), n_new))
    return reqs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_continuous_session_matches_oracles(weights, tau, seed):
    """A random stream through ``LMContinuousSession``: every request's
    tokens and stages equal the port's eager oracle at the decoder's
    view length exactly, and JAX's eager ``generate`` outside flagged
    rows; every slot and page back on the free lists; the request
    telemetry counted once per request."""
    eng = _engine(weights, tau)
    clock = FakeClock()
    sess = eng.session(continuous=True, clock=clock, start=False, **POOL)
    view = sess.decoder.view_len
    reqs = _stream(seed, 8, view)
    futs = []
    for i, (p, n) in enumerate(reqs):
        futs.append(sess.submit(p, n_new=n))
        clock.advance(0.001)
        if i % 3 == 2:
            sess.pump()
    sess.flush()
    outs = [f.result(timeout=WAIT_S) for f in futs]
    oracle = _engine(weights, tau)
    jeng = _jengine(weights, tau)
    flags, stages = [], set()
    for (p, n), o in zip(reqs, outs):
        want, diag = _probe_oracle(oracle, p, n, max_len=view)
        np.testing.assert_array_equal(o["tokens"], want[0])
        np.testing.assert_array_equal(o["stages"], want[1])
        stages |= set(np.unique(o["stages"]).tolist())
        jwant = jeng.generate(p, n, max_len=view, mode="eager")
        flags += _flags(want, jwant, diag)
    assert 0 in stages and len(stages) >= 2     # tokens left early
    assert all(flags), f"unflagged divergence from JAX eager: {flags}"
    assert sess.decoder.active_rows == 0
    assert sess.decoder.allocator.in_use == 0
    assert eng.stats()["requests"]["requests"] == len(reqs)
    assert sess.stats()["scheduler"]["completed"] == len(reqs)
    sess.close()


def test_continuous_session_on_its_worker_thread(weights, tau):
    """The same session served by its own dispatcher thread: every
    caller's tokens equal the per-request oracle (JAX's
    test_session_stream_matches_oracle)."""
    eng = _engine(weights, tau)
    sess = eng.session(continuous=True, **POOL)
    rs = np.random.RandomState(29)
    prompts = rs.randint(0, CFG.vocab, (6, 5))
    futs = [sess.submit(prompts[i], n_new=6) for i in range(6)]
    outs = [f.result(timeout=WAIT_S) for f in futs]
    view = sess.decoder.view_len
    sess.close()
    oracle = _engine(weights, tau)
    for i, o in enumerate(outs):
        tok, stg = oracle.generate(prompts[i:i + 1], 6, max_len=view)
        np.testing.assert_array_equal(o["tokens"], tok)
        np.testing.assert_array_equal(o["stages"], stg)
    assert eng.stats()["requests"]["requests"] == 6


def _cont_session(eng, clock, **cfg_kw):
    cfg = SchedulerConfig(policy="reject", flush_ms=0.0, **cfg_kw)
    return eng.session(continuous=True, cfg=cfg, clock=clock, start=False,
                       **POOL)


def test_starved_senior_reserves_freed_capacity(weights):
    """A wide request that cannot fit the busy pool is not backfilled
    around forever: after starve_ms, freed slots are held for it, so it
    completes before later juniors that would each fit."""
    eng = _engine(weights, np.ones(2))
    clock = FakeClock()
    sess = _cont_session(eng, clock, starve_ms=10.0)
    rs = np.random.RandomState(17)
    f_short = sess.submit(rs.randint(0, CFG.vocab, (2, 5)), n_new=2)
    f_long = sess.submit(rs.randint(0, CFG.vocab, (2, 5)), n_new=8)
    sess.pump()                      # both admitted: pool full
    assert sess.decoder.active_rows == 4
    big = sess.submit(rs.randint(0, CFG.vocab, (3, 5)), n_new=2)
    clock.advance(0.1)               # the senior is now starved
    # juniors in another lane (shorter prompts) are lane heads of their
    # own: only pop_next's reservation keeps them from backfilling
    smalls = [sess.submit(rs.randint(0, CFG.vocab, (1, 4)), n_new=2)
              for _ in range(3)]
    order = []
    for _ in range(200):
        sess.pump()
        for name, f in [("big", big)] + \
                [(f"s{i}", f) for i, f in enumerate(smalls)]:
            if f.done() and name not in order:
                order.append(name)
        if len(order) == 4:
            break
    assert f_short.done() and f_long.done()
    assert order[0] == "big", order
    assert set(order[1:]) == {"s0", "s1", "s2"}
    assert sess.stats()["scheduler"]["starved"] > 0
    sess.close()


def test_fresh_senior_is_not_reserved_for_prematurely(weights):
    """Before starve_ms, juniors may backfill around a senior that does
    not fit: reservation is a starvation remedy, not a blockade."""
    eng = _engine(weights, np.ones(2))
    clock = FakeClock()
    sess = _cont_session(eng, clock, starve_ms=10_000.0)
    rs = np.random.RandomState(19)
    f_long = sess.submit(rs.randint(0, CFG.vocab, (2, 5)), n_new=6)
    sess.pump()                      # 2 slots busy
    big = sess.submit(rs.randint(0, CFG.vocab, (3, 5)), n_new=2)
    small = sess.submit(rs.randint(0, CFG.vocab, (1, 4)), n_new=2)
    for _ in range(50):
        sess.pump()
        if small.done():
            break
    assert small.done() and not big.done()
    for _ in range(200):
        sess.pump()
        if big.done():
            break
    assert big.done() and f_long.done()
    assert sess.stats()["scheduler"]["starved"] == 0
    sess.close()


def test_requeue_bypasses_backpressure_and_completes(weights):
    """A requeued continuation is exempt from the lane limit and keeps
    its submit time; an impossible request is rejected at submit."""
    eng = _engine(weights, np.ones(2))
    clock = FakeClock()
    sess = _cont_session(eng, clock, starve_ms=10.0, max_queue=1)
    rs = np.random.RandomState(23)
    blocker = sess.submit(rs.randint(0, CFG.vocab, (4, 5)), n_new=4)
    sess.pump()                      # pool now full
    f1 = sess.submit(rs.randint(0, CFG.vocab, (1, 5)), n_new=2)
    cont = sess._admit(rs.randint(0, CFG.vocab, (1, 5)), None, 0,
                       now=clock(), n_new=2)
    assert sess.queue.push(
        sess._admit(rs.randint(0, CFG.vocab, (1, 5)), None, 0,
                    now=clock(), n_new=2)) == "rejected"
    assert sess.queue.requeue(cont) == "queued"
    for _ in range(200):
        sess.pump()
        if f1.done() and cont.future.done():
            break
    assert blocker.done() and f1.done() and cont.future.done()
    assert cont.future.exception() is None
    fut = sess.submit(np.zeros((1, 30), np.int64), n_new=20)
    with pytest.raises(RequestRejected):
        fut.result(timeout=WAIT_S)
    sess.close()


def test_a_failing_step_fails_only_the_pooled_requests(weights, tau):
    """A decode step that raises fails exactly the requests in the pool
    with a DispatchError, frees their slots, and the next pump serves
    the queue."""
    from repro_torch.serving import DispatchError
    eng = _engine(weights, tau)
    clock = FakeClock()
    sess = _cont_session(eng, clock)
    rs = np.random.RandomState(31)
    a = sess.submit(rs.randint(0, CFG.vocab, (4, 5)), n_new=3)
    sess.pump()
    b = sess.submit(rs.randint(0, CFG.vocab, (1, 5)), n_new=3)
    step = sess.decoder.step
    sess.decoder.step = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    sess.pump()
    sess.decoder.step = step
    with pytest.raises(DispatchError):
        a.result(timeout=WAIT_S)
    assert sess.decoder.active_rows == 0
    sess.flush()
    assert b.result(timeout=WAIT_S)["tokens"].shape == (1, 3)
    assert sess.counters["step_errors"] == 1
    sess.close()


# ---------------------------------------------------------------------------
# observability, against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture
def _fresh_obs():
    for o in (obs, jobs):
        o.reset()
        o.configure(enabled=True)
    yield
    for o in (obs, jobs):
        o.reset()


def _starving_run(sess, clock, rs_seed=17):
    """The starvation scenario on a fake clock: returns the futures."""
    rs = np.random.RandomState(rs_seed)
    futs = [sess.submit(rs.randint(0, CFG.vocab, (2, 5)), n_new=2),
            sess.submit(rs.randint(0, CFG.vocab, (2, 5)), n_new=8)]
    sess.pump()
    futs.append(sess.submit(rs.randint(0, CFG.vocab, (3, 5)), n_new=2,
                            deadline_ms=20.0))
    clock.advance(0.1)
    futs += [sess.submit(rs.randint(0, CFG.vocab, (1, 4)), n_new=2)
             for _ in range(3)]
    for _ in range(40):
        clock.advance(0.001)
        sess.pump()
    sess.flush()
    for f in futs:
        f.result(timeout=WAIT_S)
    return futs


def _slot_view(tracer):
    return ([(s["rid"], s["lane"], tuple(s["slots"]), s["pages_in_use"],
              round(s["queue_wait_s"], 9)) for s in tracer.spans("slot")],
            [(s["rid"], s["n_tokens"], s["deadline_missed"])
             for s in tracer.spans("exit")])


def test_slot_spans_occupancy_and_starved_match_jax(weights, _fresh_obs):
    """The starvation scenario through both packages' continuous sessions
    with obs on: the same slot spans (slot ids, pages in use, queue
    wait), exit spans, occupancy gauges, ``starved`` count (in stats and
    in the Prometheus text), token counter and per-lane completions."""
    clock, jclock = FakeClock(), FakeClock()
    sess = _cont_session(_engine(weights, np.ones(2)), clock,
                         starve_ms=10.0)
    jcfg = JaxConfig(policy="reject", flush_ms=0.0, starve_ms=10.0)
    jsess = _jengine(weights, np.ones(2)).session(
        continuous=True, cfg=jcfg, clock=jclock, start=False, **POOL)
    _starving_run(sess, clock)
    _starving_run(jsess, jclock)
    slots, exits = _slot_view(obs.get_tracer())
    jslots, jexits = _slot_view(jobs.get_tracer())
    assert len(slots) == 6 and all(s[2] for s in slots)
    assert slots == jslots
    assert sorted(exits) == sorted(jexits)
    st, jst = sess.stats()["scheduler"], jsess.stats()["scheduler"]
    assert st["starved"] == jst["starved"] > 0
    assert st == jst
    fams = M.parse_prometheus(obs.get_registry().render())
    jfams = M.parse_prometheus(jobs.get_registry().render())
    names = ("dart_slots_total", "dart_slots_in_use", "dart_pages_total",
             "dart_pages_in_use", "dart_pages_peak", "dart_lm_tokens_total",
             "dart_requests_completed_total", "dart_deadline_miss_total",
             "dart_scheduler_events_total", "dart_queue_depth")
    for name in names:
        assert fams[name]["samples"] == jfams[name]["samples"], name
    assert fams["dart_slots_total"]["samples"][0][2] == 4
    assert fams["dart_slots_in_use"]["samples"][0][2] == 0
    assert fams["dart_lm_tokens_total"]["samples"][0][2] == 2 * 2 + 2 * 8 \
        + 3 * 2 + 3 * 2
    sess.close()
    jsess.close()


# ---------------------------------------------------------------------------
# the pooled session
# ---------------------------------------------------------------------------

def test_pooled_lm_session_survives_engine_death(weights, tau):
    """JAX's test_resilience.py LM case: two engines on one param tree
    behind ``pooled_lm_session``, a seeded plan that kills the first
    engine called; the request completes once, equal to one engine's
    ``generate``, and the pool counts the death."""
    l0, l1, oracle = (_engine(weights, tau) for _ in range(3))
    inj = FaultInjector(FaultPlan([FaultSpec("engine_death", "step", 0)]))
    pool = EnginePool({"l0": l0, "l1": l1},
                      ResilienceConfig(backoff_s=0.001,
                                       requeue_backoff_s=0.001),
                      injector=inj, heartbeat=False)
    sess = pooled_lm_session(pool, SchedulerConfig(max_batch=2),
                             start=False)
    assert isinstance(sess, LMDecodeSession)
    assert not isinstance(sess, LMContinuousSession)
    prompts = np.random.RandomState(6).randint(0, CFG.vocab, (2, 4))
    f = sess.submit(prompts, n_new=3)
    for _ in range(400):
        if f.done():
            break
        sess.flush()
        time.sleep(0.002)
    out = f.result(timeout=WAIT_S)
    ref_toks, ref_stages = oracle.generate(prompts, 3)
    np.testing.assert_array_equal(out["tokens"], ref_toks)
    np.testing.assert_array_equal(out["stages"], ref_stages)
    st = sess.stats()
    assert st["pool"]["deaths"] == 1
    assert st["requests"]["requests"] == 1
    sess.close()
    pool.close()
