"""The port's async request scheduler (``repro_torch.serving``) against
the JAX package's (``repro.serving``) on the CPU.

Both servers serve the same seeded bursts of 1-5 synthetic images a
request, with mixed deadlines and priorities, through engines with the
same converted weights and policy (``_torch_serving.py``), each on a fake
clock driven by ``pump()``.  The scheduler's own decisions (the flush
sequence: reason, request ids, lane, padded size; backpressure; the
lanes) and everything the fake clock measures (latencies, deadline
misses) must be exactly equal; per request ``exit_idx`` and ``pred``
equal outside counted gate-edge rows, ``conf`` and ``alpha`` within
CAL_ATOL.  The predictor, the state helpers, Alg. 1 routing under the
engine's policy and the per-lane DAES are held to the JAX package's on
identical numpy inputs."""
import numpy as np
import pytest
import torch

from _torch_serving import (CAL_ATOL, CASES, FakeClock, burst, drive,
                            edge_rows, host, make_pair)
from repro.core import adaptive as jAD
from repro.core import daes as jDAES
from repro.engine import state as jST
from repro.serving import ExitDepthPredictor as JaxPredictor
from repro.serving import Request as JaxRequest
from repro.serving import RequestQueue as JaxQueue
from repro_torch import convert
from repro_torch.core import adaptive as AD
from repro_torch.core import daes as DAES
from repro_torch.core import routing as R
from repro_torch.engine import state as ST
from repro_torch.serving import (AsyncDartServer, DispatchError,
                                 ExitDepthPredictor, Request, RequestQueue,
                                 SchedulerConfig)

# tiny tensors: one thread is faster than torch's pool, and leaves the
# cores to the JAX side and to other test workers
torch.set_num_threads(1)

BURST = dict(max_batch=16, flush_ms=10.0, margin_ms=1.0)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return make_pair(request.param)


@pytest.fixture(scope="module")
def alexnet():
    return make_pair("alexnet-tiny")


def _serve_both(pair, stream, tau=None, **cfg):
    jsrv, srv = pair.servers(**cfg)
    if tau is not None:
        for e in (pair.jeng, pair.eng):
            e.state = e.state.with_policy(tau=tau)
    jfuts = drive(jsrv, pair.images, stream)
    futs = drive(srv, pair.images, stream)
    return (jsrv, [f.result(timeout=5) for f in jfuts],
            srv, [f.result(timeout=5) for f in futs])


def _requests(stream):
    return [(a, n) for reqs in stream for a, n, _, _ in reqs]


def _check_results(pair, stream, jouts, outs):
    """Per request: the same lane, fake-clock latency and miss, and the
    JAX package's answers; returns the number of gate-edge rows."""
    n_edge = 0
    for (a, n), jo, o in zip(_requests(stream), jouts, outs):
        edge = edge_rows(pair.eng, pair.images[a:a + n])
        n_edge += int(edge.sum())
        ok = ~edge
        for k in ("exit_idx", "pred"):
            np.testing.assert_array_equal(o[k][ok], host(jo[k])[ok],
                                          err_msg=k)
        for k in ("conf", "alpha"):
            np.testing.assert_allclose(o[k], host(jo[k]), atol=CAL_ATOL,
                                       rtol=0, err_msg=k)
        np.testing.assert_array_equal(o["macs"], host(jo["macs"]))
        for k in ("latency_ms", "deadline_missed", "lane"):
            assert o[k] == jo[k], k
        # a cold lane's cost is linear in mean alpha (slope <= E-1 on the
        # normalised cost curve); a warm one reads the exit-depth EMA
        np.testing.assert_allclose(o["predicted_cost"], jo["predicted_cost"],
                                   atol=(pair.eng.n_exits - 1) * CAL_ATOL,
                                   rtol=0)
        assert o["exit_idx"].shape == (n,)
    return n_edge


def _check_stats(jsrv, srv):
    st, jst = srv.stats(), jsrv.stats()
    assert st["requests"] == jst["requests"]
    sched, jsched = st["scheduler"], jst["scheduler"]
    # the JAX queue's LM slot-refill counter; the port has no such refill
    assert jsched.pop("starved") == 0
    assert sched == jsched
    assert st["served"] == jst["served"]
    np.testing.assert_array_equal(st["exit_counts"], jst["exit_counts"])
    rows, jrows = st["daes"], jst["daes"]
    assert list(rows) == list(jrows)
    for lane in rows:
        r, jr = rows[lane], jrows[lane]
        assert r["n"] == jr["n"]
        assert r["speedup"] == jr["speedup"]
        assert r["power_eff"] == jr["power_eff"]
        # acc is the mean exited conf: CAL_ATOL on conf in [0.1, 1]
        np.testing.assert_allclose(r["acc_pct"] / 100, jr["acc_pct"] / 100,
                                   atol=CAL_ATOL, rtol=0)
        np.testing.assert_allclose(r["daes"], jr["daes"], rtol=1e-4)


@pytest.mark.parametrize("mode", ["masked", "compacted"])
def test_seeded_burst_matches_jax(pair, mode):
    """The same flush sequence, results, telemetry and counters as the
    JAX scheduler, and every result that of the request served alone."""
    stream = burst()
    jsrv, jouts, srv, outs = _serve_both(pair, stream, mode=mode, **BURST)
    assert srv.flushes == jsrv.flushes
    reasons = {f[0] for f in srv.flushes}
    assert {"deadline", "size"} <= reasons, reasons
    assert len({f[2] for f in srv.flushes}) >= 2          # several lanes
    n_edge = _check_results(pair, stream, jouts, outs)
    assert n_edge <= 0.02 * sum(n for _, n in _requests(stream))
    _check_stats(jsrv, srv)
    assert srv.planner.priors() == jsrv.planner.priors()
    # every result is that of serving the request alone
    for (a, n), o in zip(_requests(stream), outs):
        x = pair.images[a:a + n]
        alone = pair.eng.infer(x, mode="masked")
        ok = ~edge_rows(pair.eng, x)
        for k in ("exit_idx", "pred"):
            np.testing.assert_array_equal(o[k][ok], alone[k].numpy()[ok])


def test_conservative_predictor_matches_jax_and_off(pair):
    """predict="conservative" (compacted, where head-skip removes gate
    launches): the JAX scheduler's flushes, quotes and predictor state,
    and the answers of the same stream served with prediction off."""
    stream = burst(seed=11, n_bursts=10)
    tau = pair.states[1].tau.numpy().copy()
    tau[0] = 1.0                # gate 0 never fires: min_exit >= 1
    cfg = dict(mode="compacted", **BURST)
    jsrv, jouts, srv, outs = _serve_both(pair, stream, tau=tau,
                                         predict="conservative", **cfg)
    assert srv.flushes == jsrv.flushes
    _check_results(pair, stream, jouts, outs)
    _check_stats(jsrv, srv)
    st, jst = srv.stats(), jsrv.stats()
    assert st["requests"]["quote"] == jst["requests"]["quote"]
    assert st["requests"]["quote"]["quoted"] > 0
    sd, jsd = srv.predictor.state_dict(), jsrv.predictor.state_dict()
    # the logistic heads learn from alpha (CAL_ATOL apart): a few SGD
    # steps of lr 0.25 keep them within 1e-6
    for k in ("w0", "w1"):
        np.testing.assert_allclose(sd.pop(k), jsd.pop(k), atol=1e-6, rtol=0)
    assert sd == jsd
    assert srv.planner.state_dict() == jsrv.planner.state_dict()
    assert all(isinstance(o["lane"], tuple) for o in outs)
    assert st["scheduler"]["predictor"]["skip_stages"] > 0
    _, _, _, off_outs = _serve_both(pair, stream, tau=tau, **cfg)
    for (a, n), o, p in zip(_requests(stream), outs, off_outs):
        ok = ~edge_rows(pair.eng, pair.images[a:a + n])
        for k in ("exit_idx", "pred"):
            np.testing.assert_array_equal(o[k][ok], p[k][ok])


@pytest.mark.parametrize("policy", ["shed", "reject", "degrade-alpha"])
def test_backpressure_matches_jax(alexnet, policy):
    """Two-deep lanes under a burst of 12 single-image requests with
    priorities 0-3: the same counters, the same shed or rejected ids,
    and (degrade-alpha) the same re-laned requests."""
    alpha = alexnet.eng.infer(alexnet.images[:12], mode="compacted",
                              record=False)["alpha"]
    edge = float(np.median(alpha))
    cfg = dict(max_queue=2, policy=policy, degrade_factor=0.25,
               edges=(edge,), max_batch=16)
    dropped = {}
    for srv in alexnet.servers(**cfg):
        futs = [srv.submit(alexnet.images[i:i + 1], priority=i % 4)
                for i in range(12)]
        srv.close()
        lost = [(i, type(f.exception(timeout=5)).__name__)
                for i, f in enumerate(futs) if f.exception(timeout=5)]
        kept = {i: f.result(timeout=5)["lane"]
                for i, f in enumerate(futs) if not f.exception(timeout=5)}
        dropped[srv.engine is alexnet.eng] = (
            lost, kept, srv.queue.shed, srv.queue.rejected,
            srv.counters["degraded"], srv.flushes)
    assert dropped[True] == dropped[False]
    lost, kept, shed, rejected, degraded, _ = dropped[True]
    assert {"shed": shed, "reject": rejected,
            "degrade-alpha": degraded}[policy] > 0
    assert len(lost) == shed + rejected
    assert {name for _, name in lost} <= {"RequestShed", "RequestRejected"}


@pytest.mark.parametrize("policy", ["shed", "reject"])
def test_request_queue_matches_jax(policy):
    """A seeded mix of push and take (with and without force) on both
    packages' queues: the same actions, the same requests out, the same
    counters, and the same requests left in each lane."""
    from concurrent.futures import Future
    rng = np.random.RandomState(5)
    q, jq = RequestQueue(max_queue=4, policy=policy), JaxQueue(
        max_queue=4, policy=policy)
    bucket = lambda n: 1 << max(n - 1, 0).bit_length()      # noqa: E731
    rid = 0
    for step in range(300):
        op = rng.randint(0, 3)
        if op < 2:
            kw = dict(rid=rid, n=int(rng.randint(1, 5)),
                      lane=int(rng.randint(0, 3)), predicted_cost=1.0,
                      priority=int(rng.randint(0, 3)), t_submit=step * 1e-3,
                      deadline_s=None)
            rid += 1
            got = q.push(Request(x=None, alpha=None, future=Future(), **kw))
            want = jq.push(JaxRequest(x=None, alpha=None, future=Future(),
                                      **kw))
        else:
            kw = dict(max_samples=int(rng.randint(1, 9)),
                      force=bool(rng.randint(0, 2)))
            key = int(rng.randint(0, 3))
            got = [r.rid for r in q.take(key, bucket_key=bucket, **kw)]
            want = [r.rid for r in jq.take(key, bucket_key=bucket, **kw)]
        assert got == want, step
    assert (q.shed, q.rejected) == (jq.shed, jq.rejected)
    assert q.shed or q.rejected
    assert q.keys() == jq.keys()
    for key in q.keys():
        assert [r.rid for r in q.take(key, 1 << 10, bucket, force=True)] \
            == [r.rid for r in jq.take(key, 1 << 10, bucket, force=True)]
    assert q.empty


def test_exit_depth_predictor_matches_jax(alexnet):
    """One stream of (alpha, exit) into both predictors, both modes:
    equal depths, bands, head-skip bounds and state_dict."""
    jeng, eng = alexnet.reset()
    tau = eng.state.tau.numpy().copy()
    tau[0] = 1.0                               # gate 0 can never fire
    for e in (jeng, eng):
        e.state = e.state.with_policy(tau=tau)
    eng._policy_mirror = None
    rng = np.random.RandomState(3)
    for mode in ("conservative", "aggressive"):
        priors = [0.5, None, 1.5]
        p = ExitDepthPredictor(eng.n_exits, mode=mode, min_obs=8,
                               priors=lambda: priors)
        jp = JaxPredictor(jeng.n_exits, mode=mode, min_obs=8,
                          priors=lambda: priors)
        for _ in range(12):
            alpha = rng.uniform(0, 1, int(rng.randint(1, 9)))
            exits = rng.randint(0, eng.n_exits, len(alpha))
            for a in (0.1, 0.5, 0.9, float(alpha.mean())):
                assert p.predict_depth(a) == jp.predict_depth(a)
                assert p.admit_info(a) == jp.admit_info(a)
                assert p.min_exit(eng, a) == jp.min_exit(jeng, a)
            p.observe(alpha, exits)
            jp.observe(alpha, exits)
        assert p.state_dict() == jp.state_dict()
        assert p.stats() == jp.stats()
        assert p.min_exit(eng, 0.0) >= 1
    alexnet.reset()


def test_state_helpers_and_route_match_jax(alexnet):
    """record_requests (ring wrap), record_quotes (None quotes skipped),
    request_stats, latency_percentiles and telemetry_totals against the
    JAX package's; Alg. 1 routing under the port engine's policy against
    ``DartEngine.route`` of the JAX engine."""
    jeng, eng = alexnet.reset()
    acfg = AD.AdaptiveConfig(n_exits=3, n_classes=10)
    jacfg = jAD.AdaptiveConfig(n_exits=3, n_classes=10)
    st = ST.EngineState.create(3, acfg, lat_window=4, device="cpu")
    jst = jST.EngineState.create(3, jacfg, lat_window=4)
    for lats, missed, quotes in (([10.0, 20.5, 30.0], [True, False, False],
                                  [None, 12.0, 40.0]),
                                 ([40.0, 50.25, 60.0], [False, True, False],
                                  [None, None, None]),
                                 ([7.0], None, [9.5])):
        st = ST.record_quotes(ST.record_requests(st, lats, missed), quotes,
                              lats)
        jst = jST.record_quotes(jST.record_requests(jst, lats, missed),
                                quotes, lats)
    for f in ("lat_ms", "lat_ptr", "lat_count", "deadline_miss",
              "quote_ms_sum", "quote_err_ms_sum", "quote_count"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f)
    assert ST.request_stats(st) == jST.request_stats(jst)
    assert ST.request_stats(st)["requests"] == 7
    assert set(st.lat_ms.tolist()) == {50.25, 60.0, 7.0, 40.0}
    lat = np.random.RandomState(1).gamma(2.0, 5.0, 101)
    assert ST.latency_percentiles(lat) == jST.latency_percentiles(lat)
    for k, v in ST.telemetry_totals(eng.state).items():
        np.testing.assert_array_equal(
            v, jST.telemetry_totals(jeng.state, sharded=False)[k])
    assert "requests" not in eng.stats()
    eng.record_requests([5.0, 6.0], [False, True])
    jeng.record_requests([5.0, 6.0], [False, True])
    assert eng.stats()["requests"] == jeng.stats()["requests"]

    x = alexnet.images[:16]
    logits = np.random.RandomState(2).normal(0, 2, (3, 16, 10)).astype(
        np.float32)
    alpha = eng.infer(x, mode="compacted", record=False)["alpha"]
    got = R.route(eng._conf_fn(torch.as_tensor(logits)),
                  torch.as_tensor(alpha), eng.dart_params())
    for want in (jeng.route(logits, inputs=x),
                 jeng.route(logits, alpha=alpha)):
        np.testing.assert_array_equal(got["exit_idx"].numpy(),
                                      np.asarray(want["exit_idx"]))
        for k in ("conf", "eff_thresholds", "alpha"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=CAL_ATOL, rtol=0, err_msg=k)
    alexnet.reset()


def test_lane_daes_match_jax():
    """LaneDaesAccumulator rows and the offline summary rows under the
    ``macs`` energy model, the one the port keeps."""
    rng = np.random.RandomState(4)
    acc, jacc = (DAES.LaneDaesAccumulator(static_macs=4.8e8),
                 jDAES.LaneDaesAccumulator(static_macs=4.8e8))
    for _ in range(20):
        lane = (int(rng.randint(0, 3)), int(rng.randint(0, 2)))
        n = int(rng.randint(1, 6))
        conf = rng.uniform(0.1, 1.0, n).astype(np.float32)
        macs = rng.choice([1.4e8, 2.7e8, 4.8e8], n)
        alpha = rng.uniform(0, 1, n).astype(np.float32)
        acc.observe(lane, conf, macs, alpha)
        jacc.observe(lane, conf, macs, alpha)
    assert acc.rows() == jacc.rows("macs")
    assert len(acc.rows()) >= 4


def test_threaded_server_resolves_all_and_matches_infer_alone(alexnet):
    """start=True: the dispatcher thread on the real clock; 64 requests
    of 1-3 images from two submitting threads all resolve, each with the
    answers of serving it alone."""
    import threading
    _, eng = alexnet.reset()
    rng = np.random.RandomState(9)
    spans = [(int(a), int(n)) for a, n in zip(rng.randint(0, 120, 64),
                                               rng.randint(1, 4, 64))]
    futs = [None] * len(spans)
    with AsyncDartServer(eng, SchedulerConfig(max_batch=16, flush_ms=2.0,
                                              mode="masked")) as srv:
        def submit(part):
            for i in part:
                a, n = spans[i]
                futs[i] = srv.submit(alexnet.images[a:a + n],
                                     deadline_ms=1000.0, priority=i % 2)
        threads = [threading.Thread(target=submit, args=(range(k, 64, 2),))
                   for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        outs = [f.result(timeout=60) for f in futs]
    assert srv.counters["completed"] == 64 == srv.stats()["requests"][
        "requests"]
    assert srv.last_error is None
    for (a, n), o in zip(spans, outs):
        x = alexnet.images[a:a + n]
        alone = eng.infer(x, mode="masked")
        ok = ~edge_rows(eng, x)
        for k in ("exit_idx", "pred"):
            np.testing.assert_array_equal(o[k][ok], alone[k].numpy()[ok])
        assert o["latency_ms"] > 0
    alexnet.reset()


def test_bad_request_fails_its_bucket_not_the_loop(alexnet):
    """An input the engine refuses (five channels) fails its bucket's
    futures with DispatchError; the scheduler serves on."""
    _, eng = alexnet.reset()
    srv = AsyncDartServer(eng, SchedulerConfig(edges=()),
                          clock=FakeClock(), start=False)
    bad = srv.submit(np.zeros((2, 32, 32, 5), np.float32))
    srv._clock.advance(1.0)
    assert srv.pump()
    with pytest.raises(DispatchError) as ei:
        bad.result(timeout=5)
    assert ei.value.stage == "dispatch"
    assert srv.counters["dispatch_errors"] == 1
    ok = srv.submit(alexnet.images[:2])
    srv.close()
    assert ok.result(timeout=5)["pred"].shape == (2,)
    alexnet.reset()


def test_convert_keeps_stacked_non_conv_leaves():
    """Only a 4-D leaf under the conv key "w" goes HWIO -> OIHW: a
    layer-stacked attention weight (L, d, H, Dh) keeps its layout."""
    rng = np.random.RandomState(0)
    wq = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    conv = rng.normal(size=(3, 3, 2, 5)).astype(np.float32)
    tree = {"layers": {"attn": {"wq": wq, "wo": [wq]}},
            "blocks": [[{"w": conv, "b": np.zeros(5, np.float32)}]]}
    got = convert.to_port_tree(tree, "cpu")
    np.testing.assert_array_equal(got["layers"]["attn"]["wq"].numpy(), wq)
    np.testing.assert_array_equal(got["layers"]["attn"]["wo"][0].numpy(),
                                  wq)
    np.testing.assert_array_equal(got["blocks"][0][0]["w"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
