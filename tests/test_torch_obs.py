"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``) on the CPU.

After the same seeded burst through both schedulers (``_torch_serving.
py``: same weights, policy and fake clocks), the Prometheus text of the
two registries parses to the same families, labels and values, and the
two tracers hold the same spans.  One family differs by design and is
left out of the comparison: the JAX package exports its kernels'
backend decisions, counted when a function is traced
(``dart_kernel_dispatch_total{kernel,backend}``); the port exports the
launches of its hand-written kernels (``dart_kernel_launches_total
{kernel}``), which the CPU never makes.  One sample differs too: the
JAX queue counts, as ``dart_scheduler_events_total{event="starved"}``,
the capacity its LM slot refill held back; the port has no such refill
and no such counter, and the JAX value is checked to be 0 after the
classifier burst.  The gauges computed from
confidences (the per-lane mean conf and DAES) agree within the
engines' conf tolerance, every other value exactly."""
import logging
import urllib.request

import numpy as np
import pytest
import torch

import repro.obs as jobs
from _torch_serving import CAL_ATOL, burst, drive, make_pair
from repro.obs import metrics as jM
from repro_torch import obs
from repro_torch.kernels import dispatch as KD
from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T
from repro_torch.obs.stats import SUMMARY_KEYS
from repro_torch.serving import AsyncDartServer, SchedulerConfig
from repro_torch.serving.request import DispatchError

torch.set_num_threads(1)

#: families that exist on one side only (see the module docstring)
JAX_ONLY = {"dart_kernel_dispatch_total"}
PORT_ONLY = {"dart_kernel_launches_total"}
#: a sample that exists on the JAX side only, always 0 here
JAX_ONLY_SAMPLE = ("dart_scheduler_events_total",
                   ("dart_scheduler_events_total", (("event", "starved"),)))
#: gauges computed from exited confidences: acc_pct is 100 * mean conf,
#: daes is proportional to it
CONF_FAMILIES = {"dart_lane_acc_pct": 100 * CAL_ATOL, "dart_lane_daes": None}


@pytest.fixture(autouse=True)
def _fresh_obs():
    for o in (obs, jobs):
        o.reset()
    yield
    for o in (obs, jobs):
        o.reset()


@pytest.fixture(scope="module")
def alexnet():
    return make_pair("alexnet-tiny")


def _samples(text):
    return {name: {(s[0], tuple(sorted(s[1].items()))): s[2]
                   for s in fam["samples"]} | {"type": fam["type"]}
            for name, fam in M.parse_prometheus(text).items()}


@pytest.mark.parametrize("predict", ["off", "conservative"])
def test_prometheus_and_spans_match_jax(alexnet, predict):
    for o in (obs, jobs):
        o.configure(enabled=True)
    servers = alexnet.servers(max_batch=16, flush_ms=10.0, predict=predict)
    for srv in servers:
        futs = drive(srv, alexnet.images, burst(seed=5))
        assert all(f.result(timeout=5) for f in futs)
    jtext, text = jobs.OBS.registry.render(), obs.OBS.registry.render()
    jfams, fams = _samples(jtext), _samples(text)
    fam, key = JAX_ONLY_SAMPLE
    assert jfams[fam].pop(key) == 0.0
    assert set(jfams) - set(fams) == JAX_ONLY
    assert set(fams) - set(jfams) == PORT_ONLY
    assert {"dart_requests_total", "dart_request_latency_ms",
            "dart_exits_total", "dart_flushes_total", "dart_lane_daes",
            "dart_depth_prior", "dart_scheduler_events_total",
            "dart_engine_latency_ms", "dart_engine_exits_total",
            "dart_recompiles_total"} <= set(fams)
    for name in sorted(set(fams) & set(jfams)):
        got, want = fams[name], jfams[name]
        assert got.keys() == want.keys(), name
        for key in got:
            if name in CONF_FAMILIES and key != "type":
                np.testing.assert_allclose(
                    got[key], want[key], rtol=1e-4,
                    atol=CONF_FAMILIES[name] or 0, err_msg=name)
            else:
                assert got[key] == want[key], (name, key)
    # the exposition parses the same with either package's parser
    assert M.parse_prometheus(text) == jM.parse_prometheus(text)
    # the tracers: the same spans, by name and count, in the same order
    spans, jspans = obs.get_tracer().spans(), jobs.get_tracer().spans()
    assert [s["name"] for s in spans] == [s["name"] for s in jspans]
    assert set(s["name"] for s in spans) == {
        "admit", "bucket", "queue_wait", "compiled_step", "exit"}
    for s, js in zip(spans, jspans):
        assert s.get("rid") == js.get("rid")
        assert s["ts"] == js["ts"] and s["dur"] == js["dur"]
        if s["name"] == "exit":
            assert s["exits"] == [int(e) for e in js["exits"]]
    assert set(T.SPAN_NAMES) >= {s["name"] for s in spans}


def test_spans_reconcile_with_engine_telemetry(alexnet):
    """The exit spans add up to the engine's exit histogram, one admit
    and one queue_wait per request, and the completed counter is the
    scheduler's."""
    obs.configure(enabled=True)
    _, srv = alexnet.servers(max_batch=16, flush_ms=10.0)
    futs = drive(srv, alexnet.images, burst(seed=6))
    stats = srv.stats()
    for k in SUMMARY_KEYS:
        assert k in stats
    span_exits = np.zeros(alexnet.eng.n_exits, np.int64)
    for s in obs.get_tracer().spans("exit"):
        for e in s["exits"]:
            span_exits[int(e)] += 1
    np.testing.assert_array_equal(span_exits, stats["exit_counts"])
    assert len(obs.get_tracer().spans("admit")) == len(futs)
    assert len(obs.get_tracer().spans("queue_wait")) == len(futs)
    fams = M.parse_prometheus(obs.get_registry().render())
    comp = sum(v for _, _, v in
               fams["dart_requests_completed_total"]["samples"])
    assert comp == stats["scheduler"]["completed"] == len(futs)


def test_disabled_obs_is_inert(alexnet):
    assert not obs.is_enabled()
    _, srv = alexnet.servers(max_batch=16)
    drive(srv, alexnet.images, burst(seed=6))
    assert len(obs.get_tracer()) == 0
    assert "dart_" not in obs.get_registry().render()


def test_kernel_launch_family_reads_dispatch_counts(monkeypatch):
    """The port's kernel family mirrors ``dispatch.launch_counts``."""
    obs.configure(enabled=True)
    for name, mod in KD._WRAPPERS.items():
        monkeypatch.setattr(mod, "launches", len(name))
    fam = M.parse_prometheus(obs.get_registry().render())[
        "dart_kernel_launches_total"]
    assert {s[1]["kernel"]: s[2] for s in fam["samples"]} == {
        name: float(len(name)) for name in KD._WRAPPERS}


def test_textfile_and_http_roundtrip(alexnet, tmp_path):
    prom = tmp_path / "metrics.prom"
    obs.configure(enabled=True, textfile=str(prom), http_port=0)
    _, srv = alexnet.servers(max_batch=16)
    drive(srv, alexnet.images, burst(seed=6, n_bursts=2))
    obs.flush_textfile()
    with urllib.request.urlopen(
            f"http://127.0.0.1:{obs.OBS.http_port}/metrics",
            timeout=10) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        served = M.parse_prometheus(r.read().decode())
    on_disk = M.parse_prometheus(prom.read_text())
    for fams in (served, on_disk):
        assert "dart_request_latency_ms" in fams
        assert "dart_requests_total" in fams


class _Boom(RuntimeError):
    pass


def test_dispatch_failure_is_logged_and_counted(alexnet, caplog,
                                                monkeypatch):
    """An engine call that raises (as a kernel that fails to launch on a
    card does) fails its bucket's futures with DispatchError, is counted
    and logged, and the scheduler lives on."""
    obs.configure(enabled=True)
    _, eng = alexnet.reset()

    def boom(*a, **kw):
        raise _Boom("engine exploded")

    monkeypatch.setattr(eng, "infer", boom)
    sched = AsyncDartServer(eng, SchedulerConfig(), start=False)
    fut = sched.submit(alexnet.images[0])
    with caplog.at_level(logging.ERROR, logger="repro_torch.obs"):
        sched.flush()
    with pytest.raises(DispatchError) as ei:
        fut.result(timeout=5)
    assert isinstance(ei.value.cause, _Boom)
    assert ei.value.stage == "dispatch"
    assert sched.counters["dispatch_errors"] == 1
    errs = obs.get_registry().counter(
        "dart_errors_total", "scheduler/dispatcher errors by component",
        ("component",))
    assert errs.value(component="dispatch") == 1
    rec = [r for r in caplog.records if r.name == "repro_torch.obs.dispatch"]
    assert rec and "bucket dispatch failed" in rec[0].getMessage()
    assert "rids=" in rec[0].getMessage()


def test_counter_roundtrip_with_escaped_labels():
    reg = M.Registry()
    c = reg.counter("dart_x_total", 'help with "quotes"\nand newline',
                    ("lane",))
    c.inc(2, lane='a"b\\c\nd')
    c.inc(1.5, lane="plain")
    fams = M.parse_prometheus(reg.render())
    assert fams["dart_x_total"]["type"] == "counter"
    assert fams["dart_x_total"]["help"] == 'help with "quotes"\nand newline'
    got = {s[1]["lane"]: s[2] for s in fams["dart_x_total"]["samples"]}
    assert got == {'a"b\\c\nd': 2.0, "plain": 1.5}
    assert reg.render() == jM.render_prometheus(_jax_copy(reg))


def _jax_copy(reg):
    """The same families in the JAX package's registry."""
    jreg = jM.Registry()
    for fam in reg.collect():
        jfam = jreg.counter(fam.name, fam.help, fam.labelnames)
        for _, labels, v in fam.samples():
            jfam.inc(v, **labels)
    return jreg


def test_histogram_exposition_and_percentile_match_jax():
    reg, jreg = M.Registry(), jM.Registry()
    vals = np.random.RandomState(0).gamma(2.0, 20.0, 300)
    for r in (reg, jreg):
        h = r.histogram("dart_lat_ms", "latency", ("lane",))
        for v in vals:
            h.observe(float(v), lane="0")
    assert reg.render() == jreg.render()
    for q in (50, 95, 99):
        assert reg.get("dart_lat_ms").percentile(q, lane="0") == \
            jreg.get("dart_lat_ms").percentile(q, lane="0")


def test_registry_redeclaration_and_dead_collectors():
    reg = M.Registry()
    reg.counter("dart_a_total", "a", ("x",))
    with pytest.raises(ValueError, match="re-declared"):
        reg.gauge("dart_a_total", "a", ("x",))
    calls = []
    reg.register_collector(lambda r: calls.append(1) or "dead")
    reg.register_collector(lambda r: 1 / 0)
    reg.render()
    reg.render()
    assert calls == [1]
    assert reg._collectors == []


def test_ring_overflow_drops_oldest_and_chrome_trace(tmp_path):
    tr = T.Tracer(capacity=4)
    for i in range(7):
        tr.record("admit", ts=float(i), rid=i, lane=(i % 2, 0))
    assert [s["rid"] for s in tr.spans()] == [3, 4, 5, 6]
    assert tr.dropped == 3
    path = tmp_path / "spans.jsonl"
    assert tr.export_jsonl(str(path)) == 4
    ct = T.chrome_trace(T.load_jsonl(str(path)))
    threads = [e for e in ct["traceEvents"] if e["ph"] == "M"]
    assert len(threads) == 2
    assert sum(e["ph"] == "X" for e in ct["traceEvents"]) == 4
