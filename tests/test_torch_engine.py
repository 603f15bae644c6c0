"""The whole slice against the JAX package: the port's ``DartEngine`` on
the CPU and the JAX ``DartEngine``, with the same converted weights, on
the same synthetic batches — calibration, policy, masked and compacted
``infer``, section II.C updates and stats, and ``measure_costs``.

Both packages draw the synthetic images from ``hash((seed, split))``, a
str hash that changes with each process's hash seed; here both draw
them from one hash-free base instead (``_fixed_images``), so every
worker and every run serves the same images.  An image with a Sobel
magnitude within 1e-7 of tau_edge, which the two packages' float32
chains round to either side (alpha then differs by w_edge / 900, one
pixel of edge density), is counted (``_sobel_edge``) and kept out of
the alpha comparison and the decisions, as rows at a gate's edge are."""
import copy
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_testbeds as jTB
from repro.data import datasets as jDS
from repro.engine import DartEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import paper_testbeds as TB
from repro_torch.data import datasets as DS
from repro_torch.engine import DartEngine
from repro_torch.engine import registry as REG
from repro_torch.models import get_family

# tiny tensors: one thread is faster than torch's pool, and leaves the
# cores to the JAX side and to other test workers
torch.set_num_threads(1)

# conf, alpha: fp32 reductions and convolutions in another order
CAL_ATOL = 1e-5
# rows whose conf at a gate lies this close to tau' may route differently
EDGE = 1e-5

# images with a Sobel magnitude this close to tau_edge (float64) may
# count as an edge pixel on one side only; the flips seen lay within 1e-7
SOBEL_EDGE = 1e-6

TINY_VGG = dict(blocks=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1)),
                fc_dim=32)
CASES = {
    "vgg-narrow": (dataclasses.replace(jTB.VGG16_CIFAR, **TINY_VGG),
                   dataclasses.replace(TB.VGG16_CIFAR, **TINY_VGG)),
    "alexnet-tiny": (jTB.ALEXNET_TINY, TB.ALEXNET_TINY),
    # ResNet-18 (basic blocks 2-2-2-2, four exits) at width 8
    "resnet18-narrow": (dataclasses.replace(jTB.RESNET18_CIFAR, width=8),
                        dataclasses.replace(TB.RESNET18_CIFAR, width=8)),
}
JDATA = jDS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=1024)
DATA = DS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=1024)
# every batch the JAX engine sees in full is padded to this one bucket, so
# it compiles its forward once per case
BATCH = 128


def _fixed_rng_for(cfg, index, split):
    """``datasets._rng_for`` with a hash-free base per (seed, split)."""
    base = zlib.crc32(f"{cfg.seed}/{split}".encode()) % (2**31 - 1)
    return np.random.RandomState(base ^ (index * 2654435761 % (2**31 - 1)))


@pytest.fixture(scope="module", autouse=True)
def _fixed_images():
    """One draw of the synthetic images for both packages, whatever the
    process's hash seed."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jDS, DS):
            mp.setattr(mod, "_rng_for", _fixed_rng_for)
        yield


def _jax_layout(tree):
    """The port's init in the JAX layout (conv OIHW -> HWIO)."""
    return jax.tree.map(lambda t: t.permute(2, 3, 1, 0).numpy()
                        if t.dim() == 4 else t.numpy(), tree)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(jax cfg, jax values, port cfg, port params) with one set of
    weights: the port's seeded init, handed to JAX in its layout and
    converted back through ``convert.from_jax_params``."""
    jcfg, cfg = CASES[request.param]
    values = _jax_layout(get_family(cfg).init(cfg, seed=7, device="cpu"))
    params = convert.from_jax_params(values, cfg, device="cpu")
    return jcfg, values, cfg, params


@pytest.fixture(scope="module")
def engines(pair):
    """One JAX and one port engine per case, shared by the tests so the
    JAX engine compiles each (stage, bucket) once; ``_reset`` gives each
    test the fresh state back."""
    jcfg, values, cfg, params = pair
    jeng = JaxEngine.from_config(jcfg, values, update_every=100)
    eng = DartEngine.from_config(cfg, params, device="cpu",
                                 update_every=100)
    return jeng, eng, (jeng.state, eng.state)


@pytest.fixture(scope="module")
def median_tau(engines):
    """The median policy of each case, from one port calibration."""
    return _median_policy(engines[1].collect_calibration(DATA, n=BATCH,
                                                         batch=BATCH))


def _reset(engines, adapt):
    jeng, eng, (jstate, state) = engines
    jeng.state, eng.state = jstate, state
    jeng.total_latency_s = eng.total_latency_s = 0.0
    for e in (jeng, eng):
        e.adapt = adapt
        e._policy_mirror = None
    return jeng, eng


def _median_policy(cal):
    """tau at each exit's median of conf - beta_diff*alpha, so about half
    of the rows reaching a gate leave there."""
    e = cal.conf.shape[1]
    return np.array([np.median(cal.conf[:, s] - 0.3 * cal.alpha)
                     for s in range(e - 1)], np.float32)


def _edge_rows(masked):
    """Rows with a gate whose conf lies within EDGE of its tau'."""
    conf = masked["conf_stack"].numpy()[:-1].T
    eff = masked["eff_thresholds"].numpy()
    return np.abs(conf - eff).min(axis=1) < EDGE


def _sobel_edge(x, tau_edge=0.1):
    """Images with a Sobel magnitude (Eqs. 1-3, in float64) within
    SOBEL_EDGE of tau_edge."""
    g = np.asarray(x, np.float64) @ np.array([0.299, 0.587, 0.114])
    h, w = g.shape[1:]
    tl, tc, tr, ml, _, mr, bl, bc, br = (
        g[:, i:h - 2 + i, j:w - 2 + j] for i in range(3) for j in range(3))
    gx = (tr + 2 * mr + br) - (tl + 2 * ml + bl)
    gy = (bl + 2 * bc + br) - (tl + 2 * tc + tr)
    mag = np.sqrt(gx * gx + gy * gy)
    return (np.abs(mag - tau_edge) < SOBEL_EDGE).any(axis=(1, 2))


def test_calibration_and_policy_match_jax(engines):
    jeng, eng = _reset(engines, adapt=False)
    jcal = jeng.collect_calibration(JDATA, n=BATCH, batch=BATCH)
    cal = eng.collect_calibration(DATA, n=BATCH, batch=BATCH)
    sobel = _sobel_edge(DS.make_batch(DATA, range(BATCH), split="eval")[0])
    assert sobel.sum() <= 0.03 * BATCH
    for k in ("conf", "correct", "entropy"):
        np.testing.assert_allclose(getattr(cal, k), getattr(jcal, k),
                                   atol=CAL_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(cal.alpha[~sobel], jcal.alpha[~sobel],
                               atol=CAL_ATOL, rtol=0)
    # the counted images fit the policy with one alpha on both sides
    jcal.alpha[sobel] = cal.alpha[sobel]
    np.testing.assert_array_equal(cal.labels, jcal.labels)
    np.testing.assert_array_equal(cal.cum_costs, jcal.cum_costs)
    jpol = jeng.calibrate(jcal)
    pol = eng.calibrate(cal)
    np.testing.assert_allclose(pol.tau, jpol.tau, atol=CAL_ATOL, rtol=0)
    assert pol.beta_diff == jpol.beta_diff
    np.testing.assert_allclose(eng.state.tau.numpy(),
                               np.asarray(jeng.state.tau), atol=CAL_ATOL,
                               rtol=0)
    for alpha_lo in (0.0, 1.0):
        assert eng.min_exit_bound(alpha_lo) == jeng.min_exit_bound(alpha_lo)


def _install(engines, tau):
    for e in engines:
        e.state = e.state.with_policy(tau=tau, beta_diff=0.3)


def test_infer_modes_match_jax(engines, median_tau):
    jeng, eng = _reset(engines, adapt=False)
    _install((jeng, eng), median_tau)
    x, _ = DS.make_batch(DATA, range(256, 256 + BATCH), split="eval")
    masked = eng.infer(x, mode="masked")
    compacted = eng.infer(x, mode="compacted")
    jmasked = jeng.infer(x, mode="masked")
    jcompacted = jeng.infer(x, mode="compacted")
    edge = _edge_rows(masked)
    sobel = _sobel_edge(x)
    assert edge.sum() <= 0.01 * len(x) and sobel.sum() <= 0.03 * len(x)
    ok = ~edge & ~sobel
    idx = masked["exit_idx"].numpy()
    assert len(np.unique(idx)) >= 2          # compaction really ran
    for got, want in ((idx, jmasked["exit_idx"]),
                      (compacted["exit_idx"], jcompacted["exit_idx"]),
                      (compacted["exit_idx"], idx)):
        np.testing.assert_array_equal(np.asarray(got)[ok],
                                      np.asarray(want)[ok])
    for got, want in ((masked["pred"].numpy(), jmasked["pred"]),
                      (compacted["pred"], jcompacted["pred"]),
                      (compacted["pred"], masked["pred"].numpy())):
        np.testing.assert_array_equal(np.asarray(got)[ok],
                                      np.asarray(want)[ok])
    np.testing.assert_allclose(compacted["alpha"][~sobel],
                               np.asarray(jcompacted["alpha"])[~sobel],
                               atol=CAL_ATOL, rtol=0)
    np.testing.assert_allclose(compacted["conf"][ok],
                               np.asarray(jcompacted["conf"])[ok],
                               atol=CAL_ATOL, rtol=0)


def test_infer_options_match_jax(engines, median_tau):
    """alpha= (precomputed difficulty), pad_to= (masked) and min_exit=
    (head-skip under the sound bound) change no decision."""
    jeng, eng = _reset(engines, adapt=False)
    tau = median_tau.copy()
    tau[0] = 1.0                        # gate 0 can never fire
    _install((jeng, eng), tau)
    x, _ = DS.make_batch(DATA, range(700, 800), split="eval")
    base = eng.infer(x, mode="compacted", record=False)
    alpha = base["alpha"]
    m = eng.min_exit_bound(float(alpha.min()))
    assert m == jeng.min_exit_bound(float(alpha.min())) == 1
    skip = eng.infer(x, mode="compacted", record=False, min_exit=m,
                     alpha=alpha)
    jskip = jeng.infer(x, mode="compacted", record=False, min_exit=m,
                       alpha=alpha)
    masked = eng.infer(x, mode="masked", pad_to=eng.bucket_key(len(x)),
                       alpha=alpha)
    ok = ~_edge_rows(masked)
    assert masked["exit_idx"].shape == (100,)
    for out in (skip, jskip):
        np.testing.assert_array_equal(np.asarray(out["exit_idx"])[ok],
                                      base["exit_idx"][ok])
        np.testing.assert_array_equal(np.asarray(out["pred"])[ok],
                                      base["pred"][ok])
    np.testing.assert_array_equal(masked["exit_idx"].numpy()[ok],
                                  base["exit_idx"][ok])
    assert (base["exit_idx"] > 0).all()
    with pytest.raises(ValueError, match="out of range"):
        eng.infer(x, min_exit=eng.n_exits)
    with pytest.raises(ValueError, match="unknown mode"):
        eng.infer(x, mode="warp")


def test_update_and_stats_match_jax(engines, median_tau):
    jeng, eng = _reset(engines, adapt=True)
    _install((jeng, eng), median_tau)
    served = 0
    for a, z in ((456, 520), (520, 584), (584, 648)):
        x, _ = DS.make_batch(DATA, range(a, z), split="eval")
        # the window must see the same decisions: serve only the rows
        # that no gate holds within EDGE of its threshold (under the
        # coefficients in force now) and no Sobel-edge image; the masked
        # pass records nothing
        x = x[~_edge_rows(eng.infer(x, mode="masked")) & ~_sobel_edge(x)]
        served += len(x)
        # the JAX side records through its masked path (the same
        # decisions as its compacted one)
        out = eng.infer(x)
        jout = jeng.infer(x, mode="masked", record=True, pad_to=BATCH)
        np.testing.assert_array_equal(out["exit_idx"], jout["exit_idx"])
    eng.update()
    jeng.update()
    ad, jad = eng.state.adaptive, jeng.state.adaptive
    for k in ("coef_temporal", "coef_class", "ucb_counts", "ucb_rewards",
              "active_strategy", "t", "ptr", "seen"):
        # window means in fp32 in another order -> 1e-6
        np.testing.assert_allclose(ad[k].numpy(), np.asarray(jad[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    st, jst = eng.stats(), jeng.stats()
    assert st["served"] == jst["served"] == served > 150
    np.testing.assert_array_equal(st["exit_counts"], jst["exit_counts"])
    np.testing.assert_allclose(st["total_macs"], jst["total_macs"],
                               rtol=1e-6)
    assert st["active_strategy"] == jst["active_strategy"]
    for k in jst["window"]:
        np.testing.assert_allclose(st["window"][k], jst["window"][k],
                                   atol=1e-6, rtol=0, err_msg=k)


# XLA's cost analysis also counts bias adds and ReLUs, which count_macs
# leaves out for AlexNet and VGG: normalised, within 0.5 % for the tiny
# ones.  ResNet's batchnorm, ReLU and residual adds count_macs counts
# (ResNet-18 within 5 MACs of XLA, at width 8 and at full width)
COST_RTOL = 0.01
# before ResNet's elementwise work was counted, XLA counted 5.3 % more
# than the convolutions at ResNet-18-narrow's first exit and 3.3 % at
# its last (the elementwise flops grow with the width, the MACs with its
# square); normalised, 1.9 % apart at the first exit (measured, seed 7)
COST_RTOL_CASE = {"resnet18-narrow": 0.025}


def test_measure_costs_match_jax(pair, request):
    """Normalised cumulative MACs within COST_RTOL of the JAX engine's,
    and handed to the policy as ``collect_calibration``'s
    ``cum_costs``."""
    jcfg, values, cfg, params = pair
    eng = DartEngine.from_config(cfg, params, device="cpu")
    got = eng.measure_costs((32, 32, 3))
    want = JaxEngine.from_config(jcfg, values).measure_costs((32, 32, 3))
    rtol = COST_RTOL_CASE.get(request.node.callspec.id, COST_RTOL)
    np.testing.assert_allclose(got / got[-1], want / want[-1], rtol=rtol)
    np.testing.assert_array_equal(eng.cum_costs, got)
    cal = eng.collect_calibration(DATA, n=8, batch=8)
    np.testing.assert_array_equal(cal.cum_costs, got / got[-1])


def test_measure_costs_resnet18_full_width_match_jax():
    """RESNET18_CIFAR at full width (one seeded init): raw and normalised
    within 1 % of XLA's count at every exit.  A count over the whole
    kernel, padding taps included (``FlopCounterMode`` at the aten
    level), misses XLA's by more than 10 % at the last exit."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = TB.RESNET18_CIFAR
    params = get_family(cfg).init(cfg, seed=0, device="cpu")
    eng = DartEngine.from_config(cfg, params, device="cpu")
    got = eng.measure_costs((32, 32, 3))
    want = JaxEngine.from_config(
        jTB.RESNET18_CIFAR, _jax_layout(params)).measure_costs((32, 32, 3))
    np.testing.assert_allclose(got, want, rtol=COST_RTOL)
    np.testing.assert_allclose(got / got[-1], want / want[-1],
                               rtol=COST_RTOL)
    assert 4.7e8 < got[-1] < 4.9e8
    fam = eng.family
    h = fam.apply_stem(params, torch.zeros(1, 32, 32, 3), cfg)
    with FlopCounterMode(display=False) as whole:
        for s in range(eng.n_exits):
            h = fam.apply_stage(params, h, s, cfg)
        fam.apply_exit(params, h, eng.n_exits - 1, cfg)
    assert whole.get_total_flops() / 2 > 1.1 * want[-1]
    eng.family = copy.copy(eng.family)
    eng.family.apply_stage = None
    assert not eng.family.staged
    with pytest.raises(ValueError, match="staged family"):
        eng.measure_costs((32, 32, 3))


def test_oversized_batch_splits_into_chunks(monkeypatch):
    cfg = TB.ALEXNET_TINY
    eng = DartEngine.from_config(
        cfg, get_family(cfg).init(cfg, seed=3, device="cpu"),
        device="cpu", adapt=False)
    cal = eng.collect_calibration(DATA, n=64, batch=64)
    eng.state = eng.state.with_policy(tau=_median_policy(cal), beta_diff=0.3)
    # random images: 1500 synthetic ones take seconds to draw
    x = np.random.RandomState(5).uniform(0, 1, (1500, 32, 32, 3)).astype(
        np.float32)
    spans = []
    chunk = eng._infer_compacted_chunk
    monkeypatch.setattr(eng, "_infer_compacted_chunk",
                        lambda xc, **kw: spans.append(len(xc))
                        or chunk(xc, **kw))
    out = eng.infer(x, mode="compacted")
    assert spans == [1024, 476]
    assert out["exit_idx"].shape == out["pred"].shape == (1500,)
    masked = eng.infer(x, mode="masked")
    ok = ~_edge_rows(masked)
    np.testing.assert_array_equal(out["exit_idx"][ok],
                                  masked["exit_idx"].numpy()[ok])
    np.testing.assert_array_equal(out["pred"][ok],
                                  masked["pred"].numpy()[ok])
    assert eng.stats()["served"] == 1500      # masked does not record


def test_from_config_defaults_to_cuda_and_raises_without_it(monkeypatch):
    cfg = TB.ALEXNET_TINY
    params = get_family(cfg).init(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DartEngine.from_config(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DartEngine.from_config(cfg, params, device="cuda")
    assert DartEngine.from_config(cfg, params, device="cpu").device.type \
        == "cpu"


def test_resnet18_full_width_tree_and_cuda_default(monkeypatch):
    """RESNET18_CIFAR at full width: the port's tree has the JAX init's
    shapes (~11.2 M parameters), and its engine runs on the card unless
    told otherwise."""
    from repro.models import get_family as jget_family
    from repro.parallel.sharding import unzip
    cfg = TB.RESNET18_CIFAR
    jshapes = jax.eval_shape(lambda: unzip(jget_family(
        jTB.RESNET18_CIFAR).init(jax.random.key(0), jTB.RESNET18_CIFAR))[0])
    params = get_family(cfg).init(cfg, seed=0, device="cpu")
    got = [tuple(t.shape) for t in convert.leaves(_jax_layout(params))]
    assert got == [tuple(a.shape) for a in jax.tree.leaves(jshapes)]
    assert sum(t.numel() for t in convert.leaves(params)) == 11_188_072
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DartEngine.from_config(cfg, params)
    eng = DartEngine.from_config(cfg, params, device="cpu")
    assert eng.device.type == "cpu" and eng.n_exits == 4


def test_state_constructors_default_to_cuda(monkeypatch):
    from repro_torch.core import adaptive as AD
    from repro_torch.engine.state import EngineState
    acfg = AD.AdaptiveConfig(n_exits=3, n_classes=10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: AD.init_state(acfg, **kw),
                 lambda **kw: EngineState.create(3, acfg, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    st = EngineState.create(3, acfg, device="cpu")
    assert st.tau.device.type == st.adaptive["ptr"].device.type == "cpu"


def test_registry_unknown_names_raise():
    for get, kind in ((REG.get_confidence, "confidence"),
                      (REG.get_difficulty, "difficulty"),
                      (REG.get_optimizer, "optimizer")):
        with pytest.raises(KeyError, match=f"unknown {kind} strategy"):
            get("warp")
    # strategies of later slices are unknown names in this one
    with pytest.raises(KeyError):
        REG.get_difficulty("tokens")
    with pytest.raises(KeyError):
        REG.get_optimizer("cascade_dp")
    assert float(REG.get_difficulty("zero")(torch.ones(3, 8, 8, 3)).sum()) \
        == 0.0
    lg = torch.randn(2, 5, 10)
    conf = REG.get_confidence("entropy")(lg)
    assert conf.shape == (2, 5) and bool(((conf > 0) & (conf <= 1)).all())
