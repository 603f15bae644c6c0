"""The port's paper math against the JAX package on the same numpy
inputs: thresholds (Eqs. 10, 12, 19, Alg. 1), routing, the section II.C
adaptation, the section II.B policy solvers, the Table I baselines with
``route_policy``, DAES and the estimator's FLOP count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jAD
from repro.core import daes as jDAES
from repro.core import difficulty as jDIFF
from repro.core import policy as jPOL
from repro.core import routing as jR
from repro.core import thresholds as jTH
from repro.engine import registry as jREG
from repro_torch.core import adaptive as AD
from repro_torch.core import daes as DAES
from repro_torch.core import difficulty as DIFF
from repro_torch.core import policy as POL
from repro_torch.core import routing as R
from repro_torch.core import thresholds as TH
from repro_torch.engine import registry as REG

# tiny tensors: one thread is faster than torch's pool, and leaves the
# cores to the JAX side and to other test workers
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _calib(n=256, e=4, seed=0):
    """Calibration measurements with confidence that rises with depth and
    correctness that tracks confidence, like a trained multi-exit net."""
    rs = np.random.RandomState(seed)
    depth = np.linspace(0.35, 0.9, e)[None, :]
    alpha = rs.uniform(0, 1, n)
    conf = np.clip(depth + 0.25 * rs.randn(n, e) - 0.2 * alpha[:, None],
                   0.05, 1.0)
    correct = (rs.uniform(0, 1, (n, e)) < conf).astype(float)
    cum = np.arange(1, e + 1) / e
    return conf, correct, alpha, cum


def test_thresholds_match_jax():
    conf, correct, alpha, cum = _calib()
    rs = np.random.RandomState(1)
    tau = rs.uniform(0.3, 0.9, 3).astype(np.float32)
    coef = rs.uniform(0.8, 1.2, 3).astype(np.float32)
    a32 = alpha.astype(np.float32)
    # Eq. 19, per-sample coefficients too: elementwise fp32 -> exact
    for c in (coef, rs.uniform(0.8, 1.2, (256, 3)).astype(np.float32)):
        np.testing.assert_array_equal(
            TH.adapt_thresholds(_t(tau), _t(c), _t(a32), 0.3).numpy(),
            np.asarray(jTH.adapt_thresholds(jnp.asarray(tau),
                                            jnp.asarray(c),
                                            jnp.asarray(a32), 0.3)))
    np.testing.assert_allclose(
        TH.stage_threshold(_t(tau[1]), _t(coef[1]), _t(a32), 0.3).numpy(),
        np.asarray(jTH.stage_threshold(tau[1], coef[1], jnp.asarray(a32),
                                       0.3)), atol=1e-7, rtol=0)
    eff = TH.adapt_thresholds(_t(tau), _t(coef), _t(a32), 0.3)
    idx, ex = TH.select_exit(_t(conf.T.astype(np.float32)), eff)
    jidx, jex = jTH.select_exit(jnp.asarray(conf.T, jnp.float32),
                                jnp.asarray(eff.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ex.numpy(), np.asarray(jex))
    np.testing.assert_array_equal(
        TH.simulate_routing(conf, alpha, tau, coef, 0.3).numpy(),
        np.asarray(jTH.simulate_routing(conf, alpha, tau, coef, 0.3)))
    # Eq. 10 in float32 on both sides: reductions of n terms -> 1e-6
    np.testing.assert_allclose(
        float(TH.objective(conf, alpha, correct, cum, tau, coef, 0.3, 0.5)),
        float(jTH.objective(conf, alpha, correct, cum, tau, coef, 0.3, 0.5)),
        atol=1e-6, rtol=0)
    np.testing.assert_array_equal(TH.candidate_thresholds(conf[:, 0]),
                                  jTH.candidate_thresholds(conf[:, 0]))
    np.testing.assert_allclose(
        TH.exit_distribution(idx, 4).numpy(),
        np.asarray(jTH.exit_distribution(jidx, 4)), atol=1e-7, rtol=0)
    np.testing.assert_allclose(
        float(TH.expected_cost(idx, cum)),
        float(jTH.expected_cost(jidx, cum)), atol=1e-6, rtol=0)
    for alpha_lo in (0.0, 0.5, 1.0):
        tau_hi = np.array([0.9, 0.8, 0.2])
        assert TH.min_exit_bound(tau_hi, np.ones(3), 0.3, alpha_lo) == \
            jTH.min_exit_bound(tau_hi, np.ones(3), 0.3, alpha_lo)


def test_route_matches_jax():
    conf, _, alpha, _ = _calib(n=128, e=3, seed=2)
    c32, a32 = conf.T.astype(np.float32), alpha.astype(np.float32)
    tau, coef = np.array([0.6, 0.75], np.float32), np.ones(2, np.float32)
    got = R.route(_t(c32), _t(a32), R.DartParams(tau=tau, coef=coef))
    want = jR.route(jnp.asarray(c32), jnp.asarray(a32),
                    jR.DartParams(tau=tau, coef=coef))
    for k in ("exit_idx", "conf", "eff_thresholds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    lg = np.random.RandomState(3).randn(3, 16, 10).astype(np.float32) * 3
    np.testing.assert_allclose(
        R.confidence_from_logits(_t(lg)).numpy(),
        np.asarray(jR.confidence_from_logits(jnp.asarray(lg))),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        R.entropy_from_logits(_t(lg)).numpy(),
        np.asarray(jR.entropy_from_logits(jnp.asarray(lg))),
        atol=1e-6, rtol=1e-6)
    idx = got["exit_idx"]
    np.testing.assert_array_equal(
        R.routed_macs(idx, np.array([1.0, 2.0, 4.0])).numpy(),
        np.asarray(jR.routed_macs(jnp.asarray(idx.numpy()),
                                  np.array([1.0, 2.0, 4.0]))))


def _lm_logits(fn, rs, b=6, v=32000):
    """Rows at V = 32000 where torch.softmax's serial CPU sums miss JAX:
    a planted top logit (conf 0.77 to 1) for conf, a wide spread for the
    entropy."""
    if fn == "entropy":
        return (rs.randn(b, v) * 4).astype(np.float32)
    lg = (rs.randn(b, v) * 2).astype(np.float32)
    lg[np.arange(b), rs.randint(0, v, b)] += 16
    return lg


@pytest.mark.parametrize("fn", ["confidence", "entropy", "exit_head"])
def test_softmax_chain_matches_jax_at_lm_vocab(fn):
    """At V = 32000 the port's conf and entropy (core.routing) and the
    plain exit head's conf stay within 1e-6 of JAX's: each writes out
    jax.nn.softmax's chain (torch.softmax adds a CPU row in long serial
    runs and missed JAX by 2e-6 to 1e-5 on these rows)."""
    from repro.kernels.exit_head.ref import ref_exit_head_gate as jhead
    from repro_torch.kernels.exit_head.ref import ref_exit_head_gate as head
    rs = np.random.RandomState(32000)
    if fn == "exit_head":
        d = 64
        args = (rs.randn(4, d).astype(np.float32),
                (1 + 0.1 * rs.randn(d)).astype(np.float32),
                (rs.randn(32000, d) * 0.5).astype(np.float32),
                np.full(4, 0.3, np.float32))
        got = [t.numpy() for t in head(*map(_t, args))]
        want = [np.asarray(a) for a in jhead(*map(jnp.asarray, args))]
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        return
    lg = _lm_logits(fn, rs)
    port, ref = {"confidence": (R.confidence_from_logits,
                                jR.confidence_from_logits),
                 "entropy": (R.entropy_from_logits,
                             jR.entropy_from_logits)}[fn]
    np.testing.assert_allclose(port(_t(lg)).numpy(),
                               np.asarray(ref(jnp.asarray(lg))),
                               atol=1e-6, rtol=0)


# one compiled program per shape instead of one per op
_jrecord = jax.jit(jAD.record_batch, static_argnums=1)
_jupdate = jax.jit(jAD.periodic_update, static_argnums=1)


def _records(rs, b, cfg):
    return dict(exit_idx=rs.randint(0, cfg.n_exits, b).astype(np.int32),
                pseudo_class=rs.randint(0, cfg.n_classes, b).astype(np.int32),
                conf=rs.uniform(0, 1, b).astype(np.float32),
                correct=(rs.uniform(0, 1, b) < 0.7).astype(np.float32),
                cost=rs.uniform(0, 1, b).astype(np.float32))


def _assert_state_close(got, want):
    assert set(got) == set(want)
    for k in want:
        # window means in fp32 in another order -> 1e-6
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("ucb", [True, False])
def test_adaptive_matches_jax(ucb):
    kw = dict(n_exits=4, n_classes=10, window=50, ucb_enabled=ucb)
    cfg, jcfg = AD.AdaptiveConfig(**kw), jAD.AdaptiveConfig(**kw)
    s, js = AD.init_state(cfg, device="cpu"), jAD.init_state(jcfg)
    rs = np.random.RandomState(4)
    # 70 > window: the ring keeps the last 50 rows, like the in-order
    # scatter of the reference
    for step, b in enumerate((17, 30, 70, 9, 33, 12)):
        rec = _records(rs, b, cfg)
        valid = (rs.uniform(0, 1, b) < 0.8).astype(np.float32) \
            if step == 3 else None
        s = AD.record_batch(s, cfg, *map(_t, rec.values()),
                            valid=None if valid is None else _t(valid))
        js = _jrecord(js, jcfg, *map(jnp.asarray, rec.values()),
                      valid=valid)
        _assert_state_close(s, js)
        s = AD.periodic_update(s, cfg, beta_opt=0.5)
        js = _jupdate(js, jcfg, beta_opt=0.5)
        _assert_state_close(s, js)
        np.testing.assert_allclose(
            AD.effective_coef(s, cfg).numpy(),
            np.asarray(jAD.effective_coef(js, jcfg)), atol=1e-6, rtol=0)
        pc = rs.randint(0, 10, 8).astype(np.int32)
        np.testing.assert_allclose(
            AD.effective_coef(s, cfg, _t(pc)).numpy(),
            np.asarray(jAD.effective_coef(js, jcfg, jnp.asarray(pc))),
            atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(AD.window_exit_depth(s, cfg)),
                               float(jAD.window_exit_depth(js, jcfg)),
                               atol=1e-6, rtol=0)
    st, jst = AD.window_stats(s, cfg), jAD.window_stats(js, jcfg)
    for k in jst:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


# brute force at 4 exits scores 9^3 candidates through the JAX
# objective op by op; 3 exits keep it quick
@pytest.mark.parametrize("optimizer,e", [
    ("optimize_joint_dp", 3), ("optimize_joint_dp", 4),
    ("optimize_brute_force", 3), ("optimize_independent", 3),
    ("optimize_independent", 4)])
def test_policy_solvers_match_jax(optimizer, e):
    conf, correct, alpha, cum = _calib(n=192, e=e, seed=10 + e)
    mk = (POL.CalibrationData, jPOL.CalibrationData)
    got = getattr(POL, optimizer)(mk[0](conf, correct, alpha, cum),
                                  beta_opt=0.5)
    want = getattr(jPOL, optimizer)(mk[1](conf, correct, alpha, cum),
                                    beta_opt=0.5)
    np.testing.assert_allclose(got.tau, want.tau, atol=1e-7, rtol=0)
    np.testing.assert_allclose(got.coef, want.coef, atol=0, rtol=0)
    assert got.beta_diff == want.beta_diff
    assert got.method == want.method
    np.testing.assert_allclose(got.objective, want.objective, atol=1e-6,
                               rtol=0)


def test_joint_dp_fit_beta_diff_matches_jax():
    conf, correct, alpha, cum = _calib(n=160, e=3, seed=21)
    got = POL.optimize_joint_dp(POL.CalibrationData(conf, correct, alpha,
                                                    cum), fit_beta_diff=True)
    want = jPOL.optimize_joint_dp(jPOL.CalibrationData(conf, correct, alpha,
                                                       cum),
                                  fit_beta_diff=True)
    np.testing.assert_allclose(got.tau, want.tau, atol=1e-7, rtol=0)
    assert got.beta_diff == want.beta_diff
    np.testing.assert_allclose(got.dp_thresholds, want.dp_thresholds)


def test_difficulty_class_host_and_tensor_agree():
    a = np.array([0.0, 0.35, 0.36, 0.65, 0.66, 1.0], np.float32)
    np.testing.assert_array_equal(DIFF.difficulty_class(a), [0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(DIFF.difficulty_class(_t(a)).numpy(),
                                  DIFF.difficulty_class(a))


def _calib_data(mk, seed, entropy, n=256, e=4):
    """One seeded calibration set for either package; with ``entropy``
    an entropy matrix that falls as confidence rises, plus noise."""
    conf, correct, alpha, cum = _calib(n=n, e=e, seed=seed)
    ent = None
    if entropy:
        rs = np.random.RandomState(seed + 100)
        ent = -np.log(conf) + 0.3 * rs.uniform(0, 1, conf.shape)
    return mk(conf, correct, alpha, cum, labels=np.arange(n) % 10,
              entropy=ent)


# the baselines are numpy on both sides (the Eq. 19 projection through
# each package's float32 simulate_routing): equal to the last bit
@pytest.mark.parametrize("entropy", [True, False])
@pytest.mark.parametrize("name", ["static", "branchynet", "rl_agent"])
def test_table1_baselines_match_jax(name, entropy):
    got = REG.get_optimizer(name)(
        _calib_data(POL.CalibrationData, 30, entropy), beta_opt=0.4)
    want = jREG.get_optimizer(name)(
        _calib_data(jPOL.CalibrationData, 30, entropy), beta_opt=0.4)
    for k in ("tau", "coef"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   atol=1e-12, rtol=0, err_msg=k)
    assert got.beta_diff == want.beta_diff
    assert got.method == want.method == name
    np.testing.assert_allclose(got.objective, want.objective, atol=1e-12,
                               rtol=0)
    if name == "rl_agent":
        np.testing.assert_array_equal(got.diagnostics["policy"].q,
                                      want.diagnostics["policy"].q)
    # a holdout of another seed, with and without entropy: the native
    # router (and the Eq. 19 projection where entropy is missing)
    for ent in (True, False):
        idx = REG.route_policy(got, _calib_data(POL.CalibrationData, 31,
                                                ent))
        jidx = jREG.route_policy(want, _calib_data(jPOL.CalibrationData,
                                                   31, ent))
        np.testing.assert_array_equal(idx, jidx)
        if name == "static":
            assert (idx == 3).all()
        else:
            assert len(np.unique(idx)) >= 2


def test_route_policy_without_router_matches_jax():
    data = (_calib_data(POL.CalibrationData, 32, False),
            _calib_data(jPOL.CalibrationData, 32, False))
    got = POL.optimize_joint_dp(data[0], beta_opt=0.5)
    want = jPOL.optimize_joint_dp(data[1], beta_opt=0.5)
    hold = (_calib_data(POL.CalibrationData, 33, False),
            _calib_data(jPOL.CalibrationData, 33, False))
    np.testing.assert_array_equal(REG.route_policy(got, hold[0]),
                                  jREG.route_policy(want, hold[1]))


def test_daes_and_estimator_flops_match_jax():
    """The port's DAES rows are the JAX package's under its ``macs``
    energy model, the one the port keeps."""
    rows = [("static", 0.61, 0.0042, 4.8e8), ("dart", 0.58, 0.0021, 2.1e8),
            ("rl", 0.55, 0.0030, 3.3e8)]
    ms = [DAES.MethodMeasurement(n, a, t, m) for n, a, t, m in rows]
    jms = [jDAES.MethodMeasurement(n, a, t, m) for n, a, t, m in rows]
    for m, jm in zip(ms, jms):
        assert DAES.summary_row(ms[0], m, 0.85) == \
            jDAES.summary_row(jms[0], jm, 0.85, "macs")
    for shape in ((32, 32, 3), (28, 28, 1)):
        assert DIFF.estimator_flops(*shape) == jDIFF.estimator_flops(*shape)
