"""The LM decode slice as a whole on the CPU: the port's
``ContinuousLMDecoder`` against the port's eager oracle (exactly, over
random admission streams, with the pool's invariants checked after every
admission and step), and both against the JAX package's continuous
decoder and eager oracle with the same weights, outside counted near-tie
rows.  Also admission, release, telemetry and the modes that raise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.routing import DartParams as JaxDart
from repro.engine import LMDecodeEngine as JaxEngine
from repro.models import transformer_lm as jTLM
from repro_torch import convert
from repro_torch.configs.tinyllama_1_1b import REDUCED
from repro_torch.core.routing import DartParams
from repro_torch.engine.compactor import OutOfCapacity
from repro_torch.engine.lm import LMDecodeEngine
from repro_torch.kernels import dispatch
from repro_torch.models import transformer_lm as TLM

# tiny tensors: one thread is faster than torch's pool, and leaves the
# cores to the JAX side and to other test workers
torch.set_num_threads(1)

# REDUCED widths with three stages (exits after layers 0 and 2)
CFG = dataclasses.replace(REDUCED, exit_layers=(0, 2))
JCFG = jTLM.LMConfig(
    name=CFG.name, n_layers=CFG.n_layers, d_model=CFG.d_model,
    n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads, d_ff=CFG.d_ff,
    vocab=CFG.vocab, exit_layers=CFG.exit_layers, max_seq=CFG.max_seq,
    rope_theta=CFG.rope_theta, tie_embeddings=CFG.tie_embeddings,
    remat=False)
POOL = dict(n_slots=4, page_size=4, max_len=16)
BETA = 1e-3
# a decision is flagged as a near-tie when the oracle's top-2 logit gap
# or |conf - tau'| at the deciding stage is below these: fp32 logits of
# the two packages (and of two batch shapes) differ in the low bits
GAP = 1e-4
EDGE = 1e-5


@pytest.fixture(scope="module")
def weights():
    p = TLM.lm_init(CFG, seed=11, device="cpu")
    values = convert.tree_map(lambda t: t.numpy(), p)
    return convert.from_jax_params(values, CFG, device="cpu"), values


@pytest.fixture(scope="module")
def tau(weights):
    """Per-gate tau from the median of each gate's conf (nothing fires in
    the probing run), lowered by the typical difficulty term so rows
    leave at every stage."""
    eng = LMDecodeEngine(CFG, weights[0], _dart(np.full(2, 2.0)),
                         device="cpu")
    conf = {0: [], 1: []}

    def probe(t, s, active, h, logits, c, eff):
        if s < 2:
            conf[s].append(c.numpy())
    prompts = np.random.RandomState(0).randint(0, CFG.vocab, (8, 5))
    eng._generate_eager(prompts, 6, probe=probe)
    return np.array([np.median(np.concatenate(conf[s])) - BETA * 0.3
                     for s in (0, 1)], np.float32)


def _dart(tau):
    return DartParams(tau=torch.as_tensor(tau, dtype=torch.float32),
                      coef=torch.ones(2), beta_diff=BETA)


def _engine(weights, tau):
    return LMDecodeEngine(CFG, weights[0], _dart(tau), device="cpu")


def _stream(seed, n_reqs, view_len):
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n_reqs):
        b = int(rs.randint(1, 3))
        s0 = int(rs.randint(1, 8))
        n_new = int(rs.randint(1, view_len - s0 + 2))
        reqs.append((i, rs.randint(0, CFG.vocab, (b, s0)), n_new))
    return reqs


def _synchronous_embed(jdec):
    """Make the JAX decoder's embed step finish before ``step()`` goes
    on.  That step reads the host ``fresh`` mask, which ``step()`` zeroes
    right after dispatching it; with the CPU backend's asynchronous
    dispatch the computation can read the zeroed buffer, skip the Eq. 8
    EMA reset of newly admitted slots and route those rows differently
    from run to run (about half of the runs of this file did)."""
    step = jdec._embed_step

    def embed_step():
        fn = step()
        return lambda *args: jax.block_until_ready(fn(*args))
    jdec._embed_step = embed_step
    return jdec


def _drive(dec, reqs, seed):
    """Admit FIFO at random steps (an idle pool always admits), checking
    the pool's invariants after every admission round and every step."""
    rs = np.random.RandomState(seed + 1000)
    results, pending, steps = {}, list(reqs), 0
    while len(results) < len(reqs):
        steps += 1
        assert steps < 500, "stream did not converge"
        while pending:
            tag, p, n = pending[0]
            if not dec.can_admit(p.shape[0], p.shape[1], n):
                break
            if dec.active_rows and rs.rand() < 0.5:
                break
            dec.admit(p, n, tag=tag)
            pending.pop(0)
        dec.check_invariants()
        for tag, toks, stgs in dec.step():
            results[tag] = (toks, stgs)
        dec.check_invariants()
    return results


def _oracle(eng, reqs, view_len, probe_log=None):
    """Each request through the port's eager oracle at the decoder's view
    length; with ``probe_log`` also each stage's (conf, tau', top-2 gap)
    per (request, row, step)."""
    out = {}
    for tag, p, n in reqs:
        diag = {}

        def probe(t, s, active, h, logits, conf, eff, diag=diag):
            top2 = torch.topk(logits.float(), 2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).numpy()
            e = np.full(len(active), np.nan) if eff is None else eff.numpy()
            for k, r in enumerate(active):
                diag[(int(r), t, s)] = (float(conf[k]), float(e[k]),
                                        float(gap[k]))
        out[tag] = eng._generate_eager(
            p, n, max_len=view_len,
            probe=probe if probe_log is not None else None)
        if probe_log is not None:
            probe_log[tag] = diag
    return out


def _flagged_divergence(want, got, diag):
    """Rows of one request where ``got`` leaves ``want``: None if they
    agree, True if the first divergent step is flagged by the oracle
    (top-2 gap < GAP or |conf - tau'| < EDGE at the deciding stage),
    False if it is not.  Later steps of a divergent row are exempt."""
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


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_continuous_equals_port_eager_oracle_exactly(weights, tau, seed):
    eng = _engine(weights, tau)
    dec = eng.continuous(**POOL)
    reqs = _stream(seed, 7, dec.view_len)
    got = _drive(dec, reqs, seed)
    want = _oracle(_engine(weights, tau), reqs, dec.view_len)
    stages = set()
    for tag, _, n in reqs:
        np.testing.assert_array_equal(got[tag][0], want[tag][0])
        np.testing.assert_array_equal(got[tag][1], want[tag][1])
        assert got[tag][0].shape[1] == n
        stages |= set(np.unique(got[tag][1]).tolist())
    assert stages == {0, 1, 2}                 # every stage took tokens
    # drained: every slot and page back on the free lists
    assert dec.active_rows == 0 and dec.allocator.in_use == 0
    assert dec.pool.in_use == 0


def test_continuous_matches_jax_continuous_outside_flagged_rows(weights,
                                                                 tau):
    eng = _engine(weights, tau)
    dec = eng.continuous(**POOL)
    reqs = _stream(7, 6, dec.view_len)
    got = _drive(dec, reqs, 7)
    jeng = JaxEngine(JCFG, weights[1],
                     JaxDart(tau=jnp.asarray(tau), coef=jnp.ones(2),
                             beta_diff=BETA))
    jdec = _synchronous_embed(jeng.continuous(**POOL))
    jgot = _drive(jdec, reqs, 7)
    diag = {}
    _oracle(_engine(weights, tau), reqs, dec.view_len, probe_log=diag)
    flags = []
    for tag, _, _ in reqs:
        flags += _flagged_divergence(jgot[tag], got[tag], diag[tag])
    assert all(flags), f"unflagged divergence from the JAX decoder: {flags}"
    assert len(flags) <= 1, f"{len(flags)} flagged rows"
    # the JAX decoder's telemetry agrees with the port's
    js, ps = jeng.stats(), eng.stats()
    if not flags:
        np.testing.assert_array_equal(js["exit_counts"], ps["exit_counts"])
    assert js["continuous"] == ps["continuous"]


def test_eager_matches_jax_eager_outside_flagged_rows(weights, tau):
    prompts = np.random.RandomState(5).randint(0, CFG.vocab, (3, 6))
    eng = _engine(weights, tau)
    diag = {}
    got = _oracle(eng, [(0, prompts, 5)], 16, probe_log=diag)[0]
    jeng = JaxEngine(JCFG, weights[1],
                     JaxDart(tau=jnp.asarray(tau), coef=jnp.ones(2),
                             beta_diff=BETA))
    want = jeng.generate(prompts, 5, max_len=16, mode="eager")
    flags = _flagged_divergence(want, got, diag[0])
    assert all(flags) and len(flags) <= 1, flags
    assert len(np.unique(got[1])) >= 2


def test_decoder_alpha_follows_the_oracle_across_slot_reuse(weights, tau):
    """A slot handed to a new request restarts its Eq. 8 EMA at 0.5."""
    eng = _engine(weights, tau)
    dec = eng.continuous(n_slots=1, page_size=4, max_len=16)
    rs = np.random.RandomState(9)
    first, second = (rs.randint(0, CFG.vocab, (1, 4)) for _ in range(2))
    dec.admit(first, 3)
    while dec.active_rows:
        dec.step()
    dec.admit(second, 2)
    dec.step()
    oracle = _engine(weights, tau)
    cache = oracle.prefill(second[:, :-1], oracle.init_cache(1,
                                                             dec.view_len))
    _, _, _, alpha = oracle.decode_step(second[:, -1], cache, 3,
                                        np.full(1, 0.5, np.float32))
    np.testing.assert_allclose(dec.alpha.numpy(), alpha, atol=1e-7)


def test_admission_is_all_or_nothing_and_release_frees(weights, tau):
    dec = _engine(weights, tau).continuous(**POOL)
    rs = np.random.RandomState(3)
    dec.admit(rs.randint(0, CFG.vocab, (3, 4)), 4, tag="a")
    dec.check_invariants()
    held = (dec.pool.in_use, dec.allocator.in_use)
    assert held == (3, 3 * dec.pages_needed(4, 4))
    assert not dec.can_admit(2, 4, 4)
    with pytest.raises(OutOfCapacity):
        dec.admit(rs.randint(0, CFG.vocab, (2, 4)), 4, tag="b")
    assert (dec.pool.in_use, dec.allocator.in_use) == held   # nothing taken
    with pytest.raises(ValueError, match="never fit"):
        dec.admit(rs.randint(0, CFG.vocab, (1, 10)), 10)
    dec.step()
    assert dec.slots_of("a") == [0, 1, 2]
    assert dec.release("a") and not dec.release("a")
    dec.check_invariants()
    assert dec.slots_of("a") == []
    assert dec.occupancy() == {"slots_total": 4, "slots_in_use": 0,
                               "pages_total": 16, "pages_in_use": 0,
                               "pages_peak": held[1]}
    dec.admit(rs.randint(0, CFG.vocab, (4, 4)), 4, tag="c")   # room again
    dec.check_invariants()


def test_generate_modes_and_telemetry(weights, tau):
    prompts = np.random.RandomState(4).randint(0, CFG.vocab, (6, 5))
    eng = _engine(weights, tau)
    with pytest.raises(ValueError, match="needs a mesh"):
        eng.generate(prompts, 3, mode="sharded")
    with pytest.raises(ValueError, match="unknown mode"):
        eng.generate(prompts, 3, mode="bucketed")
    dispatch.reset_launch_counts()
    toks, stgs = eng.generate(prompts, 4, mode="continuous")
    assert dispatch.launch_counts() == {"exit_gate": 0, "difficulty": 0,
                                        "exit_head": 0, "paged_gather": 0}
    dec = eng._cont_default
    want = _engine(weights, tau).generate(prompts, 4, max_len=dec.view_len)
    np.testing.assert_array_equal(toks, want[0])
    np.testing.assert_array_equal(stgs, want[1])
    st = eng.stats()
    assert st["served"] == toks.size
    np.testing.assert_array_equal(
        st["exit_counts"], np.bincount(stgs.ravel(), minlength=3))
    np.testing.assert_array_equal(eng.stats_exit, st["exit_counts"])
    steps = eng.step_counts[("lm-cont-decode", 16, 8, dec.pages_per_slot)]
    assert st["continuous"]["decode_steps"] == steps
    assert st["continuous"]["slot_steps"] == toks.size
    assert eng.step_counts[("lm-cont-embed", 16)] == steps
    assert st["layers_run"] + st["layers_skipped"] == toks.size * 4
    cum = np.array([1, 3, 4]) / 4
    assert st["total_macs"] == pytest.approx(float(cum[stgs].sum()))


def test_engine_defaults_to_cuda(weights, tau):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is taken")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMDecodeEngine(CFG, weights[0], _dart(tau))
