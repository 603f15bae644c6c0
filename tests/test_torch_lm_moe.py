"""granite-moe-3b-a800m's LM in the port against the JAX package on the
CPU, at REDUCED widths (3 layers, d_model 64, 8 experts top-2, vocab
256, float32), and the port's continuous decoder against the step-replay
oracle of ``chip_smoke.py``.

Both packages take the same weights and the same numpy tokens.  Held to
JAX: ``lm_forward``'s exit hidden rows and ``aux_loss``, the Eq. 18
``lm_multi_exit_loss`` and every leaf's gradient with ``remat`` and
``layer_scan`` each on; ``lm_prefill``, ``lm_prefill_scan`` and
``lm_decode_step``; ``_stage_apply_paged`` with idle slots at low
indices and a router that makes the capacity drop pairs (the idle slots
take the capacity first: a reference quirk the port keeps); the eager
``generate`` outside flagged near-tie rows; five ``Trainer`` steps; the
parameter and flop counts at full width; the registry; ``convert`` of
the MoE leaves.

The continuous decoder is held exactly to the CPU form of the
step-replay oracle: every served step replayed from its snapshot with
the plain kernels and the served fire pattern, the hidden rows bit-equal
and every decision equal.  The eager path routes other rows (the
compacted survivors of each stage), which a MoE call's output depends
on, so eager and continuous differ where a drop occurs; that is pinned
too.  A zero router in layer 1 makes every row pick experts 0 and 1
(ties go to the lower index), so at 16 rows a call keeps 8 and drops
the rest.

Tolerances, float32 throughout: hidden rows and losses within FWD_TOL
(products and sums in another order), gradients within GRAD_RTOL of
each leaf's norm, trainer losses and parameters as
``test_torch_lm_train.py`` holds them.
"""
import dataclasses
import importlib.util
import pathlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jREG
from repro.core.routing import DartParams as JaxDart
from repro.data import datasets as jDS
from repro.engine import LMDecodeEngine as JaxEngine
from repro.engine import lm as jLM
from repro.models import layers as jL
from repro.models import transformer_lm as jTLM
from repro.parallel.sharding import unzip
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch import optim as OPT
from repro_torch.configs import registry as REG
from repro_torch.core.routing import DartParams
from repro_torch.data import datasets as DS
from repro_torch.engine import lm as LM
from repro_torch.engine.lm import LMDecodeEngine
from repro_torch.kernels import dispatch as KD
from repro_torch.kernels.exit_head import ref as href
from repro_torch.kernels.paged_gather import ref as pref
from repro_torch.models import transformer_lm as TLM

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_RTOL = 1e-4
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4
FLIP_SHARE = 0.02
ARCH = "granite-moe-3b-a800m"
VARIANTS = {"plain": {}, "remat": {"remat": True},
            "layer_scan": {"layer_scan": True}}
SEQ = 16
BATCH = 3
DATA = DS.DatasetConfig(name="synth-tokens", n_train=64, n_eval=64)
JDATA = jDS.DatasetConfig(name="synth-tokens", n_train=64, n_eval=64)
TRAIN = dict(batch_size=4, steps=5, lr=3e-3, warmup=2)
#: the decode tests: three stages (exits after layers 0 and 1), a zero
#: router in layer 1, 16 slots (capacity 8)
EXITS = (0, 1)
HOT = 1
SLOTS = 16
POOL = dict(n_slots=SLOTS, page_size=4, max_len=24)
BETA = 1e-3
# a decision is flagged as a near-tie when the oracle's top-2 logit gap
# or |conf - tau'| at the deciding stage is below these
GAP = 1e-4
EDGE = 1e-5


def _fold(key, name):
    """``repro.models.layers.rng`` with a hash-free fold per token."""
    for token in name.split("/"):
        key = jax.random.fold_in(key, zlib.crc32(token.encode()) % (2**31 - 1))
    return key


def _fixed_rng_for(cfg, index, split):
    """``datasets._rng_for`` with a hash-free base per (seed, split)."""
    base = zlib.crc32(f"{cfg.seed}/{split}".encode()) % (2**31 - 1)
    return np.random.RandomState(base ^ (index * 2654435761 % (2**31 - 1)))


@pytest.fixture(scope="module", autouse=True)
def _fixed_draws():
    """The JAX init and the token sets fold a str hash: fold a hash-free
    one, so every worker and run sees one draw."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jL, "rng", _fold)
        for mod in (jDS, DS):
            mp.setattr(mod, "_rng_for", _fixed_rng_for)
        yield


def _cfgs(**kw):
    return (dataclasses.replace(jREG.get_reduced(ARCH), **kw),
            dataclasses.replace(REG.get_reduced(ARCH), **kw))


def _weights(jcfg, cfg, seed=0):
    """The JAX init's values and the same tree converted to the port."""
    values = jax.device_get(unzip(jTLM.lm_init(jax.random.key(seed),
                                               jcfg))[0])
    return values, convert.from_jax_params(values, cfg, device="cpu")


def _tokens(vocab, seed=3, shape=(BATCH, SEQ + 1)):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _paths(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _chip_smoke():
    """``chip_smoke.py`` of the repository root, as a module (it imports
    only numpy and torch at the top; its CUDA work is inside functions)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# forward, loss, gradients, prefill and decode against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_loss_and_grads_match_jax(variant):
    """``lm_forward``'s exit hidden rows and ``aux_loss`` (the MoE layers'
    load-balance loss, summed), the Eq. 18 loss and every leaf's
    gradient (the routers' and the experts' too) against JAX's."""
    jcfg, cfg = _cfgs(**VARIANTS[variant])
    values, params = _weights(jcfg, cfg)
    if cfg.layer_scan:
        assert params["layers"] == []
        assert tuple(params["segments"][0]["moe"]["w_gate"].shape) == \
            (1, 8, 64, 64)
    toks = _tokens(cfg.vocab)
    x, y = toks[:, :-1], toks[:, 1:]

    def jfn(p, x, y):
        out = jTLM.lm_forward(p, x, jcfg)
        (loss, aux), g = jax.value_and_grad(
            lambda p: jTLM.lm_multi_exit_loss(p, x, y, jcfg),
            has_aux=True)(p)
        return out["exit_hidden"], out["aux_loss"], loss, aux, g
    jh, jauxl, jloss, jaux, jg = jax.jit(jfn)(values, jnp.asarray(x),
                                              jnp.asarray(y))
    with torch.no_grad():
        out = TLM.lm_forward(params, torch.from_numpy(x).long(), cfg)
    assert len(out["exit_hidden"]) == cfg.n_exits
    for i, (h, jh_) in enumerate(zip(out["exit_hidden"], jh)):
        _close(h, jh_, FWD_TOL, f"exit hidden {i}")
    assert float(out["aux_loss"]) > 0
    _close(out["aux_loss"], jauxl, FWD_TOL, "aux_loss")

    (loss, aux), g = OPT.value_and_grad(
        lambda p: TLM.lm_multi_exit_loss(p, torch.from_numpy(x).long(),
                                         torch.from_numpy(y).long(), cfg),
        params)
    _close(loss, jloss, FWD_TOL, "loss")
    _close(aux["aux_loss"], jaux["aux_loss"], FWD_TOL, "loss aux")
    for i, (c, jc) in enumerate(zip(aux["ce_per_exit"], jaux["ce_per_exit"])):
        _close(c, jc, FWD_TOL, f"ce exit {i}")
    want = _paths(convert.from_jax_params(jax.device_get(jg), cfg,
                                          device="cpu"))
    got = _paths(g)
    assert set(got) == set(want)
    assert any("router" in p for p in want)
    for path, w in want.items():
        w = w.numpy().astype(np.float64)
        err = np.linalg.norm(got[path].numpy() - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (path, err)


def test_prefill_decode_and_scan_prefill_match_jax():
    """A prefill, then three ``lm_decode_step``s against JAX's (exit
    hidden rows and the cache), and ``lm_prefill_scan`` on the stacked
    tree against JAX's."""
    jcfg, cfg = _cfgs()
    values, params = _weights(jcfg, cfg)
    toks = _tokens(cfg.vocab, seed=7, shape=(2, 9))
    max_len = 16
    jcache = jTLM.lm_init_cache(jcfg, 2, max_len)
    jcache, jh0 = jax.jit(lambda p, t, c: jTLM.lm_prefill(p, t, jcfg, c))(
        values, jnp.asarray(toks[:, :6]), jcache)
    cache = TLM.lm_init_cache(cfg, 2, max_len, device="cpu")
    _, h0 = TLM.lm_prefill(params, torch.from_numpy(toks[:, :6]).long(),
                           cfg, cache)
    for a, b in zip(h0, jh0):
        _close(a, b, FWD_TOL, "prefill exits")
    jstep = jax.jit(lambda p, t, c, i: jTLM.lm_decode_step(p, t, c, i,
                                                           jcfg))
    for i in range(6, 9):
        jh, jcache = jstep(values, jnp.asarray(toks[:, i:i + 1]), jcache, i)
        h, cache = TLM.lm_decode_step(
            params, torch.from_numpy(toks[:, i:i + 1]).long(), cache, i,
            cfg)
        for e, (a, b) in enumerate(zip(h, jh)):
            _close(a, b, FWD_TOL, f"step {i} exit {e}")
    for layer in range(cfg.n_layers):
        for name in ("k", "v"):
            _close(cache[layer][name][:, :9], jcache[layer][name][:, :9],
                   FWD_TOL, f"cache {layer} {name}")

    jscfg, scfg = _cfgs(layer_scan=True)
    svalues, sparams = _weights(jscfg, scfg)
    x = toks[:, :8]
    jd, jseg, jh = jax.jit(lambda p, t: jTLM.lm_prefill_scan(p, t, jscfg))(
        svalues, jnp.asarray(x))
    d, seg, h = TLM.lm_prefill_scan(sparams, torch.from_numpy(x).long(),
                                    scfg)
    assert d == [] and len(jd) == 0
    assert len(seg) == len(jseg) == len(TLM.scan_segments(scfg))
    for a, b in zip(seg, jseg):
        for name in ("k", "v"):
            _close(a[name], b[name], FWD_TOL, f"segment {name}")
    for a, b in zip(h, jh):
        _close(a, b, FWD_TOL, "scan prefill exits")


def test_dense_prefix_stays_unstacked():
    """With ``n_dense_layers`` the leading layers are dense and, under
    ``layer_scan``, kept unstacked ahead of the MoE segments, as in JAX:
    the forward and the scan prefill (its dense caches) match JAX's."""
    kw = dict(n_layers=4, n_dense_layers=2, exit_layers=(0, 2),
              layer_scan=True)
    jcfg, cfg = _cfgs(**kw)
    assert TLM.scan_segments(cfg) == jTLM.scan_segments(jcfg) == [(2, 3),
                                                                  (3, 4)]
    values, params = _weights(jcfg, cfg)
    assert [("ffn" in p, "moe" in p) for p in params["layers"]] == \
        [(True, False)] * 2
    assert "moe" in params["segments"][0]
    x = _tokens(cfg.vocab, seed=8, shape=(2, 8))
    out = TLM.lm_forward(params, torch.from_numpy(x).long(), cfg)
    jout = jax.jit(lambda p, t: jTLM.lm_forward(p, t, jcfg))(
        values, jnp.asarray(x))
    for a, b in zip(out["exit_hidden"], jout["exit_hidden"]):
        _close(a, b, FWD_TOL, "exit hidden")
    _close(out["aux_loss"], jout["aux_loss"], FWD_TOL, "aux")
    d, _, h = TLM.lm_prefill_scan(params, torch.from_numpy(x).long(), cfg)
    jd, _, jh = jax.jit(lambda p, t: jTLM.lm_prefill_scan(p, t, jcfg))(
        values, jnp.asarray(x))
    assert len(d) == len(jd) == 2
    _close(d[1]["v"], jd[1]["v"], FWD_TOL, "dense cache")
    for a, b in zip(h, jh):
        _close(a, b, FWD_TOL, "scan prefill exits")


# ---------------------------------------------------------------------------
# the decode engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """The port's seeded init at REDUCED widths with exits after layers 0
    and 1 and a zero router in layer ``HOT``: (port params, numpy
    values)."""
    cfg = _cfgs(exit_layers=EXITS)[1]
    p = TLM.lm_init(cfg, seed=11, device="cpu")
    p["layers"][HOT]["moe"]["router"].zero_()
    values = convert.tree_map(lambda t: t.numpy(), p)
    return convert.from_jax_params(values, cfg, device="cpu"), values


def _dart(tau):
    return DartParams(tau=torch.as_tensor(tau, dtype=torch.float32),
                      coef=torch.ones(2), beta_diff=BETA)


def _engine(weights, tau):
    return LMDecodeEngine(_cfgs(exit_layers=EXITS)[1], weights[0],
                          _dart(tau), device="cpu")


@pytest.fixture(scope="module")
def tau(weights):
    """Per-gate tau from the median of each gate's conf (nothing fires in
    the probing run), lowered by the typical difficulty term so rows
    leave at every stage."""
    eng = _engine(weights, np.full(2, 2.0))
    conf = {0: [], 1: []}

    def probe(t, s, active, h, logits, c, eff):
        if s < 2:
            conf[s].append(c.numpy())
    prompts = np.random.RandomState(0).randint(0, 256, (8, 5))
    eng._generate_eager(prompts, 6, probe=probe)
    return np.array([np.median(np.concatenate(conf[s])) - BETA * 0.3
                     for s in (0, 1)], np.float32)


def _stream(seed, n_reqs, max_len):
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n_reqs):
        s0 = int(rs.randint(1, 8))
        n_new = int(rs.randint(2, max_len - s0 + 2))
        reqs.append((i, rs.randint(0, 256, (1, s0)), n_new))
    return reqs


def _drive(dec, reqs, seed):
    """Admit FIFO at random steps, so slots free and refill mid-run and
    idle slots sit below busy ones."""
    rs = np.random.RandomState(seed + 1000)
    results, pending, steps = {}, list(reqs), 0
    while len(results) < len(reqs):
        steps += 1
        assert steps < 500, "stream did not converge"
        while pending:
            tag, p, n = pending[0]
            if not dec.can_admit(1, p.shape[1], n):
                break
            if dec.active_rows and rs.rand() < 0.3:
                break
            dec.admit(p, n, tag=tag)
            pending.pop(0)
        for tag, toks, stgs in dec.step():
            results[tag] = (toks[0], stgs[0])
    return results


def test_stage_apply_paged_keeps_idle_low_slots_first_in_the_queue(weights):
    """One paged stage (layers 0-1) over 16 slots, 0-7 idle (they must not
    write), against JAX's: output rows and pages equal.  Layer 1's zero
    router sends every slot to experts 0 and 1, whose capacity (8) the
    idle slots take first, so the active slots' pairs there are dropped;
    without the idle slots in the call, the active rows' output
    differs."""
    p, values = weights
    cfg = _cfgs(exit_layers=EXITS)[1]
    jcfg = dataclasses.replace(jREG.get_reduced(ARCH), exit_layers=EXITS)
    rs = np.random.RandomState(4)
    n, psz, per = 40, 4, 2
    pages = [{k: rs.normal(size=(n, psz, cfg.n_kv_heads, cfg.hd)).astype(
        np.float32) for k in ("k", "v")} for _ in range(2)]
    table = rs.permutation(n)[:SLOTS * per].reshape(SLOTS, per).astype(
        np.int32)
    pos = rs.randint(0, per * psz, SLOTS).astype(np.int32)
    page_w = table[np.arange(SLOTS), pos // psz]
    run = np.arange(SLOTS) >= 8
    page_idx = np.where(run, page_w, n).astype(np.int32)
    x = rs.normal(size=(SLOTS, 1, cfg.d_model)).astype(np.float32)

    def port(rows):
        pg = [{k: torch.from_numpy(np.concatenate(
            [v, np.zeros_like(v[:1])])) for k, v in layer.items()}
            for layer in pages]
        out, _ = LM._stage_apply_paged(
            p, torch.from_numpy(x[rows]), pg, torch.from_numpy(table[rows]),
            torch.from_numpy(page_idx[rows]),
            torch.from_numpy(pos[rows] % psz), torch.from_numpy(pos[rows]),
            cfg=cfg, a=0, b=2)
        return out.numpy(), pg

    out, pg = port(np.arange(SLOTS))
    jout, jpg = jLM._stage_apply_paged(
        values, jnp.asarray(x), [{k: jnp.asarray(v) for k, v in layer.items()}
                                 for layer in pages],
        jnp.asarray(table), jnp.asarray(page_idx), jnp.asarray(pos % psz),
        jnp.asarray(pos), cfg=jcfg, a=0, b=2)
    _close(out, jout, FWD_TOL, "stage output")
    for layer in range(2):
        for k in ("k", "v"):
            _close(pg[layer][k][:-1], jpg[layer][k], FWD_TOL, "pages")
    alone, _ = port(np.nonzero(run)[0])
    gap = np.abs(alone - out[run]).max(axis=(1, 2))
    assert (gap > 1e-3).all(), gap


def test_eager_generate_matches_jax_outside_flagged_rows(weights, tau):
    """12 prompts decode in one 16-row bucket (4 pad rows): the same
    compaction gives the same rows to every MoE call, in JAX as in the
    port, and layer 1 drops pairs at the first stages.  Tokens and
    stages equal JAX's eager ``generate`` outside rows whose first
    divergent step the port's oracle flags."""
    cfg = _cfgs(exit_layers=EXITS)[1]
    jcfg = dataclasses.replace(jREG.get_reduced(ARCH), exit_layers=EXITS)
    prompts = np.random.RandomState(5).randint(0, cfg.vocab, (12, 6))
    diag = {}

    def probe(t, s, active, h, logits, conf, eff):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        e = np.full(len(active), np.nan) if eff is None else eff.numpy()
        for k, r in enumerate(active):
            diag[(int(r), t, s)] = (float(conf[k]), float(e[k]),
                                    float(gap[k]))
    got = _engine(weights, tau)._generate_eager(prompts, 5, max_len=16,
                                                probe=probe)
    jeng = JaxEngine(jcfg, weights[1],
                     JaxDart(tau=jnp.asarray(tau), coef=jnp.ones(2),
                             beta_diff=BETA))
    want = jeng.generate(prompts, 5, max_len=16, mode="eager")
    flags = []
    for r in range(prompts.shape[0]):
        bad = np.nonzero((want[0][r] != got[0][r])
                         | (want[1][r] != got[1][r]))[0]
        if len(bad):
            t = int(bad[0])
            s = int(min(want[1][r, t], got[1][r, t]))
            conf, eff, gap = diag[(r, t, s)]
            flags.append(bool(gap < GAP or abs(conf - eff) < EDGE))
    assert all(flags) and len(flags) <= 1, flags
    assert len(np.unique(got[1])) >= 2


@pytest.mark.parametrize("seed", [0, 1])
def test_continuous_equals_the_step_replay_oracle(weights, tau, seed):
    """The continuous decoder over a random admission stream, every step
    replayed by ``chip_smoke.lm_step_replay`` (the plain kernels, the
    served fire pattern): every stage's hidden rows bit-equal (it raises
    otherwise) and every decision equal to the plain head's own on the
    served context.  The stream has idle slots below busy ones, and the
    replayed steps drop MoE pairs."""
    cs = _chip_smoke()
    eng = _engine(weights, tau)
    dec = eng.continuous(**POOL)
    replay, counts, undo = cs.lm_step_replay(eng, dec, href, pref)
    reqs = _stream(seed, 24, POOL["max_len"])
    results = _drive(dec, reqs, seed)
    undo()
    n = 0
    stages = set()
    for tag, _, n_new in reqs:
        toks, stgs = results[tag]
        assert len(toks) == n_new
        for t in range(n_new):
            own_t, own_s, recs = replay[(tag, t)]
            assert (own_t, own_s) == (toks[t], stgs[t]), (tag, t)
            assert set(recs) == {0, 1, 2}
            n += 1
        stages |= set(stgs.tolist())
    assert n == counts["rows"] == sum(n for _, _, n in reqs)
    assert stages == {0, 1, 2}
    assert counts["idle_below_active"] > 0
    assert counts["moe_pairs_dropped"] > 0
    cmp = cs.lm_decisions("cpu", reqs, results, replay, "float32")
    assert cmp["equal"] == cmp["decisions"] == n
    # the step counted as before: the replay left the pool as served
    assert dec.active_rows == 0 and dec.allocator.in_use == 0


def test_step_replay_catches_a_wrong_gather(weights, tau):
    """A served step whose gather reads another slot's pages differs from
    the replay's plain gather, and the oracle stops at the hidden
    rows."""
    cs = _chip_smoke()
    eng = _engine(weights, tau)
    dec = eng.continuous(**POOL)
    replay, _, _ = cs.lm_step_replay(eng, dec, href, pref)
    rs = np.random.RandomState(3)
    for i in range(3):
        dec.admit(rs.randint(0, 256, (1, 6)), 4, tag=i)
    good = KD.paged_gather
    KD.paged_gather = lambda pages, table: pref.ref_paged_gather(
        pages, table.roll(1, 0))
    try:
        with pytest.raises(cs.SmokeFailure, match="hidden rows differ"):
            dec.step()
    finally:
        KD.paged_gather = good


def test_eager_and_continuous_route_other_rows(weights):
    """Fact 3: a request decoded alone by the eager step is one row in
    every MoE call; in the continuous step it shares layer 1's call
    with all 16 slots, and a slot past the capacity (8) loses its pairs
    there.  Its hidden row after layer 1 differs from the eager one;
    a slot below the capacity agrees within FWD_TOL.  No gate fires (tau
    2), so no row's deeper KV comes from CALM propagation."""
    never = np.full(2, 2.0)
    eng = _engine(weights, never)
    dec = eng.continuous(**POOL)
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, 256, (1, 5)) for _ in range(SLOTS)]
    for i, pr in enumerate(prompts):
        dec.admit(pr, 2, tag=i)
    seen = {}
    inner = eng._head_traced

    def traced(params, h, exit_name, eff):
        seen[eng.exit_names.index(exit_name)] = h.clone()
        return inner(params, h, exit_name, eff)
    eng._head_traced = traced
    dec.step()
    del eng._head_traced
    for slot in (2, 12):
        oracle = _engine(weights, never)
        rows = {}
        cache = oracle.prefill(prompts[slot][:, :-1],
                               oracle.init_cache(1, dec.view_len))
        oracle.decode_step(prompts[slot][:, -1], cache, 4,
                           np.full(1, 0.5, np.float32),
                           probe=lambda s, a, h, *_: rows.setdefault(s, h))
        d = float((seen[1][slot] - rows[1][0]).abs().max())
        assert (d <= FWD_TOL) == (slot < 8), (slot, d)


# ---------------------------------------------------------------------------
# the trainer, counts, registry and convert
# ---------------------------------------------------------------------------

def test_trainer_steps_match_jax():
    """Five ``train_step``s of REDUCED granite on the same token batches:
    the loss per step within LOSS_TOL, then the parameters as
    test_torch_lm_train.py holds them."""
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    jcfg, cfg = _cfgs()
    jtr = JTrainer(jcfg, JTrainConfig(**TRAIN), JDATA, data_kind="tokens")
    tr = Trainer(cfg, TrainConfig(**TRAIN), DATA,
                 params=convert.from_jax_params(jax.device_get(jtr.params),
                                                cfg, device="cpu"),
                 device="cpu")
    losses, jlosses = [], []
    for s in range(TRAIN["steps"]):
        x = _tokens(cfg.vocab, seed=20 + s,
                    shape=(TRAIN["batch_size"], SEQ + 1))
        y = np.zeros(TRAIN["batch_size"], np.int32)
        jlosses.append(jtr.train_step((jnp.asarray(x), jnp.asarray(y))))
        losses.append(tr.train_step((x, y)))
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_TOL, rtol=0)
    lr = OPT.warmup_cosine(TRAIN["lr"], TRAIN["warmup"], TRAIN["steps"])
    flip = 2 * sum(float(lr(s)) for s in range(TRAIN["steps"] + 1))
    want = _paths(convert.from_jax_params(jax.device_get(jtr.params), cfg,
                                          device="cpu"))
    got = _paths(tr.params)
    n_far = n_all = 0
    for path in want:
        diff = np.abs(got[path].numpy() - want[path].numpy())
        assert diff.max() <= flip, (path, diff.max())
        n_far += int((diff > PARAM_TOL).sum())
        n_all += diff.size
    assert n_far <= FLIP_SHARE * n_all, (n_far, n_all)


def test_param_and_flop_counts_match_jax():
    """The analytic counts at full width and at REDUCED, and the full
    width's count equal to the leaves the init makes (meta device)."""
    for cfg, jcfg in ((REG.get(ARCH), jREG.get(ARCH)),
                      (REG.get_reduced(ARCH), jREG.get_reduced(ARCH))):
        assert TLM.lm_param_count(cfg) == jTLM.lm_param_count(jcfg)
        assert TLM.lm_active_param_count(cfg) == \
            jTLM.lm_active_param_count(jcfg)
        for kw in ({}, {"kv_len": 512}, {"n_exits_computed": 1}):
            assert TLM.lm_forward_flops(cfg, 4, 256, **kw) == \
                jTLM.lm_forward_flops(jcfg, 4, 256, **kw), kw
        assert TLM.lm_train_flops(cfg, 8, 256) == \
            jTLM.lm_train_flops(jcfg, 8, 256)
    cfg = REG.get(ARCH)
    tree = TLM.lm_init(cfg, device="meta")
    n = sum(t.numel() for t in convert.leaves(tree))
    assert n == TLM.lm_param_count(cfg) + cfg.n_exits * cfg.d_model
    assert 3.2e9 < n < 3.4e9
    assert 0.7e9 < TLM.lm_active_param_count(cfg) < 0.9e9
    assert tree["layers"][0]["moe"]["router"].dtype == torch.float32


def test_registry_has_granite_and_refuses_item_6c():
    """``granite-moe-3b-a800m`` resolves to the JAX package's config,
    every field (the MoE config's too) at full and REDUCED width;
    ``deepseek-v3-671b`` raises naming item 6c."""
    for get, jget in ((REG.get, jREG.get),
                      (REG.get_reduced, jREG.get_reduced)):
        cfg, jcfg = get(ARCH), jget(ARCH)
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if "dtype" in f.name:
                assert str(got).removeprefix("torch.") == \
                    jnp.dtype(want).name
            elif f.name == "moe":
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
        assert all(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    with pytest.raises(KeyError, match="item 6c"):
        REG.get("deepseek-v3-671b")


def test_convert_passes_the_moe_leaves():
    """A bf16 JAX tree converts with no layout change: the router stays
    float32, the experts (E, D, F) / (E, F, D) bf16, and under
    ``layer_scan`` the stacked (L, E, D, F) leaves keep their layout."""
    for kw in ({}, {"layer_scan": True}):
        jcfg, cfg = _cfgs(param_dtype=jnp.bfloat16, **kw)
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
        values = jax.device_get(unzip(jTLM.lm_init(jax.random.key(2),
                                                   jcfg))[0])
        params = convert.from_jax_params(values, cfg, device="cpu")
        moe, jmoe = ((params["segments"][0]["moe"],
                      values["segments"][0]["moe"]) if kw else
                     (params["layers"][0]["moe"], values["layers"][0]["moe"]))
        assert moe["router"].dtype == torch.float32
        assert moe["w_gate"].dtype == torch.bfloat16
        lead = (1,) if kw else ()
        assert tuple(moe["w_gate"].shape) == lead + (8, 64, 64)
        assert tuple(moe["w_down"].shape) == lead + (8, 64, 64)
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                moe[name].float().numpy(),
                np.asarray(jmoe[name]).astype(np.float32))
    # a tree with the router cast to bf16 is refused
    values["segments"][0]["moe"]["router"] = np.asarray(
        values["segments"][0]["moe"]["router"]).astype(jnp.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        convert.from_jax_params(values, cfg, device="cpu")
