"""The dense LM's forward and training in the port against the JAX
package on the CPU, at REDUCED widths (TinyLlama-1.1B and InternLM2-20B).

Both packages take the same weights (the JAX init, carried over by
``convert``) and the same numpy tokens.  Held to JAX: ``lm_forward``'s
exit hidden states, ``chunked_xent`` per exit, the Eq. 18
``lm_multi_exit_loss`` and every leaf's gradient, with ``remat``, chunked
attention (small ``q_chunk`` / ``kv_chunk``) and ``layer_scan`` each on;
``chunked_attention`` against ``dense_attention`` (causal and not, GQA);
``lm_decode_step`` after a prefill, and the stacked ``lm_prefill_scan``;
the analytic parameter and FLOP counts; five ``Trainer`` steps and an
LM trainer checkpoint (the same files as the JAX trainer's, restored
across packages); the registry's ``internlm2-20b``.

Tolerances, float32 throughout: hidden states and per-exit losses
within FWD_TOL (matmuls and reductions in another order); gradients
within GRAD_RTOL of each leaf's norm; trainer losses within LOSS_TOL and
parameters as ``test_torch_train.py`` holds them (AdamW maps a gradient
at rounding level to +-lr, so a bounded share of leaves may sit farther
apart, never past the flip bound).
"""
import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jCK
from repro.configs import registry as jREG
from repro.data import datasets as jDS
from repro.models import layers as jL
from repro.models import transformer_lm as jTLM
from repro.parallel.sharding import unzip
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch import checkpoint as CK
from repro_torch import convert
from repro_torch import optim as OPT
from repro_torch.configs import registry as REG
from repro_torch.data import datasets as DS
from repro_torch.models import layers as L
from repro_torch.models import transformer_lm as TLM
from repro_torch.runtime.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_RTOL = 1e-4
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4
FLIP_SHARE = 0.02
ATTN_TOL = 1e-6

ARCHS = ("tinyllama-1.1b", "internlm2-20b")
#: the options of the forward, each on alone (chunks divide SEQ = 16)
VARIANTS = {"plain": {}, "remat": {"remat": True},
            "chunked": {"attn_chunked": True, "q_chunk": 8, "kv_chunk": 4},
            "layer_scan": {"layer_scan": True}}
SEQ = 16
BATCH = 3
DATA = DS.DatasetConfig(name="synth-tokens", n_train=64, n_eval=64)
JDATA = jDS.DatasetConfig(name="synth-tokens", n_train=64, n_eval=64)
TRAIN = dict(batch_size=4, steps=5, lr=3e-3, warmup=2)


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


def _cfgs(arch, **kw):
    return (dataclasses.replace(jREG.get_reduced(arch), **kw),
            dataclasses.replace(REG.get_reduced(arch), **kw))


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


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, variant):
    """``lm_forward`` exit hidden states, each exit's ``chunked_xent``,
    the Eq. 18 loss and every leaf's gradient against JAX's, with the
    variant's option on."""
    jcfg, cfg = _cfgs(arch, **VARIANTS[variant])
    values, params = _weights(jcfg, cfg)
    if cfg.layer_scan:
        assert [tuple(s["attn"]["wq"].shape[:1]) for s in
                params["segments"]] == [(b - a,) for a, b in
                                        TLM.scan_segments(cfg)]
    toks = _tokens(cfg.vocab)
    x, y = toks[:, :-1], toks[:, 1:]

    def jfn(p, x, y):
        out = jTLM.lm_forward(p, x, jcfg)
        (loss, aux), g = jax.value_and_grad(
            lambda p: jTLM.lm_multi_exit_loss(p, x, y, jcfg),
            has_aux=True)(p)
        return out["exit_hidden"], loss, aux["ce_per_exit"], g
    jh, jloss, jces, jg = jax.jit(jfn)(values, jnp.asarray(x),
                                       jnp.asarray(y))

    with torch.no_grad():
        out = TLM.lm_forward(params, torch.from_numpy(x).long(), cfg)
    assert len(out["exit_hidden"]) == cfg.n_exits
    for i, (h, jh_) in enumerate(zip(out["exit_hidden"], jh)):
        _close(h, jh_, FWD_TOL, f"exit hidden {i}")
    assert float(out["aux_loss"]) == 0.0

    (loss, aux), g = OPT.value_and_grad(
        lambda p: TLM.lm_multi_exit_loss(p, torch.from_numpy(x).long(),
                                         torch.from_numpy(y).long(), cfg),
        params)
    _close(loss, jloss, FWD_TOL, "loss")
    for i, (c, jc) in enumerate(zip(aux["ce_per_exit"], jces)):
        _close(c, jc, FWD_TOL, f"ce exit {i}")
    want = _paths(convert.from_jax_params(jax.device_get(jg), cfg,
                                          device="cpu"))
    got = _paths(g)
    assert set(got) == set(want)
    for path, w in want.items():
        w = w.numpy().astype(np.float64)
        err = np.linalg.norm(got[path].numpy() - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (path, err)


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_chunked_xent_matches_jax(n_chunks):
    """One exit's chunked cross-entropy on the same hidden rows: any
    chunk count (3 does not divide S = 16 and falls back to 2), the gold
    logit a gather of table rows as in JAX."""
    jcfg, cfg = _cfgs("internlm2-20b")
    values, params = _weights(jcfg, cfg)
    rs = np.random.RandomState(n_chunks)
    h = rs.normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    lab = rs.randint(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    for name in ("1", "final"):
        want = jTLM.chunked_xent(values, jcfg, jnp.asarray(h),
                                 jnp.asarray(lab), name, n_chunks)
        got = TLM.chunked_xent(params, cfg, torch.from_numpy(h),
                               torch.from_numpy(lab), name, n_chunks)
        _close(got, want, FWD_TOL, name)
        logits = TLM.exit_logits(params, cfg, torch.from_numpy(h), name)
        ref = torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab), torch.from_numpy(lab).long()
            .reshape(-1))
        _close(got, ref.item(), FWD_TOL, f"{name} vs cross_entropy")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(4, 8), (16, 2), (8, 8)])
def test_chunked_attention_matches_dense_and_jax(causal, q_chunk,
                                                 kv_chunk):
    rs = np.random.RandomState(q_chunk * 10 + kv_chunk)
    q = rs.normal(size=(2, 16, 6, 8)).astype(np.float32)
    k = rs.normal(size=(2, 16, 2, 8)).astype(np.float32)
    v = rs.normal(size=(2, 16, 2, 8)).astype(np.float32)
    got = L.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    dense = L.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    _close(got, dense.numpy(), ATTN_TOL, "chunked vs dense")
    want = jL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
    _close(got, want, ATTN_TOL, "chunked vs JAX")
    with pytest.raises(ValueError, match="divide"):
        L.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), q_chunk=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_and_scan_prefill_match_jax(arch):
    """A prefill, then three ``lm_decode_step``s against JAX's (exit
    hidden states and the written cache rows); ``lm_prefill_scan`` on
    the stacked tree against JAX's and against the per-layer prefill of
    the same weights."""
    jcfg, cfg = _cfgs(arch)
    values, params = _weights(jcfg, cfg)
    toks = _tokens(cfg.vocab, seed=7, shape=(2, 9))
    max_len = 16
    jcache = jTLM.lm_init_cache(jcfg, 2, max_len)
    jcache, _ = jax.jit(lambda p, t, c: jTLM.lm_prefill(p, t, jcfg, c))(
        values, jnp.asarray(toks[:, :6]), jcache)
    cache = TLM.lm_init_cache(cfg, 2, max_len, device="cpu")
    TLM.lm_prefill(params, torch.from_numpy(toks[:, :6]).long(), cfg,
                   cache)
    jstep = jax.jit(lambda p, t, c, i: jTLM.lm_decode_step(p, t, c, i,
                                                           jcfg))
    for i in range(6, 9):
        jh, jcache = jstep(values, jnp.asarray(toks[:, i:i + 1]), jcache,
                           i)
        h, cache = TLM.lm_decode_step(
            params, torch.from_numpy(toks[:, i:i + 1]).long(), cache, i,
            cfg)
        assert len(h) == cfg.n_exits
        for e, (a, b) in enumerate(zip(h, jh)):
            _close(a, b, FWD_TOL, f"step {i} exit {e}")
    for layer in (0, cfg.n_layers - 1):
        for name in ("k", "v"):
            _close(cache[layer][name][:, :9], jcache[layer][name][:, :9],
                   FWD_TOL, f"cache {layer} {name}")

    jscfg, scfg = _cfgs(arch, layer_scan=True)
    svalues, sparams = _weights(jscfg, scfg)
    x = toks[:, :8]
    jd, jseg, jh = jax.jit(lambda p, t: jTLM.lm_prefill_scan(p, t, jscfg))(
        svalues, jnp.asarray(x))
    d, seg, h = TLM.lm_prefill_scan(sparams, torch.from_numpy(x).long(),
                                    scfg)
    assert d == [] and jd == []
    assert len(seg) == len(jseg) == len(TLM.scan_segments(scfg))
    for a, b in zip(seg, jseg):
        for name in ("k", "v"):
            _close(a[name], b[name], FWD_TOL, f"segment {name}")
    for a, b in zip(h, jh):
        _close(a, b, FWD_TOL, "scan prefill exits")
    # the stacked tree holds the per-layer init's numbers
    flat = TLM.lm_init(cfg, seed=5, device="cpu")
    stacked = TLM.lm_init(scfg, seed=5, device="cpu")
    for k, (a, b) in enumerate(TLM.scan_segments(scfg)):
        for j in range(b - a):
            assert torch.equal(stacked["segments"][k]["ffn"]["up"]["w"][j],
                               flat["layers"][a + j]["ffn"]["up"]["w"])
    cache = TLM.lm_init_cache(cfg, 2, 8, device="cpu")
    _, h2 = TLM.lm_prefill(flat, torch.from_numpy(x).long(), cfg, cache)
    _, seg2, h3 = TLM.lm_prefill_scan(stacked, torch.from_numpy(x).long(),
                                      scfg)
    for a, b in zip(h2, h3):
        torch.testing.assert_close(a, b, rtol=0, atol=FWD_TOL)
    torch.testing.assert_close(seg2[0]["k"][0], cache[0]["k"], rtol=0,
                               atol=FWD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_flop_counts_match_jax(arch):
    """The analytic counts at full width and at REDUCED, and the full
    width's count equal to the leaves the init makes (meta device: no
    weight is drawn)."""
    for cfg, jcfg in ((REG.get(arch), jREG.get(arch)),
                      (REG.get_reduced(arch), jREG.get_reduced(arch))):
        assert TLM.lm_param_count(cfg) == jTLM.lm_param_count(jcfg)
        assert TLM.lm_active_param_count(cfg) == \
            jTLM.lm_active_param_count(jcfg)
        for kw in ({}, {"kv_len": 512}, {"n_exits_computed": 1}):
            assert TLM.lm_forward_flops(cfg, 4, 256, **kw) == \
                jTLM.lm_forward_flops(jcfg, 4, 256, **kw), kw
        assert TLM.lm_train_flops(cfg, 8, 256) == \
            jTLM.lm_train_flops(jcfg, 8, 256)
    cfg = REG.get(arch)
    tree = TLM.lm_init(cfg, device="meta")
    n = sum(t.numel() for t in convert.leaves(tree))
    # the count leaves out the final and exit-head norms, as JAX's does
    assert n == TLM.lm_param_count(cfg) + cfg.n_exits * cfg.d_model


def test_registry_has_internlm2_and_refuses_item_6b():
    """``internlm2-20b`` resolves to the JAX package's config (every
    field the port has), at full and REDUCED width; the MLA, MoE and MTP
    configs raise, naming item 6b."""
    for get, jget in ((REG.get, jREG.get),
                      (REG.get_reduced, jREG.get_reduced)):
        cfg, jcfg = get("internlm2-20b"), jget("internlm2-20b")
        for f in dataclasses.fields(cfg):
            if "dtype" not in f.name:
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert REG.get("internlm2-20b").param_dtype == torch.bfloat16
    assert REG.get("tinyllama-1.1b").remat
    assert not REG.get_reduced("tinyllama-1.1b").remat
    for arch in REG.NOT_PORTED:
        with pytest.raises(KeyError, match="item"):
            REG.get(arch)
    for kw in ({"attn_kind": "mla"}, {"moe": object()}, {"mtp": True}):
        with pytest.raises(NotImplementedError, match="item 6b"):
            dataclasses.replace(REG.get_reduced("tinyllama-1.1b"), **kw)


def test_convert_takes_the_stacked_segments():
    """A JAX ``layer_scan`` tree converts leaf for leaf, its stacked
    (L, d, H, Dh) attention weights in their own layout."""
    jcfg, cfg = _cfgs("tinyllama-1.1b", layer_scan=True)
    values, params = _weights(jcfg, cfg)
    assert set(params) == set(values)
    for k in range(len(values["segments"])):
        np.testing.assert_array_equal(
            params["segments"][k]["attn"]["wq"].numpy(),
            values["segments"][k]["attn"]["wq"])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _pair(arch="tinyllama-1.1b", **train):
    jcfg, cfg = _cfgs(arch)
    jtr = JTrainer(jcfg, JTrainConfig(**{**TRAIN, **train}), JDATA,
                   data_kind="tokens")
    tr = Trainer(cfg, TrainConfig(**{**TRAIN, **train}), DATA,
                 params=convert.from_jax_params(jax.device_get(jtr.params),
                                                cfg, device="cpu"),
                 device="cpu")
    return jtr, tr


def test_trainer_steps_match_jax():
    """Five ``train_step``s on the same token batches (the labels are the
    inputs shifted by one, in both): the loss per step within LOSS_TOL,
    then the parameters as test_torch_train.py holds them."""
    jtr, tr = _pair()
    cfg = tr.model_cfg
    losses, jlosses = [], []
    for s in range(TRAIN["steps"]):
        x = _tokens(cfg.vocab, seed=20 + s,
                    shape=(TRAIN["batch_size"], SEQ + 1))
        y = np.zeros(TRAIN["batch_size"], np.int32)
        jlosses.append(jtr.train_step((jnp.asarray(x), jnp.asarray(y))))
        losses.append(tr.train_step((x, y)))
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_TOL, rtol=0)
    assert tr.step == jtr.step == TRAIN["steps"]
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
    assert not any(t.requires_grad for t in convert.leaves(tr.params))


def test_trainer_run_draws_max_seq_plus_one_and_learns():
    """``run`` draws ``synth-tokens`` sequences of ``max_seq + 1`` tokens
    (the pipeline's batches equal ``make_batch``'s), and the loss falls
    on the motif data, with ``remat`` and chunked attention on."""
    cfg = dataclasses.replace(REG.get_reduced("tinyllama-1.1b"),
                              max_seq=32, remat=True, attn_chunked=True,
                              q_chunk=8, kv_chunk=16)
    seen = []
    tr = Trainer(cfg, TrainConfig(batch_size=8, steps=30, lr=3e-3,
                                  log_every=5), DATA, device="cpu")
    step = tr.train_step
    tr.train_step = lambda b: seen.append(b[0].shape) or step(b)
    hist = tr.run()
    assert seen and all(s == (8, cfg.max_seq + 1) for s in seen)
    assert [h["step"] for h in hist] == [5, 10, 15, 20, 25, 30]
    assert hist[-1]["loss"] < hist[0]["loss"]
    x, _ = DS.make_batch(DATA, range(3), kind="tokens", seq_len=33,
                         vocab=cfg.vocab)
    jx, _ = jDS.make_batch(JDATA, range(3), kind="tokens", seq_len=33,
                           vocab=cfg.vocab)
    np.testing.assert_array_equal(x, jx)


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "manifest.msgpack"),
              "rb") as f:
        return msgpack.unpackb(f.read())


def test_lm_trainer_checkpoint_same_files_as_jax(tmp_path):
    """The two trainers' ``state_tree()`` on the same weights saved by
    each package: the same manifest but for ``treedef`` and the same
    bytes in every leaf file.  Then a JAX trainer's checkpoint after two
    steps restores into the port's trainer bit for bit."""
    jtr, tr = _pair()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jCK.save(jdir, 0, jtr.state_tree())
    CK.save(pdir, 0, tr.state_tree())
    jm, m = _manifest(jdir, 0), _manifest(pdir, 0)
    assert {**m, "treedef": None} == {**jm, "treedef": None}
    for leaf in m["leaves"]:
        a = open(os.path.join(jdir, "step_00000000", leaf["file"]),
                 "rb").read()
        b = open(os.path.join(pdir, "step_00000000", leaf["file"]),
                 "rb").read()
        assert a == b, leaf

    ckpt = str(tmp_path / "run")
    jcfg, cfg = _cfgs("tinyllama-1.1b")
    jt = JTrainer(jcfg, JTrainConfig(**TRAIN, ckpt_dir=ckpt, ckpt_every=2),
                  JDATA, data_kind="tokens")
    jt.run(steps=2)
    assert jCK.latest_step(ckpt) == 2
    t = Trainer(cfg, TrainConfig(**TRAIN, ckpt_dir=ckpt), DATA,
                device="cpu")
    assert t.restore() and t.step == 2
    want = _paths(convert.from_jax_params(jax.device_get(jt.params), cfg,
                                          device="cpu"))
    got = _paths(t.params)
    for path, w in want.items():
        assert torch.equal(got[path], w), path
