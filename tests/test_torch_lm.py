"""The port's LM modules against the JAX package on the CPU: rmsnorm,
half-split rope, attention with kv_len masking, contiguous and paged
GQA decode (out-of-range writes dropped), prefill, exit heads, CALM KV
projection, the token-domain difficulty (biased variance) and the
conversion of the LM param tree.  Same numpy inputs, the port's seeded
init handed to JAX in its own layout, fp32 throughout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import difficulty as jDIFF
from repro.models import layers as jL
from repro.models import transformer_lm as jTLM
from repro.parallel.sharding import Param
from repro_torch import convert
from repro_torch.configs.tinyllama_1_1b import CONFIG, REDUCED
from repro_torch.core import difficulty as DIFF
from repro_torch.models import layers as L
from repro_torch.models import transformer_lm as TLM

# tiny tensors: one thread is faster than torch's pool, and leaves the
# cores to the JAX side and to other test workers
torch.set_num_threads(1)

# fp32 reductions (means, dot products, softmax sums) in another order
ATOL = 1e-5
CFG = REDUCED                      # 4 layers, d_model 64, vocab 256, fp32
JCFG = jTLM.LMConfig(
    name=CFG.name, n_layers=CFG.n_layers, d_model=CFG.d_model,
    n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads, d_ff=CFG.d_ff,
    vocab=CFG.vocab, exit_layers=CFG.exit_layers, max_seq=CFG.max_seq,
    rope_theta=CFG.rope_theta, tie_embeddings=CFG.tie_embeddings,
    remat=False)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.fixture(scope="module")
def params():
    """(port params on the CPU, the same values as a JAX tree): the
    port's seeded init in the JAX layout, converted back through
    ``convert.from_jax_params``."""
    values = convert.tree_map(lambda t: t.numpy(),
                              TLM.lm_init(CFG, seed=3, device="cpu"))
    return (convert.from_jax_params(values, CFG, device="cpu"),
            jax.tree.map(jnp.asarray, values))


def test_tinyllama_config_mirrors_jax():
    from repro.configs import tinyllama_1_1b as jT
    for port, ref in ((CONFIG, jT.CONFIG), (REDUCED, jT.REDUCED)):
        for f in dataclasses.fields(port):
            want = getattr(ref, f.name)
            got = getattr(port, f.name)
            if f.name.endswith("dtype"):
                assert str(got).removeprefix("torch.") == jnp.dtype(
                    want).name
            else:
                assert got == want, f.name
        assert port.hd == ref.hd and port.n_exits == ref.n_exits


def test_rmsnorm_matches_jax():
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 5, 64) * 3).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    _close(L.rmsnorm({"scale": _t(scale)}, _t(x)),
           jL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_jax(per_row):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 6, 4, 16).astype(np.float32)
    cos, sin = L.rope_freqs(16, 40, 10000.0, device="cpu")
    jcos, jsin = jL.rope_freqs(16, 40, 10000.0)
    _close(cos, jcos)
    _close(sin, jsin)
    pos = rs.randint(0, 40, (2, 6)) if per_row else None
    got = L.apply_rope(_t(x), cos, sin, None if pos is None else _t(pos))
    want = jL.apply_rope(jnp.asarray(x), jcos, jsin,
                         None if pos is None else jnp.asarray(pos))
    _close(got, want)
    # half-split pairs: dims d and d + Dh/2 rotate together; the
    # interleaved (GPT-J) convention would pair d and d + 1
    if pos is None:
        pair = np.asarray(got)[0, 3, 0]
        ang = 3 * (1.0 / 10000.0 ** (0 / 16))
        want0 = x[0, 3, 0, 0] * np.cos(ang) - x[0, 3, 0, 8] * np.sin(ang)
        assert abs(pair[0] - want0) < 1e-5


@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_matches_jax(causal):
    rs = np.random.RandomState(2)
    q = rs.randn(3, 4 if causal else 1, 4, 16).astype(np.float32)
    k = rs.randn(3, 9, 2, 16).astype(np.float32)
    v = rs.randn(3, 9, 2, 16).astype(np.float32)
    kv_len = None if causal else np.array([1, 5, 9])
    got = L.dense_attention(_t(q), _t(k), _t(v), causal=causal,
                            kv_len=None if kv_len is None else _t(kv_len))
    want = jL.dense_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal,
                              kv_len=None if kv_len is None
                              else jnp.asarray(kv_len))
    _close(got, want)
    if not causal:
        # row 0 sees only its first key: query heads 0 and 1 share KV
        # head 0 and both return its value row
        for head in (0, 1):
            _close(np.asarray(got)[0, 0, head], v[0, 0, 0], atol=1e-6)


def test_gqa_decode_matches_jax(params):
    p, jp = params
    rs = np.random.RandomState(4)
    x = rs.randn(3, 1, CFG.d_model).astype(np.float32)
    k = rs.randn(3, 12, CFG.n_kv_heads, CFG.hd).astype(np.float32)
    v = rs.randn(3, 12, CFG.n_kv_heads, CFG.hd).astype(np.float32)
    cos, sin = L.rope_freqs(CFG.hd, 12, CFG.rope_theta, device="cpu")
    jcos, jsin = jL.rope_freqs(CFG.hd, 12, CFG.rope_theta)
    out, cache = L.gqa_decode(p["layers"][1]["attn"], _t(x), cos, sin,
                              {"k": _t(k.copy()), "v": _t(v.copy())}, 7)
    jout, jcache = jL.gqa_decode(jp["layers"][1]["attn"], jnp.asarray(x),
                                 jcos, jsin, {"k": jnp.asarray(k),
                                              "v": jnp.asarray(v)}, 7)
    _close(out, jout)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def _paged_inputs(seed, n=6, psz=4, s=3, p=3):
    rs = np.random.RandomState(seed)
    pages = {n_: rs.randn(n, psz, CFG.n_kv_heads, CFG.hd).astype(np.float32)
             for n_ in ("k", "v")}
    table = rs.randint(0, n, (s, p)).astype(np.int32)
    positions = np.array([2, 9, 5], np.int32)
    page_w = table[np.arange(s), positions // psz]
    # slot 1 must not write (a fired or inactive row): page id n is out of
    # range and dropped; slot 2 writes an out-of-range id far past it
    page_idx = np.array([page_w[0], n, n + 7], np.int32)
    return pages, table, positions, page_idx, positions % psz


def _with_sink(a):
    return _t(np.concatenate([a, np.zeros_like(a[:1])]))


def test_paged_write_drops_out_of_range_rows():
    rs = np.random.RandomState(5)
    pages = rs.randn(4, 2, 3).astype(np.float32)
    rows = rs.randn(5, 3).astype(np.float32)
    # 4 and -5 lie outside [-N, N) and are dropped; -1 counts from the
    # end, as JAX's scatter indexing does
    idx = np.array([1, 4, -1, 3, -5], np.int32)
    off = np.array([0, 1, 0, 1, 1], np.int32)
    got = L.paged_write(_with_sink(pages), _t(rows), _t(idx), _t(off))
    want = jL.paged_write(jnp.asarray(pages), jnp.asarray(rows),
                          jnp.asarray(idx), jnp.asarray(off))
    np.testing.assert_array_equal(got[:4].numpy(), np.asarray(want))
    expect = pages.copy()
    expect[1, 0], expect[3, 0], expect[3, 1] = rows[0], rows[2], rows[3]
    np.testing.assert_array_equal(got[:4].numpy(), expect)


def test_gqa_decode_paged_matches_jax(params):
    p, jp = params
    pages, table, pos, page_idx, off = _paged_inputs(6)
    x = np.random.RandomState(7).randn(3, 1, CFG.d_model).astype(np.float32)
    view = table.shape[1] * 4
    cos, sin = L.rope_freqs(CFG.hd, view, CFG.rope_theta, device="cpu")
    jcos, jsin = jL.rope_freqs(CFG.hd, view, CFG.rope_theta)
    port_pages = {n: _with_sink(a) for n, a in pages.items()}
    out, new = L.gqa_decode_paged(p["layers"][0]["attn"], _t(x), cos, sin,
                                  port_pages, _t(table), _t(page_idx),
                                  _t(off), _t(pos))
    jout, jnew = jL.gqa_decode_paged(
        jp["layers"][0]["attn"], jnp.asarray(x), jcos, jsin,
        {n: jnp.asarray(a) for n, a in pages.items()}, jnp.asarray(table),
        jnp.asarray(page_idx), jnp.asarray(off), jnp.asarray(pos))
    _close(out, jout)
    for n in ("k", "v"):
        _close(new[n][:-1], jnew[n])
        # only slot 0's row changed: the other two were dropped
        changed = np.abs(new[n][:-1].numpy() - pages[n]).max(axis=(2, 3))
        assert set(zip(*np.nonzero(changed))) == {(page_idx[0], off[0])}


def test_lm_prefill_matches_jax(params):
    p, jp = params
    toks = np.random.RandomState(8).randint(0, CFG.vocab, (2, 7))
    cache, exit_h = TLM.lm_prefill(
        p, _t(toks), CFG, TLM.lm_init_cache(CFG, 2, 10, device="cpu"))
    jcache, jexit_h = jTLM.lm_prefill(jp, jnp.asarray(toks), JCFG,
                                      jTLM.lm_init_cache(JCFG, 2, 10))
    assert len(exit_h) == len(jexit_h) == CFG.n_exits
    for got, want in zip(exit_h, jexit_h):
        _close(got, want)
    for c, jc in zip(cache, jcache):
        _close(c["k"], jc["k"])
        _close(c["v"], jc["v"])


def test_exit_logits_and_kv_project_match_jax(params):
    p, jp = params
    h = np.random.RandomState(9).randn(3, CFG.d_model).astype(np.float32)
    for name in ("1", "final"):
        _close(TLM.exit_logits(p, CFG, _t(h), name),
               jTLM.exit_logits(jp, JCFG, jnp.asarray(h), name))
    pos = np.array([0, 5, 11], np.int32)
    rows = TLM.lm_kv_project(p, _t(h), CFG, None, None, 2,
                             positions=_t(pos), max_len=12)
    jrows = jTLM.lm_kv_project(jp, jnp.asarray(h), JCFG, None, None, 2,
                               positions=jnp.asarray(pos), max_len=12)
    assert len(rows) == len(jrows) == CFG.n_layers - 2
    for r, jr in zip(rows, jrows):
        _close(r["k"], jr["k"])
        _close(r["v"], jr["v"])


def test_lm_kv_propagate_matches_jax(params):
    p, jp = params
    rs = np.random.RandomState(10)
    h = rs.randn(2, CFG.d_model).astype(np.float32)
    cache = [{n: rs.randn(2, 6, CFG.n_kv_heads, CFG.hd).astype(np.float32)
              for n in ("k", "v")} for _ in range(CFG.n_layers)]
    got = TLM.lm_kv_propagate(
        p, _t(h), CFG, [{n: _t(a.copy()) for n, a in c.items()}
                        for c in cache], 4, from_layer=2)
    want = jTLM.lm_kv_propagate(
        jp, jnp.asarray(h), JCFG,
        [{n: jnp.asarray(a) for n, a in c.items()} for c in cache], 4,
        from_layer=2)
    for i, (c, jc) in enumerate(zip(got, want)):
        for n in ("k", "v"):
            _close(c[n], jc[n])
            if i < 2:                        # layers before the exit
                np.testing.assert_array_equal(c[n].numpy(), cache[i][n])


def test_token_difficulty_matches_jax():
    rs = np.random.RandomState(11)
    for s in (2, 5):
        e = (rs.randn(3, s, 64) * np.array([0.05, 0.2, 0.6])[:, None, None]
             ).astype(np.float32)
        _close(DIFF.token_difficulty(_t(e)),
               jDIFF.token_difficulty(jnp.asarray(e)), atol=1e-6)


def test_token_difficulty_ema_biased_variance():
    """``jnp.var`` is the population variance.  With D = 4 the unbiased
    estimate is 4/3 of it, which moves alpha far past 1e-6."""
    rs = np.random.RandomState(12)
    prev = rs.uniform(0, 1, 3).astype(np.float32)
    e = (rs.randn(3, 1, 4) * 0.5).astype(np.float32)
    got = DIFF.token_difficulty_ema(_t(prev), _t(e))
    want = np.asarray(jDIFF.token_difficulty_ema(jnp.asarray(prev),
                                                 jnp.asarray(e)))
    _close(got, want, atol=1e-6)
    var = torch.var(_t(e), dim=(1, 2))               # torch's default
    inst = torch.clamp(1 - torch.exp(-var / (10 * DIFF.DEFAULT.var_scale)),
                       0, 1)
    unbiased = 0.9 * _t(prev) + 0.1 * inst
    assert np.abs(unbiased.numpy() - want).max() > 1e-4


def test_convert_lm_tree_unwraps_params_and_checks_shapes(params):
    p, _ = params
    values = convert.tree_map(lambda t: t.numpy(), p)
    wrapped = convert.tree_map(lambda a: Param(a, ()), values)
    got = convert.from_jax_params(wrapped, CFG, device="cpu")
    for a, b in zip(convert.leaves(got), convert.leaves(p)):
        assert torch.equal(a, b)
    bad = dict(values, unembed=values["unembed"][:, :8])
    with pytest.raises(ValueError, match="unembed"):
        convert.from_jax_params(bad, CFG, device="cpu")


def test_lm_init_tree_matches_jax_structure():
    """The port's init and the JAX init share keys, shapes and dtypes."""
    cfg = dataclasses.replace(CFG, tie_embeddings=False)
    port = TLM.lm_init(cfg, device="meta")
    jshapes = jax.eval_shape(
        lambda: jTLM.lm_init(jax.random.key(0), dataclasses.replace(
            JCFG, tie_embeddings=False)))
    jvals = jax.tree.map(lambda x: x.value, jshapes,
                         is_leaf=lambda x: isinstance(x, Param))
    flat = jax.tree_util.tree_flatten_with_path(jvals)[0]
    assert len(flat) == len(convert.leaves(port))
    for path, leaf in flat:
        node = port
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name


def test_lm_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default is taken")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TLM.lm_init(CFG)
