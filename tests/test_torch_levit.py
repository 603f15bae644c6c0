"""The port's LeViT (Table II) against the JAX package, on the CPU, with
converted weights: the token layers (batchnorm on the last axis, token
pooling, layernorm, tanh GELU, hard-swish), the Eq. 16 exit head, each
stage and exit in inference and train mode, ``convert``, the MAC
counts, a ``DartEngine`` session and ``Trainer`` steps.

Sizes follow ``benchmarks/table2.py``'s quick variant (dims // 4,
depths (1, 1, 2), key_dim 8), plus a variant in which a stage's token
tensors have N equal to C and a shrink block keeps its width (so a
residual around the shrink attention would have a valid shape).  The
weights are the port's seeded init with planted batchnorm statistics
and attention-bias tables (init's zeros would hide a misaddressed
token), handed to JAX in its layout.  Each named trap of the port has a
test: the token order, the batchnorm axis when N equals C, no residual
around the shrink attention, the GELU form and the layernorm eps.

The synthetic images and the JAX init fold a str hash; both packages
draw from one hash-free base here (``_fixed_draws``), as in
``test_torch_engine.py`` and ``test_torch_train.py``."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import paper_testbeds as jTB
from repro.data import datasets as jDS
from repro.engine import DartEngine as JaxEngine
from repro.models import batchnorm as jBN
from repro.models import cnn_zoo as jZOO
from repro.models import get_family as jget_family
from repro.models import layers as jL
from repro.models import vit as jVIT
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch import optim as OPT
from repro_torch.configs import paper_testbeds as TB
from repro_torch.data import datasets as DS
from repro_torch.engine import DartEngine
from repro_torch.models import batchnorm as BN
from repro_torch.models import cnn_zoo as ZOO
from repro_torch.models import get_family
from repro_torch.models import layers as L
from repro_torch.models import vit as VIT
from repro_torch.runtime.trainer import TrainConfig, Trainer

# tiny tensors: one thread is faster than torch's pool, and leaves the
# cores to the JAX side and to other test workers
torch.set_num_threads(1)

#: float32 activations through a stage: matmuls, softmax and batchnorm
#: reductions in another order
RTOL, ATOL = 1e-4, 1e-5
#: train mode normalises with the batch's own statistics, over B * N
#: rows (16 at stage 2 of a 4-image batch): an upstream rounding is
#: divided by a channel's batch std there (3.3e-5 seen on activations up
#: to 10.6 at the last stage, against 7e-7 in inference mode)
TRAIN_ATOL = 1e-4
#: one elementwise op or one short reduction: a rounding or two apart
ELEM_TOL = 1e-6
#: conf and alpha in the engine: fp32 reductions in another order
CAL_ATOL = 1e-5
#: rows whose conf at a gate lies this close to tau' may route differently
EDGE = 1e-5
#: images with a Sobel magnitude this close to tau_edge may count as an
#: edge pixel on one side only (test_torch_engine.py::SOBEL_EDGE)
SOBEL_EDGE = 1e-6

#: benchmarks/table2.py's quick variant of LeViT-128S
NARROW = dict(dims=(32, 64, 96), depths=(1, 1, 2), key_dim=8)
#: stage 0's token tensors are (B, 64, 64): N equals C; shrink 0 keeps
#: the width 64, so a residual around its attention would fit
N_EQ_C = dict(name="levit-n-eq-c", dims=(64, 64, 32), heads=(2, 2, 2),
              depths=(1, 1, 1), key_dim=8)
CASES = {
    "levit-narrow": (dataclasses.replace(jTB.LEVIT_128S, **NARROW),
                     dataclasses.replace(TB.LEVIT_128S, **NARROW)),
    "levit-n-eq-c": (dataclasses.replace(jTB.LEVIT_128S, **N_EQ_C),
                     dataclasses.replace(TB.LEVIT_128S, **N_EQ_C)),
}

#: the JAX engine's ``measure_costs((32, 32, 3))`` (XLA's cost analysis,
#: stem not counted) on the testbeds at full width, on the CPU; the same
#: numbers as chip_smoke.py's LEVIT_XLA_CUM_MACS
XLA_CUM_MACS = {
    "LEVIT_128S": [16643622.0, 44686024.0, 63443367.0],
    "LEVIT_192": [55225398.0, 95464062.0, 112654589.0],
    "LEVIT_256": [96710726.0, 165505926.0, 195993989.0],
}
#: count_macs counts the products (linears, attention einsums) and the
#: elementwise flops of the token layers as XLA counts them (halved).
#: What is left is XLA's own: its fusion recomputes the scale and bias
#: of the attention scores in the softmax's max and in its exp, and
#: counts them twice (one MAC a score element): 0.06-0.2 % of the count
#: at full width, 1.4 % at the narrow width's first exit (0.6 %
#: normalised), measured
MACS_RTOL = 0.02
MACS_NORM_RTOL = 0.01

JDATA = jDS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=1024)
DATA = DS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=1024)
BATCH = 128


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
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jL, "rng", _fold)
        for mod in (jDS, DS):
            mp.setattr(mod, "_rng_for", _fixed_rng_for)
        yield


def _jax_layout(tree):
    """A port tree in the JAX layout (conv OIHW -> HWIO), numpy leaves."""
    return jax.tree.map(lambda t: t.permute(2, 3, 1, 0).numpy()
                        if t.dim() == 4 else t.numpy(), tree)


def _plant(tree, rs):
    """Random batchnorm statistics, layernorm affine and attention-bias
    tables in a JAX-layout value tree, in place."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["mean"].shape[0]
            tree.update(scale=rs.uniform(0.5, 1.5, c),
                        bias=0.2 * rs.randn(c), mean=0.2 * rs.randn(c),
                        var=rs.uniform(0.5, 2.0, c))
        elif set(tree) == {"scale", "bias"}:
            c = tree["scale"].shape[0]
            tree.update(scale=rs.uniform(0.5, 1.5, c),
                        bias=0.2 * rs.randn(c))
        elif "wq" in tree:
            tree["bias"] = rs.randn(*tree["bias"].shape)
        for k, v in tree.items():
            if isinstance(v, np.ndarray) and v.dtype == np.float64:
                tree[k] = v.astype(np.float32)
            else:
                _plant(v, rs)
    elif isinstance(tree, list):
        for v in tree:
            _plant(v, rs)
    return tree


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(jax cfg, jax values, port cfg, port params): the port's seeded
    init with planted statistics and bias tables, converted back."""
    jcfg, cfg = CASES[request.param]
    values = _plant(_jax_layout(get_family(cfg).init(cfg, seed=1,
                                                     device="cpu")),
                    np.random.RandomState(9))
    return jcfg, values, cfg, convert.from_jax_params(values, cfg,
                                                      device="cpu")


def _images(b=4, seed=0):
    return np.random.RandomState(seed).uniform(
        0, 1, (b, 32, 32, 3)).astype(np.float32)


def _close(got, want, msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# the token layers
# ---------------------------------------------------------------------------

def _bn_params(c, rs):
    p = {"scale": rs.uniform(0.5, 1.5, c), "bias": rs.randn(c),
         "mean": rs.randn(c), "var": rs.uniform(0.2, 3.0, c)}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("shape", [(4, 16, 12), (4, 16, 16), (3, 10)])
def test_bn_apply_on_tokens_matches_jax(shape):
    """(B, N, C) tokens (N = C too) and (B, C) rows, channel_axis=-1:
    inference with planted statistics, then train mode (output, running
    update) against JAX's last-axis batchnorm."""
    rs = np.random.RandomState(sum(shape))
    p = _bn_params(shape[-1], rs)
    x = (3 * rs.randn(*shape) + 1).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(BN.bn_apply(tp, torch.from_numpy(x), channel_axis=-1),
           jBN.bn_apply(p, jnp.asarray(x), train=False), atol=ELEM_TOL,
           rtol=ELEM_TOL)
    jupd, upd = {}, {}
    want = jBN.bn_apply(p, jnp.asarray(x), train=True, updates=jupd,
                        name="a/bn")
    got = BN.bn_apply(tp, torch.from_numpy(x), channel_axis=-1, train=True,
                      updates=upd, name="a/bn")
    _close(got, want, atol=1e-5, rtol=1e-5)
    for k in BN.STATS_KEYS:
        assert upd["a/bn"][k].shape == (shape[-1],)
        _close(upd["a/bn"][k], jupd["a/bn"][k], atol=1e-6, rtol=1e-6,
               msg=k)


def test_bn_axis_when_n_equals_c_is_pinned():
    """The trap: at N = C a batchnorm over the wrong axis has a valid
    shape and no error, only wrong numbers.  The NCHW default (axis 1)
    on (B, N, N) tokens misses JAX; channel_axis=-1 matches it."""
    rs = np.random.RandomState(3)
    p = _bn_params(16, rs)
    x = (3 * rs.randn(4, 16, 16) + 1).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = np.asarray(jBN.bn_apply(p, jnp.asarray(x), train=False))
    right = BN.bn_apply(tp, torch.from_numpy(x), channel_axis=-1)
    wrong = BN.bn_apply(tp, torch.from_numpy(x))
    _close(right, want, atol=ELEM_TOL, rtol=ELEM_TOL)
    assert wrong.shape == right.shape
    assert not np.allclose(wrong.numpy(), want, rtol=RTOL, atol=ATOL)
    wrong = BN.bn_apply(tp, torch.from_numpy(x), train=True)
    want = np.asarray(jBN.bn_apply(p, jnp.asarray(x), train=True))
    assert not np.allclose(wrong.numpy(), want, rtol=RTOL, atol=ATOL)


def test_token_layers_match_jax():
    """global_avg_pool on tokens and on NCHW, layernorm, the tanh GELU
    and hard-swish, each against JAX."""
    rs = np.random.RandomState(4)
    x = (2 * rs.randn(3, 10, 12)).astype(np.float32)
    _close(L.global_avg_pool(torch.from_numpy(x)),
           jL.global_avg_pool(jnp.asarray(x)), atol=ELEM_TOL, rtol=ELEM_TOL)
    img = rs.randn(3, 5, 6, 7).astype(np.float32)
    _close(L.global_avg_pool(torch.from_numpy(img.transpose(0, 3, 1, 2))),
           jL.global_avg_pool(jnp.asarray(img)), atol=ELEM_TOL,
           rtol=ELEM_TOL)
    p = {"scale": rs.uniform(0.5, 1.5, 12).astype(np.float32),
         "bias": rs.randn(12).astype(np.float32)}
    _close(L.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x)),
           jL.layernorm(p, jnp.asarray(x)), atol=ELEM_TOL, rtol=ELEM_TOL)
    for fn, jfn in ((L.gelu, jax.nn.gelu), (L.hard_swish, jax.nn.hard_swish)):
        # both sides of hard-swish's kinks at -3 and 3
        _close(fn(torch.from_numpy(x)), jfn(jnp.asarray(x)), atol=ELEM_TOL,
               rtol=ELEM_TOL)
    assert (np.abs(x) > 3).any()


def test_gelu_form_is_pinned():
    """The trap: ``jax.nn.gelu`` is the tanh form and torch's default is
    the exact one; they differ by up to ~5e-4, far beyond a rounding."""
    x = np.linspace(-5, 5, 2001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    _close(L.gelu(torch.from_numpy(x)), want, atol=ELEM_TOL, rtol=ELEM_TOL)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_layernorm_eps_is_pinned():
    """The trap: JAX's layernorm eps is 1e-6, torch's 1e-5.  On rows of
    variance ~1e-6 the two differ by tens of percent."""
    rs = np.random.RandomState(6)
    x = (1e-3 * rs.randn(4, 32) + 0.5).astype(np.float32)
    p = {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)}
    want = np.asarray(jL.layernorm(p, jnp.asarray(x)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(L.layernorm(tp, torch.from_numpy(x)), want, atol=1e-4,
           rtol=1e-5)
    torch_default = F.layer_norm(torch.from_numpy(x), (32,)).numpy()
    assert np.abs(torch_default - want).max() > 0.1


def test_einsum_counts_every_index():
    with L.count_macs() as c:
        L.einsum("bqhd,bkhd->bhqk", torch.ones(2, 5, 3, 4),
                 torch.ones(2, 7, 3, 4))
    assert c.macs == 2 * 5 * 3 * 4 * 7
    L.einsum("bsd,dhk->bshk", torch.ones(2, 5, 4), torch.ones(4, 3, 2))
    assert c.macs == 2 * 5 * 3 * 4 * 7          # no scope: no count


@pytest.mark.parametrize("rank", [3, 2])
def test_exit_head_matches_jax(rank):
    """Eq. 16: pool (3-D tokens), layernorm, fc1, tanh GELU, fc2."""
    rs = np.random.RandomState(rank)
    gen = torch.Generator().manual_seed(rank)
    params = VIT.exit_head_init(gen, 24, 10, 16, device="cpu",
                                dtype=torch.float32)
    values = _plant(_jax_layout(params), rs)
    params = convert.to_port_tree(values, "cpu")
    x = (2 * rs.randn(*((3, 9, 24) if rank == 3 else (3, 24)))).astype(
        np.float32)
    _close(VIT.exit_head_apply(params, torch.from_numpy(x)),
           jVIT.exit_head_apply(values, jnp.asarray(x)), atol=ELEM_TOL,
           rtol=1e-5)


# ---------------------------------------------------------------------------
# the model: stages and exits, inference and train mode
# ---------------------------------------------------------------------------

def _jit_stage(jfam, train):
    def stage(values, h, s, jcfg):
        upd = {}
        return jfam.apply_stage(values, h, s, jcfg, train=train,
                                updates=upd), upd

    def exit_(values, h, s, jcfg):
        upd = {}
        return jfam.apply_exit(values, h, s, jcfg, train=train,
                               updates=upd), upd
    return (jax.jit(stage, static_argnums=(2, 3)),
            jax.jit(exit_, static_argnums=(2, 3)))


def _close_updates(upd, jupd, msg):
    assert sorted(upd) == sorted(jupd), msg
    for name in jupd:
        for k in BN.STATS_KEYS:
            _close(upd[name][k], jupd[name][k], msg=f"{msg} {name} {k}",
                   atol=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
def test_stages_and_exits_match_jax(pair, train):
    """Stem, each stage and each exit against JAX on the same values;
    in train mode also each batchnorm's running update, by name."""
    jcfg, values, cfg, params = pair
    jfam, fam = jget_family(jcfg), get_family(cfg)
    jstage, jexit = _jit_stage(jfam, train)
    atol = TRAIN_ATOL if train else ATOL
    x = _images()
    jupd, upd = {}, {}
    jh = jfam.apply_stem(values, jnp.asarray(x), jcfg, train=train,
                         updates=jupd)
    h = fam.apply_stem(params, torch.from_numpy(x), cfg, train=train,
                       updates=upd)
    _close(h, jh, "stem", atol=atol)
    _close_updates(upd, jupd, "stem")
    assert fam.num_stages(cfg) == jfam.num_stages(jcfg) == 3
    for s in range(3):
        jh, ju = jstage(values, jh, s, jcfg)
        upd = {}
        h = fam.apply_stage(params, h, s, cfg, train=train, updates=upd)
        _close(h, jh, f"stage {s}", atol=atol)
        _close_updates(upd, ju, f"stage {s}")
        jlog, ju = jexit(values, jh, s, jcfg)
        upd = {}
        _close(fam.apply_exit(params, h, s, cfg, train=train, updates=upd),
               jlog, f"exit {s}", atol=atol)
        _close_updates(upd, ju, f"exit {s}")
    out = fam.forward(params, torch.from_numpy(x), cfg, train=train)
    jout = jax.jit(jfam.forward, static_argnums=2,
                   static_argnames="train")(values, jnp.asarray(x), jcfg,
                                            train=train)
    _close(out["exit_logits"], jout["exit_logits"], "forward", atol=atol)
    _close_updates(out["bn_updates"], jout["bn_updates"], "forward")
    assert bool(out["bn_updates"]) == train


def _stage0(cfg, params, x):
    fam = get_family(cfg)
    return fam.apply_stage(params, fam.apply_stem(params, x, cfg), 0, cfg)


@pytest.mark.parametrize("order", ["nchw-memory", "column-major"])
def test_token_order_is_pinned(monkeypatch, order):
    """The trap: tokens must follow the NHWC map row by row.  A reshape
    of the NCHW memory, or a column-major order, runs without error;
    the planted bias table and the ``::2`` subsample then address other
    tokens, and the stages miss JAX."""
    jcfg, cfg = CASES["levit-narrow"]
    values = _plant(_jax_layout(get_family(cfg).init(cfg, seed=1,
                                                     device="cpu")),
                    np.random.RandomState(9))
    params = convert.from_jax_params(values, cfg, device="cpu")
    x = _images(seed=3)
    jfam = jget_family(jcfg)
    want = jax.jit(lambda v, x: jfam.apply_stage(
        v, jfam.apply_stage(v, jfam.apply_stem(v, x, jcfg), 0, jcfg), 1,
        jcfg))(values, jnp.asarray(x))
    fam = get_family(cfg)
    tx = torch.from_numpy(x)
    _close(fam.apply_stage(params, _stage0(cfg, params, tx), 1, cfg), want)
    wrong = {"nchw-memory": lambda h: h.reshape(h.shape[0], -1, h.shape[1]),
             "column-major": lambda h: h.permute(0, 3, 2, 1).reshape(
                 h.shape[0], -1, h.shape[1])}[order]
    monkeypatch.setattr(ZOO, "_tokens", wrong)
    got = fam.apply_stage(params, _stage0(cfg, params, tx), 1, cfg)
    assert got.shape == want.shape
    assert not np.allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                           atol=ATOL)


def test_bn_axis_in_the_model_when_n_equals_c(monkeypatch):
    """At stage 0 of the N = C variant every attention and MLP output is
    (B, 64, 64): batchnorm on axis 1 there runs, and misses JAX."""
    jcfg, cfg = CASES["levit-n-eq-c"]
    values = _plant(_jax_layout(get_family(cfg).init(cfg, seed=1,
                                                     device="cpu")),
                    np.random.RandomState(9))
    params = convert.from_jax_params(values, cfg, device="cpu")
    x = _images(seed=4)
    jfam = jget_family(jcfg)
    want = np.asarray(jax.jit(lambda v, x: jfam.apply_stage(
        v, jfam.apply_stem(v, x, jcfg), 0, jcfg))(values, jnp.asarray(x)))
    assert want.shape[1] == want.shape[2] == 64
    _close(_stage0(cfg, params, torch.from_numpy(x)), want)
    # batchnorm on axis 1 wherever its shape lets it: at N = C
    monkeypatch.setattr(ZOO, "_bn_tokens", lambda p, h, **kw: BN.bn_apply(
        p, h, channel_axis=1 if h.shape[1] == h.shape[2] else -1, **kw))
    wrong = _stage0(cfg, params, torch.from_numpy(x))
    assert not np.allclose(wrong.numpy(), want, rtol=RTOL, atol=ATOL)


def test_shrink_attention_has_no_residual():
    """The trap: the shrink block adds no residual around its attention
    (JAX ``cnn_zoo.py:357-366``).  In the N = C variant shrink 0 keeps
    the width, so ``xq + attn`` would have a valid shape: the port
    matches JAX, and that residual variant does not."""
    jcfg, cfg = CASES["levit-n-eq-c"]
    values = _plant(_jax_layout(get_family(cfg).init(cfg, seed=1,
                                                     device="cpu")),
                    np.random.RandomState(9))
    params = convert.from_jax_params(values, cfg, device="cpu")
    x = _images(seed=5)
    jfam = jget_family(jcfg)
    jh0 = jax.jit(lambda v, x: jfam.apply_stage(
        v, jfam.apply_stem(v, x, jcfg), 0, jcfg))(values, jnp.asarray(x))
    want = np.asarray(jfam.apply_stage(values, jh0, 1, jcfg))
    h0 = _stage0(cfg, params, torch.from_numpy(x))
    fam = get_family(cfg)
    _close(fam.apply_stage(params, h0, 1, cfg), want)
    # the residual variant, built from the port's own blocks
    sh = params["shrink"][0]
    kw = dict(train=False, updates=None)
    xq = h0.reshape(4, 8, 8, 64)[:, ::2, ::2].reshape(4, -1, 64)
    h = xq + ZOO._levit_attn(sh["attn"], xq, h0, name="", **kw)
    h = h + ZOO._levit_mlp(sh["mlp"], h, name="", **kw)
    for bp in params["stages"][1]:
        h = h + ZOO._levit_attn(bp["attn"], h, h, name="", **kw)
        h = h + ZOO._levit_mlp(bp["mlp"], h, name="", **kw)
    assert h.shape == want.shape
    assert not np.allclose(h.numpy(), want, rtol=RTOL, atol=ATOL)


def test_softmax_in_float32_then_cast_back():
    """A bf16 tree: the attention scores go through the softmax in
    float32 and come back in bf16, as in JAX (``cnn_zoo.py:274``); the
    stage output stays bf16 and near JAX's bf16 chain."""
    jcfg, cfg = CASES["levit-narrow"]
    jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    values = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a.float().numpy(), jnp.bfloat16
                                         if a.dtype == torch.bfloat16
                                         else jnp.float32)),
        _jax_layout_shapes(get_family(cfg).init(cfg, seed=2, device="cpu")))
    params = convert.from_jax_params(values, cfg, device="cpu")
    seen = []
    softmax = torch.softmax
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "softmax", lambda s, dim: seen.append(s.dtype)
                   or softmax(s, dim=dim))
        h = _stage0(cfg, params, torch.from_numpy(_images()))
    assert seen and set(seen) == {torch.float32}
    assert h.dtype == torch.bfloat16
    jfam = jget_family(jcfg)
    want = jax.jit(lambda v, x: jfam.apply_stage(
        v, jfam.apply_stem(v, x, jcfg), 0, jcfg))(values,
                                                 jnp.asarray(_images()))
    assert want.dtype == jnp.bfloat16
    # bf16 keeps 8 bits: a few units of its last place over a stage
    np.testing.assert_allclose(h.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.05,
                               atol=0.05)


# ---------------------------------------------------------------------------
# convert and MACs
# ---------------------------------------------------------------------------

def _jax_params(jcfg, seed=0):
    from repro.parallel.sharding import unzip
    init = jax.jit(lambda k: unzip(jget_family(jcfg).init(k, jcfg))[0])
    return jax.tree.map(np.asarray, init(jax.random.key(seed)))


def test_convert_levit_tree_and_reject_another_architecture():
    """The JAX package's own LeViT init converts leaf for leaf: the
    stem's HWIO conv to OIHW, the 3-D attention weights and bias tables
    kept, the batchnorm statistics float32; a tree of another
    architecture raises."""
    jcfg, cfg = CASES["levit-narrow"]
    values = _jax_params(jcfg)
    params = convert.from_jax_params(values, cfg, device="cpu")
    np.testing.assert_array_equal(
        params["stem"][0]["conv"]["w"].numpy(),
        values["stem"][0]["conv"]["w"].transpose(3, 2, 0, 1))
    attn = params["shrink"][1]["attn"]
    for k in ("wq", "wk", "wv", "wo", "bias"):
        assert attn[k].dim() == 3
        np.testing.assert_array_equal(attn[k].numpy(),
                                      values["shrink"][1]["attn"][k])
    assert attn["bias"].shape == (8, 4, 16)          # (H, Q, N)
    assert attn["wo"].shape == (8, 16, 96)
    for got, want in zip(convert.leaves(params), jax.tree.leaves(values)):
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (want.shape if want.ndim != 4 else
                                    tuple(want.shape[i] for i in
                                          (3, 2, 0, 1)))
    with pytest.raises(ValueError, match="keys"):
        convert.from_jax_params(values, TB.RESNET18_CIFAR, device="cpu")
    with pytest.raises(ValueError):
        convert.from_jax_params(values, CASES["levit-n-eq-c"][1],
                                device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.from_jax_params(_jax_layout(get_family(TB.ALEXNET_TINY).init(
            TB.ALEXNET_TINY, device="cpu")), cfg, device="cpu")


@pytest.mark.parametrize("name", ["LEVIT_128S", "LEVIT_192", "LEVIT_256",
                                  "levit-narrow", "levit-n-eq-c"])
def test_levit_macs_equal_to_jax(name):
    if name in CASES:
        jcfg, cfg = CASES[name]
    else:
        jcfg, cfg = getattr(jTB, name), getattr(TB, name)
    assert ZOO.levit_macs(cfg) == jZOO.levit_macs(jcfg)


def test_full_width_trees_and_cuda_default(monkeypatch):
    """The three testbeds at full width: the JAX init's shapes and
    parameter counts; init and the engine default to the card and raise
    without it."""
    counts = {"LEVIT_128S": 6_397_982, "LEVIT_192": 7_513_294,
              "LEVIT_256": 13_176_414}
    from repro.parallel.sharding import unzip
    for name, n in counts.items():
        jcfg, cfg = getattr(jTB, name), getattr(TB, name)
        jshapes = jax.eval_shape(lambda: unzip(jget_family(jcfg).init(
            jax.random.key(0), jcfg))[0])
        params = get_family(cfg).init(cfg, device="meta")
        got = [tuple(t.shape) for t in jax.tree.leaves(_jax_layout_shapes(
            params))]
        assert got == [tuple(a.shape) for a in jax.tree.leaves(jshapes)]
        assert sum(t.numel() for t in convert.leaves(params)) == n
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TB.LEVIT_256
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_family(cfg).init(cfg)
    params = get_family(cfg).init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DartEngine.from_config(cfg, params)


def _jax_layout_shapes(tree):
    return convert.tree_map(lambda t: t.permute(2, 3, 1, 0)
                            if t.dim() == 4 else t, tree)


def test_measure_costs_full_width_match_pinned_xla_counts():
    """The port's count at full width against XLA's, pinned (no JAX
    compile here): raw within MACS_RTOL at every exit, normalised within
    MACS_NORM_RTOL."""
    for name, want in XLA_CUM_MACS.items():
        cfg = getattr(TB, name)
        params = get_family(cfg).init(cfg, seed=0, device="cpu")
        got = DartEngine.from_config(cfg, params,
                                     device="cpu").measure_costs((32, 32, 3))
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=MACS_RTOL, err_msg=name)
        np.testing.assert_allclose(got / got[-1], want / want[-1],
                                   rtol=MACS_NORM_RTOL, err_msg=name)
        assert (got < want).all()          # the elementwise ops left out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """One JAX and one port engine on the narrow LeViT's weights."""
    jcfg, cfg = CASES["levit-narrow"]
    values = _plant(_jax_layout(get_family(cfg).init(cfg, seed=7,
                                                     device="cpu")),
                    np.random.RandomState(11))
    params = convert.from_jax_params(values, cfg, device="cpu")
    jeng = JaxEngine.from_config(jcfg, values, update_every=100)
    eng = DartEngine.from_config(cfg, params, device="cpu",
                                 update_every=100)
    return jeng, eng, (jeng.state, eng.state)


def _reset(engines, adapt):
    jeng, eng, (jstate, state) = engines
    jeng.state, eng.state = jstate, state
    jeng.total_latency_s = eng.total_latency_s = 0.0
    for e in (jeng, eng):
        e.adapt = adapt
        e._policy_mirror = None
    return jeng, eng


def _edge_rows(masked):
    conf = masked["conf_stack"].numpy()[:-1].T
    eff = masked["eff_thresholds"].numpy()
    return np.abs(conf - eff).min(axis=1) < EDGE


def _sobel_edge(x, tau_edge=0.1):
    g = np.asarray(x, np.float64) @ np.array([0.299, 0.587, 0.114])
    h, w = g.shape[1:]
    tl, tc, tr, ml, _, mr, bl, bc, br = (
        g[:, i:h - 2 + i, j:w - 2 + j] for i in range(3) for j in range(3))
    gx = (tr + 2 * mr + br) - (tl + 2 * ml + bl)
    gy = (bl + 2 * bc + br) - (tl + 2 * tc + tr)
    mag = np.sqrt(gx * gx + gy * gy)
    return (np.abs(mag - tau_edge) < SOBEL_EDGE).any(axis=(1, 2))


@pytest.mark.parametrize("case", sorted(CASES))
def test_measure_costs_narrow_match_jax(case):
    """The port's count against the JAX engine's XLA count, live, at
    narrow width, where the elementwise share is largest."""
    jcfg, cfg = CASES[case]
    params = get_family(cfg).init(cfg, seed=3, device="cpu")
    eng = DartEngine.from_config(cfg, params, device="cpu")
    got = eng.measure_costs((32, 32, 3))
    want = JaxEngine.from_config(jcfg, _jax_layout(params)).measure_costs(
        (32, 32, 3))
    np.testing.assert_allclose(got, want, rtol=MACS_RTOL)
    np.testing.assert_allclose(got / got[-1], want / want[-1],
                               rtol=MACS_NORM_RTOL)
    np.testing.assert_array_equal(eng.cum_costs, got)


def test_engine_session_matches_jax(engines):
    """Calibration, the joint-DP policy, masked and compacted infer under
    a median policy: equal to JAX outside counted edge rows."""
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
    jcal.alpha[sobel] = cal.alpha[sobel]
    pol, jpol = eng.calibrate(cal), jeng.calibrate(jcal)
    np.testing.assert_allclose(pol.tau, jpol.tau, atol=CAL_ATOL, rtol=0)
    assert pol.beta_diff == jpol.beta_diff
    tau = np.array([np.median(cal.conf[:, s] - 0.3 * cal.alpha)
                    for s in range(2)], np.float32)
    for e in (jeng, eng):
        e.state = e.state.with_policy(tau=tau, beta_diff=0.3)
    x, _ = DS.make_batch(DATA, range(256, 256 + BATCH), split="eval")
    masked = eng.infer(x, mode="masked")
    compacted = eng.infer(x, mode="compacted")
    jmasked = jeng.infer(x, mode="masked")
    jcompacted = jeng.infer(x, mode="compacted")
    edge, sobel = _edge_rows(masked), _sobel_edge(x)
    assert edge.sum() <= 0.02 * len(x) and sobel.sum() <= 0.03 * len(x)
    ok = ~edge & ~sobel
    idx = masked["exit_idx"].numpy()
    assert len(np.unique(idx)) >= 2
    for got, want in ((idx, jmasked["exit_idx"]),
                      (compacted["exit_idx"], jcompacted["exit_idx"]),
                      (compacted["exit_idx"], idx),
                      (masked["pred"].numpy(), jmasked["pred"]),
                      (compacted["pred"], jcompacted["pred"])):
        np.testing.assert_array_equal(np.asarray(got)[ok],
                                      np.asarray(want)[ok])
    np.testing.assert_allclose(compacted["conf"][ok],
                               np.asarray(jcompacted["conf"])[ok],
                               atol=CAL_ATOL, rtol=0)


def test_engine_update_and_stats_match_jax(engines):
    jeng, eng = _reset(engines, adapt=True)
    cal = eng.collect_calibration(DATA, n=BATCH, batch=BATCH)
    tau = np.array([np.median(cal.conf[:, s] - 0.3 * cal.alpha)
                    for s in range(2)], np.float32)
    for e in (jeng, eng):
        e.state = e.state.with_policy(tau=tau, beta_diff=0.3)
    served = held_out = 0
    for a, z in ((456, 520), (520, 584)):
        x, _ = DS.make_batch(DATA, range(a, z), split="eval")
        # the window must see the same decisions: rows at a gate's edge
        # (or with a Sobel magnitude at tau_edge) are counted and not
        # served to either engine
        keep = ~_edge_rows(eng.infer(x, mode="masked")) & ~_sobel_edge(x)
        held_out += int((~keep).sum())
        x = x[keep]
        served += len(x)
        out = eng.infer(x)
        jout = jeng.infer(x, mode="masked", record=True, pad_to=BATCH)
        np.testing.assert_array_equal(out["exit_idx"], jout["exit_idx"])
    eng.update()
    jeng.update()
    ad, jad = eng.state.adaptive, jeng.state.adaptive
    for k in ("coef_temporal", "coef_class", "ucb_counts", "ucb_rewards",
              "active_strategy", "t", "ptr", "seen"):
        np.testing.assert_allclose(ad[k].numpy(), np.asarray(jad[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    st, jst = eng.stats(), jeng.stats()
    assert st["served"] == jst["served"] == served > 100
    assert held_out <= 0.03 * (served + held_out), held_out
    np.testing.assert_array_equal(st["exit_counts"], jst["exit_counts"])
    np.testing.assert_allclose(st["total_macs"], jst["total_macs"],
                               rtol=1e-6)
    for k in jst["window"]:
        np.testing.assert_allclose(st["window"][k], jst["window"][k],
                                   atol=1e-6, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

#: one step's gradients, each leaf relative to the norm of JAX's:
#: float32 sums in another order (no ReLU ties in LeViT: hard-swish's
#: kinks at +-3 are seldom met to rounding) ...
GRAD_RTOL = 1e-4
#: ... plus this share of the whole gradient's norm: where a train-mode
#: batchnorm downstream removes what a leaf shifts (the batch mean), its
#: gradient is zero in exact arithmetic and only rounding is left (norms
#: ~1e-9 at stage 2 before head_bn, errors ~1e-9 of the whole gradient)
GRAD_FLOOR = 1e-8
#: five steps: the loss, then the weights (AdamW maps a gradient at
#: rounding level to +-lr, so all but FLIP_SHARE within PARAM_TOL and
#: every one within the flip bound) and the running statistics
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4
FLIP_SHARE = 0.02
STATS_TOL = 1e-3
TRAIN = dict(batch_size=16, steps=5, lr=3e-3, warmup=2)
TDATA = (jDS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=256),
         DS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=256))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _paths(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _is_stats(path):
    return path.rsplit("/", 1)[-1] in BN.STATS_KEYS


def _trainers(case="levit-narrow"):
    jcfg, cfg = CASES[case]
    jtr = JTrainer(jcfg, JTrainConfig(**TRAIN), TDATA[0])
    tr = Trainer(cfg, TrainConfig(**TRAIN), TDATA[1],
                 params=convert.from_jax_params(jax.device_get(jtr.params),
                                                cfg, device="cpu"),
                 device="cpu")
    return jtr, tr


def _batches(n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(0, 1, (16, 32, 32, 3)).astype(np.float32),
             rs.randint(0, 10, 16).astype(np.int32)) for _ in range(n)]


def test_one_step_gradients_match_jax():
    """The Eq. 18 loss and every leaf's gradient of one step, train-mode
    batchnorm on the tokens included."""
    jtr, tr = _trainers()
    x, y = _batches(1, seed=11)[0]
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr._loss_fn(p, b, None), has_aux=True))(
        jtr.params, (jnp.asarray(x), jnp.asarray(y)))
    (loss, _), g = OPT.value_and_grad(tr._loss_fn, tr.params,
                                      (torch.from_numpy(x),
                                       torch.from_numpy(y)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6, atol=1e-6)
    want = _paths(convert.from_jax_params(jax.device_get(jg), tr.model_cfg,
                                          device="cpu"))
    got = _paths(g)
    assert set(got) == set(want)
    whole = np.sqrt(sum(float(np.square(want[p].numpy(), dtype=np.float64)
                              .sum()) for p in want))
    for path in want:
        w = want[path].numpy().astype(np.float64)
        if _is_stats(path):
            assert not w.any() and not got[path].any(), path
            continue
        err = np.linalg.norm(got[path].numpy() - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w) + GRAD_FLOOR * whole, (
            path, err, np.linalg.norm(w))


def test_trainer_steps_match_jax():
    """Five train_steps on the same batches: the loss per step, the
    weights and the running statistics, merged through the list indices
    of "stem/{i}", "shrink/{s}" and "stages/{s}/{b}"."""
    jtr, tr = _trainers()
    losses, jlosses = [], []
    for x, y in _batches(5, seed=5):
        jlosses.append(jtr.train_step((jnp.asarray(x), jnp.asarray(y))))
        losses.append(tr.train_step((x, y)))
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_TOL, rtol=0)
    lr = OPT.warmup_cosine(3e-3, 2, 5)
    flip = 2 * sum(float(lr(s)) for s in range(6))
    want = _paths(convert.from_jax_params(jax.device_get(jtr.params),
                                          tr.model_cfg, device="cpu"))
    got = _paths(tr.params)
    n_far = n_all = 0
    for path in want:
        g, w = got[path].numpy(), want[path].numpy()
        if _is_stats(path):
            np.testing.assert_allclose(g, w, atol=STATS_TOL, rtol=STATS_TOL,
                                       err_msg=path)
            continue
        diff = np.abs(g - w)
        assert diff.max() <= flip, (path, diff.max())
        n_far += int((diff > PARAM_TOL).sum())
        n_all += diff.size
    assert n_far <= FLIP_SHARE * n_all, (n_far, n_all)
    for path in ("/stem/1/bn/var", "/shrink/1/mlp/bn_up/mean",
                 "/stages/2/1/attn/bn/var", "/head_bn/mean"):
        assert not torch.equal(got[path], torch.full_like(
            got[path], 1.0 if path.endswith("var") else 0.0)), path
