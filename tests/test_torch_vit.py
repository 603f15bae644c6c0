"""The port's ViT (ViT-S/16, ViT-H/14), ConvNeXt (ConvNeXt-B) and
ResNet-152 against the JAX package, on the CPU, with converted weights:
the new layers (``conv2d`` VALID and grouped, ``patch_embed``,
``mha_apply``, ``mlp``), each stage and exit of the ``REDUCED`` configs
in float32 and in bf16, ``convert``, the full-width trees, the MAC
counts (live at reduced width, pinned XLA numbers at full width), the
config registry, a ``DartEngine`` session from an arch id, five
``Trainer`` steps and ``remat``; plus one test per trap (the patch
order, ConvNeXt's layernorm axis, no bias on k and v).

Every leaf of the JAX tree is drawn from a seeded numpy normal before
it is converted (``_draw``): the JAX init leaves ``gamma`` at 1e-6 and
every bias at 0, which makes a ConvNeXt block the identity to bf16
precision and hides a missing bias.  The synthetic images and the JAX
init fold a str hash; both packages draw from one hash-free base here
(``_fixed_draws``), as in ``test_torch_levit.py``."""
import dataclasses
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jREG
from repro.data import datasets as jDS
from repro.engine import DartEngine as JaxEngine
from repro.models import get_family as jget_family
from repro.models import layers as jL
from repro.parallel.sharding import unzip
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch import optim as OPT
from repro_torch.configs import registry as REG
from repro_torch.data import datasets as DS
from repro_torch.engine import DartEngine
from repro_torch.models import convnext as CNX
from repro_torch.models import get_family
from repro_torch.models import layers as L
from repro_torch.models import vit as VIT
from repro_torch.runtime.trainer import TrainConfig, Trainer

# tiny tensors: one thread is faster than torch's pool, and leaves the
# cores to the JAX side and to other test workers
torch.set_num_threads(1)

ARCHS = ("vit-s16", "vit-h14", "convnext-b", "resnet-152")

#: float32 activations through a stage: matmuls, softmax and
#: layernorm reductions in another order
RTOL, ATOL = 1e-4, 1e-4
#: one layer: a rounding or two apart
ELEM_TOL = 1e-5
#: bf16 keeps 8 bits: each op of a chain may round once more or once
#: less than XLA's (which computes in float32 and rounds each result),
#: a few units of bf16's last place of the largest logit over a
#: REDUCED model
BF16_TOL = 0.04
#: conf and alpha in the engine: fp32 reductions in another order
CAL_ATOL = 1e-5
#: rows whose conf at a gate lies this close to tau' may route differently
EDGE = 1e-5
#: images with a Sobel magnitude this close to tau_edge may count as an
#: edge pixel on one side only (test_torch_engine.py::SOBEL_EDGE)
SOBEL_EDGE = 1e-6

#: the JAX engine's ``measure_costs((224, 224, 3))`` on each CONFIG
#: (bf16), from ``tools/xla_cum_macs.py`` on the CPU; the same numbers
#: as chip_smoke.py's XLA_CUM_MACS.  XLA's count holds more than the
#: model's arithmetic: its CPU backend computes bf16 in float32, and
#: its cost analysis counts each convert (1.3-4.5 % of the count), and
#: its fusion recomputes the elementwise chain that ends a residual
#: block in the next block, compounding along a stage (7 % of
#: ResNet-152's).  ``count_macs`` counts both as XLA does.
XLA_CUM_MACS = {
    "vit-s16": [1540830725.0, 3081172229.0, 4621687493.0],
    "vit-h14": [41963774301.0, 83925004637.0, 125886234973.0,
                167847184349.0],
    "convnext-b": [1389402181.0, 2806292421.0, 14549518789.0,
                   15917610309.0],
    "resnet-152": [702401540.0, 2668827140.0, 11164841988.0,
                   11935906564.0],
}
#: full width: the port's count within 0.11 % of XLA's at every exit
#: (measured), held to 0.5 %
MACS_RTOL = 0.005
#: reduced width, live, where XLA's fusion of the few elementwise ops
#: around each small product weighs most: within 0.4 % (float32) and
#: 1.4 % (bf16), measured; held to 2 %, as test_torch_levit.py holds
#: LeViT's narrow count
MACS_NARROW_RTOL = 0.02
#: parameters of each full-width tree (the JAX init's shapes)
N_PARAMS = {"vit-s16": 22_576_056, "vit-h14": 636_351_520,
            "convnext-b": 89_492_256, "resnet-152": 62_139_232}

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


# ---------------------------------------------------------------------------
# weights: every leaf drawn, in the JAX layout
# ---------------------------------------------------------------------------

def _fan_in(key, shape):
    if key == "wo":                                  # (H, Dh, D)
        return shape[0] * shape[1]
    if key in ("wq", "wk", "wv"):                    # (D, H, Dh)
        return shape[0]
    return math.prod(shape[:-1])                     # HWIO, (in, out)


def _draw(tree, rs, key=None):
    """A JAX-layout value tree of ``tree``'s shapes, each leaf a seeded
    draw: weights N(0, 1/fan_in), layernorm and batchnorm scales and
    ``gamma`` in [0.5, 1.5], biases and means 0.2 N(0, 1), variances in
    [0.5, 2], ``pos`` 0.5 N(0, 1) (no symmetry a transposed patch order
    could hide behind)."""
    if isinstance(tree, dict):
        return {k: _draw(v, rs, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_draw(v, rs, key) for v in tree]
    shape, dtype = tuple(tree.shape), tree.dtype
    if key in ("scale", "gamma"):
        a = rs.uniform(0.5, 1.5, shape)
    elif key == "var":
        a = rs.uniform(0.5, 2.0, shape)
    elif key in ("bias", "b", "bq", "bo", "mean"):
        a = 0.2 * rs.randn(*shape)
    elif key == "pos":
        a = 0.5 * rs.randn(*shape)
    else:
        a = rs.randn(*shape) / math.sqrt(_fan_in(key, shape))
    return np.asarray(jnp.asarray(a, dtype))


def _jax_shapes(jcfg):
    """The JAX init's value tree as shapes and dtypes (nothing drawn)."""
    return jax.eval_shape(
        lambda: unzip(jget_family(jcfg).init(jax.random.key(0), jcfg))[0])


def _cfgs(arch, bf16=False, **repl):
    """(JAX cfg, port cfg): ``REDUCED``, in bf16 if asked."""
    jcfg, cfg = jREG.get_reduced(arch), REG.get_reduced(arch)
    if bf16:
        jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16,
                                   compute_dtype=jnp.bfloat16)
        repl.update(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    return (dataclasses.replace(jcfg, **{k: v for k, v in repl.items()
                                         if "dtype" not in k}),
            dataclasses.replace(cfg, **repl))


def _pair(arch, seed=0, bf16=False, **repl):
    """(JAX cfg, JAX values, port cfg, port params) on drawn weights."""
    jcfg, cfg = _cfgs(arch, bf16, **repl)
    values = _draw(_jax_shapes(jcfg), np.random.RandomState(seed))
    return jcfg, values, cfg, convert.from_jax_params(values, cfg,
                                                      device="cpu")


def _images(b=4, res=32, seed=0):
    return np.random.RandomState(seed).uniform(
        0, 1, (b, res, res, 3)).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


def _nhwc(t):
    return _np(t.permute(0, 2, 3, 1)) if t.dim() == 4 else _np(t)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

CONV_CASES = {   # (H, W, cin, cout, k, stride, padding, groups)
    "stem-valid": (32, 32, 3, 8, 4, 4, "VALID", 1),
    "patch-valid-ragged": (30, 30, 3, 8, 8, 8, "VALID", 1),
    "downsample-valid": (9, 9, 8, 16, 2, 2, "VALID", 1),
    "depthwise-same": (9, 11, 8, 8, 7, 1, "SAME", 8),
    "grouped-same-s2": (9, 9, 8, 12, 3, 2, "SAME", 4),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_valid_and_groups_match_jax(case):
    """VALID and grouped convolutions against JAX; the weight layout of a
    depthwise leaf (7, 7, 1, C) -> (C, 1, 7, 7) by ``convert``; the MAC
    count is the taps inside the unpadded input of one group."""
    h, w, cin, cout, k, stride, padding, groups = CONV_CASES[case]
    rs = np.random.RandomState(len(case))
    x = rs.randn(2, h, w, cin).astype(np.float32)
    jp = {"w": rs.randn(k, k, cin // groups, cout).astype(np.float32),
          "b": rs.randn(cout).astype(np.float32)}
    p = convert.to_port_tree(jp, "cpu")
    assert p["w"].shape == (cout, cin // groups, k, k)
    want = jL.conv2d(jp, jnp.asarray(x), stride=stride, padding=padding,
                     groups=groups)
    got = L.conv2d(p, torch.from_numpy(x).permute(0, 3, 1, 2),
                   stride=stride, padding=padding, groups=groups)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    ones = {"w": torch.ones_like(p["w"])}
    with L.count_macs() as c:
        y = L.conv2d(ones, torch.ones(2, cin, h, w), stride=stride,
                     padding=padding, groups=groups)
    assert c.macs == int(y.sum())
    with pytest.raises(ValueError, match="padding"):
        L.conv2d(p, torch.ones(1, cin, h, w), padding="FULL")


def test_patch_embed_matches_jax_in_row_major_order():
    """(B, h*w, D) tokens in the row-major order of the NHWC map, the
    conv bias added; a 3 x 4 patch grid, so a transposed order would not
    even keep the grid's shape."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 24, 32, 3).astype(np.float32)
    jp = {"proj": {"w": rs.randn(8, 8, 3, 16).astype(np.float32),
                   "b": rs.randn(16).astype(np.float32)}}
    want = np.asarray(jL.patch_embed(jp, jnp.asarray(x), 8))
    got = L.patch_embed(convert.to_port_tree(jp, "cpu"),
                        torch.from_numpy(x).permute(0, 3, 1, 2), 8)
    assert want.shape == got.shape == (2, 12, 16)
    _close(got, want, atol=1e-5, rtol=1e-5)


def _mha_values(rs, d=24, h=4):
    hd = d // h
    return {"wq": rs.randn(d, h, hd) / math.sqrt(d),
            "wk": rs.randn(d, h, hd) / math.sqrt(d),
            "wv": rs.randn(d, h, hd) / math.sqrt(d),
            "wo": rs.randn(h, hd, d) / math.sqrt(d),
            "bq": 0.5 * rs.randn(h, hd), "bo": 0.5 * rs.randn(d)}


def test_mha_and_mlp_match_jax():
    """``mha_apply`` (biases on q and the output, float32 softmax) and
    ``mlp`` (up, tanh GELU, down) against JAX; ``mha_init`` and
    ``mlp_init`` give the JAX init's keys and shapes."""
    rs = np.random.RandomState(2)
    jp = {k: v.astype(np.float32) for k, v in _mha_values(rs).items()}
    x = rs.randn(3, 10, 24).astype(np.float32)
    _close(L.mha_apply(convert.to_port_tree(jp, "cpu"), torch.from_numpy(x)),
           jL.mha_apply(jp, jnp.asarray(x)), atol=ELEM_TOL, rtol=ELEM_TOL)
    jmlp = {"up": {"w": rs.randn(24, 40) / 5, "b": rs.randn(40)},
            "down": {"w": rs.randn(40, 24) / 6, "b": rs.randn(24)}}
    jmlp = jax.tree.map(lambda a: a.astype(np.float32), jmlp)
    _close(L.mlp(convert.to_port_tree(jmlp, "cpu"), torch.from_numpy(x)),
           jL.mlp(jmlp, jnp.asarray(x)), atol=ELEM_TOL, rtol=ELEM_TOL)
    gen = torch.Generator().manual_seed(0)
    shapes = jax.eval_shape(lambda: jax.tree.map(
        lambda p: p.value, jL.mha_init(jax.random.key(0), 24, 4,
                                       jnp.float32),
        is_leaf=lambda p: hasattr(p, "value")))
    got = L.mha_init(gen, 24, 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in shapes.items()}
    assert not got["bq"].any() and not got["bo"].any()


def test_no_bias_on_k_and_v_is_pinned():
    """The trap: JAX's attention has biases on q and the output only.
    A bias on v moves every output (it passes the softmax); a bias on k
    moves none (each query's scores shift by one constant, which the
    softmax removes), so only the tree's keys can catch it: ``convert``
    rejects a tree with ``bk`` or ``bv``."""
    rs = np.random.RandomState(3)
    jp = {k: v.astype(np.float32) for k, v in _mha_values(rs).items()}
    x = torch.from_numpy(rs.randn(3, 10, 24).astype(np.float32))
    want = np.asarray(jL.mha_apply(jp, jnp.asarray(x.numpy())))
    p = convert.to_port_tree(jp, "cpu")
    b = torch.from_numpy(rs.randn(4, 6).astype(np.float32))

    def biased(kb, vb):
        q = L.einsum("bsd,dhk->bshk", x, p["wq"]) + p["bq"]
        k = L.einsum("bsd,dhk->bshk", x, p["wk"]) + kb
        v = L.einsum("bsd,dhk->bshk", x, p["wv"]) + vb
        o = L.dense_attention(q, k, v)
        return L.einsum("bshk,hkd->bsd", o, p["wo"]) + p["bo"]
    _close(biased(0, 0), want, atol=ELEM_TOL, rtol=ELEM_TOL)
    _close(biased(b, 0), want, atol=ELEM_TOL, rtol=ELEM_TOL)
    assert not np.allclose(_np(biased(0, b)), want, rtol=RTOL, atol=ATOL)
    jcfg, values, cfg, _ = _pair("vit-s16")
    for extra in ("bk", "bv"):
        bad = jax.tree.map(lambda a: a, values)
        bad["blocks"][0]["attn"][extra] = np.zeros((4, 12), np.float32)
        with pytest.raises(ValueError, match="keys"):
            convert.from_jax_params(bad, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the models: stages and exits
# ---------------------------------------------------------------------------

def _exit_at(cfg, s):
    """Whether stage ``s`` ends at an exit (``forward`` stacks those)."""
    n = get_family(cfg).num_stages(cfg)
    return s in getattr(cfg, "exit_stages", range(n)) or s == n - 1


def _stage_by_stage(jcfg, values, cfg, params, x, atol, rtol):
    """Stem, each stage and each exit against JAX; returns the logits of
    both sides, stacked like ``forward``."""
    jfam, fam = jget_family(jcfg), get_family(cfg)
    jstage = jax.jit(lambda v, h, s: jfam.apply_stage(v, h, s, jcfg),
                     static_argnums=2)
    jexit = jax.jit(lambda v, h, s: jfam.apply_exit(v, h, s, jcfg),
                    static_argnums=2)
    jh = jax.jit(lambda v, x: jfam.apply_stem(v, x, jcfg))(
        values, jnp.asarray(x))
    h = fam.apply_stem(params, torch.from_numpy(x), cfg)
    _close(h if h.dim() == 3 else h.permute(0, 2, 3, 1), jh, "stem",
           atol=atol, rtol=rtol)
    logits, jlogits = [], []
    n = fam.num_stages(cfg)
    assert n == jfam.num_stages(jcfg)
    for s in range(n):
        jh = jstage(values, jh, s)
        h = fam.apply_stage(params, h, s, cfg)
        _close(h if h.dim() == 3 else h.permute(0, 2, 3, 1), jh,
               f"stage {s}", atol=atol, rtol=rtol)
        if _exit_at(cfg, s):
            jlogits.append(np.asarray(jexit(values, jh, s), np.float32))
            logits.append(fam.apply_exit(params, h, s, cfg))
            _close(logits[-1], jlogits[-1], f"exit {s}", atol=atol,
                   rtol=rtol)
    return torch.stack(logits), np.stack(jlogits)


@pytest.mark.parametrize("arch", ARCHS)
def test_stages_and_exits_match_jax_float32(arch):
    """Each REDUCED config in float32: stem, every stage and exit, and
    ``forward`` (logits only at the exits, as the reference stacks
    them) against JAX on drawn weights."""
    jcfg, values, cfg, params = _pair(arch)
    x = _images()
    logits, _ = _stage_by_stage(jcfg, values, cfg, params, x, ATOL, RTOL)
    out = get_family(cfg).forward(params, torch.from_numpy(x), cfg)
    jout = jax.jit(lambda v, x: jget_family(jcfg).forward(v, x, jcfg))(
        values, jnp.asarray(x))
    assert out["exit_logits"].shape == (cfg.n_exits, 4, 10)
    _close(out["exit_logits"], jout["exit_logits"], atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(_np(out["exit_logits"]), _np(logits))


def _bf16_ulp(a):
    """One unit of bf16's last place at |a| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


@pytest.mark.parametrize("arch", ["vit-s16", "convnext-b"])
def test_stages_and_exits_match_jax_bf16(arch):
    """One bf16 case per family: stages and exits within BF16_TOL of
    the largest activation; the argmax equal outside rows whose top-2
    gap is within one bf16 ulp of the max (counted: at most 1 in 4)."""
    jcfg, values, cfg, params = _pair(arch, seed=4, bf16=True)
    assert params["head"]["w"].dtype == torch.bfloat16
    x = _images(b=16, seed=2)
    jfam, fam = jget_family(jcfg), get_family(cfg)
    jh = jnp.asarray(x)
    h = torch.from_numpy(x)
    jh = jax.jit(lambda v, x: jfam.apply_stem(v, x, jcfg))(values, jh)
    h = fam.apply_stem(params, h, cfg)
    logits, jlogits = [], []
    for s in range(fam.num_stages(cfg)):
        jh = jax.jit(lambda v, h, s=s: jfam.apply_stage(v, h, s, jcfg))(
            values, jh)
        h = fam.apply_stage(params, h, s, cfg)
        assert h.dtype == torch.bfloat16 and jh.dtype == jnp.bfloat16
        want = np.asarray(jh, np.float32)
        got = _np(h if h.dim() == 3 else h.permute(0, 2, 3, 1))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL * scale,
                                   err_msg=f"stage {s}")
        if _exit_at(cfg, s):
            jlogits.append(np.asarray(jax.jit(
                lambda v, h, s=s: jfam.apply_exit(v, h, s, jcfg))(values, jh),
                np.float32))
            logits.append(_np(fam.apply_exit(params, h, s, cfg)))
    for s, (got, want) in enumerate(zip(logits, jlogits)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_TOL * scale, err_msg=f"exit {s}")
        top2 = np.sort(want, axis=1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] <= _bf16_ulp(top2[:, 1])
        assert tie.sum() <= len(x) // 4, tie.sum()
        np.testing.assert_array_equal(got.argmax(1)[~tie],
                                      want.argmax(1)[~tie])


def test_patch_order_is_pinned():
    """The trap: tokens and ``pos`` follow the NHWC patch grid row by
    row.  Flattening the NCHW map column by column runs without error
    (a square grid), and with a non-symmetric ``pos`` stage 0 misses
    JAX."""
    jcfg, values, cfg, params = _pair("vit-s16", seed=5)
    x = _images(seed=6)
    jfam = jget_family(jcfg)
    want = np.asarray(jax.jit(lambda v, x: jfam.apply_stage(
        v, jfam.apply_stem(v, x, jcfg), 0, jcfg))(values, jnp.asarray(x)))
    tx = torch.from_numpy(x)
    _close(VIT.apply_stage(params, VIT.apply_stem(params, tx, cfg), 0, cfg),
           want)
    proj = params["patch"]["proj"]
    y = L.conv2d(proj, tx.permute(0, 3, 1, 2), stride=cfg.patch,
                 padding="VALID")
    col_major = y.permute(0, 3, 2, 1).reshape(4, -1, cfg.d_model)
    wrong = VIT.apply_stage(params, col_major + params["pos"], 0, cfg)
    assert wrong.shape == want.shape
    assert not np.allclose(_np(wrong), want, rtol=RTOL, atol=ATOL)


def test_convnext_layernorm_axis_is_pinned(monkeypatch):
    """The trap: the layernorms normalise the channels, the NHWC last
    axis.  With a 16-channel 16 x 16 stem map, a layernorm over the last
    axis of the port's NCHW map (the width) has a valid shape and runs;
    ConvNeXt then misses JAX from the stem on."""
    jcfg, values, cfg, params = _pair("convnext-b", seed=7, img_res=64)
    x = _images(res=64, seed=8)
    jfam = jget_family(jcfg)
    want = np.asarray(jax.jit(lambda v, x: jfam.apply_stage(
        v, jfam.apply_stem(v, x, jcfg), 0, jcfg))(values, jnp.asarray(x)))
    tx = torch.from_numpy(x)

    def stage0():
        h = CNX.apply_stage(params, CNX.apply_stem(params, tx, cfg), 0, cfg)
        assert h.shape == (4, 16, 16, 16)
        return _nhwc(h)
    np.testing.assert_allclose(stage0(), want, rtol=RTOL, atol=ATOL)
    monkeypatch.setattr(CNX, "_channels_last", lambda fn, h: fn(h))
    assert not np.allclose(stage0(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# convert, the full-width trees, the registry
# ---------------------------------------------------------------------------

def test_convert_each_tree_and_reject_another_architecture():
    """Each REDUCED tree converts leaf for leaf: convolutions (patch,
    stem, depthwise, downsample) HWIO -> OIHW, the attention weights,
    ``bq``, ``pos`` and ``gamma`` in their layout, the batchnorm
    statistics float32 in a bf16 tree; another architecture's tree, or
    the same family's at another size, raises."""
    trees = {a: _pair(a) for a in ARCHS}
    for arch, (jcfg, values, cfg, params) in trees.items():
        for got, want in zip(convert.leaves(params),
                             jax.tree.leaves(values)):
            w = want.transpose(3, 2, 0, 1) if (
                want.ndim == 4 and got.shape != want.shape) else want
            np.testing.assert_array_equal(got.numpy(), w, err_msg=arch)
    _, values, _, params = trees["convnext-b"]
    assert params["stages"][0][0]["dwconv"]["w"].shape == (16, 1, 7, 7)
    assert values["stages"][0][0]["dwconv"]["w"].shape == (7, 7, 1, 16)
    _, values, _, params = trees["vit-s16"]
    assert params["blocks"][0]["attn"]["wo"].shape == (4, 12, 48)
    np.testing.assert_array_equal(params["pos"].numpy(), values["pos"])
    for a, b in (("vit-s16", "convnext-b"), ("convnext-b", "resnet-152"),
                 ("resnet-152", "vit-h14"), ("vit-s16", "vit-h14")):
        with pytest.raises(ValueError):
            convert.from_jax_params(trees[a][1], trees[b][2], device="cpu")
    jcfg, cfg = _cfgs("resnet-152", bf16=True)
    params = convert.from_jax_params(_draw(_jax_shapes(jcfg),
                                           np.random.RandomState(0)),
                                     cfg, device="cpu")
    bn = params["stages"][0][0]["bn1"]
    assert bn["scale"].dtype == torch.bfloat16
    assert bn["mean"].dtype == bn["var"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_trees_match_jax_shapes(arch):
    """Each CONFIG at full width: the port's init (on the meta device,
    nothing drawn) has the JAX init's shapes leaf for leaf, its
    parameter count, and bf16 leaves (batchnorm statistics float32)."""
    jcfg, cfg = jREG.get(arch), REG.get(arch)
    assert cfg.img_res == 224 and cfg.compute_dtype == torch.bfloat16
    params = get_family(cfg).init(cfg, device="meta")
    jshapes = _jax_shapes(jcfg)
    hwio = convert.tree_map(lambda t: t.permute(2, 3, 1, 0)
                            if t.dim() == 4 else t, params)
    assert ([tuple(t.shape) for t in jax.tree.leaves(hwio)]
            == [tuple(a.shape) for a in jax.tree.leaves(jshapes)])
    assert sum(t.numel() for t in convert.leaves(params)) == N_PARAMS[arch]
    for k, t in _keyed(params):
        assert t.dtype == (torch.float32 if k in ("mean", "var")
                           else torch.bfloat16), k


def _keyed(tree, key=None):
    if isinstance(tree, dict):
        return [kt for k, v in tree.items() for kt in _keyed(v, k)]
    if isinstance(tree, list):
        return [kt for v in tree for kt in _keyed(v, key)]
    return [(key, tree)]


def test_registry_known_and_unknown_ids():
    """The port's ids resolve to configs of the JAX package's widths;
    the other assigned ids raise a KeyError naming the ROADMAP item
    that ports them; an unknown id lists the known ones."""
    for arch in (*ARCHS, "tinyllama-1.1b"):
        cfg, jcfg = REG.get(arch), jREG.get(arch)
        for f in dataclasses.fields(jcfg):
            if hasattr(cfg, f.name) and "dtype" not in f.name:
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), (
                    arch, f.name)
        assert REG.get_reduced(arch).name == jREG.get_reduced(arch).name
    assert set(REG.ASSIGNED) | set(REG.NOT_PORTED) == set(jREG.ASSIGNED)
    for arch in REG.NOT_PORTED:
        with pytest.raises(KeyError, match="ROADMAP queue 1, item"):
            REG.get(arch)
    with pytest.raises(KeyError, match="known"):
        REG.get("vit-b16")
    want = jREG.paper_testbeds()
    got = REG.paper_testbeds()
    assert set(got) == set(want)
    assert all(got[k].name == want[k].name for k in want)


def test_from_config_takes_an_arch_id(monkeypatch):
    """``DartEngine.from_config("<arch id>", params)`` resolves the
    config through the registry (full width, on the meta device) and
    defaults to the card."""
    for arch in ARCHS:
        cfg = REG.get(arch)
        eng = DartEngine.from_config(
            arch, get_family(cfg).init(cfg, device="meta"), device="meta")
        assert eng.cfg == cfg
        assert eng.n_exits == cfg.n_exits
    with pytest.raises(KeyError, match="item 8"):
        DartEngine.from_config("dit-s2", {}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = REG.get_reduced("vit-s16")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_family(cfg).init(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DartEngine.from_config("vit-s16",
                               get_family(cfg).init(cfg, device="cpu"))


# ---------------------------------------------------------------------------
# MAC counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,bf16", [(a, False) for a in ARCHS]
                         + [(a, True) for a in ("vit-s16", "convnext-b",
                                                "resnet-152")])
def test_measure_costs_reduced_match_jax(arch, bf16):
    """The port's count against the JAX engine's XLA count, live, on
    each REDUCED config (the CNNs at depths 1-2-3-2, so that XLA's fused
    chain compounds), and in bf16 (its converts)."""
    kw = {} if arch.startswith("vit") else {"depths": (1, 2, 3, 2)}
    jcfg, values, cfg, params = _pair(arch, bf16=bf16, **kw)
    eng = DartEngine.from_config(cfg, params, device="cpu")
    got = eng.measure_costs((32, 32, 3))
    want = JaxEngine.from_config(jcfg, values).measure_costs((32, 32, 3))
    np.testing.assert_allclose(got, want, rtol=MACS_NARROW_RTOL)
    np.testing.assert_array_equal(eng.cum_costs, got)


def test_measure_costs_full_width_match_pinned_xla_counts():
    """Each CONFIG at full width on the meta device (shapes only, no
    JAX compile): within MACS_RTOL of XLA's pinned count at every
    exit."""
    for arch, want in XLA_CUM_MACS.items():
        cfg = REG.get(arch)
        eng = DartEngine.from_config(
            arch, get_family(cfg).init(cfg, device="meta"), device="meta")
        got = eng.measure_costs((224, 224, 3))
        np.testing.assert_allclose(got, want, rtol=MACS_RTOL, err_msg=arch)


def test_count_converts_only_in_bf16():
    """``count_converts`` adds half a MAC an element of each bf16 tensor
    and nothing for float32 or outside a scope."""
    a, b = torch.ones(3, 4, dtype=torch.bfloat16), torch.ones(5)
    with L.count_macs() as c:
        L.count_converts(a, b, a)
    assert c.macs == 12
    L.count_converts(a)
    assert c.macs == 12


# ---------------------------------------------------------------------------
# the engine, from an arch id
# ---------------------------------------------------------------------------

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


@pytest.fixture(scope="module", params=["vit-s16", "convnext-b"])
def engines(request):
    """One JAX and one port engine, each from the arch id, the registry
    resolving it to the REDUCED config on both sides; drawn weights."""
    arch = request.param
    _, values, _, params = _pair(arch, seed=9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jREG, "get", jREG.get_reduced)
        mp.setattr(REG, "get", REG.get_reduced)
        jeng = JaxEngine.from_config(arch, values, update_every=100)
        eng = DartEngine.from_config(arch, params, device="cpu",
                                     update_every=100)
    assert eng.cfg == REG.get_reduced(arch)
    return jeng, eng


def test_engine_session_matches_jax(engines):
    """Calibration, the joint-DP policy, masked and compacted infer
    under a median policy, ``update`` and ``stats``: equal to JAX
    outside counted edge rows."""
    jeng, eng = engines
    for e in (jeng, eng):
        e.adapt = False
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
    n_gates = eng.n_exits - 1
    tau = np.array([np.median(cal.conf[:, s] - 0.3 * cal.alpha)
                    for s in range(n_gates)], np.float32)
    for e in (jeng, eng):
        e.state = e.state.with_policy(tau=tau, beta_diff=0.3)
        e.adapt = True
    x, _ = DS.make_batch(DATA, range(256, 256 + BATCH), split="eval")
    masked = eng.infer(x, mode="masked")
    jmasked = jeng.infer(x, mode="masked")
    edge, sobel = _edge_rows(masked), _sobel_edge(x)
    assert edge.sum() <= 0.03 * len(x) and sobel.sum() <= 0.03 * len(x)
    ok = ~edge & ~sobel
    idx = masked["exit_idx"].numpy()
    assert len(np.unique(idx)) >= 2
    compacted = eng.infer(x[ok], mode="compacted")
    jcompacted = jeng.infer(x[ok], mode="compacted")
    for got, want in ((idx[ok], np.asarray(jmasked["exit_idx"])[ok]),
                      (compacted["exit_idx"], jcompacted["exit_idx"]),
                      (compacted["exit_idx"], idx[ok]),
                      (masked["pred"].numpy()[ok],
                       np.asarray(jmasked["pred"])[ok]),
                      (compacted["pred"], jcompacted["pred"])):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_allclose(compacted["conf"],
                               np.asarray(jcompacted["conf"]),
                               atol=CAL_ATOL, rtol=0)
    eng.update()
    jeng.update()
    ad, jad = eng.state.adaptive, jeng.state.adaptive
    for k in ("coef_temporal", "coef_class", "ucb_counts", "ucb_rewards",
              "active_strategy", "t", "ptr", "seen"):
        np.testing.assert_allclose(ad[k].numpy(), np.asarray(jad[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    st, jst = eng.stats(), jeng.stats()
    assert st["served"] == jst["served"] == int(ok.sum())
    np.testing.assert_array_equal(st["exit_counts"], jst["exit_counts"])
    np.testing.assert_allclose(st["total_macs"], jst["total_macs"],
                               rtol=MACS_NARROW_RTOL)
    for k in jst["window"]:
        np.testing.assert_allclose(st["window"][k], jst["window"][k],
                                   atol=1e-6, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the trainer and remat
# ---------------------------------------------------------------------------

#: five steps (test_torch_train.py's bounds): the loss per step, then
#: the weights, all but FLIP_SHARE within PARAM_TOL and every one within
#: AdamW's flip bound (a gradient at rounding level moves by +-lr)
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4
FLIP_SHARE = 0.02
TRAIN = dict(batch_size=8, steps=5, lr=3e-3, warmup=2)
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


def _batches(n, seed, b=8):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(0, 1, (b, 32, 32, 3)).astype(np.float32),
             rs.randint(0, 10, b).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("arch", ["vit-s16", "convnext-b"])
def test_trainer_steps_match_jax(arch):
    """Five ``train_step``s of the REDUCED model from the same drawn
    weights and batches: the loss per step and the weights."""
    jcfg, values, cfg, params = _pair(arch, seed=11)
    jtr = JTrainer(jcfg, JTrainConfig(**TRAIN), TDATA[0])
    jtr.params = jax.tree.map(jnp.asarray, values)
    tr = Trainer(cfg, TrainConfig(**TRAIN), TDATA[1], params=params,
                 device="cpu")
    losses, jlosses = [], []
    for x, y in _batches(5, seed=5):
        jlosses.append(jtr.train_step((jnp.asarray(x), jnp.asarray(y))))
        losses.append(tr.train_step((x, y)))
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_TOL, rtol=0)
    lr = OPT.warmup_cosine(3e-3, 2, 5)
    flip = 2 * sum(float(lr(s)) for s in range(6))
    want = _paths(convert.from_jax_params(jax.device_get(jtr.params), cfg,
                                          device="cpu"))
    got = _paths(tr.params)
    assert set(got) == set(want)
    n_far = n_all = 0
    for path in want:
        diff = np.abs(got[path].numpy() - want[path].numpy())
        assert diff.max() <= flip, (path, diff.max())
        n_far += int((diff > PARAM_TOL).sum())
        n_all += diff.size
    assert n_far <= FLIP_SHARE * n_all, (n_far, n_all)
    assert not torch.equal(got["/head/w"], _paths(params)["/head/w"])


def test_remat_gives_the_same_gradients_and_serves_without_it(monkeypatch):
    """``remat=True`` (ViT-H/14's) recomputes each block in the backward
    pass: the loss and every gradient equal those without it, each block
    went through ``checkpoint``; with gradients off (serving) no block
    does."""
    _, _, cfg, params = _pair("vit-h14", seed=12)
    calls = []
    checkpoint = VIT.checkpoint
    monkeypatch.setattr(VIT, "checkpoint", lambda fn, *a, **kw: (
        calls.append(1), checkpoint(fn, *a, **kw))[1])
    x, y = (torch.from_numpy(a) for a in _batches(1, seed=13)[0])
    out = {}
    for remat in (False, True):
        tr = Trainer(dataclasses.replace(cfg, remat=remat),
                     TrainConfig(**TRAIN), TDATA[1], params=params,
                     device="cpu")
        out[remat] = OPT.value_and_grad(tr._loss_fn, tr.params, (x, y))
    assert len(calls) == cfg.n_layers
    (l0, _), g0 = out[False]
    (l1, _), g1 = out[True]
    assert float(l0) == float(l1)
    for path, g in _paths(g0).items():
        torch.testing.assert_close(_paths(g1)[path], g, rtol=0, atol=0)
    rcfg = dataclasses.replace(cfg, remat=True)
    with torch.no_grad():
        served = get_family(rcfg).forward(params, x, rcfg)["exit_logits"]
    assert len(calls) == cfg.n_layers
    _close(served, _np(get_family(cfg).forward(params, x,
                                               cfg)["exit_logits"]),
           rtol=0, atol=0)
