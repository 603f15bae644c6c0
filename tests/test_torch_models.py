"""The port's testbed CNNs against the JAX package with converted
weights: SAME convolution and max-pooling, inference batchnorm, and the
staged AlexNet, VGG and ResNet per stage and per exit.  Pins the padding
/ pooling / flatten hazards of the port, and the MAC count of its
convolutions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_testbeds as jTB
from repro.models import batchnorm as jBN
from repro.models import get_family as jget_family
from repro.models import layers as jL
from repro.parallel.sharding import unzip
from repro_torch import convert
from repro_torch.configs import paper_testbeds as TB
from repro_torch.models import batchnorm as BN
from repro_torch.models import cnn_zoo
from repro_torch.models import get_family
from repro_torch.models import layers as L

# tiny tensors: one thread is faster than torch's pool, and leaves the
# cores to the JAX side and to other test workers
torch.set_num_threads(1)

# CPU convolution algorithms differ between XLA and torch
RTOL, ATOL = 1e-4, 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("hw,k,stride", [
    (8, 3, 1), (8, 3, 2), (7, 3, 2), (9, 5, 1), (6, 1, 2), (5, 3, 3)])
def test_conv2d_same_matches_jax(hw, k, stride):
    rs = np.random.RandomState(hw * 10 + k + stride)
    x = rs.randn(2, hw, hw, 3).astype(np.float32)
    w = rs.randn(k, k, 3, 4).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    want = jL.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride)
    p = {"w": torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
         "b": torch.from_numpy(b)}
    got = L.conv2d(p, _nchw(x), stride=stride)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("hw,k,stride", [
    (8, 3, 1), (8, 3, 2), (7, 3, 2), (9, 5, 1), (6, 1, 2), (5, 3, 3),
    (32, 7, 2), (29, 7, 2)])
def test_conv2d_mac_count_is_the_taps_inside_the_image(hw, k, stride):
    """With ones for image and kernel, each output sums the taps that
    land inside the unpadded image: their total over the outputs is the
    count ``count_macs`` must give, padding excluded."""
    x = torch.ones(2, 3, hw, hw + 1)
    p = {"w": torch.ones(4, 3, k, k)}
    with L.count_macs() as c:
        y = L.conv2d(p, x, stride=stride)
    assert c.macs == int(y.sum())
    with L.count_macs() as c:
        L.linear({"w": torch.ones(5, 7), "b": torch.ones(7)},
                 torch.ones(2, 3, 5))
    assert c.macs == 2 * 3 * 5 * 7
    L.conv2d(p, x, stride=stride)                   # no scope: no count
    assert c.macs == 2 * 3 * 5 * 7


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_bn_apply_matches_jax(dtype):
    """Inference batchnorm with planted statistics (init's mean 0 and var
    1 would hide a swapped or transposed statistic), NCHW against JAX's
    NHWC; then train mode (the batch's own statistics) on the same input."""
    rs = np.random.RandomState(2)
    c = 6
    p = {"scale": rs.uniform(0.5, 1.5, c), "bias": rs.randn(c),
         "mean": rs.randn(c), "var": rs.uniform(0.2, 3.0, c)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (3 * rs.randn(2, 5, 7, c) + 1).astype(np.float32)
    jp = dict(p)
    if dtype == "bfloat16":
        jp["scale"] = jnp.asarray(p["scale"], jnp.bfloat16)
        jp["bias"] = jnp.asarray(p["bias"], jnp.bfloat16)
        jx = jnp.asarray(x, jnp.bfloat16)
    else:
        jx = jnp.asarray(x)
    want = np.asarray(jBN.bn_apply(jp, jx, train=False), np.float32)
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
          jp.items()}
    tx = _nchw(np.asarray(jx, np.float32))
    if dtype == "bfloat16":
        tp["scale"], tp["bias"] = (tp["scale"].bfloat16(),
                                   tp["bias"].bfloat16())
        tx = tx.bfloat16()
    got = BN.bn_apply(tp, tx)
    assert got.dtype == tx.dtype
    # f32: one rounding apart; bf16: the same f32 value cast to bf16
    tol = (1e-6, 1e-6) if dtype == np.float32 else (8e-3, 8e-3)
    np.testing.assert_allclose(_nhwc(got.float()), want, rtol=tol[0],
                               atol=tol[1])
    # train mode: batch mean and biased variance, in another order (f32)
    want = np.asarray(jBN.bn_apply(jp, jx, train=True), np.float32)
    got = BN.bn_apply(tp, tx, train=True)
    assert got.dtype == tx.dtype
    tol = (1e-5, 1e-5) if dtype == np.float32 else (8e-3, 8e-3)
    np.testing.assert_allclose(_nhwc(got.float()), want, rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("hw,expect", [(28, 14), (14, 7), (7, 4), (5, 3),
                                       (1, 1)])
def test_max_pool_same_rounds_up_like_jax(hw, expect):
    x = np.random.RandomState(hw).randn(2, hw, hw, 3).astype(np.float32)
    want = np.asarray(jL.max_pool(jnp.asarray(x), 2, 2))
    got = _nhwc(L.max_pool(_nchw(x), 2, 2))
    assert got.shape[1:3] == want.shape[1:3] == (expect, expect)
    np.testing.assert_array_equal(got, want)


def _jax_params(jcfg, seed=0):
    """The JAX package's own init, as the numpy value tree."""
    init = jax.jit(lambda k: unzip(jget_family(jcfg).init(k, jcfg))[0])
    return jax.tree.map(np.asarray, init(jax.random.key(seed)))


def _jax_layout(tree):
    """A port init in the JAX layout (conv OIHW -> HWIO); the JAX random
    init compiles for seconds per architecture, this costs nothing."""
    return jax.tree.map(lambda t: t.permute(2, 3, 1, 0).numpy()
                        if t.dim() == 4 else t.numpy(), tree)


@pytest.fixture(scope="module")
def alexnet_tiny_jax_init():
    return _jax_params(jTB.ALEXNET_TINY)


def _plant_bn(tree, rs):
    """Random batchnorm scale, bias, mean and var (> 0) in a JAX-layout
    value tree, in place; trees without batchnorm are left as they are."""
    if isinstance(tree, dict) and set(tree) == {"scale", "bias", "mean",
                                                "var"}:
        c = tree["mean"].shape[0]
        tree.update(scale=rs.uniform(0.5, 1.5, c), bias=0.2 * rs.randn(c),
                    mean=0.2 * rs.randn(c), var=rs.uniform(0.5, 2.0, c))
        for k in tree:
            tree[k] = tree[k].astype(np.float32)
    elif isinstance(tree, dict):
        for v in tree.values():
            _plant_bn(v, rs)
    elif isinstance(tree, list):
        for v in tree:
            _plant_bn(v, rs)
    return tree


def _pair(jcfg, cfg, values=None):
    if values is None:
        values = _plant_bn(_jax_layout(
            get_family(cfg).init(cfg, seed=1, device="cpu")),
            np.random.RandomState(9))
    return values, convert.from_jax_params(values, cfg, device="cpu")


TINY_VGG = dict(blocks=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1)),
                fc_dim=32)
MNIST_NARROW = dict(channels=(8, 16, 24, 16, 16), fc_dims=(32, 16))
RESNET_BASIC = dict(depths=(1, 1, 1, 1), width=8)
RESNET_BOTTLENECK = dict(name="resnet-bottleneck", depths=(1, 1, 1, 1),
                         width=4, block="bottleneck", small_input=False)

CASES = {
    "alexnet-tiny": (jTB.ALEXNET_TINY, TB.ALEXNET_TINY),
    "alexnet-mnist": (dataclasses.replace(jTB.ALEXNET_MNIST, **MNIST_NARROW),
                      dataclasses.replace(TB.ALEXNET_MNIST, **MNIST_NARROW)),
    "vgg-narrow": (dataclasses.replace(jTB.VGG16_CIFAR, **TINY_VGG),
                   dataclasses.replace(TB.VGG16_CIFAR, **TINY_VGG)),
}
# basic blocks with the 3x3 small-input stem; bottleneck blocks with the
# 7x7 stride-2 stem and the 3/2 max pool; each at an even and an odd
# size (the stride-2 convolutions pad at the end only, or on both sides)
for _name, _kw in (("resnet-basic", RESNET_BASIC),
                   ("resnet-bottleneck", RESNET_BOTTLENECK)):
    for _res in (32, 29):
        CASES[f"{_name}-{_res}"] = tuple(
            dataclasses.replace(tb.RESNET18_CIFAR, img_res=_res, **_kw)
            for tb in (jTB, TB))


def _images(cfg, b=3, seed=0):
    rs = np.random.RandomState(seed)
    return rs.uniform(0, 1, (b, cfg.img_res, cfg.img_res,
                             cfg.in_channels)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_model_matches_jax_per_stage_and_exit(name,
                                                      alexnet_tiny_jax_init):
    jcfg, cfg = CASES[name]
    values, params = _pair(jcfg, cfg, alexnet_tiny_jax_init
                           if name == "alexnet-tiny" else None)
    jfam, fam = jget_family(jcfg), get_family(cfg)
    # one compiled program per function instead of one per op
    jstage = jax.jit(jfam.apply_stage, static_argnums=(2, 3))
    jexit = jax.jit(jfam.apply_exit, static_argnums=(2, 3))
    x = _images(cfg)
    jh = jfam.apply_stem(values, jnp.asarray(x), jcfg)
    h = fam.apply_stem(params, torch.from_numpy(x), cfg)
    assert fam.num_stages(cfg) == jfam.num_stages(jcfg)
    for s in range(fam.num_stages(cfg)):
        jh = jstage(values, jh, s, jcfg)
        h = fam.apply_stage(params, h, s, cfg)
        got = _nhwc(h) if h.dim() == 4 else h.numpy()
        np.testing.assert_allclose(got, np.asarray(jh), rtol=RTOL,
                                   atol=ATOL, err_msg=f"stage {s}")
        np.testing.assert_allclose(
            fam.apply_exit(params, h, s, cfg).numpy(),
            np.asarray(jexit(values, jh, s, jcfg)), rtol=RTOL,
            atol=ATOL, err_msg=f"exit {s}")
    got = fam.forward(params, torch.from_numpy(x), cfg)["exit_logits"]
    want = jax.jit(jfam.forward, static_argnums=2)(
        values, jnp.asarray(x), jcfg)["exit_logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_alexnet_flatten_order_is_pinned(monkeypatch):
    """At CIFAR width the FC input is a 4x4x32 map: flattening it NCHW
    permutes the FC rows, and the parity check above would catch it."""
    jcfg, cfg = CASES["alexnet-tiny"]
    values, params = _pair(jcfg, cfg)
    x = _images(cfg, seed=5)
    want = np.asarray(jax.jit(jget_family(jcfg).forward, static_argnums=2)(
        values, jnp.asarray(x), jcfg)["exit_logits"][-1])
    monkeypatch.setattr(cnn_zoo, "_flatten_nhwc",
                        lambda h: h.reshape(h.shape[0], -1))
    wrong = get_family(cfg).forward(params, torch.from_numpy(x),
                                    cfg)["exit_logits"][-1].numpy()
    assert not np.allclose(wrong, want, rtol=RTOL, atol=ATOL)


def test_convert_rejects_a_tree_of_another_architecture(
        alexnet_tiny_jax_init):
    values = alexnet_tiny_jax_init
    with pytest.raises(ValueError, match="shape"):
        convert.from_jax_params(values, TB.ALEXNET_CIFAR, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.from_jax_params(values, TB.VGG16_CIFAR, device="cpu")


def test_init_matches_jax_shapes_and_distributions(alexnet_tiny_jax_init):
    """Same tree, shapes and init distributions as the JAX init (not the
    same numbers): He-normal convs, trunc-normal(0.02) linears, zero
    biases."""
    cfg = TB.ALEXNET_TINY
    params = get_family(cfg).init(cfg, seed=3, device="cpu")
    converted = convert.from_jax_params(alexnet_tiny_jax_init, cfg,
                                        device="cpu")
    w = params["conv3"]["w"]
    fan_in = w.shape[1] * 9
    assert abs(float(w.std()) - (2.0 / fan_in) ** 0.5) < 0.05 * (
        2.0 / fan_in) ** 0.5
    fc = params["fc"][0]["w"]
    assert float(fc.abs().max()) <= 0.04 + 1e-7
    assert abs(float(fc.std()) - float(converted["fc"][0]["w"].std())) < 1e-3
    assert float(params["conv1"]["b"].abs().sum()) == 0.0
    again = get_family(cfg).init(cfg, seed=3, device="cpu")
    assert torch.equal(again["conv1"]["w"], params["conv1"]["w"])


def test_convert_bf16_resnet_keeps_batchnorm_statistics_in_float32():
    """The JAX init of a bf16 ResNet (its own keys, shapes and dtypes:
    bias-free convolutions, bf16 weights, float32 running statistics)
    converts leaf for leaf; statistics in bf16, or a weight in float32,
    raise."""
    jcfg = dataclasses.replace(jTB.RESNET18_CIFAR, param_dtype=jnp.bfloat16,
                               **RESNET_BASIC)
    cfg = dataclasses.replace(TB.RESNET18_CIFAR, param_dtype=torch.bfloat16,
                              **RESNET_BASIC)
    values = _jax_params(jcfg)
    params = convert.from_jax_params(values, cfg, device="cpu")
    bns = [params["stem"]["bn"]] + [b[k] for st in params["stages"]
                                    for b in st for k in b if "bn" in k]
    assert len(bns) == 1 + 4 * 2 + 3          # stem, 2 a block, 3 downs
    for bn in bns:
        assert bn["mean"].dtype == bn["var"].dtype == torch.float32
        assert bn["scale"].dtype == bn["bias"].dtype == torch.bfloat16
    assert "b" not in params["stem"]["conv"]
    assert params["stem"]["conv"]["w"].dtype == torch.bfloat16
    for got, want in zip(convert.leaves(params), jax.tree.leaves(values)):
        want = np.asarray(want, np.float32)
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(got.float().numpy(), want)
    bad = jax.tree.map(lambda a: a, values)
    bad["stem"]["bn"]["var"] = np.asarray(values["stem"]["bn"]["var"],
                                          jnp.bfloat16)
    with pytest.raises(TypeError, match=r"\['var'\]: param dtype"):
        convert.from_jax_params(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a, values)
    bad["head"]["w"] = np.asarray(values["head"]["w"], np.float32)
    with pytest.raises(TypeError, match="param dtype"):
        convert.from_jax_params(bad, cfg, device="cpu")
