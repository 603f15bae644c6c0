"""The port's testbed CNNs against the JAX package with converted
weights: SAME convolution and max-pooling, and the staged AlexNet and VGG
per stage and per exit.  Pins the padding / pooling / flatten hazards of
the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_testbeds as jTB
from repro.models import get_family as jget_family
from repro.models import layers as jL
from repro.parallel.sharding import unzip
from repro_torch import convert
from repro_torch.configs import paper_testbeds as TB
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


def _pair(jcfg, cfg, values=None):
    if values is None:
        values = _jax_layout(get_family(cfg).init(cfg, seed=1, device="cpu"))
    return values, convert.from_jax_params(values, cfg, device="cpu")


TINY_VGG = dict(blocks=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1)),
                fc_dim=32)
MNIST_NARROW = dict(channels=(8, 16, 24, 16, 16), fc_dims=(32, 16))

CASES = {
    "alexnet-tiny": (jTB.ALEXNET_TINY, TB.ALEXNET_TINY),
    "alexnet-mnist": (dataclasses.replace(jTB.ALEXNET_MNIST, **MNIST_NARROW),
                      dataclasses.replace(TB.ALEXNET_MNIST, **MNIST_NARROW)),
    "vgg-narrow": (dataclasses.replace(jTB.VGG16_CIFAR, **TINY_VGG),
                   dataclasses.replace(TB.VGG16_CIFAR, **TINY_VGG)),
}


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
