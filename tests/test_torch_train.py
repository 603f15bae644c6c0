"""The port's classifier trainer against the JAX package's: train-mode
batchnorm, the Eq. 18 loss, the optimizers and schedules, the data
order, whole trainer steps, and DartEngine serving the weights the port
trained.

Both packages get the same seeded numpy inputs, and the trainers start
from one set of weights: the JAX trainer's own init, converted with
``convert.from_jax_params``.  AdamW turns a gradient that is nearly zero
into an update of about +-lr whatever its size, so two gradients that
differ in the low bits can move a weight by up to 2 lr in opposite
directions; multi-step parameter parity therefore cannot be tight, and
it is held in three layers: the gradients of one step (tight), one
optimizer update from the same numpy gradients (tight), and the loss,
the parameters and the batchnorm statistics over five steps (looser,
stated below)."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_testbeds as jTB
from repro.core import routing as jR
from repro.data import datasets as jDS
from repro.data import pipeline as jPIPE
from repro.engine import DartEngine as JaxEngine
from repro.models import batchnorm as jBN
from repro.models import layers as jL
from repro.models import resnet as jRES
from repro import optim as jOPT
from repro.parallel.sharding import unzip
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch import optim as OPT
from repro_torch.configs import paper_testbeds as TB
from repro_torch.core import routing as R
from repro_torch.data import datasets as DS
from repro_torch.data import pipeline as PIPE
from repro_torch.engine import DartEngine
from repro_torch.models import batchnorm as BN
from repro_torch.models import resnet as RES
from repro_torch.models.transformer_lm import LMConfig
from repro_torch.runtime.trainer import TrainConfig, Trainer

# tiny tensors: one thread is faster than torch's pool, and leaves the
# cores to the JAX side and to other test workers
torch.set_num_threads(1)

#: float32 forward values: reductions and convolutions in another order
FWD_TOL = 1e-5
#: gradients of one step (the same weights and batch), each leaf against
#: JAX's relative to the norm of JAX's: float32 sums in another order
GRAD_RTOL = 1e-4
#: except upstream of a ResNet batchnorm+ReLU: batchnorm computes in
#: float32 in both packages, and a ReLU input within its rounding of 0
#: lands on either side, which gates that unit's gradient; the leaves
#: upstream of it then move by up to ~1e-2 of their norm.  The exit
#: heads, downstream of every ReLU, stay within GRAD_RTOL.
TIE_RTOL = 2e-2
#: one optimizer update from the same gradients: the same float32 ops,
#: one rounding apart at most (lr 3e-3 moves a weight by ~1e-3)
UPDATE_TOL = 1e-6
#: the loss per step over five steps: the weights drift apart by the
#: AdamW flips above (and by batchnorm ties, see TIE_RTOL)
LOSS_TOL = 1e-4
#: parameters after five steps: a flipped weight may sit up to
#: 2 * sum(lr_t) off; all but FLIP_SHARE of them within PARAM_TOL
PARAM_TOL = 1e-4
FLIP_SHARE = 0.02
#: batchnorm running statistics after five steps: weights a flip moved
#: apart by ~lr shift a channel's batch mean and variance by about that
STATS_TOL = 1e-3

TINY_VGG = dict(blocks=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1)),
                fc_dim=32)
RESNET_BASIC = dict(name="resnet-basic", depths=(1, 1), width=8,
                    block="basic", img_res=32, n_classes=10,
                    small_input=True, exit_stages=(0,))
# the bottleneck blocks with the 7x7 stride-2 stem and its max pool
RESNET_BOTTLENECK = dict(RESNET_BASIC, name="resnet-bottleneck",
                         block="bottleneck", small_input=False)
MODELS = {
    "alexnet-tiny": (jTB.ALEXNET_TINY, TB.ALEXNET_TINY),
    "vgg-narrow": (dataclasses.replace(jTB.VGG16_CIFAR, **TINY_VGG),
                   dataclasses.replace(TB.VGG16_CIFAR, **TINY_VGG)),
    "resnet-basic": (jRES.ResNetConfig(**RESNET_BASIC),
                     RES.ResNetConfig(**RESNET_BASIC)),
    "resnet-bottleneck": (jRES.ResNetConfig(**RESNET_BOTTLENECK),
                          RES.ResNetConfig(**RESNET_BOTTLENECK)),
}
JDATA = jDS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=256)
DATA = DS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=256)
BATCH = 16
STEPS = 5
TRAIN = dict(batch_size=BATCH, steps=STEPS, lr=3e-3, warmup=2)


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
    """The JAX init and both packages' synthetic images fold a str hash,
    which changes with each process's hash seed; fold a hash-free one, so
    every worker and every run trains and serves the same weights and
    images."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jL, "rng", _fold)
        for mod in (jDS, DS):
            mp.setattr(mod, "_rng_for", _fixed_rng_for)
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(x):
    return _t(np.asarray(x).transpose(0, 3, 1, 2))


def _paths(tree, prefix=""):
    """{"/a/0/b": leaf} over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _paths(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _jax_layout(tree):
    """A port tree in the JAX layout (conv OIHW -> HWIO), numpy leaves."""
    return jax.tree.map(lambda t: t.permute(2, 3, 1, 0).numpy()
                        if t.dim() == 4 else t.numpy(), tree)


def _port_tree(jtree, cfg):
    """A JAX value tree in the port's layout, on the CPU."""
    return convert.from_jax_params(jax.device_get(jtree), cfg, device="cpu")


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(0, 1, (BATCH, 32, 32, 3)).astype(np.float32),
             rs.randint(0, 10, BATCH).astype(np.int32)) for _ in range(n)]


def _is_stats(path):
    return path.rsplit("/", 1)[-1] in BN.STATS_KEYS


# ---------------------------------------------------------------------------
# batchnorm, train mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 5, 5, 6), (16, 6)])
def test_bn_train_matches_jax(shape):
    """Output, gradients (input, scale, bias) and the running update of
    train-mode batchnorm against JAX on NHWC / NCHW twins (and (B, C))."""
    rs = np.random.RandomState(len(shape))
    c = shape[-1]
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = rs.randn(*shape).astype(np.float32)        # d(loss)/d(output)
    p = {"scale": (1 + 0.1 * rs.randn(c)).astype(np.float32),
         "bias": (0.1 * rs.randn(c)).astype(np.float32),
         "mean": (0.1 * rs.randn(c)).astype(np.float32),
         "var": (1 + 0.1 * rs.rand(c)).astype(np.float32)}

    def jloss(x, p):
        upd = {}
        y = jBN.bn_apply(p, x, train=True, updates=upd, name="a/bn")
        return jnp.sum(y * w), (y, upd)

    (_, (jy, jupd)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))

    def to_port(a):             # (B, H, W, C) -> (B, C, H, W); (B, C) kept
        return _nchw(a) if a.ndim == 4 else _t(a)

    xt = to_port(x).requires_grad_()
    pt = {k: _t(v).requires_grad_(k in ("scale", "bias"))
          for k, v in p.items()}
    upd = {}
    y = BN.bn_apply(pt, xt, train=True, updates=upd, name="a/bn")
    (y * to_port(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), to_port(jy).numpy(),
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), to_port(jg[0]).numpy(),
                               atol=FWD_TOL, rtol=0)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(jg[1][k]),
                                   atol=1e-4, rtol=1e-5, err_msg=k)
    assert set(upd) == set(jupd) == {"a/bn"}
    for k in BN.STATS_KEYS:
        got = upd["a/bn"][k]
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(jupd["a/bn"][k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    # the keep factor is 0.9 and the variance the biased one: torch's own
    # batchnorm (update factor 0.1, unbiased variance) would miss
    axes = tuple(range(x.ndim - 1))
    np.testing.assert_allclose(
        upd["a/bn"]["var"].numpy(),
        0.9 * p["var"] + 0.1 * x.var(axis=axes, dtype=np.float64),
        atol=1e-5, rtol=0)
    # inference mode is unchanged, and records nothing
    none = {}
    BN.bn_apply(pt, xt, updates=none, name="a/bn")
    assert none == {}


def test_resnet_train_forward_update_names_and_merge_match_jax():
    """The train-mode ResNet forward (bottleneck blocks, the 7x7 stem)
    names its batchnorm updates by JAX's key paths; merge_updates puts
    them where JAX's does and leaves the input tree untouched.  (The
    values are held to JAX by the gradient and trainer tests.)"""
    jcfg, cfg = MODELS["resnet-bottleneck"]
    params = RES.resnet_init(cfg, seed=1, device="cpu")
    x, _ = _batches(1)[0]
    values = _jax_layout(params)
    jnames = jax.eval_shape(
        lambda p, x: jRES.resnet_forward(p, x, jcfg, train=True)
        ["bn_updates"], values, jnp.asarray(x))
    out = RES.resnet_forward(params, _t(x), cfg, train=True)
    assert sorted(out["bn_updates"]) == sorted(jnames)
    assert "stages/1/0/down_bn" in out["bn_updates"]
    merged = BN.merge_updates(params, out["bn_updates"])
    jmerged = jBN.merge_updates(values, jax.tree.map(
        lambda t: t.numpy(), out["bn_updates"]))
    got, before = _paths(merged), _paths(params)
    want = _paths(convert.from_jax_params(jmerged, cfg, device="cpu"))
    assert set(got) == set(want)
    for path in want:
        assert torch.equal(got[path], want[path]), path
        if not _is_stats(path):
            assert got[path] is before[path]
    assert not torch.equal(got["/stem/bn/mean"], before["/stem/bn/mean"])
    assert (before["/stem/bn/mean"] == 0).all()
    assert RES.resnet_forward(params, _t(x), cfg)["bn_updates"] == {}


# ---------------------------------------------------------------------------
# the Eq. 18 loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy_weight,exit_weights", [
    (0.01, None), (0.5, None), (0.3, (0.1, 0.2, 0.3, 1.0)), (0.01, (1.0,))])
def test_multi_exit_xent_matches_jax(policy_weight, exit_weights):
    e = 1 if exit_weights == (1.0,) else 4
    rs = np.random.RandomState(e + int(policy_weight * 100))
    # early exits flatter than the last, so the policy term is live
    lg = (rs.randn(e, 32, 10) * np.linspace(3, 0.5, e)[:, None, None]
          ).astype(np.float32)
    y = rs.randint(0, 10, 32).astype(np.int32)

    def jloss(lg):
        return jR.multi_exit_xent(lg, jnp.asarray(y),
                                  policy_weight=policy_weight,
                                  exit_weights=exit_weights)
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(lg))
    lt = _t(lg).requires_grad_()
    loss, aux = R.multi_exit_xent(lt, _t(y), policy_weight=policy_weight,
                                  exit_weights=exit_weights)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(aux["ce_per_exit"].detach().numpy(),
                               np.asarray(jaux["ce_per_exit"]), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), atol=1e-8,
                               rtol=1e-5)
    ces = aux["ce_per_exit"].detach().numpy()
    if e > 1:
        assert (ces[:-1] > ces[-1]).any()             # the policy term ran


# ---------------------------------------------------------------------------
# optimizers, schedules, data order
# ---------------------------------------------------------------------------

def _opt_tree(rs):
    """A small Param tree: a conv, a linear and a batchnorm."""
    from repro.parallel.sharding import Param
    tree = {"conv": {"w": Param(jnp.asarray(rs.randn(3, 3, 2, 4)
                                            .astype(np.float32)),
                                (None, None, None, None)),
                     "b": Param(jnp.zeros(4), (None,))},
            "head": {"w": Param(jnp.asarray(rs.randn(4, 10)
                                            .astype(np.float32) * 0.02),
                                (None, None)),
                     "b": Param(jnp.zeros(10), (None,))},
            "bn": jBN.bn_init(4, jnp.float32)}
    return unzip(tree)


def _grads_like(values, rs, scale):
    g = jax.tree.map(lambda v: (rs.randn(*v.shape) * scale).astype(
        np.float32), values)
    g["bn"]["mean"] = np.zeros(4, np.float32)       # stats get no gradient
    g["bn"]["var"] = np.zeros(4, np.float32)
    return g


def _to_port_tree(values):
    return convert.tree_map(
        lambda a: _t(np.asarray(a).transpose(3, 2, 0, 1)
                     if np.ndim(a) == 4 else a), values)


def _assert_tree_close(got, jtree, tol, what):
    want = _paths(_to_port_tree(jax.device_get(jtree)))
    got = _paths(got)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                   atol=tol, rtol=0,
                                   err_msg=f"{what}{path}")


@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd-nesterov"])
def test_optimizer_updates_match_jax(name):
    """One update from the same numpy gradients, then two more, under
    warmup_cosine with gradient clipping (norms above and below the
    limit) and the stats mask: parameters and optimizer state within
    UPDATE_TOL.  SGD takes lr at state.step and AdamW at step + 1, so
    SGD's first step under the warmup moves nothing."""
    rs = np.random.RandomState(len(name))
    values, axes = _opt_tree(rs)
    sched = (jOPT.warmup_cosine(3e-3, 2, 10), OPT.warmup_cosine(3e-3, 2, 10))
    jmask = jOPT.trainable_mask(axes)
    params = _to_port_tree(values)
    mask = OPT.trainable_mask(params)
    assert _paths(mask) == _paths(jax.tree.map(bool, jmask))
    assert not mask["bn"]["mean"] and mask["bn"]["scale"]
    kw = dict(weight_decay=0.01, max_grad_norm=1.0)
    if name == "adamw":
        jopt = jOPT.adamw(sched[0], mask=jmask, **kw)
        opt = OPT.adamw(sched[1], mask=mask, **kw)
    else:
        kw["nesterov"] = name == "sgd-nesterov"
        jopt = jOPT.sgd(sched[0], mask=jmask, **kw)
        opt = OPT.sgd(sched[1], mask=mask, **kw)
    jstate, state = jopt.init(values), opt.init(params)
    for step, scale in enumerate((1.0, 0.01, 0.3)):   # clipped, then not
        g = _grads_like(values, rs, scale)
        values, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                     values)
        new, state = opt.update(_to_port_tree(g), state, params)
        _assert_tree_close(new, values, UPDATE_TOL, f"step {step + 1} ")
        for k in state.inner:
            _assert_tree_close(state.inner[k], jstate.inner[k], UPDATE_TOL,
                               f"{k} ")
        assert state.step == int(jstate.step) == step + 1
        for path, leaf in _paths(new).items():
            assert not leaf.requires_grad
            if _is_stats(path):
                assert torch.equal(leaf, _paths(params)[path]), path
        if step == 0 and name != "adamw":
            for path, leaf in _paths(new).items():
                assert torch.equal(leaf, _paths(params)[path]), path
        params = new


@pytest.mark.parametrize("norm_scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_jax(norm_scale):
    rs = np.random.RandomState(int(norm_scale * 100))
    values, _ = _opt_tree(rs)
    g = _grads_like(values, rs, norm_scale)
    jclipped, jnorm = jOPT.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    clipped, norm = OPT.clip_by_global_norm(_to_port_tree(g), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert (float(norm) > 1.0) == (norm_scale > 1)
    _assert_tree_close(clipped, jclipped, 1e-7, "clipped ")


def test_schedules_match_jax():
    warm, total = 20, 120
    steps = [0, 1, warm - 1, warm, warm + 1, 70, total - 1, total,
             total + 5]
    pairs = [(jOPT.warmup_cosine(3e-3, warm, total),
              OPT.warmup_cosine(3e-3, warm, total)),
             (jOPT.warmup_cosine(1e-3, warm, total, end_frac=0.1),
              OPT.warmup_cosine(1e-3, warm, total, end_frac=0.1)),
             (jOPT.linear_decay(1e-3, total), OPT.linear_decay(1e-3, total)),
             (jOPT.constant(1e-3), OPT.constant(1e-3))]
    for jf, f in pairs:
        for s in steps:
            got = f(s)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(jf(s)), rtol=1e-6,
                                       atol=0, err_msg=f"step {s}")
    assert float(pairs[0][1](0)) == 0.0
    assert float(pairs[0][1](warm)) == pytest.approx(3e-3)


def test_batch_indices_bit_equal_across_epoch_wrap():
    jcfg = jDS.DatasetConfig(name="synth-cifar", n_train=100, n_eval=40,
                             seed=3)
    cfg = DS.DatasetConfig(name="synth-cifar", n_train=100, n_eval=40,
                           seed=3)
    for split in ("train", "eval"):
        for step in range(9):                      # 32-row batches wrap
            np.testing.assert_array_equal(
                PIPE.batch_indices(cfg, step, 32, split),
                jPIPE.batch_indices(jcfg, step, 32, split))
    idx = PIPE.batch_indices(cfg, 3, 32)           # rows 96..127 of 100
    assert len(idx) == 32 and len(set(idx[:4])) == 4


def test_pipeline_and_eval_batches_match_jax():
    pipe = PIPE.DataPipeline(DATA, 8, start_step=2, device="cpu")
    try:
        for want_step in (2, 3):
            step, x, y = next(pipe)
            assert step == want_step and x.device.type == "cpu"
            jx, jy = jDS.make_batch(JDATA, jPIPE.batch_indices(
                JDATA, step, 8))
            np.testing.assert_array_equal(x.numpy(), jx)
            np.testing.assert_array_equal(y.numpy(), jy)
        assert pipe.wait_s >= 0.0
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()
    got = list(PIPE.eval_batches(DATA, 100, n=250))
    want = list(jPIPE.eval_batches(JDATA, 100, n=250))
    assert [len(b[1]) for b in got] == [100, 100, 50]
    for (x, y), (jx, jy) in zip(got, want):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


# ---------------------------------------------------------------------------
# whole trainer steps
# ---------------------------------------------------------------------------

def _pair(model, **train):
    """A JAX trainer from its own init and a port trainer from the same
    weights, converted."""
    jcfg, cfg = MODELS[model]
    jtr = JTrainer(jcfg, JTrainConfig(**{**TRAIN, **train}), JDATA)
    tr = Trainer(cfg, TrainConfig(**{**TRAIN, **train}), DATA,
                 params=_port_tree(jtr.params, cfg), device="cpu")
    return jtr, tr


@pytest.mark.parametrize("model", sorted(MODELS))
def test_one_step_gradients_match_jax(model):
    jtr, tr = _pair(model)
    x, y = _batches(1, seed=11)[0]
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtr._loss_fn(p, b, None), has_aux=True))(
        jtr.params, (jnp.asarray(x), jnp.asarray(y)))
    (loss, aux), g = OPT.value_and_grad(tr._loss_fn, tr.params,
                                        (_t(x), _t(y)))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6, atol=1e-6)
    assert not loss.requires_grad
    assert not aux["ce_per_exit"].requires_grad
    want = _paths(_port_tree(jg, tr.model_cfg))
    got = _paths(g)
    assert set(got) == set(want)
    for path in want:
        w = want[path].numpy().astype(np.float64)
        if _is_stats(path):
            assert not w.any() and not got[path].any(), path
            continue
        tol = (TIE_RTOL if model.startswith("resnet") and "head" not in path
               else GRAD_RTOL)
        err = np.linalg.norm(got[path].numpy() - w) / np.linalg.norm(w)
        assert err <= tol, (path, err)
    assert not any(t.requires_grad for t in convert.leaves(tr.params))


TRAIN_CASES = [("alexnet-tiny", "adamw", 1), ("vgg-narrow", "adamw", 1),
               ("resnet-basic", "adamw", 1), ("resnet-bottleneck", "adamw", 1),
               ("resnet-basic", "adamw", 2), ("resnet-basic", "sgd", 1),
               ("alexnet-tiny", "sgd", 2)]


@pytest.mark.parametrize("model,optimizer,microbatches", TRAIN_CASES)
def test_trainer_steps_match_jax(model, optimizer, microbatches):
    """Five train_steps on the same numpy batches: the loss per step
    within LOSS_TOL, then the parameters (all but FLIP_SHARE within
    PARAM_TOL, every one within the AdamW flip bound) and the batchnorm
    running statistics within STATS_TOL.  With two microbatches the
    statistics come from the last one only, as in JAX."""
    jtr, tr = _pair(model, optimizer=optimizer, microbatches=microbatches)
    losses, jlosses = [], []
    for x, y in _batches(STEPS, seed=5):
        jlosses.append(jtr.train_step((jnp.asarray(x), jnp.asarray(y))))
        losses.append(tr.train_step((x, y)))
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_TOL, rtol=0)
    assert tr.step == jtr.step == STEPS
    lr = OPT.warmup_cosine(3e-3, 2, STEPS)
    flip = 2 * sum(float(lr(s)) for s in range(STEPS + 1))
    want = _paths(_port_tree(jtr.params, tr.model_cfg))
    got = _paths(tr.params)
    n_far = n_all = 0
    for path in want:
        diff = np.abs(got[path].numpy() - want[path].numpy())
        if _is_stats(path):
            np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                       atol=STATS_TOL, rtol=STATS_TOL,
                                       err_msg=path)
            continue
        assert diff.max() <= flip, (path, diff.max())
        n_far += int((diff > PARAM_TOL).sum())
        n_all += diff.size
    assert n_far <= FLIP_SHARE * n_all, (n_far, n_all)
    assert not any(t.requires_grad for t in convert.leaves(tr.params))
    if model.startswith("resnet"):
        assert not torch.equal(got["/stem/bn/var"], torch.ones_like(
            got["/stem/bn/var"]))


def test_trainer_run_logs_and_trains():
    """run() draws the pipeline's batches, logs every log_every steps and
    at the last, and the Eq. 18 loss falls on the tiny AlexNet."""
    tr = Trainer(TB.ALEXNET_TINY, TrainConfig(batch_size=16, steps=30,
                                              lr=3e-3, log_every=5),
                 DATA, device="cpu")
    hist = tr.run()
    assert [h["step"] for h in hist] == [5, 10, 15, 20, 25, 30]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert tr.run() == hist                      # nothing left to train


# ---------------------------------------------------------------------------
# serving the trained weights
# ---------------------------------------------------------------------------

def test_engine_serves_port_trained_resnet():
    """DartEngine on the port-trained tiny ResNet: outputs carry no
    autograd graph; calibration and joint-DP tau match the JAX engine on
    the same weights, and the exits match outside counted edge rows."""
    jcfg, cfg = MODELS["resnet-basic"]
    tr = Trainer(cfg, TrainConfig(batch_size=16, steps=12, lr=3e-3),
                 DATA, device="cpu")
    tr.run()
    eng = DartEngine.from_config(cfg, tr.params, device="cpu", adapt=False)
    jeng = JaxEngine.from_config(jcfg, _jax_layout(tr.params))
    cal = eng.collect_calibration(DATA, n=128, batch=64)
    jcal = jeng.collect_calibration(JDATA, n=128, batch=64)
    for k in ("conf", "alpha", "entropy"):
        np.testing.assert_allclose(getattr(cal, k), getattr(jcal, k),
                                   atol=1e-5, rtol=0, err_msg=k)
    pol, jpol = eng.calibrate(cal), jeng.calibrate(jcal)
    np.testing.assert_allclose(pol.tau, jpol.tau, atol=1e-5, rtol=0)
    x, _ = DS.make_batch(DATA, range(128, 256), split="eval")
    for mode in ("masked", "compacted"):
        out = eng.infer(x, mode=mode)
        for v in out.values():
            assert not (torch.is_tensor(v) and v.grad_fn is not None)
    masked = eng.infer(x, mode="masked")
    conf = masked["conf_stack"].numpy()[:-1].T
    edge = np.abs(conf - masked["eff_thresholds"].numpy()).min(axis=1) < 1e-5
    assert edge.sum() <= 0.02 * len(x)
    jout = jeng.infer(x, mode="masked")
    np.testing.assert_array_equal(masked["exit_idx"].numpy()[~edge],
                                  np.asarray(jout["exit_idx"])[~edge])


# ---------------------------------------------------------------------------
# no fallback, and the options of later slices
# ---------------------------------------------------------------------------

def test_trainer_and_pipeline_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TB.ALEXNET_TINY, TrainConfig(), DATA)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PIPE.DataPipeline(DATA, 8)
    assert Trainer(TB.ALEXNET_TINY, TrainConfig(), DATA,
                   device="cpu").device.type == "cpu"


@pytest.mark.parametrize("option,item", [
    (dict(ckpt_dir="ckpt"), 4), (dict(fsdp=True), 9),
    (dict(compression="int8"), 9), ("mesh", 9), ("lm", 6), ("restore", 4)])
def test_later_slice_options_raise(option, item, tmp_path):
    cfg, kw, tc = TB.ALEXNET_TINY, {"device": "cpu"}, TrainConfig()
    if option == "mesh":
        kw["mesh"] = object()
    elif option == "lm":
        cfg = LMConfig(name="t", n_layers=2, d_model=32, n_heads=2,
                       n_kv_heads=2, d_ff=64, vocab=64, exit_layers=(0,),
                       max_seq=32)
    elif isinstance(option, dict):
        tc = TrainConfig(**option)
    if item == 4:
        # checkpointing is ported (item 4): ckpt_dir and restore() now
        # work instead of raising (test_torch_checkpoint.py holds them)
        tc = dataclasses.replace(tc, ckpt_dir=str(tmp_path))
        tr = Trainer(cfg, tc, DATA, **kw)
        assert tr.manager is not None and tr.restore() is False
        return
    if option == "lm":
        # the dense LM trains since item 6a (test_torch_lm_train.py holds
        # it to JAX); MLA and MTP configs still raise (item 6c)
        tr = Trainer(cfg, tc, DATA, **kw)
        x = np.random.RandomState(0).randint(0, 64, (2, 33))
        assert np.isfinite(tr.train_step((x, np.zeros(2, np.int32))))
        with pytest.raises(NotImplementedError, match="item 6c"):
            dataclasses.replace(cfg, attn_kind="mla")
        return
    match = f"ROADMAP queue 1, item {item}"
    with pytest.raises(NotImplementedError, match=match):
        tr = Trainer(cfg, tc, DATA, **kw)
        if option == "restore":
            tr.restore()
