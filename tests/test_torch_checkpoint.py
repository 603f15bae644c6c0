"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``) on the CPU.

The JAX package's checkpoint cases run on the port; the manifest bytes
are those ``msgpack.packb`` writes, and a tree saved by both packages
gives the same leaf files.  ``EngineState`` crosses between the packages
in both directions (each older layout too), a JAX ``Trainer``
checkpoint resumes in the port's ``Trainer`` through
``convert.restore_checkpoint``, and the port's own crash-resume equals
its straight run.  Inputs are seeded numpy draws; the synthetic images
come from a hash-free seed, as in ``test_torch_train.py``."""
import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from _torch_serving import _fixed_rng_for, _jax_layout
from repro import checkpoint as jCK
from repro.configs import paper_testbeds as jTB
from repro.core import adaptive as jAD
from repro.core.routing import DartParams as jDartParams
from repro.data import datasets as jDS
from repro.engine import DartEngine as JaxEngine
from repro.engine import state as jST
from repro.models import layers as jL
from repro.models import resnet as jRES
from repro.runtime.trainer import TrainConfig as JTrainConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch import checkpoint as CK
from repro_torch import convert
from repro_torch import optim as OPT
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs import paper_testbeds as TB
from repro_torch.core.routing import DartParams
from repro_torch.data import datasets as DS
from repro_torch.engine import DartEngine
from repro_torch.engine.lm import LMDecodeEngine
from repro_torch.engine import state as ST
from repro_torch.models import get_family
from repro_torch.models import resnet as RES
from repro_torch.models.transformer_lm import LMConfig, lm_init
from repro_torch.runtime import fault
from repro_torch.runtime.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

#: conf of the same weights and images: float32 sums in another order
CONF_TOL = 1e-5
#: rows whose conf at a gate lies this close to tau' may route otherwise
EDGE = 1e-5
#: the JAX crash-resume test's bounds (tests/test_fault.py)
RESUME_ATOL, RESUME_RTOL = 1e-6, 1e-5
#: one trainer step after the restore, as test_torch_train.py holds five
#: (see there): the loss, the parameters (all but FLIP_SHARE within
#: PARAM_TOL, each within the AdamW flip bound), the batchnorm statistics
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4
FLIP_SHARE = 0.02
STATS_TOL = 1e-3

DATA = DS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=256)
JDATA = jDS.DatasetConfig(name="synth-cifar", n_train=256, n_eval=256)
BUCKETS = (4, 8, 16, 64)


def _fold(key, name):
    """``repro.models.layers.rng`` with a hash-free fold per token."""
    for token in name.split("/"):
        key = jax.random.fold_in(key, zlib.crc32(token.encode()) % (2**31 - 1))
    return key


@pytest.fixture(scope="module", autouse=True)
def _fixed_draws():
    """One draw of weights and images for every worker and run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jL, "rng", _fold)
        for mod in (jDS, DS):
            mp.setattr(mod, "_rng_for", _fixed_rng_for)
        yield


def _np(leaf):
    """A leaf of either package as numpy (bf16 through its bits)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy()
        return leaf.numpy()
    a = np.asarray(leaf)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_leaves_equal(got, want):
    """Port leaves bit-equal to JAX (or port) leaves, dtypes by name."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        gn = str(g.dtype).replace("torch.", "")
        wn = str(w.dtype).replace("torch.", "")
        assert gn == wn, (i, gn, wn)
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# the JAX package's checkpoint cases, on the port
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)},
            "e": [torch.zeros(2), torch.full((2, 2), -1.0)]}


def _jtree():
    return {"a": jnp.arange(12.0).reshape(3, 4),
            "b": {"c": jnp.ones((5,), jnp.bfloat16), "d": jnp.asarray(3)},
            "e": [jnp.zeros(2), jnp.full((2, 2), -1.0)]}


def test_roundtrip_bitexact(tmp_path):
    t = _tree()
    CK.save(str(tmp_path), 3, t, {"lr": 0.1})
    got, step, extra = CK.restore(str(tmp_path), t)
    assert step == 3 and extra["lr"] == 0.1
    _assert_leaves_equal(flatten(got), flatten(t))
    assert list(got) == list(t) and list(got["b"]) == ["c", "d"]


def test_async_save_and_latest(tmp_path):
    t = _tree()
    f1 = CK.save_async(str(tmp_path), 1, t)
    f2 = CK.save_async(str(tmp_path), 2, t)
    f1.result()
    f2.result()
    assert CK.latest_step(str(tmp_path)) == 2


def test_async_save_copies_before_it_returns(tmp_path):
    """The writer thread never sees a later change to the tree."""
    t = _tree()
    fut = CK.save_async(str(tmp_path), 1, t)
    t["a"].add_(100.0)                       # training moves on in place
    fut.result()
    got, _, _ = CK.restore(str(tmp_path), t)
    np.testing.assert_array_equal(got["a"].numpy(),
                                  np.arange(12.0).reshape(3, 4))


def test_crc_detects_corruption(tmp_path):
    t = _tree()
    CK.save(str(tmp_path), 1, t)
    victim = os.path.join(str(tmp_path), "step_00000001", "leaf_00000.bin")
    raw = bytearray(open(victim, "rb").read())
    raw[0] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        CK.restore(str(tmp_path), t)


def test_structure_mismatch_raises(tmp_path):
    CK.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="leaf count"):
        CK.restore(str(tmp_path), {"only": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        CK.restore(str(tmp_path), {**_tree(), "a": torch.zeros(4, 3)})


def test_tmp_dirs_invisible(tmp_path):
    """A torn write (a left-over .tmp) is no checkpoint."""
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert CK.latest_step(str(tmp_path)) is None


def test_manager_gc_and_backpressure(tmp_path):
    mgr = CK.CheckpointManager(str(tmp_path), keep=2, save_every=1)
    t = _tree()
    for s in range(1, 6):
        mgr.maybe_save(s, t)
    mgr.wait()
    mgr._gc()
    steps = sorted(d for d in os.listdir(str(tmp_path))
                   if d.startswith("step_"))
    assert len(steps) <= 2
    assert CK.latest_step(str(tmp_path)) == 5
    assert mgr.restore_or_none(t)[1] == 5
    assert CK.CheckpointManager(str(tmp_path / "none")).restore_or_none(
        t) is None


@pytest.mark.parametrize("saved,target", [
    ("float32", "bfloat16"), ("bfloat16", "float32"), ("float32", "int32"),
    ("int32", "float32")])
def test_restore_respects_target_dtype(tmp_path, saved, target):
    """Each leaf takes its target's dtype, as the JAX package's restore
    casts it (float to int truncates)."""
    w = np.asarray([1.5, -2.25, 3.0, 7.75], np.float32)
    jCK.save(str(tmp_path / "jax"), 1, {"w": jnp.asarray(w, saved)})
    jgot, _, _ = jCK.restore(str(tmp_path / "jax"),
                             {"w": jnp.zeros(4, target)})
    CK.save(str(tmp_path / "port"), 1,
            {"w": torch.from_numpy(w).to(getattr(torch, saved))})
    got, _, _ = CK.restore(str(tmp_path / "port"),
                           {"w": torch.zeros(4, dtype=getattr(torch, target))})
    _assert_leaves_equal([got["w"]], [jgot["w"]])


# ---------------------------------------------------------------------------
# the manifest's bytes and the leaf files, against the JAX package
# ---------------------------------------------------------------------------

def _manifest_bytes(path, step):
    with open(os.path.join(path, f"step_{step:08d}",
                           "manifest.msgpack"), "rb") as f:
        return f.read()


def test_same_tree_same_files_as_jax(tmp_path):
    """One tree saved by each package: the same leaf files, the same
    manifest but for ``treedef``, and each manifest's bytes those of
    ``msgpack.packb``; each package restores the other's."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jCK.save(jdir, 4, _jtree(), {"loss": 0.25, "tag": "x", "n": -3})
    CK.save(pdir, 4, _tree(), {"loss": 0.25, "tag": "x", "n": -3})
    jraw, raw = _manifest_bytes(jdir, 4), _manifest_bytes(pdir, 4)
    jm, m = msgpack.unpackb(jraw), msgpack.unpackb(raw)
    assert raw == msgpack.packb(m)
    assert _msgpack.packb(jm) == jraw
    assert _msgpack.unpackb(jraw) == jm and _msgpack.unpackb(raw) == m
    assert jm["treedef"].startswith("PyTreeDef(")
    assert m["treedef"].startswith("repro_torch:conv=OIHW:")
    assert {**m, "treedef": None} == {**jm, "treedef": None}
    for leaf in m["leaves"]:
        a = open(os.path.join(jdir, "step_00000004", leaf["file"]),
                 "rb").read()
        b = open(os.path.join(pdir, "step_00000004", leaf["file"]),
                 "rb").read()
        assert a == b, leaf
    got, _, _ = CK.restore(jdir, _tree())
    _assert_leaves_equal(flatten(got), flatten(_tree()))
    jgot, _, extra = jCK.restore(pdir, _jtree())
    _assert_leaves_equal(jax.tree.leaves(jgot), jax.tree.leaves(_jtree()))
    assert extra == {"loss": 0.25, "tag": "x", "n": -3}


VALUES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
          2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
          -2**31 - 1, -2**63, 0.1, -0.0, 1e300, float("inf"), True, False,
          None, "", "é" * 10, "a" * 31, "a" * 32, "a" * 255, "a" * 256,
          "a" * 70000, [], [1] * 15, [1] * 16, [0.5] * 70000, {},
          {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
          {str(i): None for i in range(70000)},
          {"nested": [{"a": [1, {"b": -2.5}]}, "s", None, True]}]


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_msgpack_matches_the_package(i):
    v = VALUES[i]
    assert _msgpack.packb(v) == msgpack.packb(v)
    assert _msgpack.unpackb(msgpack.packb(v)) == msgpack.unpackb(
        msgpack.packb(v))


def test_msgpack_rejects_what_a_manifest_never_holds():
    with pytest.raises(ValueError, match="unsupported"):
        _msgpack.unpackb(msgpack.packb(b"raw bytes"))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2])[:-1])
    with pytest.raises(ValueError, match="extra bytes"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(TypeError):
        _msgpack.packb({"a": object()})


# ---------------------------------------------------------------------------
# EngineState across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """A JAX and a port AlexNet-tiny engine on one set of weights, with
    adaptation on; the JAX engine calibrated, served and updated."""
    jcfg, cfg = jTB.ALEXNET_TINY, TB.ALEXNET_TINY
    values = _jax_layout(get_family(cfg).init(cfg, seed=7, device="cpu"))
    params = convert.from_jax_params(values, cfg, device="cpu")
    kw = dict(buckets=BUCKETS, update_every=10_000)
    jeng = JaxEngine.from_config(jcfg, values, **kw)
    jeng.calibrate(JDATA, n=128, batch=64)
    x, _ = DS.make_batch(DATA, range(0, 64), split="eval")
    jeng.infer(x, mode="compacted")
    jeng.update()
    return jeng, (cfg, params, kw)


def _port_engine(engines):
    cfg, params, kw = engines[1]
    return DartEngine.from_config(cfg, params, device="cpu", **kw)


def _edge_rows(eng, x):
    m = eng.infer(x, mode="masked")
    conf = m["conf_stack"].numpy()[:-1].T
    return np.abs(conf - m["eff_thresholds"].numpy()).min(axis=1) < EDGE


def test_jax_engine_state_restores_in_port_and_serves_alike(engines,
                                                            tmp_path):
    """A state the JAX engine saved after calibrate -> infer -> update
    restores in the port bit for bit; the next infer + update on both
    give the same decisions outside counted edge rows, conf within
    CONF_TOL, and the same state after the update (its float leaves
    within CONF_TOL)."""
    jeng, _ = engines
    jstate = jeng.state
    jeng.save_state(str(tmp_path), step=3)
    eng = _port_engine(engines)
    eng._policy_host()                           # a stale host mirror
    assert eng.restore_state(str(tmp_path)) == 3
    _assert_leaves_equal(flatten(eng.state), jax.tree.leaves(jstate))
    assert all(t.device.type == "cpu" for t in flatten(eng.state))
    np.testing.assert_array_equal(eng._policy_host()[1],
                                  np.asarray(jeng._coef(), np.float32))
    x, _ = DS.make_batch(DATA, range(64, 192), split="eval")
    edge = _edge_rows(eng, x)
    assert edge.sum() <= 0.02 * len(x), edge.sum()
    jout = jeng.infer(x, mode="compacted")
    jeng.update()
    jnext, jeng.state = jeng.state, jstate       # the fixture's state back
    out = eng.infer(x, mode="compacted")
    eng.update()
    for k in ("exit_idx", "pred"):
        np.testing.assert_array_equal(out[k][~edge],
                                      np.asarray(jout[k])[~edge], err_msg=k)
    np.testing.assert_allclose(out["conf"], np.asarray(jout["conf"]),
                               atol=CONF_TOL, rtol=0)
    if edge.any():
        return                                   # the windows differ
    got, want = flatten(eng.state), jax.tree.leaves(jnext)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=CONF_TOL, rtol=0,
                                       err_msg=f"leaf {i}")
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"leaf {i}")


def test_port_engine_state_restores_in_jax(engines, tmp_path):
    """The other direction: a state the port saved (after restoring JAX's
    and serving on) restores through JAX's ``restore_with_migration``
    bit for bit."""
    jeng, _ = engines
    jeng.save_state(str(tmp_path / "a"), step=1)
    eng = _port_engine(engines)
    eng.restore_state(str(tmp_path / "a"))
    x, _ = DS.make_batch(DATA, range(64, 128), split="eval")
    eng.infer(x, mode="compacted")
    eng.update()
    eng.save_state(str(tmp_path / "b"), step=2)
    restored, step = jST.restore_with_migration(str(tmp_path / "b"),
                                                jeng.state)
    assert step == 2
    _assert_leaves_equal(flatten(eng.state), jax.tree.leaves(restored))


@pytest.mark.parametrize("prefix", range(3))
def test_legacy_jax_layouts_restore_in_port(engines, tmp_path, prefix):
    """Each of the JAX package's older layouts (``_LAYOUT_PREFIXES``):
    its fields restore, the rest keep the port engine's own values."""
    jeng, _ = engines
    fields = jST._LAYOUT_PREFIXES[prefix]
    assert fields == ST._LAYOUT_PREFIXES[prefix]
    jCK.save(str(tmp_path), 5, [getattr(jeng.state, f) for f in fields])
    eng = _port_engine(engines)
    eng.state = dataclasses.replace(
        eng.state, quote_count=torch.tensor(9, dtype=torch.int32),
        lat_ms=torch.full_like(eng.state.lat_ms, 2.5))
    fresh = eng.state
    assert eng.restore_state(str(tmp_path)) == 5
    for f in ST._FIELDS:
        src = jeng.state if f in fields else None
        got = flatten(getattr(eng.state, f))
        if src is None:
            _assert_leaves_equal(got, flatten(getattr(fresh, f)))
        else:
            _assert_leaves_equal(got, jax.tree.leaves(getattr(src, f)))


def test_engine_restore_moves_leaves_and_refuses_another_config(engines,
                                                                tmp_path):
    eng = _port_engine(engines)
    eng.save_state(str(tmp_path / "a"))
    cfg, params, kw = engines[1]
    other = DartEngine.from_config(cfg, params, device="cpu", n_classes=7,
                                   **kw)
    with pytest.raises(ValueError, match="shape mismatch"):
        other.restore_state(str(tmp_path / "a"))


LMCFG = LMConfig(name="ck-lm", n_layers=2, d_model=16, n_heads=2,
                 n_kv_heads=1, d_ff=32, vocab=16, exit_layers=(0,),
                 max_seq=32)


def test_lm_engine_state_roundtrip(tmp_path):
    """LMDecodeEngine's state: the port's round-trip after decoding, and a
    state of JAX's LM engine layout restored in the port; a mesh
    raises (the multi-device slice)."""
    params = lm_init(LMCFG, seed=0, device="cpu")
    dart = DartParams(tau=torch.full((1,), 0.5), coef=torch.ones(1),
                      beta_diff=0.1)
    eng = LMDecodeEngine(LMCFG, params, dart, device="cpu")
    prompts = np.random.RandomState(6).randint(0, LMCFG.vocab, (2, 4))
    eng.generate(prompts, 3)
    eng.save_state(str(tmp_path / "port"), step=2)
    other = LMDecodeEngine(LMCFG, params, dart, device="cpu")
    assert other.restore_state(str(tmp_path / "port")) == 2
    _assert_leaves_equal(flatten(other.state), flatten(eng.state))
    assert int(other.state.served) > 0
    jstate = jST.EngineState.create(
        eng.n_exits, jAD.AdaptiveConfig(n_exits=eng.n_exits,
                                        n_classes=min(LMCFG.vocab, 64)),
        jDartParams(tau=jnp.full((1,), 0.25), coef=jnp.ones(1),
                    beta_diff=0.3))
    jCK.save(str(tmp_path / "jax"), 1, jstate)
    other.restore_state(str(tmp_path / "jax"))
    _assert_leaves_equal(flatten(other.state), jax.tree.leaves(jstate))
    with pytest.raises(NotImplementedError, match="item 9"):
        other.restore_state(str(tmp_path / "jax"), mesh=object())


# ---------------------------------------------------------------------------
# convert: the writer's layout, from the treedef
# ---------------------------------------------------------------------------

def test_conv_layout_is_told_by_the_treedef_not_the_shape(tmp_path):
    """A 3x3 conv with 3 inputs and 3 outputs has one shape in HWIO and
    OIHW: only the manifest's treedef says which a checkpoint holds."""
    rs = np.random.RandomState(3)
    oihw = torch.from_numpy(rs.randn(3, 3, 3, 3).astype(np.float32))
    port = {"conv": {"w": oihw, "b": torch.zeros(3)}}
    jtree = {"conv": {"w": jnp.asarray(oihw.permute(2, 3, 1, 0).numpy()),
                      "b": jnp.zeros(3)}}
    jCK.save(str(tmp_path / "jax"), 1, jtree)
    CK.save(str(tmp_path / "port"), 1, port)
    target = {"conv": {"w": torch.zeros(3, 3, 3, 3), "b": torch.zeros(3)}}
    for d in ("jax", "port"):
        got, _, _ = convert.restore_checkpoint(str(tmp_path / d), target)
        np.testing.assert_array_equal(got["conv"]["w"].numpy(),
                                      oihw.numpy(), err_msg=d)
    # read as if the port had written it, the JAX file runs and is wrong
    raw, _, _ = CK.restore(str(tmp_path / "jax"), target)
    assert raw["conv"]["w"].shape == oihw.shape
    assert not torch.equal(raw["conv"]["w"], oihw)


def test_unknown_writer_is_refused(tmp_path):
    CK.checkpoint._write(str(tmp_path), 1, [torch.zeros(2)], "pickle:?", {})
    with pytest.raises(ValueError, match="unknown checkpoint writer"):
        convert.restore_checkpoint(str(tmp_path), [torch.zeros(2)])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

RESNET_BASIC = dict(name="resnet-basic", depths=(1, 1), width=8,
                    block="basic", img_res=32, n_classes=10,
                    small_input=True, exit_stages=(0,))
TRAINERS = {
    "resnet-basic-adamw": (jRES.ResNetConfig(**RESNET_BASIC),
                           RES.ResNetConfig(**RESNET_BASIC), "adamw"),
    "alexnet-tiny-sgd": (jTB.ALEXNET_TINY, TB.ALEXNET_TINY, "sgd"),
}
TRAIN = dict(batch_size=16, steps=8, lr=3e-3, warmup=2, ckpt_every=4,
             log_every=4)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, v in enumerate(tree)
                for p, v in _paths(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("case", sorted(TRAINERS))
def test_jax_trainer_checkpoint_resumes_in_port(case, tmp_path):
    """A JAX Trainer checkpoint at step 4 restores in the port's Trainer
    (params and moments from HWIO, step 4), every leaf equal to JAX's
    own after conversion; step 5 on one batch then matches JAX's step 5
    within test_torch_train.py's bounds."""
    jcfg, cfg, optimizer = TRAINERS[case]
    ckpt = str(tmp_path)
    jtr = JTrainer(jcfg, JTrainConfig(**TRAIN, optimizer=optimizer,
                                      ckpt_dir=ckpt), JDATA)
    jtr.run(steps=4)
    assert jCK.latest_step(ckpt) == 4
    tr = Trainer(cfg, TrainConfig(**TRAIN, optimizer=optimizer,
                                  ckpt_dir=ckpt), DATA, device="cpu")
    assert tr.restore()
    assert tr.step == 4 and tr.opt_state.step == 4
    want = jax.tree.map(np.asarray, jtr.state_tree())
    want_params = convert.from_jax_params(want["params"], cfg, device="cpu")
    _assert_leaves_equal(flatten(tr.params), flatten(want_params))
    inner = {k: convert.to_port_tree(v, "cpu")
             for k, v in want["opt"].inner.items()}
    _assert_leaves_equal(flatten(tr.opt_state.inner), flatten(inner))
    assert not any(t.requires_grad for t in flatten(tr.params))

    rs = np.random.RandomState(5)
    x = rs.rand(16, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 10, 16).astype(np.int32)
    jloss = jtr.train_step((jnp.asarray(x), jnp.asarray(y)))
    loss = tr.train_step((x, y))
    assert abs(loss - jloss) <= LOSS_TOL
    lr = OPT.warmup_cosine(3e-3, 2, 8)
    flip = 2 * sum(float(lr(s)) for s in range(6))
    got = _paths(tr.params)
    ref = _paths(convert.from_jax_params(jax.tree.map(np.asarray,
                                                      jtr.params),
                                         cfg, device="cpu"))
    n_far = n_all = 0
    for path, w in ref.items():
        diff = np.abs(got[path].numpy() - w.numpy())
        if path.rsplit("/", 1)[-1] in ("mean", "var"):
            np.testing.assert_allclose(got[path].numpy(), w.numpy(),
                                       atol=STATS_TOL, rtol=STATS_TOL)
            continue
        assert diff.max() <= flip, (path, diff.max())
        n_far += int((diff > PARAM_TOL).sum())
        n_all += diff.size
    assert n_far <= FLIP_SHARE * n_all, (n_far, n_all)


def test_port_crash_resume_equals_straight_run(tmp_path):
    """8 steps straight against 4 + crash + resume 4, on the port: the
    same final parameters within the JAX test's bounds (in fact equal),
    and the same losses from step 5 on."""
    cfg = TB.ALEXNET_TINY
    tc = dict(TRAIN, warmup=0)

    def run(d, fail):
        conf = TrainConfig(**tc, ckpt_dir=str(d))
        if fail:
            before, after, tr = fault.simulate_failure_and_recover(
                cfg, conf, fail_at=4, total_steps=8, data_cfg=DATA,
                device="cpu")
            assert [h["step"] for h in before] == [4]
            return tr, after
        tr = Trainer(cfg, conf, DATA, device="cpu")
        return tr, tr.run()

    straight, hist = run(tmp_path / "a", False)
    resumed, after = run(tmp_path / "b", True)
    assert straight.step == resumed.step == 8
    assert [h["step"] for h in hist] == [4, 8] and after[-1]["step"] == 8
    assert after[-1]["loss"] == hist[-1]["loss"]
    for a, b in zip(flatten(straight.state_tree()),
                    flatten(resumed.state_tree())):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   atol=RESUME_ATOL, rtol=RESUME_RTOL)
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000004",
                                                  "step_00000008"]


def test_trainer_restore_without_checkpoint_and_mesh_refused(tmp_path):
    tr = Trainer(TB.ALEXNET_TINY, TrainConfig(**TRAIN,
                                              ckpt_dir=str(tmp_path)),
                 DATA, device="cpu")
    assert tr.restore() is False and tr.step == 0
    with pytest.raises(NotImplementedError, match="item 9"):
        fault.resume(TB.ALEXNET_TINY, TrainConfig(**TRAIN), mesh=object())
