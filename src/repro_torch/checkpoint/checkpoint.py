"""Checkpointing: atomic, async, integrity-checked.

Layout:  <dir>/step_<N:08d>/manifest.msgpack + leaf_<i:05d>.bin

The on-disk format of the JAX package's ``repro/checkpoint``, so that
either package restores what the other wrote:

* **order**    — leaves in the JAX package's flatten order: dict keys
  sorted, lists and tuples in order, a dataclass that names its
  ``CKPT_FIELDS`` (``EngineState``, ``OptimizerState``) in that order;
  ``None`` is no leaf.  A Python int is a 0-d int32 leaf (the JAX
  trainer's step is a 0-d int32 array).
* **atomic**   — written to ``step_N.tmp`` then renamed (a restart never
  sees a torn checkpoint).
* **async**    — ``save_async`` copies every leaf to host memory before
  it returns and writes on a background thread, so the writer never
  reads a card tensor that training may still replace or change.
* **integrity**— CRC32 per leaf, checked on restore.
* **GC**       — keep-last-k (``CheckpointManager``).

Each leaf file holds the raw bytes of the C-contiguous array; the
manifest names its shape and dtype (``"bfloat16"`` for torch.bfloat16,
whose bytes go through torch: numpy has no such type without
``ml_dtypes``).  The manifest's ``treedef`` is a descriptor the JAX
package never reads; the port writes ``repro_torch:conv=OIHW:`` and the
structure, which ``convert.restore_checkpoint`` tells apart from the
JAX package's ``PyTreeDef(...)`` (whose convolution weights are HWIO).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import zlib
from concurrent.futures import Future, ThreadPoolExecutor

import torch

from repro_torch.checkpoint import _msgpack

#: prefix of the ``treedef`` the port writes
TREEDEF_PREFIX = "repro_torch:"
#: the port's convolution weight layout, named in its ``treedef``
CONV_LAYOUT = "OIHW"

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# ---------------------------------------------------------------------------
# flatten / unflatten in the JAX package's order
# ---------------------------------------------------------------------------

def _children(node):
    """(kind, [(key, child), ...]) of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return "dict", [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return type(node).__name__, [(None, v) for v in node]
    fields = getattr(type(node), "CKPT_FIELDS", None)
    if fields is not None and dataclasses.is_dataclass(node):
        return type(node).__name__, [(f, getattr(node, f)) for f in fields]
    return None


def map_leaves(fn, tree, key=None):
    """``fn(key, leaf)`` on every leaf, in flatten order, ``key`` the
    nearest dict key or field name above it; the structure (dicts in
    their own key order) is rebuilt around the results.  ``None`` stays
    ``None``."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(key, tree)
    kind, items = node
    if kind == "dict":
        new = {k: map_leaves(fn, v, k) for k, v in items}   # sorted order
        return {k: new[k] for k in tree}                     # the tree's
    if kind in ("list", "tuple"):
        out = [map_leaves(fn, v, key) for _, v in items]
        return out if kind == "list" else tuple(out)
    return dataclasses.replace(tree, **{
        f: map_leaves(fn, v, f) for f, v in items})


def flatten(tree) -> list:
    """The leaves of ``tree`` in the JAX package's flatten order."""
    out = []
    map_leaves(lambda _, leaf: out.append(leaf), tree)
    return out


def unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` (in flatten order) in it."""
    it = iter(leaves)
    return map_leaves(lambda *_: next(it), tree)


def describe(tree) -> str:
    """The structure of ``tree`` as the port's ``treedef`` string."""
    def walk(node):
        if node is None:
            return "None"
        kids = _children(node)
        if kids is None:
            return "*"
        kind, items = kids
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {walk(v)}"
                                   for k, v in items) + "}"
        if kind in ("list", "tuple"):
            inner = ", ".join(walk(v) for _, v in items)
            return f"[{inner}]" if kind == "list" else f"({inner})"
        return kind + "(" + ", ".join(f"{f}={walk(v)}"
                                      for f, v in items) + ")"
    return f"{TREEDEF_PREFIX}conv={CONV_LAYOUT}:{walk(tree)}"


# ---------------------------------------------------------------------------
# leaves <-> bytes
# ---------------------------------------------------------------------------

def _host(leaf) -> torch.Tensor:
    """A host copy of one leaf that no caller can change: card tensors
    are copied down, host tensors are copied too; an int becomes a 0-d
    int32 tensor."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return torch.tensor(leaf, dtype=torch.int32)
    raise TypeError(f"can not checkpoint a leaf of type "
                    f"{type(leaf).__name__}")


def _raw(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_raw(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype not in _TORCH_DTYPES:
        raise ValueError(f"unsupported leaf dtype {dtype!r}")
    tdt = _TORCH_DTYPES[dtype]
    if not raw:
        return torch.empty(shape, dtype=tdt)
    return torch.frombuffer(bytearray(raw), dtype=tdt).reshape(shape)


def _shape(leaf) -> tuple:
    return () if isinstance(leaf, int) else tuple(leaf.shape)


def _cast(arr: torch.Tensor, tgt, device):
    """``arr`` as the target leaf's type: its dtype, and its device (or
    ``device``) for a tensor; an int for an int."""
    if isinstance(tgt, int):
        return int(arr.item())
    dev = tgt.device if device is None else torch.device(device)
    return arr.to(dtype=tgt.dtype).to(dev)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def save(path: str, step: int, tree, extra: dict | None = None) -> str:
    """Synchronous atomic save.  Returns the final directory."""
    host = [_host(x) for x in flatten(tree)]
    return _write(path, step, host, describe(tree), extra or {})


_EXEC = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")


def save_async(path: str, step: int, tree, extra: dict | None = None
               ) -> Future:
    """Copy every leaf to the host now, write in the background."""
    host = [_host(x) for x in flatten(tree)]      # device->host sync point
    return _EXEC.submit(_write, path, step, host, describe(tree),
                        extra or {})


def _write(path, step, host_leaves, treedef, extra):
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": int(step), "treedef": str(treedef),
                "extra": extra, "leaves": []}
    for i, t in enumerate(host_leaves):
        raw = _raw(t)
        manifest["leaves"].append({
            "file": f"leaf_{i:05d}.bin",
            "shape": list(t.shape),
            "dtype": _DTYPE_NAMES[t.dtype],
            "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
        })
        with open(os.path.join(tmp, f"leaf_{i:05d}.bin"), "wb") as f:
            f.write(raw)
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(_msgpack.packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def read_manifest(path: str, step: int | None = None) -> dict:
    """The manifest of ``step`` (default: the latest) under ``path``."""
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        return _msgpack.unpackb(f.read())


def restore(path: str, target_tree, step: int | None = None, *,
            device=None, strict_structure=True):
    """Restore into the structure of ``target_tree``.  Returns
    ``(tree, step, extra)``.

    Each leaf takes its target's dtype, and a tensor leaf its target's
    device (or ``device`` when given)."""
    manifest = read_manifest(path, step)
    d = os.path.join(path, f"step_{manifest['step']:08d}")
    t_leaves = flatten(target_tree)
    if strict_structure and len(t_leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"leaf count mismatch: ckpt {len(manifest['leaves'])} "
            f"vs target {len(t_leaves)}")
    out = []
    for i, (meta, tgt) in enumerate(zip(manifest["leaves"], t_leaves)):
        with open(os.path.join(d, meta["file"]), "rb") as f:
            raw = f.read()
        if (zlib.crc32(raw) & 0xFFFFFFFF) != meta["crc32"]:
            raise IOError(f"CRC mismatch in {meta['file']}")
        arr = _from_raw(raw, meta["dtype"], meta["shape"])
        if tuple(arr.shape) != _shape(tgt):
            raise ValueError(f"shape mismatch leaf {i}: "
                             f"{tuple(arr.shape)} vs {_shape(tgt)}")
        out.append(_cast(arr, tgt, device))
    return unflatten(target_tree, out), manifest["step"], manifest["extra"]


class CheckpointManager:
    """keep-last-k + async orchestration + restore-or-init."""

    def __init__(self, path: str, keep: int = 3, save_every: int = 100):
        self.path = path
        self.keep = keep
        self.save_every = save_every
        self._pending: Future | None = None
        os.makedirs(path, exist_ok=True)

    def maybe_save(self, step: int, tree, extra=None, force=False):
        if not force and (step == 0 or step % self.save_every):
            return None
        if self._pending is not None:
            self._pending.result()                 # backpressure
        self._pending = save_async(self.path, step, tree, extra)
        self._pending.add_done_callback(lambda _: self._gc())
        return self._pending

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.path)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_or_none(self, target_tree, *, device=None):
        if latest_step(self.path) is None:
            return None
        return restore(self.path, target_tree, device=device)
