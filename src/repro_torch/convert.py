"""Convert the JAX package's parameters into the port's.

``from_jax_params`` takes the JAX param tree with array leaves (numpy,
or anything ``np.asarray`` reads) — ``Param`` leaves of
``parallel/sharding.py`` are unwrapped here, recognised by their
``value`` and ``axes`` attributes — and returns the port's tree on a
device.  Dicts and lists keep their structure; convolution weights go
from HWIO to OIHW.  A convolution weight is a 4-D leaf under the key
``"w"`` (``layers.conv_init``'s key): ViT's patch embedding, ConvNeXt's
stem, downsampling and depthwise convolutions too (a depthwise
(7, 7, 1, C) leaf becomes (C, 1, 7, 7), torch's grouped layout).  Other
4-D leaves, such as a layer-stacked attention weight ``wq`` (L, d, H,
Dh), keep their layout, as do the 3-D attention weights
``wq``/``wk``/``wv``/``wo`` of LeViT and ViT, ViT's ``bq`` (H, Dh) and
``pos`` (N, D), ConvNeXt's ``gamma``, and LeViT's bias tables.  Linear weights keep their (in, out) layout, and the
models flatten NHWC before a fully connected layer, so no FC row needs
permuting.  The LM tree (``models/transformer_lm.py``: embed, layers'
norms, attention and SwiGLU weights, final and exit-head norms, the
untied unembedding) keeps the JAX einsum layouts and needs no transpose;
neither do the 1-D batchnorm leaves.  bfloat16 leaves (numpy's
``ml_dtypes`` type) arrive as torch bfloat16.  The result is checked
against the port's own init for the same config, leaf by leaf: shapes,
so a tree of the wrong architecture raises, and dtypes, which are
``cfg.param_dtype`` except for the batchnorm running statistics
(``mean``, ``var``), kept in float32 whatever the param dtype.

``restore_checkpoint`` reads a checkpoint of either package into a tree
of the port (a trainer's ``state_tree()``, an ``EngineState``): the
manifest's ``treedef`` says who wrote it.  The port's (``repro_torch:``)
restores as it is.  The JAX package's (``PyTreeDef(``) holds HWIO
convolution weights: every 4-D leaf under the key ``"w"`` is read in
that layout and turned into OIHW, in the params and in the optimizer's
moments alike.  The layout is never inferred from a shape: a 3 x 3
convolution with as many inputs as outputs has one shape in both.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import checkpoint as CK
from repro_torch import device as DEV
from repro_torch.checkpoint.checkpoint import TREEDEF_PREFIX, map_leaves
from repro_torch.models import get_family
from repro_torch.models.transformer_lm import LMConfig, lm_init


def tree_map(fn, tree, *rest):
    """``fn`` on every leaf of a params tree of dicts and lists, and on
    the matching leaves of ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree):
    """The leaves of a params tree, in order."""
    out = []
    tree_map(out.append, tree)
    return out


def _to_port(leaf, key, device):
    if hasattr(leaf, "value") and hasattr(leaf, "axes"):     # Param
        leaf = leaf.value
    a = np.asarray(leaf)
    if key == "w" and a.ndim == 4:                   # conv HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    if a.dtype.name == "bfloat16":                   # ml_dtypes: no torch twin
        return torch.tensor(a.view(np.int16),
                            device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)           # copies


def to_port_tree(values_tree, device, key=None):
    """The JAX value tree as torch tensors on ``device``, each leaf in
    the port's layout (``_to_port``, by its key)."""
    if isinstance(values_tree, dict):
        return {k: to_port_tree(v, device, k)
                for k, v in values_tree.items()}
    if isinstance(values_tree, (list, tuple)):
        return [to_port_tree(v, device, key) for v in values_tree]
    return _to_port(values_tree, key, device)


def _check(got, want, path="params"):
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path}: keys {sorted(got)} != "
                             f"{sorted(want)}")
        for k in want:
            _check(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise ValueError(f"{path}: expected a list of {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _check(g, w, f"{path}[{i}]")
    elif got.shape != want.shape:
        raise ValueError(f"{path}: shape {tuple(got.shape)} != "
                         f"{tuple(want.shape)}")
    elif got.dtype != want.dtype:
        raise TypeError(f"{path}: param dtype {got.dtype} != {want.dtype}")


def from_jax_params(values_tree, cfg, device=None):
    """JAX value tree (numpy leaves) -> the port's params for ``cfg`` on
    ``device`` (``None`` = the CUDA card)."""
    dev = DEV.resolve(device)
    params = to_port_tree(values_tree, dev)
    if isinstance(cfg, LMConfig):
        _check(params, lm_init(cfg, device="meta"))
    else:
        _check(params, get_family(cfg).init(cfg, device="meta"))
    return params


def _is_conv(key, leaf) -> bool:
    return key == "w" and isinstance(leaf, torch.Tensor) and leaf.dim() == 4


def restore_checkpoint(path: str, target, step: int | None = None, *,
                       device=None):
    """``checkpoint.restore`` of a checkpoint that either package wrote,
    into ``target`` (the port's layout).  Returns ``(tree, step,
    extra)``."""
    treedef = CK.read_manifest(path, step)["treedef"]
    if treedef.startswith(TREEDEF_PREFIX):
        return CK.restore(path, target, step, device=device)
    if not treedef.startswith("PyTreeDef("):
        raise ValueError(f"{path}: unknown checkpoint writer "
                         f"(treedef {treedef[:40]!r})")
    # the JAX package wrote it: read conv weights as HWIO views of the
    # target, then turn them into OIHW
    jax_target = map_leaves(
        lambda k, t: t.permute(2, 3, 1, 0) if _is_conv(k, t) else t, target)
    tree, step, extra = CK.restore(path, jax_target, step, device=device)
    tree = map_leaves(
        lambda k, t: t.permute(3, 2, 0, 1).contiguous() if _is_conv(k, t)
        else t, tree)
    return tree, step, extra
