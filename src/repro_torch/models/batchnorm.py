"""BatchNorm with running statistics, in inference and train mode.

The parameters are ``{"scale", "bias", "mean", "var"}``: scale and bias
in the param dtype, the running mean and variance in float32 whatever
the param dtype, as in the JAX package.  ``bn_apply`` normalises over
the axis ``channel_axis`` in float32 with ``rsqrt(var + eps)`` and casts
back to the input's dtype: axis 1 of NCHW activations and of (B, C)
rows (the default), axis -1 of LeViT's (B, N, C) tokens, where the JAX
package normalises the last axis of (..., C).  The axis is the
caller's to say: it cannot be read off the shape, since N equals C for
some token tensors.  Nothing is folded into the convolution before it:
folding rounds differently.

Train mode normalises with the batch statistics: the float32 mean and
the *biased* variance over every axis but the channels, with gradients
flowing through both (``jnp.mean`` / ``jnp.var``).  It appends the new
running statistics to ``updates`` under ``name``, computed detached in
float32 as ``momentum * old + (1 - momentum) * batch``: JAX's
``momentum=0.9`` is the keep factor, the opposite of torch's
convention, and torch's running variance is the unbiased one, so
neither ``F.batch_norm`` nor ``nn.BatchNorm2d`` computes this.  The
trainer merges the updates back with ``merge_updates``.
"""
from __future__ import annotations

import torch

EPS = 1e-5
#: the running statistics: leaves the optimizer leaves alone
STATS_KEYS = ("mean", "var")


def bn_init(dim, dtype, *, device):
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device),
            "mean": torch.zeros(dim, dtype=torch.float32, device=device),
            "var": torch.ones(dim, dtype=torch.float32, device=device)}


def bn_apply(p, x, *, channel_axis: int = 1, train: bool = False,
             momentum: float = 0.9, updates: dict | None = None,
             name: str = ""):
    """x normalised per channel along ``channel_axis`` (1: (B, C, ...);
    -1: (..., C)): with the running statistics, or in train mode with
    the batch's over every other axis (the new running ones go to
    ``updates[name]`` when ``updates`` is given)."""
    axis = channel_axis % x.dim()
    shape = [1] * x.dim()
    shape[axis] = -1
    xf = x.float()
    if train:
        axes = tuple(d for d in range(x.dim()) if d != axis)
        mu = xf.mean(dim=axes)
        var = xf.var(dim=axes, correction=0)
        if updates is not None:
            with torch.no_grad():
                updates[name] = {
                    "mean": momentum * p["mean"] + (1 - momentum) * mu,
                    "var": momentum * p["var"] + (1 - momentum) * var}
        mu, var = mu.view(shape), var.view(shape)
    else:
        mu, var = p["mean"].view(shape), p["var"].view(shape)
    y = (xf - mu) * torch.rsqrt(var + EPS)
    return (y * p["scale"].float().view(shape)
            + p["bias"].float().view(shape)).to(x.dtype)


def merge_updates(params, updates: dict):
    """A new tree with the running statistics of ``updates``
    ({name: {"mean", "var"}}) in place of the old ones.  Names are
    '/'-joined key paths to a batchnorm's dict ("stages/0/1/bn1"); the
    nodes along each path are copied, the rest of the tree is shared."""
    params = dict(params)
    for name, upd in updates.items():
        node = params
        for k in name.split("/"):
            key = int(k) if isinstance(node, list) else k
            node[key] = (list(node[key]) if isinstance(node[key], list)
                         else dict(node[key]))
            node = node[key]
        node["mean"], node["var"] = upd["mean"], upd["var"]
    return params
