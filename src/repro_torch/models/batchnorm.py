"""BatchNorm with running statistics, inference mode only.

The parameters are ``{"scale", "bias", "mean", "var"}``: scale and bias
in the param dtype, the running mean and variance in float32 whatever
the param dtype, as in the JAX package.  ``bn_apply`` normalises over
the channel axis of an NCHW (or (B, C)) tensor in float32 with
``rsqrt(var + eps)`` and casts back to the input's dtype.  Nothing is
folded into the convolution before it: folding rounds differently.

Train mode (batch statistics and the EMA update of the running ones)
is not ported: its momentum is a keep factor and its variance is the
biased one, both unlike torch's defaults.
"""
from __future__ import annotations

import torch

EPS = 1e-5


def bn_init(dim, dtype, *, device):
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device),
            "mean": torch.zeros(dim, dtype=torch.float32, device=device),
            "var": torch.ones(dim, dtype=torch.float32, device=device)}


def bn_apply(p, x, *, train: bool = False):
    """x: (B, C, ...) normalised per channel with the running statistics."""
    if train:
        raise NotImplementedError(
            "train-mode batchnorm is not ported; it comes with the trainer "
            "(ROADMAP queue 1, item 5)")
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mu, var = p["mean"].view(shape), p["var"].view(shape)
    y = (x.float() - mu) * torch.rsqrt(var + EPS)
    return (y * p["scale"].float().view(shape)
            + p["bias"].float().view(shape)).to(x.dtype)
