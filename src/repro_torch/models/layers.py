"""Building blocks of the testbed CNNs (plain functions on tensors).

Parameters are dicts of tensors.  Convolution weights are OIHW and the
activations of these layers are NCHW (torch's own layout); the models'
public entry points take NHWC images, like the JAX package.  Padding
follows JAX's ``"SAME"``: output size ceil(in / stride), with the total
pad split so the larger half comes after — a stride-2 or odd-sized
window therefore pads at the end only, and SAME max-pooling rounds odd
sizes up (28 -> 14 -> 7 -> 4), where torch's defaults would floor.

Init draws from an explicit ``torch.Generator``: He-normal convolutions
and truncated-normal (std 0.02, cut at 2 std) linears, the same
distributions as the JAX init, not the same numbers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def trunc_normal(shape, generator, *, std=0.02, device,
                 dtype=torch.float32):
    t = torch.empty(shape, dtype=dtype, device=device)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                       generator=generator)


def he_normal(shape, generator, fan_in, *, device, dtype=torch.float32):
    std = math.sqrt(2.0 / fan_in)
    return std * torch.randn(shape, generator=generator, device=device,
                             dtype=dtype)


def linear_init(generator, in_dim, out_dim, *, device,
                dtype=torch.float32):
    """{"w": (in, out), "b": (out,)} — the JAX layout, ``x @ w + b``."""
    return {"w": trunc_normal((in_dim, out_dim), generator, device=device,
                              dtype=dtype),
            "b": torch.zeros(out_dim, device=device, dtype=dtype)}


def linear(p, x):
    return x @ p["w"] + p["b"]


def conv_init(generator, kh, kw, cin, cout, *, device,
              dtype=torch.float32):
    """{"w": (cout, cin, kh, kw), "b": (cout,)}, He-normal."""
    return {"w": he_normal((cout, cin, kh, kw), generator, kh * kw * cin,
                           device=device, dtype=dtype),
            "b": torch.zeros(cout, device=device, dtype=dtype)}


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """JAX/XLA "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh, kw, stride, value=0.0):
    """Pad an NCHW tensor for a SAME window; returns (x, symmetric pad)
    — the symmetric case is left to the op's own ``padding``."""
    ph = same_pads(x.shape[2], kh, stride)
    pw = same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def conv2d(p, x, *, stride=1):
    """NCHW convolution with JAX's SAME padding."""
    kh, kw = p["w"].shape[2:]
    x, pad = _pad_same(x, kh, kw, stride)
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=pad)


def max_pool(x, window, stride):
    """NCHW max pool with JAX's SAME padding (-inf), so odd sizes round
    up."""
    x, pad = _pad_same(x, window, window, stride, value=-math.inf)
    return F.max_pool2d(x, window, stride, padding=pad)


def global_avg_pool(x):
    """(B, C, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3))
