"""ConvNeXt with early exits after each stage.

Assigned arch ``convnext-b``: depths 3-3-27-3, dims 128-256-512-1024.
A block is a 7x7 depthwise SAME convolution, then layernorm, ``pw1``
(4x), the tanh GELU, ``pw2`` and the layer scale ``gamma`` (init 1e-6),
added to the residual.  The stem is a 4x4 stride-4 VALID convolution
and a layernorm; each later stage starts with a layernorm and a 2x2
stride-2 VALID convolution.  An exit pools, normalises and classifies.
Stochastic depth is omitted, as in the JAX package.

The layernorms normalise the channels, the last axis of the JAX
package's NHWC maps.  The port holds NCHW between convolutions, so each
one runs on a channel-last view (``_channels_last``: permute, apply,
permute back before the residual); the axis is never read off the
shape.  ``apply_stem`` and ``convnext_forward`` take NHWC images.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import device as DEV
from repro_torch.models import layers as L
from repro_torch.models.cnn_zoo import _generator, _stem


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    name: str
    depths: tuple[int, ...] = (3, 3, 27, 3)
    dims: tuple[int, ...] = (128, 256, 512, 1024)
    img_res: int = 224
    n_classes: int = 1000
    in_channels: int = 3
    exit_stages: tuple[int, ...] = (0, 1, 2)
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    @property
    def n_exits(self) -> int:
        return len(self.exit_stages) + 1


def _channels_last(fn, x):
    """``fn`` on the NHWC view of an NCHW map, the result back in NCHW."""
    return fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _block_init(gen, dim, kw):
    return {"dwconv": L.conv_init(gen, 7, 7, dim, dim, groups=dim, **kw),
            "norm": L.layernorm_init(dim, kw["dtype"], device=kw["device"]),
            "pw1": L.linear_init(gen, dim, 4 * dim, **kw),
            "pw2": L.linear_init(gen, 4 * dim, dim, **kw),
            "gamma": torch.full((dim,), 1e-6, **kw)}


def _block_apply(p, x):
    h = L.conv2d({"w": p["dwconv"]["w"]}, x, groups=x.shape[1])

    def channel_mlp(h):
        h = L.add_bias(h, p["dwconv"]["b"])
        h = L.layernorm(p["norm"], h)
        h = L.linear_biased(p["pw2"], L.gelu(L.linear_biased(p["pw1"], h)))
        L.count_flops(2 * h.numel())                # gamma, the residual
        L.count_converts(h, p["gamma"], h, h, h, h)  # gamma; x + h
        return p["gamma"] * h
    return x + _channels_last(channel_mlp, h)


def convnext_init(cfg: ConvNeXtConfig, *, seed: int = 0, device="cuda"):
    device = DEV.resolve(device)
    gen = _generator(seed, device)
    kw = dict(device=device, dtype=cfg.param_dtype)

    def norm(dim):
        return L.layernorm_init(dim, cfg.param_dtype, device=device)
    p = {"stem": {"conv": L.conv_init(gen, 4, 4, cfg.in_channels,
                                      cfg.dims[0], **kw),
                  "norm": norm(cfg.dims[0])},
         "stages": [], "downsample": [],
         "final_norm": norm(cfg.dims[-1]),
         "head": L.linear_init(gen, cfg.dims[-1], cfg.n_classes, **kw),
         "exit_heads": {}}
    for s, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        p["stages"].append([_block_init(gen, dim, kw) for _ in range(depth)])
        if s < len(cfg.depths) - 1:
            p["downsample"].append({
                "norm": norm(dim),
                "conv": L.conv_init(gen, 2, 2, dim, cfg.dims[s + 1], **kw)})
    for s in cfg.exit_stages:
        p["exit_heads"][str(s)] = {
            "norm": norm(cfg.dims[s]),
            "fc": L.linear_init(gen, cfg.dims[s], cfg.n_classes, **kw)}
    return p


#: XLA fuses the converts that end a bf16 block into the next block's
#: residual add as well, so its cost analysis counts them again in each
#: later block of a stage, compounding (tools/xla_cum_macs.py at depth
#: k: a stage's flops grow by 11 an element more with each block in
#: bf16, by none in float32)
_TAIL_CONVERTS = 11


def _conv_valid(p, x, stride):
    """A VALID convolution with its bias add counted, as XLA counts the
    JAX package's separate add."""
    y = L.conv2d(p, x, stride=stride, padding="VALID")
    L.count_flops(y.numel())
    L.count_converts(y, p["b"], y)
    return y


# -- staged interface -------------------------------------------------------

def apply_stem(params, images, cfg: ConvNeXtConfig):
    x = _conv_valid(params["stem"]["conv"], _stem(images, cfg.compute_dtype),
                    stride=4)
    return _channels_last(lambda h: L.layernorm(params["stem"]["norm"], h),
                          x)


def apply_stage(params, x, stage: int, cfg: ConvNeXtConfig):
    if stage > 0:
        ds = params["downsample"][stage - 1]
        x = _channels_last(lambda h: L.layernorm(ds["norm"], h), x)
        x = _conv_valid(ds["conv"], x, stride=2)
    chain = 0
    for bp in params["stages"][stage]:
        L.count_flops(chain * x.numel())
        x = _block_apply(bp, x)
        chain += _TAIL_CONVERTS * (x.dtype == torch.bfloat16)
    return x


def apply_exit(params, x, stage: int, cfg: ConvNeXtConfig):
    L.count_flops(x.numel())                        # the pooling
    L.count_converts(x)
    h = L.global_avg_pool(x)
    if stage == len(cfg.depths) - 1:
        return L.linear(params["head"], L.layernorm(params["final_norm"], h))
    ep = params["exit_heads"][str(stage)]
    return L.linear(ep["fc"], L.layernorm(ep["norm"], h))


def num_stages(cfg: ConvNeXtConfig) -> int:
    return len(cfg.depths)


def convnext_forward(params, images, cfg: ConvNeXtConfig, *, train=False):
    """All exits: ``{"exit_logits": (E, B, n_classes), "bn_updates": {}}``,
    logits only at ``exit_stages`` and the last stage, as the reference
    stacks them."""
    x = apply_stem(params, images, cfg)
    logits = []
    for s in range(num_stages(cfg)):
        x = apply_stage(params, x, s, cfg)
        if s in cfg.exit_stages or s == num_stages(cfg) - 1:
            logits.append(apply_exit(params, x, s, cfg))
    return {"exit_logits": torch.stack(logits), "bn_updates": {}}
