"""ResNet (basic or bottleneck blocks) with BranchyNet-style early exits.

The paper's ResNet-18 testbed (basic blocks, depths 2-2-2-2) and the
deeper bottleneck variants.  Exits sit after each stage (global average
pool -> linear head).  Every convolution is bias-free and followed by a
batchnorm: in inference mode on the serving path, in train mode under
``train=True``, where each batchnorm adds its new running statistics to
``updates`` under the JAX package's key path ("stem/bn",
"stages/{s}/{b}/bn1", ...).  ``apply_stem`` and ``resnet_forward`` take
NHWC images; activations are NCHW between stages.  The stride-2 blocks
and the 7x7 stride-2 stem pad to JAX's SAME split (``layers.conv2d``).
Inside a ``layers.count_macs`` scope the batchnorms, ReLUs and residual
adds add their flops as XLA's cost analysis counts them, the chain XLA
recomputes in each identity block included (``_TAIL_FLOPS``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.batchnorm import bn_apply, bn_init
from repro_torch.models.cnn_zoo import _generator, _stem


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    depths: tuple[int, ...] = (3, 8, 36, 3)
    width: int = 64
    block: str = "bottleneck"              # "bottleneck" | "basic"
    img_res: int = 224
    n_classes: int = 1000
    in_channels: int = 3
    exit_stages: tuple[int, ...] = (0, 1, 2)   # early exits after these
    small_input: bool = False              # CIFAR-style stem (3x3, no pool)
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    @property
    def expansion(self) -> int:
        return 4 if self.block == "bottleneck" else 1

    @property
    def n_exits(self) -> int:
        return len(self.exit_stages) + 1


def _block_init(gen, cin, planes, cfg, stride, kw):
    e = cfg.expansion
    if cfg.block == "bottleneck":
        shapes = ((1, cin, planes), (3, planes, planes),
                  (1, planes, planes * e))
    else:
        shapes = ((3, cin, planes), (3, planes, planes))
    p = {}
    for i, (k, ci, co) in enumerate(shapes, 1):
        p[f"conv{i}"] = L.conv_init(gen, k, k, ci, co, bias=False, **kw)
        p[f"bn{i}"] = bn_init(co, kw["dtype"], device=kw["device"])
    if stride != 1 or cin != planes * e:
        p["down_conv"] = L.conv_init(gen, 1, 1, cin, planes * e, bias=False,
                                     **kw)
        p["down_bn"] = bn_init(planes * e, kw["dtype"], device=kw["device"])
    return p


def _relu(x):
    L.count_flops(x.numel())
    return torch.relu(x)


def _block_apply(p, x, cfg, stride, *, train=False, updates=None, name=""):
    def bn(key, h):
        # subtract, scale, scale, shift an element; var + eps a channel
        L.count_flops(4 * h.numel() + h.shape[1])
        L.count_converts(h, p[key]["scale"], p[key]["bias"], h)
        return bn_apply(p[key], h, train=train, updates=updates,
                        name=f"{name}/{key}")

    if cfg.block == "bottleneck":
        h = _relu(bn("bn1", L.conv2d(p["conv1"], x)))
        h = _relu(bn("bn2", L.conv2d(p["conv2"], h, stride=stride)))
        h = bn("bn3", L.conv2d(p["conv3"], h))
    else:
        h = _relu(bn("bn1", L.conv2d(p["conv1"], x, stride=stride)))
        h = bn("bn2", L.conv2d(p["conv2"], h))
    idn = x
    if "down_conv" in p:
        idn = bn("down_bn", L.conv2d(p["down_conv"], x, stride=stride))
    L.count_flops(h.numel())                        # the residual add
    L.count_converts(h, idn, h)
    return _relu(h + idn)


def _stride(stage: int, block: int) -> int:
    return 2 if (block == 0 and stage > 0) else 1


def resnet_init(cfg: ResNetConfig, *, seed: int = 0, device="cuda"):
    gen = _generator(seed, device)
    kw = dict(device=device, dtype=cfg.param_dtype)
    e = cfg.expansion
    k = 3 if cfg.small_input else 7
    stem = {"conv": L.conv_init(gen, k, k, cfg.in_channels, cfg.width,
                                bias=False, **kw),
            "bn": bn_init(cfg.width, cfg.param_dtype, device=device)}
    stages, cin = [], cfg.width
    for s, depth in enumerate(cfg.depths):
        planes = cfg.width * (2 ** s)
        blocks = []
        for b in range(depth):
            blocks.append(_block_init(gen, cin, planes, cfg, _stride(s, b),
                                      kw))
            cin = planes * e
        stages.append(blocks)
    heads = {str(s): L.linear_init(gen, cfg.width * (2 ** s) * e,
                                   cfg.n_classes, **kw)
             for s in cfg.exit_stages}
    return {"stem": stem, "stages": stages,
            "head": L.linear_init(gen, cin, cfg.n_classes, **kw),
            "exit_heads": heads}


# -- staged interface -------------------------------------------------------

def apply_stem(params, images, cfg: ResNetConfig, *, train=False,
               updates=None):
    x = _stem(images, cfg.compute_dtype)
    x = L.conv2d(params["stem"]["conv"], x,
                 stride=1 if cfg.small_input else 2)
    x = torch.relu(bn_apply(params["stem"]["bn"], x, train=train,
                            updates=updates, name="stem/bn"))
    if not cfg.small_input:
        x = L.max_pool(x, 3, 2)
    return x


#: XLA fuses the elementwise chain that ends a block (its last
#: batchnorm, the shortcut's, the residual add and the ReLU: flops an
#: element, float32 and bf16 with its converts) into the next block's
#: residual add as well as computing it for the next convolution, so
#: its cost analysis counts the chain again in each identity block,
#: compounding along a stage (tools/xla_cum_macs.py at depth k: the
#: stage's flops grow by 6 (bf16: 12) an element more with each block)
_TAIL_FLOPS = {"down": (10, 17), "identity": (6, 12)}


def apply_stage(params, x, stage: int, cfg: ResNetConfig, *, train=False,
                updates=None):
    chain = 0                   # flops an element of x's fused chain
    for b, bp in enumerate(params["stages"][stage]):
        kind = "down" if "down_conv" in bp else "identity"
        if kind == "down":
            chain = 0
        L.count_flops(chain * x.numel())
        x = _block_apply(bp, x, cfg, _stride(stage, b), train=train,
                         updates=updates, name=f"stages/{stage}/{b}")
        chain += _TAIL_FLOPS[kind][x.dtype == torch.bfloat16]
    return x


def apply_exit(params, x, stage: int, cfg: ResNetConfig):
    L.count_flops(x.numel())                        # the pooling
    L.count_converts(x)
    h = L.global_avg_pool(x)
    if stage == len(cfg.depths) - 1:
        return L.linear(params["head"], h)
    return L.linear(params["exit_heads"][str(stage)], h)


def num_stages(cfg: ResNetConfig) -> int:
    return len(cfg.depths)


def resnet_forward(params, images, cfg: ResNetConfig, *, train=False):
    """All exits: ``{"exit_logits": (E, B, n_classes), "bn_updates":
    {name: {"mean", "var"}}}``, the updates empty in inference mode."""
    updates: dict = {}
    x = apply_stem(params, images, cfg, train=train, updates=updates)
    logits = []
    for s in range(num_stages(cfg)):
        x = apply_stage(params, x, s, cfg, train=train, updates=updates)
        if s in cfg.exit_stages or s == num_stages(cfg) - 1:
            logits.append(apply_exit(params, x, s, cfg))
    return {"exit_logits": torch.stack(logits), "bn_updates": updates}

