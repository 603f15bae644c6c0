"""The paper's CNN testbeds: AlexNet and VGG-16 (Table I, CIFAR-10 / MNIST).

Both expose the staged interface of the DART serving engine
(``apply_stem`` / ``apply_stage`` / ``apply_exit`` / ``num_stages``) and
an all-exits ``forward``.  ``apply_stem`` and ``forward`` take NHWC
images ``(B, H, W, C)`` and exit heads return logits ``(B, n_classes)``;
``forward`` stacks them to ``(E, B, n_classes)``.  Between stages the
activations are NCHW.  Before a flatten into a fully connected layer
they are put back in NHWC order, so the FC weights mean what they mean
in the JAX package.  AlexNet and VGG use their original norm-free
convolutions.  LeViT waits for a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers as L


def _flatten_nhwc(x):
    """(B, C, H, W) -> (B, H*W*C) in the NHWC order of the reference."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _stem(images, dtype):
    """NHWC images -> NCHW activations in the compute dtype."""
    return images.to(dtype).permute(0, 3, 1, 2).contiguous()


def _generator(seed: int, device) -> torch.Generator | None:
    """A seeded generator on ``device``; none for "meta", where init only
    builds shapes."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _exit_conv_head_init(gen, cin, n_classes, **kw):
    return {"conv": L.conv_init(gen, 3, 3, cin, 64, **kw),
            "fc": L.linear_init(gen, 64, n_classes, **kw)}


def _exit_conv_head(p, x):
    h = torch.relu(L.conv2d(p["conv"], x))
    return L.linear(p["fc"], L.global_avg_pool(h))


# ---------------------------------------------------------------------------
# AlexNet
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlexNetConfig:
    name: str = "alexnet"
    img_res: int = 32
    in_channels: int = 3
    n_classes: int = 10
    channels: tuple[int, ...] = (64, 192, 384, 256, 256)
    fc_dims: tuple[int, ...] = (1024, 512)
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32


def alexnet_init(cfg: AlexNetConfig, *, seed: int = 0, device="cuda"):
    gen = _generator(seed, device)
    kw = dict(device=device, dtype=cfg.param_dtype)
    c = cfg.channels
    cins = (cfg.in_channels,) + c[:-1]
    p = {f"conv{i + 1}": L.conv_init(gen, 3, 3, cins[i], c[i], **kw)
         for i in range(5)}
    p["exit_heads"] = {
        "0": _exit_conv_head_init(gen, c[1], cfg.n_classes, **kw),
        "1": _exit_conv_head_init(gen, c[4], cfg.n_classes, **kw)}
    feat_res = cfg.img_res
    for _ in range(3):                      # three SAME-padded stride-2 pools
        feat_res = -(-feat_res // 2)
    dims = (c[4] * feat_res * feat_res,) + cfg.fc_dims
    p["fc"] = [L.linear_init(gen, dims[i], dims[i + 1], **kw)
               for i in range(len(cfg.fc_dims))]
    p["head"] = L.linear_init(gen, dims[-1], cfg.n_classes, **kw)
    return p


def alexnet_apply_stem(params, images, cfg: AlexNetConfig):
    return _stem(images, cfg.compute_dtype)


def alexnet_apply_stage(params, x, stage: int, cfg: AlexNetConfig):
    if stage == 0:
        x = torch.relu(L.conv2d(params["conv1"], x))
        x = L.max_pool(x, 2, 2)
        x = torch.relu(L.conv2d(params["conv2"], x))
        return L.max_pool(x, 2, 2)
    if stage == 1:
        x = torch.relu(L.conv2d(params["conv3"], x))
        x = torch.relu(L.conv2d(params["conv4"], x))
        x = torch.relu(L.conv2d(params["conv5"], x))
        return L.max_pool(x, 2, 2)
    h = _flatten_nhwc(x)
    for fp in params["fc"]:
        h = torch.relu(L.linear(fp, h))
    return h


def alexnet_apply_exit(params, x, stage: int, cfg: AlexNetConfig):
    if stage == 2:
        return L.linear(params["head"], x)
    return _exit_conv_head(params["exit_heads"][str(stage)], x)


def alexnet_num_stages(cfg: AlexNetConfig) -> int:
    return 3  # two BranchyNet-style branches + final


# ---------------------------------------------------------------------------
# VGG-16
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VGGConfig:
    name: str = "vgg16"
    img_res: int = 32
    in_channels: int = 3
    n_classes: int = 10
    blocks: tuple[tuple[int, int], ...] = ((64, 2), (128, 2), (256, 3),
                                           (512, 3), (512, 3))
    fc_dim: int = 512
    exit_blocks: tuple[int, ...] = (1, 2, 3)
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32


def vgg_init(cfg: VGGConfig, *, seed: int = 0, device="cuda"):
    gen = _generator(seed, device)
    kw = dict(device=device, dtype=cfg.param_dtype)
    p = {"blocks": [], "exit_heads": {}}
    cin = cfg.in_channels
    for b, (ch, depth) in enumerate(cfg.blocks):
        convs = []
        for _ in range(depth):
            convs.append(L.conv_init(gen, 3, 3, cin, ch, **kw))
            cin = ch
        p["blocks"].append(convs)
        if b in cfg.exit_blocks:
            p["exit_heads"][str(b)] = _exit_conv_head_init(
                gen, ch, cfg.n_classes, **kw)
    feat_res = cfg.img_res
    for _ in range(len(cfg.blocks)):        # SAME-padded stride-2 pools
        feat_res = -(-feat_res // 2)
    flat = cfg.blocks[-1][0] * feat_res * feat_res
    p["fc1"] = L.linear_init(gen, flat, cfg.fc_dim, **kw)
    p["head"] = L.linear_init(gen, cfg.fc_dim, cfg.n_classes, **kw)
    return p


def vgg_apply_stem(params, images, cfg: VGGConfig):
    return _stem(images, cfg.compute_dtype)


def _vgg_stage_blocks(cfg: VGGConfig):
    """Stages aligned with exits: each stage ends at an exit block (or the
    final classifier), so the staged serving engine always has a head."""
    bounds = [b + 1 for b in cfg.exit_blocks] + [len(cfg.blocks)]
    out, start = [], 0
    for b in bounds:
        out.append(tuple(range(start, b)))
        start = b
    return [s for s in out if s]


def vgg_apply_stage(params, x, stage: int, cfg: VGGConfig):
    stages = _vgg_stage_blocks(cfg)
    for bi in stages[stage]:
        for cp in params["blocks"][bi]:
            x = torch.relu(L.conv2d(cp, x))
        x = L.max_pool(x, 2, 2)
    if stage == len(stages) - 1:
        x = torch.relu(L.linear(params["fc1"], _flatten_nhwc(x)))
    return x


def vgg_apply_exit(params, x, stage: int, cfg: VGGConfig):
    stages = _vgg_stage_blocks(cfg)
    if stage == len(stages) - 1:
        return L.linear(params["head"], x)
    return _exit_conv_head(params["exit_heads"][str(stages[stage][-1])], x)


def vgg_num_stages(cfg: VGGConfig) -> int:
    return len(_vgg_stage_blocks(cfg))


# ---------------------------------------------------------------------------
# all exits
# ---------------------------------------------------------------------------

def staged_forward(stem, stage, exit_, n_stages):
    """All-exits forward built from the staged functions.  AlexNet and VGG
    have no batchnorm, so ``train`` changes nothing and ``bn_updates`` is
    empty."""
    def forward(params, images, cfg, *, train=False):
        x = stem(params, images, cfg)
        logits = []
        for s in range(n_stages(cfg)):
            x = stage(params, x, s, cfg)
            logits.append(exit_(params, x, s, cfg))
        return {"exit_logits": torch.stack(logits), "bn_updates": {}}
    return forward


alexnet_forward = staged_forward(alexnet_apply_stem, alexnet_apply_stage,
                                 alexnet_apply_exit, alexnet_num_stages)
vgg_forward = staged_forward(vgg_apply_stem, vgg_apply_stage,
                             vgg_apply_exit, vgg_num_stages)
