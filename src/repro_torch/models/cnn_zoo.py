"""The paper's CNN/ViT testbeds: AlexNet and VGG-16 (Table I, CIFAR-10 /
MNIST) and LeViT (Table II).

All expose the staged interface of the DART serving engine
(``apply_stem`` / ``apply_stage`` / ``apply_exit`` / ``num_stages``) and
an all-exits ``forward``.  ``apply_stem`` and ``forward`` take NHWC
images ``(B, H, W, C)`` and exit heads return logits ``(B, n_classes)``;
``forward`` stacks them to ``(E, B, n_classes)``.  Between stages the
activations are NCHW.  Before a flatten into a fully connected layer
they are put back in NHWC order, so the FC weights mean what they mean
in the JAX package.  AlexNet and VGG use their original norm-free
convolutions.

LeViT keeps the JAX package's design: a stem of stride-2 convolutions
with batchnorm and hard-swish, then (B, N, C) tokens in the row-major
order of the NHWC map (``_tokens``: the NCHW activations are put back
in NHWC order first, so the (heads, q, n) attention-bias table and the
``::2`` subsample of a shrink block address the tokens they address in
JAX); attention blocks with a learned bias table and a float32
softmax, MLP blocks, a batchnorm on the last axis after each; a shrink
block between stages, whose attention has no residual around it; the
Eq. 16 exit heads (``vit.exit_head_apply``).  In train mode each
batchnorm adds its new running statistics to ``updates`` under the JAX
package's key path ("stem/0/bn", "stages/0/1/attn/bn", ...).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import device as DEV
from repro_torch.models import layers as L
from repro_torch.models.batchnorm import bn_apply, bn_init
from repro_torch.models.vit import exit_head_apply, exit_head_init


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
# LeViT
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeViTConfig:
    name: str = "levit-128s"
    img_res: int = 224
    in_channels: int = 3
    n_classes: int = 1000
    dims: tuple[int, ...] = (128, 256, 384)
    heads: tuple[int, ...] = (4, 6, 8)
    depths: tuple[int, ...] = (2, 3, 4)
    key_dim: int = 16
    mlp_ratio: int = 2
    stem_convs: int = 4                 # each stride 2 (224 -> 14)
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    @property
    def n_exits(self) -> int:
        return len(self.dims)           # exit after each stage; last = final

    @property
    def stem_res(self) -> int:
        return self.img_res // (2 ** self.stem_convs)


def _levit_stem_channels(cfg: LeViTConfig) -> list[int]:
    return ([cfg.in_channels]
            + [max(8, cfg.dims[0] // (2 ** (cfg.stem_convs - 1 - i)))
               for i in range(cfg.stem_convs - 1)] + [cfg.dims[0]])


def _levit_attn_init(gen, dim, heads, key_dim, n_tokens, kw, *,
                     out_dim=None, q_tokens=None):
    out_dim = out_dim or dim
    v_dim = key_dim * 2
    q_tokens = q_tokens or n_tokens

    def w(*shape):
        return L.trunc_normal(shape, gen, **kw)
    return {"wq": w(dim, heads, key_dim), "wk": w(dim, heads, key_dim),
            "wv": w(dim, heads, v_dim), "wo": w(heads, v_dim, out_dim),
            "bias": torch.zeros((heads, q_tokens, n_tokens), **kw),
            "bn": bn_init(out_dim, kw["dtype"], device=kw["device"])}


def _bn_tokens(p, x, *, train, updates, name):
    L.count_flops(4 * x.numel() + x.shape[-1])
    return bn_apply(p, x, channel_axis=-1, train=train, updates=updates,
                    name=name)


def _add(x, y):
    """A residual add, counted."""
    L.count_flops(x.numel())
    return x + y


def _levit_attn(p, xq, xkv, *, train, updates, name):
    """Queries from ``xq`` (B, Q, D), keys and values from ``xkv`` (B, N,
    D): scores plus the (H, Q, N) bias, softmax in float32 cast back,
    hard-swish after ``wo``, then batchnorm on the tokens."""
    q = L.einsum("bsd,dhk->bshk", xq, p["wq"])
    k = L.einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = L.einsum("bsd,dhk->bshk", xkv, p["wv"])
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = L.einsum("bqhd,bkhd->bhqk", q, k) * scale + p["bias"]
    # scale and bias, then softmax: max, subtract, sum, divide (XLA
    # counts each reduction of n elements as n - 1 flops)
    L.count_flops(6 * s.numel() - 2 * (s.numel() // s.shape[-1]))
    w = torch.softmax(s.float(), dim=-1).to(xq.dtype)
    o = L.einsum("bhqk,bkhd->bqhd", w, v)
    o = L.hard_swish(L.einsum("bqhd,hdo->bqo", o, p["wo"]))
    return _bn_tokens(p["bn"], o, train=train, updates=updates, name=name)


def _levit_mlp_init(gen, dim, ratio, kw):
    return {"up": L.linear_init(gen, dim, dim * ratio, bias=False, **kw),
            "bn_up": bn_init(dim * ratio, kw["dtype"], device=kw["device"]),
            "down": L.linear_init(gen, dim * ratio, dim, bias=False, **kw),
            "bn_down": bn_init(dim, kw["dtype"], device=kw["device"])}


def _levit_mlp(p, x, *, train, updates, name):
    h = L.hard_swish(_bn_tokens(p["bn_up"], L.linear(p["up"], x),
                                train=train, updates=updates,
                                name=f"{name}/bn_up"))
    return _bn_tokens(p["bn_down"], L.linear(p["down"], h), train=train,
                      updates=updates, name=f"{name}/bn_down")


def levit_init(cfg: LeViTConfig, *, seed: int = 0, device="cuda"):
    device = DEV.resolve(device)
    gen = _generator(seed, device)
    kw = dict(device=device, dtype=cfg.param_dtype)
    chans = _levit_stem_channels(cfg)
    p = {"stem": [{"conv": L.conv_init(gen, 3, 3, chans[i], chans[i + 1],
                                       bias=False, **kw),
                   "bn": bn_init(chans[i + 1], cfg.param_dtype,
                                 device=device)}
                  for i in range(cfg.stem_convs)],
         "stages": [], "shrink": [], "exit_heads": {},
         "head_bn": bn_init(cfg.dims[-1], cfg.param_dtype, device=device),
         "head": L.linear_init(gen, cfg.dims[-1], cfg.n_classes, **kw)}
    res = cfg.stem_res
    last = len(cfg.dims) - 1
    for s, (dim, heads, depth) in enumerate(zip(cfg.dims, cfg.heads,
                                                cfg.depths)):
        n_tok = res * res
        p["stages"].append([
            {"attn": _levit_attn_init(gen, dim, heads, cfg.key_dim, n_tok,
                                      kw),
             "mlp": _levit_mlp_init(gen, dim, cfg.mlp_ratio, kw)}
            for _ in range(depth)])
        if s < last:
            p["shrink"].append({
                "attn": _levit_attn_init(gen, dim, cfg.heads[s + 1],
                                         cfg.key_dim, n_tok, kw,
                                         out_dim=cfg.dims[s + 1],
                                         q_tokens=(res // 2) ** 2),
                "mlp": _levit_mlp_init(gen, cfg.dims[s + 1], cfg.mlp_ratio,
                                       kw)})
            res //= 2
            p["exit_heads"][str(s)] = exit_head_init(
                gen, dim, cfg.n_classes, max(16, dim // 2), **kw)
    return p


def _tokens(x):
    """(B, C, H, W) -> (B, H*W, C) in the row-major order of the NHWC
    map, the JAX package's token order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def levit_apply_stem(params, images, cfg: LeViTConfig, *, train=False,
                     updates=None):
    x = _stem(images, cfg.compute_dtype)
    for i, sp in enumerate(params["stem"]):
        x = L.hard_swish(bn_apply(sp["bn"], L.conv2d(sp["conv"], x,
                                                     stride=2),
                                  train=train, updates=updates,
                                  name=f"stem/{i}/bn"))
    return _tokens(x)


def levit_apply_stage(params, x, stage: int, cfg: LeViTConfig, *,
                      train=False, updates=None):
    kw = dict(train=train, updates=updates)
    if stage > 0:
        # shrink: queries on every other row and column of the token
        # map, no residual around the attention (its width changes)
        sh = params["shrink"][stage - 1]
        b, n, d = x.shape
        res = int(n ** 0.5)
        xq = x.reshape(b, res, res, d)[:, ::2, ::2].reshape(b, -1, d)
        x = _levit_attn(sh["attn"], xq, x,
                        name=f"shrink/{stage - 1}/attn/bn", **kw)
        x = _add(x, _levit_mlp(sh["mlp"], x,
                               name=f"shrink/{stage - 1}/mlp", **kw))
    for i, bp in enumerate(params["stages"][stage]):
        x = _add(x, _levit_attn(bp["attn"], x, x,
                                name=f"stages/{stage}/{i}/attn/bn", **kw))
        x = _add(x, _levit_mlp(bp["mlp"], x,
                               name=f"stages/{stage}/{i}/mlp", **kw))
    return x


def levit_apply_exit(params, x, stage: int, cfg: LeViTConfig, *,
                     train=False, updates=None):
    if stage == len(cfg.dims) - 1:
        L.count_flops(x.numel())                    # the pooling
        h = _bn_tokens(params["head_bn"], L.global_avg_pool(x),
                       train=train, updates=updates, name="head_bn")
        return L.linear(params["head"], h)
    return exit_head_apply(params["exit_heads"][str(stage)], x)


def levit_num_stages(cfg: LeViTConfig) -> int:
    return len(cfg.dims)


def levit_forward(params, images, cfg: LeViTConfig, *, train=False):
    """All exits: ``{"exit_logits": (E, B, n_classes), "bn_updates":
    {name: {"mean", "var"}}}``, the updates empty in inference mode."""
    updates: dict = {}
    kw = dict(train=train, updates=updates)
    x = levit_apply_stem(params, images, cfg, **kw)
    logits = []
    for s in range(levit_num_stages(cfg)):
        x = levit_apply_stage(params, x, s, cfg, **kw)
        logits.append(levit_apply_exit(params, x, s, cfg, **kw))
    return {"exit_logits": torch.stack(logits), "bn_updates": updates}


def levit_macs(cfg: LeViTConfig) -> int:
    """Analytic MACs for Table II, formula for formula the JAX package's:
    the stem, the stages' blocks and the final linear.  It leaves out
    what the reference leaves out: the shrink blocks and the exit
    heads."""
    res = cfg.img_res
    macs = 0
    chans = _levit_stem_channels(cfg)
    for i in range(cfg.stem_convs):
        res //= 2
        macs += 9 * chans[i] * chans[i + 1] * res * res
    res = cfg.stem_res
    for s, (dim, heads, depth) in enumerate(zip(cfg.dims, cfg.heads,
                                                cfg.depths)):
        n = res * res
        kd, vd = cfg.key_dim, cfg.key_dim * 2
        per = (n * dim * heads * (2 * kd + vd) + n * n * heads * (kd + vd)
               + n * heads * vd * dim + 2 * n * dim * dim * cfg.mlp_ratio)
        macs += depth * per
        if s < len(cfg.dims) - 1:
            res //= 2
    macs += cfg.dims[-1] * cfg.n_classes
    return int(macs)


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
