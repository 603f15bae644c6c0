"""Vision Transformer with early-exit heads (paper §II.D mapping).

Exit heads follow Eq. 16: ``ExitBlock_ViT(T) = MLP(LayerNorm(GlobalPool(T)))``
(``exit_head_init`` / ``exit_head_apply``; LeViT's early exits use them
too).  The final head is ``head(final_norm(GlobalPool(T)))``.

Covers the assigned archs ``vit-s16`` and ``vit-h14`` (and their
reduced variants) with the staged interface of the DART serving engine
(``num_stages``, ``apply_stem``, ``apply_stage``, ``apply_exit``):
stages are groups of pre-LN encoder blocks split at the exit layers.
``apply_stem`` takes NHWC images and returns (B, N, D) tokens in the
JAX package's row-major patch order, ``pos`` added.  Everything keeps
the JAX package's forms: layernorm in float32 with eps 1e-6, the tanh
GELU, attention with biases on q and the output only and a float32
softmax cast back.  ``remat`` recomputes each block in the backward
pass (``torch.utils.checkpoint``) and only while gradients are
recorded, so serving never takes it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as DEV
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    in_channels: int = 3
    exit_layers: tuple[int, ...] = ()
    exit_mlp_ratio: float = 0.5       # hidden dim of the Eq. 16 exit MLP
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = False

    @property
    def n_tokens(self) -> int:
        return (self.img_res // self.patch) ** 2

    @property
    def n_exits(self) -> int:
        return len(self.exit_layers) + 1

    @property
    def stage_bounds(self) -> tuple[int, ...]:
        """Layer index (exclusive) ending each stage; the last is
        n_layers."""
        return tuple(i + 1 for i in self.exit_layers) + (self.n_layers,)


def exit_head_init(gen, d_model, n_classes, hidden, *, device,
                   dtype):
    kw = dict(device=device, dtype=dtype)
    return {"norm": L.layernorm_init(d_model, dtype, device=device),
            "fc1": L.linear_init(gen, d_model, hidden, **kw),
            "fc2": L.linear_init(gen, hidden, n_classes, **kw)}


def exit_head_apply(p, tokens):
    """tokens: (B, N, D), pooled here, or already pooled (B, D)."""
    if tokens.dim() == 2:
        h = tokens
    else:
        L.count_flops(tokens.numel())               # the pooling
        L.count_converts(tokens)
        h = L.global_avg_pool(tokens)
    h = L.layernorm(p["norm"], h)
    return L.linear(p["fc2"], L.gelu(L.linear(p["fc1"], h)))


def _block_init(gen, cfg: ViTConfig, kw):
    dt = cfg.param_dtype
    return {"norm1": L.layernorm_init(cfg.d_model, dt, device=kw["device"]),
            "attn": L.mha_init(gen, cfg.d_model, cfg.n_heads, **kw),
            "norm2": L.layernorm_init(cfg.d_model, dt, device=kw["device"]),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, **kw)}


def vit_init(cfg: ViTConfig, *, seed: int = 0, device="cuda"):
    device = DEV.resolve(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    kw = dict(device=device, dtype=cfg.param_dtype)
    hidden = max(16, int(cfg.d_model * cfg.exit_mlp_ratio))
    return {
        "patch": L.patch_embed_init(gen, cfg.patch, cfg.in_channels,
                                    cfg.d_model, **kw),
        "pos": L.trunc_normal((cfg.n_tokens, cfg.d_model), gen, **kw),
        "blocks": [_block_init(gen, cfg, kw) for _ in range(cfg.n_layers)],
        "final_norm": L.layernorm_init(cfg.d_model, cfg.param_dtype,
                                       device=device),
        "head": L.linear_init(gen, cfg.d_model, cfg.n_classes, **kw),
        "exit_heads": {str(i): exit_head_init(gen, cfg.d_model,
                                              cfg.n_classes, hidden, **kw)
                       for i in cfg.exit_layers},
    }


def _residual(x, y):
    L.count_flops(x.numel())
    out = x + y
    L.count_converts(x, y, out)
    return out


def _block_apply(p, x):
    x = _residual(x, L.mha_apply(p["attn"], L.layernorm(p["norm1"], x)))
    return _residual(x, L.mlp(p["mlp"], L.layernorm(p["norm2"], x)))


# -- staged interface -------------------------------------------------------

def apply_stem(params, images, cfg: ViTConfig):
    """NHWC images -> (B, N, D) tokens, ``pos`` added."""
    x = images.to(cfg.compute_dtype).permute(0, 3, 1, 2)
    x = L.patch_embed(params["patch"], x, cfg.patch)
    return x + params["pos"].to(cfg.compute_dtype)


def apply_stage(params, x, stage: int, cfg: ViTConfig):
    start = 0 if stage == 0 else cfg.stage_bounds[stage - 1]
    remat = cfg.remat and torch.is_grad_enabled() and x.requires_grad
    for i in range(start, cfg.stage_bounds[stage]):
        if remat:
            x = checkpoint(_block_apply, params["blocks"][i], x,
                           use_reentrant=False)
        else:
            x = _block_apply(params["blocks"][i], x)
    return x


def apply_exit(params, x, stage: int, cfg: ViTConfig):
    """Logits at the exit ending ``stage`` (the last stage: the final
    head)."""
    if stage == len(cfg.stage_bounds) - 1:
        L.count_flops(x.numel())                    # the pooling
        L.count_converts(x)
        h = L.layernorm(params["final_norm"], L.global_avg_pool(x))
        return L.linear(params["head"], h)
    return exit_head_apply(params["exit_heads"][str(cfg.exit_layers[stage])],
                           x)


def num_stages(cfg: ViTConfig) -> int:
    return len(cfg.stage_bounds)


def vit_forward(params, images, cfg: ViTConfig, *, train=False):
    """All exits: ``{"exit_logits": (E, B, n_classes), "bn_updates": {}}``
    (no batchnorm; ``train`` changes nothing but ``remat``'s use)."""
    x = apply_stem(params, images, cfg)
    logits = []
    for s in range(num_stages(cfg)):
        x = apply_stage(params, x, s, cfg)
        logits.append(apply_exit(params, x, s, cfg))
    return {"exit_logits": torch.stack(logits), "bn_updates": {}}
