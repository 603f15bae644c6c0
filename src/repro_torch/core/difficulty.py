"""DART difficulty estimation — paper section II.A (Eqs. 1-8) for images,
and its token-domain analogue for LM decode.

Three complementary per-input metrics, fused with weights (w1, w2, w3):

* edge density        — Sobel gradient magnitude thresholded (Eqs. 1-4)
* pixel variance      — spatial variance per channel, averaged (Eqs. 5-6)
* gradient complexity — mean |Laplacian| response (Eq. 7)

The paper's empirical weights are (0.4, 0.3, 0.3); beta_diff = 0.3.

This module is the plain torch chain; the fused CUDA kernel in
``repro_torch.kernels.difficulty`` is held against it.  The 3x3
stencils are written as shifted views of the valid region (the same
cross-correlation as the reference's VALID convolutions), so they need
no convolution library and no TF32 setting on a card.  Images are NHWC
``(B, H, W, C)`` in [0, 1].
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

LUMA = (0.299, 0.587, 0.114)


@dataclasses.dataclass(frozen=True)
class DifficultyConfig:
    w_edge: float = 0.4          # paper: w1
    w_variance: float = 0.3      # paper: w2
    w_gradient: float = 0.3      # paper: w3
    tau_edge: float = 0.1        # Eq. 4 threshold (on [0,1] images)
    var_scale: float = 0.05      # variance squashing scale
    grad_scale: float = 0.2      # |Laplacian| squashing scale
    beta_diff: float = 0.3       # Eq. 19 sensitivity


DEFAULT = DifficultyConfig()


def to_grayscale(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W).  Luminance for C==3, mean otherwise."""
    x = images.float()
    if x.shape[-1] == 3:
        return LUMA[0] * x[..., 0] + LUMA[1] * x[..., 1] + LUMA[2] * x[..., 2]
    return x.mean(dim=-1)


def _neighbours(g: torch.Tensor):
    """The nine shifted (B, H-2, W-2) views of a 3x3 valid stencil, in
    row-major order: tl, tc, tr, ml, mc, mr, bl, bc, br."""
    h, w = g.shape[1:]
    return [g[:, i:h - 2 + i, j:w - 2 + j] for i in range(3) for j in range(3)]


def edge_density(images, tau_edge=DEFAULT.tau_edge):
    """Eqs. 1-4.  Returns (B,)."""
    tl, tc, tr, ml, _, mr, bl, bc, br = _neighbours(to_grayscale(images))
    gx = (tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)
    gy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    mag = torch.sqrt(gx * gx + gy * gy)
    return (mag > tau_edge).float().mean(dim=(1, 2))


def pixel_variance(images, var_scale=DEFAULT.var_scale):
    """Eqs. 5-6 with squashing to [0,1].  Returns (B,)."""
    x = images.float()
    mu = x.mean(dim=(1, 2), keepdim=True)                  # per (b, c)
    var = (x - mu).square().mean(dim=(1, 2, 3))            # 1/(CHW) sum
    return 1.0 - torch.exp(-var / var_scale)


def gradient_complexity(images, grad_scale=DEFAULT.grad_scale):
    """Eq. 7 with squashing to [0,1].  Returns (B,)."""
    _, tc, _, ml, mc, mr, _, bc, _ = _neighbours(to_grayscale(images))
    lap = tc + ml + mr + bc - 4.0 * mc
    return 1.0 - torch.exp(-lap.abs().mean(dim=(1, 2)) / grad_scale)


def fuse(alpha_edge, alpha_var, alpha_grad, cfg: DifficultyConfig = DEFAULT):
    """Eq. 8: alpha = w1*edge + w2*var + w3*grad, clamped to [0,1]."""
    a = (cfg.w_edge * alpha_edge + cfg.w_variance * alpha_var
         + cfg.w_gradient * alpha_grad)
    return torch.clamp(a, 0.0, 1.0)


def image_difficulty(images, cfg: DifficultyConfig = DEFAULT):
    """The paper's difficulty score for a batch of images.  (B,) in [0,1]."""
    return fuse(edge_density(images, cfg.tau_edge),
                pixel_variance(images, cfg.var_scale),
                gradient_complexity(images, cfg.grad_scale), cfg)


# ---------------------------------------------------------------------------
# Token domain (LM) — Eq. 17 transposed to embedding space
# ---------------------------------------------------------------------------
# ``jnp.var`` is the biased (population) variance, so every variance here
# takes ``correction=0``; torch's default (unbiased) would shift alpha in
# every decode step.

def token_difficulty(embeddings, cfg: DifficultyConfig = DEFAULT,
                     edge_tau: float = 1.0):
    """embeddings: (B, S, D) input-token embeddings.  Returns (B,) in [0,1].

    * edge analogue    — fraction of token transitions with RMS step > tau
    * variance analogue — feature variance (squashed)
    * gradient analogue — RMS second difference (squashed)
    """
    x = embeddings.float()
    if x.shape[1] < 3:
        # decode steps: fall back to feature variance only
        var = torch.var(x, dim=(1, 2), correction=0)
        return torch.clamp(1.0 - torch.exp(-var / cfg.var_scale), 0.0, 1.0)
    d1 = x[:, 1:] - x[:, :-1]
    step = torch.sqrt(d1.square().mean(dim=-1))              # (B, S-1) RMS
    a_edge = (step > edge_tau).float().mean(dim=-1)
    var = torch.var(x, dim=(1, 2), correction=0)
    a_var = 1.0 - torch.exp(-var / (10 * cfg.var_scale))
    d2 = x[:, 2:] - 2 * x[:, 1:-1] + x[:, :-2]
    curv = torch.sqrt(d2.square().mean(dim=-1)).mean(dim=-1)
    a_grad = 1.0 - torch.exp(-curv / (10 * cfg.grad_scale))
    return fuse(a_edge, a_var, a_grad, cfg)


def token_difficulty_ema(prev_alpha, new_embedding, cfg=DEFAULT,
                         decay: float = 0.9):
    """Decode-time difficulty: EMA over per-token feature stats.
    prev_alpha: (B,); new_embedding: (B, 1, D)."""
    var = torch.var(new_embedding.float(), dim=(1, 2), correction=0)
    inst = torch.clamp(1.0 - torch.exp(-var / (10 * cfg.var_scale)), 0.0,
                       1.0)
    return decay * prev_alpha + (1.0 - decay) * inst


#: Default class boundaries on Eq. 8 alpha — easy (0, 0.35], medium
#: (0.35, 0.65], hard (0.65, 1].
DEFAULT_EDGES = (0.35, 0.65)


def difficulty_class(alpha, edges=DEFAULT_EDGES):
    """Partition Eq. 8 difficulties into classes: class k <=> alpha in
    (edges[k-1], edges[k]].  Host inputs (python scalars / numpy) stay on
    numpy; tensors stay on their device.  Returns int32 class indices
    shaped like ``alpha``."""
    if isinstance(alpha, torch.Tensor):
        e = torch.tensor(edges, dtype=torch.float32, device=alpha.device)
        return (alpha[..., None] > e).sum(dim=-1).to(torch.int32)
    a = np.asarray(alpha, np.float32)
    e = np.asarray(edges, np.float32)
    return np.sum(a[..., None] > e, axis=-1).astype(np.int32)


# ---------------------------------------------------------------------------
# FLOPs of the estimator (paper section III.B overhead comparison)
# ---------------------------------------------------------------------------

def estimator_flops(h: int, w: int, c: int = 3) -> int:
    """Per-image FLOPs of the difficulty estimator (conv MACs x2 +
    pointwise), counted as the JAX package counts them.

    Paper reports 78.9 KFLOPs for its configuration; RACENet-style adaptive
    normalization costs 3.96 MFLOPs (50.3x more)."""
    gray = h * w * (2 * c - 1) if c == 3 else h * w * c
    hv, wv = h - 2, w - 2
    sobel = 2 * hv * wv * 9 * 2            # two 3x3 convs
    mag = hv * wv * 3                      # square, add, sqrt
    edge_thresh = hv * wv + hv * wv        # compare + mean
    var = 4 * h * w * c                    # mean + centered square + mean
    lap = hv * wv * 9 * 2 + 2 * hv * wv    # conv + |.| + mean
    return int(gray + sobel + mag + edge_thresh + var + lap + 16)
