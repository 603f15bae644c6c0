"""The Eq. 16 exit head of the paper's transformer testbeds:
``ExitBlock_ViT(T) = MLP(LayerNorm(GlobalPool(T)))``.

LeViT's early exits use it.  The ViT family itself waits for a later
slice (ROADMAP queue 1).  The head keeps the JAX package's forms:
layernorm in float32 with eps 1e-6, then ``fc1``, the tanh GELU and
``fc2``.
"""
from __future__ import annotations

from repro_torch.models import layers as L


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
        h = L.global_avg_pool(tokens)
    h = L.layernorm(p["norm"], h)
    return L.linear(p["fc2"], L.gelu(L.linear(p["fc1"], h)))
