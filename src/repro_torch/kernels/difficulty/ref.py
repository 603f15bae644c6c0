"""Plain torch version of the fused difficulty kernel: the Eq. 1-8 chain
of ``repro_torch.core.difficulty``, stacked in the kernel's layout."""
from __future__ import annotations

import torch

from repro_torch.core.difficulty import (DifficultyConfig, edge_density,
                                         fuse, gradient_complexity,
                                         pixel_variance)


def ref_components(images, *, tau_edge=0.1, var_scale=0.05, grad_scale=0.2,
                   w1=0.4, w2=0.3, w3=0.3):
    """(B, H, W, C) -> (B, 4) = (a_edge, a_var, a_grad, alpha)."""
    cfg = DifficultyConfig(w_edge=w1, w_variance=w2, w_gradient=w3,
                           tau_edge=tau_edge, var_scale=var_scale,
                           grad_scale=grad_scale)
    e = edge_density(images, tau_edge)
    v = pixel_variance(images, var_scale)
    g = gradient_complexity(images, grad_scale)
    return torch.stack([e, v, g, fuse(e, v, g, cfg)], dim=1)
