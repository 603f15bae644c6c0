"""vit-h14 — ViT-Huge/14 [arXiv:2010.11929], as the JAX package's
``configs/vit_h14.py`` states it: 32L, d 1280, 16H, ff 5120, exits after
layers 7, 15 and 23, each block recomputed in the backward pass
(``remat``), bf16 parameters and compute, 224x224 images."""
import dataclasses

import torch

from repro_torch.models.vit import ViTConfig

CONFIG = ViTConfig(
    name="vit-h14", img_res=224, patch=14, n_layers=32, d_model=1280,
    n_heads=16, d_ff=5120, n_classes=1000, exit_layers=(7, 15, 23),
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, remat=True,
)

REDUCED = dataclasses.replace(
    CONFIG, img_res=32, patch=8, n_layers=4, d_model=64, n_heads=4,
    d_ff=128, n_classes=10, exit_layers=(1,), remat=False,
    param_dtype=torch.float32, compute_dtype=torch.float32)
