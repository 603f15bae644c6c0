"""vit-s16 — ViT-Small/16 [arXiv:2010.11929], as the JAX package's
``configs/vit_s16.py`` states it: 12L, d 384, 6H, ff 1536, exits after
layers 3 and 7, bf16 parameters and compute, 224x224 images."""
import dataclasses

import torch

from repro_torch.models.vit import ViTConfig

CONFIG = ViTConfig(
    name="vit-s16", img_res=224, patch=16, n_layers=12, d_model=384,
    n_heads=6, d_ff=1536, n_classes=1000, exit_layers=(3, 7),
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
)

REDUCED = dataclasses.replace(
    CONFIG, img_res=32, patch=8, n_layers=3, d_model=48, n_heads=4,
    d_ff=96, n_classes=10, exit_layers=(0,),
    param_dtype=torch.float32, compute_dtype=torch.float32)
