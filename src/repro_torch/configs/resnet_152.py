"""resnet-152 — [arXiv:1512.03385], as the JAX package's
``configs/resnet_152.py`` states it: bottleneck blocks 3-8-36-3, width
64, the 224-pixel ImageNet stem (7x7 stride 2, max pool), exits after
stages 0, 1 and 2, bf16 parameters and compute."""
import dataclasses

import torch

from repro_torch.models.resnet import ResNetConfig

CONFIG = ResNetConfig(
    name="resnet-152", depths=(3, 8, 36, 3), width=64, block="bottleneck",
    img_res=224, n_classes=1000, exit_stages=(0, 1, 2),
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
)

REDUCED = dataclasses.replace(
    CONFIG, depths=(1, 1, 2, 1), width=16, img_res=32, n_classes=10,
    small_input=True, param_dtype=torch.float32, compute_dtype=torch.float32)
