"""convnext-b — ConvNeXt-Base [arXiv:2201.03545], as the JAX package's
``configs/convnext_b.py`` states it: depths 3-3-27-3, dims
128-256-512-1024, exits after stages 0, 1 and 2, bf16 parameters and
compute, 224x224 images."""
import dataclasses

import torch

from repro_torch.models.convnext import ConvNeXtConfig

CONFIG = ConvNeXtConfig(
    name="convnext-b", depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024),
    img_res=224, n_classes=1000, exit_stages=(0, 1, 2),
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
)

REDUCED = dataclasses.replace(
    CONFIG, depths=(1, 1, 2, 1), dims=(16, 32, 48, 64), img_res=32,
    n_classes=10, param_dtype=torch.float32, compute_dtype=torch.float32)
