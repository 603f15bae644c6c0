"""internlm2-20b — GQA [arXiv:2403.17297], as the JAX package's
``configs/internlm2_20b.py`` states it.

48L, d_model 6144, 48 heads (GQA kv=8, head dim 128), d_ff 16384,
vocab 92544; exits after layers 11, 23 and 35; rope theta 1e6; bf16
parameters and compute, untied unembed, ``remat``.
"""
import dataclasses

import torch

from repro_torch.models.transformer_lm import LMConfig

CONFIG = LMConfig(
    name="internlm2-20b", n_layers=48, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=16384, vocab=92544, exit_layers=(11, 23, 35),
    max_seq=4096, rope_theta=1000000.0, param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16, remat=True, tie_embeddings=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
    vocab=256, exit_layers=(1,), max_seq=128, remat=False,
    rope_theta=10000.0, param_dtype=torch.float32,
    compute_dtype=torch.float32)
