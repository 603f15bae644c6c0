"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385], as the JAX
package's ``configs/tinyllama_1_1b.py`` states it.

22L, d_model 2048, 32 heads (GQA kv=4), d_ff 5632, vocab 32000; exits
after layers 5, 10 and 15; bf16 parameters and compute, untied unembed,
each layer recomputed in the backward pass (``remat``).
"""
import dataclasses

import torch

from repro_torch.models.transformer_lm import LMConfig

CONFIG = LMConfig(
    name="tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=5632, vocab=32000, exit_layers=(5, 10, 15),
    max_seq=4096, rope_theta=10000.0, param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16, remat=True, tie_embeddings=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab=256, exit_layers=(1,), max_seq=128, remat=False,
    param_dtype=torch.float32, compute_dtype=torch.float32)
