"""granite-moe-3b-a800m — the JAX package's
``configs/granite_moe_3b_a800m.py``, field for field.

Its numbers are those of ``ibm-granite/granite-3.0-3b-a800m-base``
(Hugging Face ``config.json``): 32 layers, d_model 1536, 24 heads (GQA
kv=8, head dim 64), a MoE FFN in every layer (40 experts of d_ff 512,
top-8, no shared expert), vocab 49155, tied embeddings.  The JAX file
cites ``granite-3.0-1b-a400m-base``, a smaller model of the same family.
Granite's muP multipliers (embedding,
attention, residual, logits scaling) are not in the reference, and the
port adds none.  Exits after layers 7, 15 and 23; bf16 parameters and
compute, ``remat``.  ``moe_ep_mode="tp"`` names the JAX package's mesh
layout (40 experts do not divide 16 shards); without a mesh it is
ignored.
"""
import dataclasses

import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer_lm import LMConfig

CONFIG = LMConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512, n_shared=0),
    moe_ep_mode="tp", n_dense_layers=0, exit_layers=(7, 15, 23),
    max_seq=4096, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True, tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=256, moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, n_shared=0),
    exit_layers=(0,), max_seq=128, remat=False,
    param_dtype=torch.float32, compute_dtype=torch.float32)
