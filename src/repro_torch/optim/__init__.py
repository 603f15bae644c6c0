"""Optimizers, schedules and gradient accumulation over the port's
params tree (``repro/optim`` written out in torch)."""
from repro_torch.optim.accumulate import GradAccumulator, value_and_grad
from repro_torch.optim.optimizers import (Optimizer, OptimizerState,
                                          adamw, apply_mask,
                                          clip_by_global_norm, global_norm,
                                          sgd, trainable_mask)
from repro_torch.optim.schedules import constant, linear_decay, warmup_cosine

__all__ = ["adamw", "sgd", "OptimizerState", "Optimizer",
           "clip_by_global_norm", "global_norm", "trainable_mask",
           "apply_mask", "warmup_cosine", "constant", "linear_decay",
           "GradAccumulator", "value_and_grad"]
