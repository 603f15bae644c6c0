"""Optimizers as functions over the port's params tree: SGD (+momentum)
and AdamW, written out as the JAX package computes them.

    opt = adamw(schedule, weight_decay=0.01, mask=trainable_mask(params))
    state = opt.init(params)
    params, state = opt.update(grads, state, params)

They are not ``torch.optim``'s: the same float32 chain, op for op
(moments, bias corrections ``1 - b**step`` and ``lr_t`` in float32,
``p - lr_t * u`` cast back to the param dtype), rounds the same way on
both sides.  Two quirks of the reference are kept: ``sgd`` takes the
learning rate at ``state.step`` and ``adamw`` at ``step + 1``, so under
a warmup from 0 SGD's first step moves nothing; weight decay applies to
every trainable leaf, biases and batchnorm scales too.  Masked leaves
(the batchnorm running statistics, picked by key: the port's tree has no
axes) get zero updates.  ``update`` records no autograd graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.convert import leaves, tree_map
from repro_torch.models.batchnorm import STATS_KEYS


@dataclasses.dataclass
class OptimizerState:
    step: int
    inner: Any

    #: flatten order for ``repro_torch.checkpoint``: the JAX package's
    #: ``(step, inner)``; the int step is a 0-d int32 leaf on disk
    CKPT_FIELDS = ("step", "inner")


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm):
    """(tree scaled by ``min(1, max_norm / (norm + 1e-9))``, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree), norm


def trainable_mask(params):
    """True for trainable leaves; False for the running statistics."""
    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return key not in STATS_KEYS
    return walk(params)


def apply_mask(updates, mask):
    if mask is None:
        return updates
    return tree_map(lambda u, m: u if m else torch.zeros_like(u), updates,
                    mask)


def _to_lr(lr, step):
    return _f32(lr(step) if callable(lr) else lr)


def sgd(lr, momentum: float = 0.9, *, nesterov=False, weight_decay=0.0,
        max_grad_norm: float | None = None, mask=None) -> Optimizer:
    def init(params):
        return OptimizerState(
            step=0, inner={"mom": tree_map(torch.zeros_like, params)})

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        lr_t = _to_lr(lr, state.step)
        mom = tree_map(lambda m, g: momentum * m + g.to(m.dtype),
                       state.inner["mom"], grads)
        upd = tree_map(lambda m, g: momentum * m + g if nesterov else m,
                       mom, grads)
        if weight_decay:
            upd = tree_map(lambda u, p: u + weight_decay * p, upd, params)
        upd = apply_mask(upd, mask)
        new = tree_map(lambda p, u: (p.float() - lr_t * u.float()
                                     ).to(p.dtype), params, upd)
        return new, OptimizerState(state.step + 1, {"mom": mom})

    return Optimizer(init, update)


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
          max_grad_norm: float | None = 1.0, mask=None) -> Optimizer:
    """AdamW with decoupled weight decay and float32 moments."""
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return OptimizerState(step=0, inner={"m": tree_map(zeros, params),
                                             "v": tree_map(zeros, params)})

    @torch.no_grad()
    def update(grads, state, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr_t = _to_lr(lr, step)
        bc1 = 1.0 - _f32(b1) ** _f32(step)
        bc2 = 1.0 - _f32(b2) ** _f32(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state.inner["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                     state.inner["v"], grads)

        def upd(m_, v_, p):
            return (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps) \
                + weight_decay * p.float()

        updates = apply_mask(tree_map(upd, m, v, params), mask)
        new = tree_map(lambda p, u: (p.float() - lr_t * u).to(p.dtype),
                       params, updates)
        return new, OptimizerState(step, {"m": m, "v": v})

    return Optimizer(init, update)
