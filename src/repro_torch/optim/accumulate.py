"""Gradients of a params tree, and their accumulation over microbatches.

``value_and_grad`` is ``jax.value_and_grad(loss_fn, has_aux=True)`` for
the port's tree: it differentiates every floating leaf, and a leaf that
does not reach the loss (the batchnorm running statistics in train
mode) gets a zero gradient, as in JAX.  The tree handed in is never
marked as requiring grad.
"""
from __future__ import annotations

import torch

from repro_torch.convert import leaves, tree_map


def value_and_grad(loss_fn, params, *args):
    """((loss, aux), grads) of ``loss_fn(params, *args) -> (loss, aux)``;
    the loss and aux come back detached."""
    live = [t.detach().requires_grad_(t.is_floating_point())
            for t in leaves(params)]
    it = iter(live)
    loss, aux = loss_fn(tree_map(lambda _: next(it), params), *args)
    wrt = [t for t in live if t.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))

    def grad_of(t):
        g = next(got) if t.requires_grad else None
        return torch.zeros_like(t) if g is None else g

    grads = iter([grad_of(t) for t in live])
    aux = tree_map(lambda a: a.detach() if torch.is_tensor(a) else a, aux)
    return (loss.detach(), aux), tree_map(lambda _: next(grads), params)


class GradAccumulator:
    """accumulate(loss_fn, params, batch) -> (mean_loss, mean_grads,
    aux of the LAST microbatch): the batchnorm updates of a step with
    ``n_micro > 1`` come from its last microbatch only, as in JAX."""

    def __init__(self, n_micro: int):
        self.n_micro = n_micro

    def split(self, batch):
        """Split a global batch (a tuple of tensors) into n_micro
        microbatches along axis 0."""
        def sp(x):
            b = x.shape[0]
            if b % self.n_micro:
                raise ValueError(f"batch {b} does not split into "
                                 f"{self.n_micro} microbatches")
            return x.reshape(self.n_micro, b // self.n_micro, *x.shape[1:])
        return [sp(x) for x in batch]

    def accumulate(self, loss_fn, params, batch, *args):
        micro = self.split(batch)
        grads = None
        total = 0.0
        aux_last = None
        for i in range(self.n_micro):
            (loss, aux), g = value_and_grad(
                loss_fn, params, tuple(x[i] for x in micro), *args)
            total = total + loss
            aux_last = aux
            grads = g if grads is None else tree_map(torch.add, grads, g)
        scale = 1.0 / self.n_micro
        grads = tree_map(lambda g: g * scale, grads)
        return total * scale, grads, aux_last
