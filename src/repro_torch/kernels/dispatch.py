"""The port's public fused ops, with the backend chosen by device.

A tensor on the CPU takes the plain torch version (``ref.py`` beside
each kernel).  A tensor on a CUDA device launches the hand-written
kernel, or raises: there is no environment switch, no forced scope and
no fallback to the plain version on a card.  Any other device raises.

    exit_gate(logits, thresholds)        (conf, entropy, pred, fire)
    softmax_confidence(logits)           (conf, pred) over (..., V)
    difficulty_components(images, cfg)   (B, 4) Eq. 1-8 statistics
    image_difficulty(images, cfg)        (B,) fused Eq. 8 alpha
    exit_head_gate(h, scale, table, th)  (conf, pred, fire) of an LM exit
    paged_gather(pages, page_table)      dense (S, P*psz, ...) KV view

``launch_counts()`` reports how many times each kernel was launched
since ``reset_launch_counts()``; the plain versions are not counted.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.difficulty import kernel as _difficulty
from repro_torch.kernels.difficulty import ref as _difficulty_ref
from repro_torch.kernels.exit_gate import kernel as _gate
from repro_torch.kernels.exit_gate import ref as _gate_ref
from repro_torch.kernels.exit_head import kernel as _head
from repro_torch.kernels.exit_head import ref as _head_ref
from repro_torch.kernels.paged_gather import kernel as _paged
from repro_torch.kernels.paged_gather import ref as _paged_ref

_WRAPPERS = {"exit_gate": _gate, "difficulty": _difficulty,
             "exit_head": _head, "paged_gather": _paged}


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0


def _on_cpu(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{op}: no kernel for device {t.device}")


def exit_gate(logits: torch.Tensor, thresholds: torch.Tensor):
    """Fused (conf, entropy, pred, fire).  logits (B, V), thresholds (B,)
    float32 — the Eq. 19 difficulty-adapted per-sample thresholds."""
    if _on_cpu(logits, "exit_gate"):
        return _gate_ref.ref_exit_gate(logits, thresholds)
    return _gate.exit_gate_cuda(logits, thresholds)


def softmax_confidence(logits: torch.Tensor):
    """(conf, pred) over (..., V) — the gate without a threshold."""
    if _on_cpu(logits, "softmax_confidence"):
        return _gate_ref.ref_softmax_confidence(logits)
    lead = logits.shape[:-1]
    flat = logits.reshape(-1, logits.shape[-1]).contiguous()
    ones = torch.ones(flat.shape[0], dtype=torch.float32,
                      device=logits.device)
    conf, _, pred, _ = _gate.exit_gate_cuda(flat, ones)
    return conf.reshape(lead), pred.reshape(lead)


def difficulty_components(images: torch.Tensor, cfg=None) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4): alpha_edge, alpha_var, alpha_grad, alpha
    (Eq. 8)."""
    from repro_torch.core.difficulty import DEFAULT
    cfg = DEFAULT if cfg is None else cfg
    kw = dict(tau_edge=cfg.tau_edge, var_scale=cfg.var_scale,
              grad_scale=cfg.grad_scale, w1=cfg.w_edge, w2=cfg.w_variance,
              w3=cfg.w_gradient)
    if _on_cpu(images, "difficulty_components"):
        return _difficulty_ref.ref_components(images, **kw)
    return _difficulty.difficulty_cuda(images, **kw)


def image_difficulty(images: torch.Tensor, cfg=None) -> torch.Tensor:
    """Fused Eq. 8 alpha, (B,)."""
    return difficulty_components(images, cfg)[:, 3]


def exit_head_gate(h: torch.Tensor, scale: torch.Tensor,
                   table: torch.Tensor, thresholds: torch.Tensor, *,
                   eps: float = 1e-6):
    """Fused decode-time exit head for the ``lm-token`` functional:
    rmsnorm -> unembedding -> max-softmax confidence -> Eq. 19 gate.
    h (B, D) hidden rows, scale (D,) rmsnorm weight, table (V, D)
    unembedding, thresholds (B,) float32.  Returns (conf (B,) float32,
    pred (B,) int32, fire (B,) int32); on a card the (B, V) logits are
    never written to device memory."""
    if _on_cpu(h, "exit_head_gate"):
        return _head_ref.ref_exit_head_gate(h, scale, table, thresholds,
                                            eps=eps)
    return _head.exit_head_gate_cuda(h.contiguous(), scale, table,
                                     thresholds, eps=eps)


def paged_gather(pages: torch.Tensor, page_table: torch.Tensor):
    """Dense per-slot view of a paged KV store.  pages (N, psz, ...),
    page_table (S, P) page ids, clamped to [0, N-1].  Returns
    (S, P*psz, ...), bit-identical to a contiguous cache holding the same
    rows."""
    if _on_cpu(pages, "paged_gather"):
        return _paged_ref.ref_paged_gather(pages, page_table)
    return _paged.paged_gather_cuda(
        pages, page_table.to(torch.int32).contiguous())
