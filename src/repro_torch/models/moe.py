"""Mixture-of-Experts FFN, mesh-less: the port of ``repro/models/moe.py``.

Dispatch is capacity-based (Switch/GShard "dropping"): every token picks
its top-k experts from a float32 router; the (token, choice) pairs are
sorted stably by expert, so each expert's queue is in token order, and an
expert keeps the first ``capacity`` pairs of its queue,

    capacity = min(max(8, ceil(T * k / E * capacity_factor / 8) * 8), T),

dropping the rest (they contribute nothing).  So a token's output
depends on the other rows of the call: which tokens share it, and in
what order.  The kept pairs fill an (E, C, D) buffer, the experts run as
three batched products, and each token sums its k weighted rows.

Numerics as the JAX package writes them:

* the router runs in float32 whatever the model dtype (its weight is a
  float32 leaf), softmax over the experts, top-k with ties to the lower
  expert index (``lax.top_k``'s order: a stable descending sort here,
  since ``torch.topk`` promises no order among ties), the top-k
  probabilities renormalised, and the Switch load-balance loss
  ``E * sum_e f_e * P_e * aux_loss_weight``;
* the combine casts the router probability to the activation dtype
  before the product and sums each token's rows in the expert-sorted
  order, as ``segment_sum`` over that order does.  The sum is a fixed
  sequence of adds (no ``index_add_`` or ``scatter_add_``: on a card
  those are atomic and their last bits move from run to run, and one
  bit can flip a later layer's top-k).

The buffer is filled and read by gathers only: expert e's slot c holds
the sorted pair ``starts[e] + c`` when ``c < min(count_e, capacity)``.
The routing indices carry no gradient, as in JAX; the router's gradient
flows through the top-k probabilities and the aux loss.

The JAX package's ``ep`` / ``tp`` layouts and its all-to-all dispatch are
``shard_map`` bodies over a device mesh (ROADMAP queue 1, item 9).
Without a mesh it ignores ``ep_mode`` and ``dispatch``, and so does the
port.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

EP_MODES = ("ep", "tp")
DISPATCH = ("ar", "a2a")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalise the top-k probabilities
    aux_loss_weight: float = 0.01


def moe_init(gen, d_model: int, cfg: MoEConfig, dtype, *, device):
    """{"router" (D, E) float32, "w_gate"/"w_up" (E, D, F) and "w_down"
    (E, F, D) in ``dtype``, "shared" a SwiGLU of n_shared * F when
    n_shared > 0}: the JAX layout, each leaf truncated normal of std
    0.02 drawn in float32."""
    e, f = cfg.n_experts, cfg.d_ff
    p = {"router": L.trunc_normal((d_model, e), gen, device=device),
         "w_gate": L.trunc_normal((e, d_model, f), gen, device=device,
                                  dtype=dtype),
         "w_up": L.trunc_normal((e, d_model, f), gen, device=device,
                                dtype=dtype),
         "w_down": L.trunc_normal((e, f, d_model), gen, device=device,
                                  dtype=dtype)}
    if cfg.n_shared:
        kw = dict(device=device, dtype=dtype, bias=False)
        p["shared"] = {
            "gate": L.linear_init(gen, d_model, cfg.n_shared * f, **kw),
            "up": L.linear_init(gen, d_model, cfg.n_shared * f, **kw),
            "down": L.linear_init(gen, cfg.n_shared * f, d_model, **kw)}
    return p


def capacity(t: int, cfg: MoEConfig) -> int:
    """Slots per expert for a call of ``t`` tokens (JAX's arithmetic,
    float for float)."""
    c = max(8, int(math.ceil(t * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor / 8.0)) * 8)
    return min(c, t)


def _route(x, router_w, cfg: MoEConfig):
    """Router in float32.  x (T, D).  Returns (probs_topk (T, k), ids_topk
    (T, k) int64, aux_loss)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MoE router runs in float32: switch TF32 "
                           "matmuls off (torch.backends.cuda.matmul."
                           "allow_tf32 = False)")
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    order = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices
    ids = order[:, :cfg.top_k]
    p_top = probs.gather(1, ids)
    if cfg.router_norm_topk:
        p_top = p_top / p_top.sum(dim=-1, keepdim=True)
    # Switch load-balance loss: E * sum_e f_e * P_e, f_e the mean number
    # of a token's choices that went to e
    e = cfg.n_experts
    counts = torch.zeros(e, dtype=torch.float32, device=x.device)
    counts.scatter_add_(0, ids.reshape(-1),
                        torch.ones(ids.numel(), dtype=torch.float32,
                                   device=x.device))
    f_e = counts / x.shape[0]
    p_e = probs.mean(dim=0)
    aux = e * (f_e * p_e).sum() * cfg.aux_loss_weight
    return p_top, ids, aux


def dispatch_plan(ids, cfg: MoEConfig):
    """The capacity dispatch of one call's (T, k) expert ids, on the
    device (no host sync).  Returns a dict of
    ``order`` (T*k,) — the flat (token, choice) pairs stably sorted by
    expert; ``s_eid``, ``s_tok`` — each sorted pair's expert and token;
    ``pos`` — its place in its expert's queue; ``keep`` — pos < capacity;
    ``starts`` (E,) — each queue's first sorted pair; ``capacity``."""
    t, k = ids.shape
    e = cfg.n_experts
    c = capacity(t, cfg)
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    s_eid = flat[order]
    s_tok = order // k                       # flat pair (t, j) -> t
    counts = torch.zeros(e, dtype=torch.long, device=ids.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=ids.device) - starts[s_eid]
    return {"order": order, "s_eid": s_eid, "s_tok": s_tok, "pos": pos,
            "keep": pos < c, "starts": starts, "counts": counts,
            "capacity": c}


def _expert_compute_local(x, p_top, ids, w_gate, w_up, w_down,
                          cfg: MoEConfig):
    """Capacity dispatch to all E experts, differentiable.  x (T, D),
    p_top/ids (T, k), w_* (E, D, F) / (E, F, D).  Returns (T, D) in x's
    dtype."""
    t, d = x.shape
    k = cfg.top_k
    e = w_gate.shape[0]
    plan = dispatch_plan(ids, cfg)
    c = plan["capacity"]
    s_tok, keep = plan["s_tok"], plan["keep"]

    # slot (e, c) <- sorted pair starts[e] + c, if that pair is kept
    slot_c = torch.arange(c, device=x.device)
    src = plan["starts"][:, None] + slot_c[None, :]            # (E, C)
    filled = slot_c[None, :] < plan["counts"][:, None]
    src_tok = s_tok[src.clamp(max=t * k - 1)]
    xe = torch.where(filled[..., None], x[src_tok],
                     x.new_zeros(()))                          # (E, C, D)

    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)                                  # (E, C, D)

    # each sorted pair's row back, weighted by its router probability
    # (cast to the activation dtype), dropped pairs times 0
    y_slots = ye.reshape(e * c, d)
    slot = torch.where(keep, plan["s_eid"] * c + plan["pos"], e * c - 1)
    s_prob = p_top.reshape(-1)[plan["order"]]
    w = (s_prob * keep.to(s_prob.dtype)).to(y_slots.dtype)
    y_routed = y_slots[slot] * w[:, None]                      # (T*k, D)

    # token t sums its k rows in sorted order (segment_sum's order)
    inv = torch.argsort(plan["order"])
    rows = torch.sort(inv.reshape(t, k), dim=1).values
    mine = y_routed[rows]                                      # (T, k, D)
    out = mine[:, 0]
    for j in range(1, k):
        out = out + mine[:, j]
    return out.to(x.dtype)


def moe_apply(p, x, cfg: MoEConfig, *, ep_mode: str = "ep",
              dispatch: str = "ar"):
    """Apply the MoE FFN.  x (B, S, D) or (T, D); the tokens of one call
    share the experts' capacity in row-major order.  Returns (out of x's
    shape, aux_loss)."""
    if ep_mode not in EP_MODES:
        raise ValueError(f"ep_mode {ep_mode!r}; known: {EP_MODES}")
    if dispatch not in DISPATCH:
        raise ValueError(f"dispatch {dispatch!r}; known: {DISPATCH}")
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    p_top, ids, aux = _route(x, p["router"], cfg)
    out = _expert_compute_local(x, p_top, ids, p["w_gate"], p["w_up"],
                                p["w_down"], cfg)
    if "shared" in p:
        out = out + L.swiglu(p["shared"], x)
    return out.reshape(shape), aux


def moe_flops(tokens: int, d_model: int, cfg: MoEConfig) -> int:
    """Analytic forward FLOPs of the routed and shared experts and the
    router."""
    routed = tokens * cfg.top_k * (3 * 2 * d_model * cfg.d_ff)
    shared = tokens * cfg.n_shared * (3 * 2 * d_model * cfg.d_ff)
    router = tokens * 2 * d_model * cfg.n_experts
    return routed + shared + router
