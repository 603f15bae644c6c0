"""LLaMA-family language models with early-exit heads (GQA attention,
dense or MoE FFN).

The port of ``repro/models/transformer_lm.py`` for the GQA configs
(TinyLlama-1.1B, InternLM2-20B, and granite-moe-3b-a800m with a MoE FFN
in every layer past ``n_dense_layers``, ``models/moe.py``): the config,
the init (per layer, or with ``layer_scan`` the layers between exits
stacked into ``"segments"`` after the unstacked dense prefix), the full
forward with ``remat`` and chunked attention, the Eq. 18 multi-exit
loss over a chunked-vocabulary cross-entropy plus the MoE load-balance
loss, the KV cache with prefill (also per stacked segment) and
one-token decode, the exit heads (RMSNorm + unembedding), the CALM KV
propagation of an exited row, and the analytic parameter and FLOP
counts.  MLA attention and the MTP head are ROADMAP queue 1, item 6c: a
config asking for them raises.

Parameters are a dict tree in the JAX layout (``convert.from_jax_params``
maps the JAX tree onto it without transposes):

    embed.table (V, D); layers[i].{attn_norm, ffn_norm}.scale (D,);
    layers[i].attn.{wq (D, H, Dh), wk, wv (D, Hkv, Dh), wo (H, Dh, D)};
    layers[i].ffn.{gate, up}.w (D, F), ffn.down.w (F, D) in a dense
    layer, layers[i].moe.{router (D, E) float32, w_gate, w_up (E, D, F),
    w_down (E, F, D)} in a MoE layer;
    final_norm.scale; exit_heads[str(layer)].norm.scale; unembed (V, D)
    when the embeddings are untied.  Under ``layer_scan``,
    ``segments[k]`` holds the layers of ``scan_segments(cfg)[k]`` with
    each leaf stacked on a new leading axis (L_k, ...), and ``layers``
    holds the ``n_dense_layers`` leading dense layers.

A "scan" here is a Python loop over the stacked leading axis; ``remat``
wraps each layer in ``torch.utils.checkpoint`` (recomputed in the
backward pass) where JAX wraps it in ``jax.checkpoint``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as DEV
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                              # dense FFN hidden dim
    vocab: int
    head_dim: int | None = None
    exit_layers: tuple[int, ...] = ()      # exit after these layer indices
    max_seq: int = 4096
    rope_theta: float = 10000.0
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    tie_embeddings: bool = True
    remat: bool = True
    attn_chunked: bool = False
    q_chunk: int = 1024
    kv_chunk: int = 2048
    # stack the layers between exit boundaries into "segments", run as a
    # loop over the stacked axis (train and prefill paths only)
    layer_scan: bool = False
    attn_kind: str = "gqa"                 # "mla": ROADMAP item 6c
    moe: MOE.MoEConfig | None = None
    moe_ep_mode: str = "ep"                # mesh layouts: item 9
    n_dense_layers: int = 0                # leading dense layers
    moe_dispatch: str = "ar"               # mesh dispatch: item 9
    mtp: bool = False                      # multi-token prediction: 6c

    def __post_init__(self):
        if self.attn_kind != "gqa" or self.mtp:
            raise NotImplementedError(
                f"{self.name}: MLA attention and the MTP head are not "
                "ported yet (ROADMAP queue 1, item 6c)")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_exits(self) -> int:
        return len(self.exit_layers) + 1   # + final head

    def layer_is_moe(self, i: int) -> bool:
        return self.moe is not None and i >= self.n_dense_layers


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _generator(seed: int, device) -> torch.Generator | None:
    """A seeded generator on ``device``; none for "meta", where init only
    builds shapes."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _trunc(shape, gen, std, cfg, device):
    """Truncated normal (cut at 2 std) drawn in float32, then cast to the
    param dtype, as the JAX init does."""
    return L.trunc_normal(shape, gen, std=std, device=device).to(
        cfg.param_dtype)


def _ones(dim, cfg, device):
    return {"scale": torch.ones(dim, dtype=cfg.param_dtype, device=device)}


def _layer_init(gen, cfg: LMConfig, device, i: int):
    d, hd = cfg.d_model, cfg.hd
    p = {
        "attn_norm": _ones(d, cfg, device),
        "ffn_norm": _ones(d, cfg, device),
        "attn": {
            "wq": _trunc((d, cfg.n_heads, hd), gen, 0.02, cfg, device),
            "wk": _trunc((d, cfg.n_kv_heads, hd), gen, 0.02, cfg, device),
            "wv": _trunc((d, cfg.n_kv_heads, hd), gen, 0.02, cfg, device),
            "wo": _trunc((cfg.n_heads, hd, d), gen, 0.02, cfg, device)},
    }
    if cfg.layer_is_moe(i):
        p["moe"] = MOE.moe_init(gen, d, cfg.moe, cfg.param_dtype,
                                device=device)
    else:
        p["ffn"] = {
            "gate": {"w": _trunc((d, cfg.d_ff), gen, 0.02, cfg, device)},
            "up": {"w": _trunc((d, cfg.d_ff), gen, 0.02, cfg, device)},
            "down": {"w": _trunc((cfg.d_ff, d), gen, 0.02, cfg, device)}}
    return p


def scan_segments(cfg: LMConfig) -> list[tuple[int, int]]:
    """[start, end) layer ranges of the stacked segments: from the first
    layer past the ``n_dense_layers`` leading dense ones (kept unstacked,
    as in JAX), split at the exit boundaries so every exit lands between
    two segments."""
    bounds = [cfg.n_dense_layers]
    bounds += [e + 1 for e in sorted(cfg.exit_layers)
               if e + 1 > cfg.n_dense_layers]
    bounds.append(cfg.n_layers)
    return [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def _stack(trees):
    """Stack a list of identical param trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unstack(tree, j: int):
    """Layer ``j`` of a stacked segment tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _unstack(v, j) for k, v in tree.items()}
    return tree[j]


def lm_init(cfg: LMConfig, *, seed: int = 0, device=None):
    """Seeded random parameters drawn on ``device`` (``None``: the CUDA
    card), so a 1.1 B-parameter model never passes through the host.
    The JAX init's distributions (embedding std 0.01, everything else
    std 0.02, norms at 1), not its numbers.  With ``layer_scan`` the
    layers are drawn in the same order and stacked per segment, so the
    stacked tree holds the non-scan init's numbers."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else DEV.resolve(device)
    gen = _generator(seed, dev)
    layers = [_layer_init(gen, cfg, dev, i) for i in range(cfg.n_layers)]
    p = {
        "embed": {"table": _trunc((cfg.vocab, cfg.d_model), gen, 0.01, cfg,
                                  dev)},
        "layers": layers,
        "final_norm": _ones(cfg.d_model, cfg, dev),
        "exit_heads": {str(i): {"norm": _ones(cfg.d_model, cfg, dev)}
                       for i in cfg.exit_layers},
    }
    if not cfg.tie_embeddings:
        p["unembed"] = _trunc((cfg.vocab, cfg.d_model), gen, 0.02, cfg, dev)
    if cfg.layer_scan:
        p["layers"] = layers[:cfg.n_dense_layers]
        p["segments"] = [_stack(layers[a:b]) for a, b in scan_segments(cfg)]
    return p


# ---------------------------------------------------------------------------
# Forward and the Eq. 18 training loss
# ---------------------------------------------------------------------------

def ffn_apply(p, h, cfg: LMConfig):
    """The FFN of one layer on its normed input: the MoE of a MoE layer
    (the layer's tree has "moe"), else the dense SwiGLU.  Returns (out,
    the MoE load-balance loss, None in a dense layer)."""
    if "moe" in p:
        return MOE.moe_apply(p["moe"], h, cfg.moe, ep_mode=cfg.moe_ep_mode,
                             dispatch=cfg.moe_dispatch)
    return L.swiglu(p["ffn"], h), None


def _layer_apply(p, x, cos, sin, cfg: LMConfig):
    h = L.rmsnorm(p["attn_norm"], x)
    x = x + L.gqa_apply(p["attn"], h, cos, sin, causal=True,
                        chunked=cfg.attn_chunked, q_chunk=cfg.q_chunk,
                        kv_chunk=cfg.kv_chunk)
    f, aux = ffn_apply(p, L.rmsnorm(p["ffn_norm"], x), cfg)
    return x + f, aux


def _layer_fn(cfg: LMConfig):
    """One layer, returning (x, aux), recomputed in the backward pass
    under ``remat`` (only where autograd records: a no-grad forward has
    nothing to save)."""
    if cfg.remat and torch.is_grad_enabled():
        return lambda p, x, cos, sin: checkpoint(
            _layer_apply, p, x, cos, sin, cfg, use_reentrant=False)
    return lambda p, x, cos, sin: _layer_apply(p, x, cos, sin, cfg)


def _layer_params(params, cfg: LMConfig):
    """(layer index, layer params) in depth order, for either tree."""
    yield from enumerate(params["layers"])
    if not cfg.layer_scan:
        return
    for k, (a, b) in enumerate(scan_segments(cfg)):
        for j in range(b - a):
            yield a + j, _unstack(params["segments"][k], j)


def lm_forward(params, token_ids, cfg: LMConfig, *, collect_exits=True):
    """Full forward of (B, S) tokens.  Returns a dict with
    ``exit_hidden`` — list of (B, S, D), one per early exit and the
    final one; ``aux_loss`` — the MoE load-balance loss summed over the
    layers (0 for a dense config); ``final_hidden``.  Exit logits are
    left to the loss (the vocabulary projection is the expensive part;
    chunked there)."""
    s = token_ids.shape[1]
    cos, sin = L.rope_freqs(cfg.hd, max(s, cfg.max_seq), cfg.rope_theta,
                            device=token_ids.device)
    x = L.embed(params["embed"], token_ids).to(cfg.compute_dtype)
    layer = _layer_fn(cfg)
    exit_hidden = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in _layer_params(params, cfg):
        x, aux = layer(p, x, cos, sin)
        if aux is not None:
            aux_total = aux_total + aux
        if collect_exits and i in cfg.exit_layers:
            exit_hidden.append(x)
    exit_hidden.append(x)
    return {"exit_hidden": exit_hidden, "aux_loss": aux_total,
            "final_hidden": x}


def chunked_xent(params, cfg: LMConfig, h, labels, exit_name: str,
                 n_chunks: int = 8):
    """Mean cross-entropy of exit ``exit_name`` against ``labels`` (B, S),
    the vocabulary projection computed over sequence chunks (one chunk's
    (B, S/n, V) logits at a time).  The gold logit is a row-gather of the
    unembedding table dotted with the normed hidden row, as the JAX
    package computes it (never a gather from the logits)."""
    b, s, _ = h.shape
    n_chunks = min(n_chunks, s)
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    table = _unembed_table(params, cfg)
    norm = params["final_norm"] if exit_name == "final" \
        else params["exit_heads"][exit_name]["norm"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        hc = L.rmsnorm(norm, h[:, c * cs:(c + 1) * cs])
        logits = torch.einsum("bsd,vd->bsv", hc, table).float()
        lab = labels[:, c * cs:(c + 1) * cs].long()
        lse = torch.logsumexp(logits, dim=-1)
        gold_rows = table[lab].float()
        gold = torch.einsum("bsd,bsd->bs", hc.float(), gold_rows)
        total = total + (lse - gold).sum()
    return total / (b * s)


def lm_multi_exit_loss(params, token_ids, labels, cfg: LMConfig, *,
                       policy_weight: float = 0.01, xent_chunks: int = 8):
    """Paper Eq. 18: L = sum_i w_i CE(y, y_i) + lambda L_policy with
    w_i = i / N, where L_policy = sum over early exits of
    max(CE_i - CE_final, 0) (early heads much worse than the last one
    mean overuse of later exits).  Returns (loss, {"ce_per_exit",
    "aux_loss"})."""
    out = lm_forward(params, token_ids, cfg)
    n = cfg.n_exits
    names = [str(i) for i in cfg.exit_layers] + ["final"]
    total = torch.zeros((), dtype=torch.float32, device=token_ids.device)
    ces = []
    for rank, (name, h) in enumerate(zip(names, out["exit_hidden"]),
                                     start=1):
        ce = chunked_xent(params, cfg, h, labels, name, xent_chunks)
        ces.append(ce)
        total = total + (rank / n) * ce
    if len(ces) > 1:
        policy = sum(torch.clamp(ce - ces[-1], min=0.0) for ce in ces[:-1])
    else:
        policy = torch.zeros((), dtype=torch.float32, device=total.device)
    total = total + policy_weight * policy + out["aux_loss"]
    return total, {"ce_per_exit": ces, "aux_loss": out["aux_loss"]}


# ---------------------------------------------------------------------------
# Exit heads
# ---------------------------------------------------------------------------

def _unembed_table(params, cfg: LMConfig):
    if cfg.tie_embeddings:
        return params["embed"]["table"]
    return params["unembed"]


def exit_logits(params, cfg: LMConfig, h, exit_name: str):
    """Logits for one exit head (or "final")."""
    if exit_name == "final":
        hn = L.rmsnorm(params["final_norm"], h)
    else:
        hn = L.rmsnorm(params["exit_heads"][exit_name]["norm"], h)
    return torch.einsum("...d,vd->...v", hn, _unembed_table(params, cfg))


# ---------------------------------------------------------------------------
# KV cache: prefill and CALM propagation
# ---------------------------------------------------------------------------

def lm_init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, *,
                  device):
    dtype = dtype or cfg.compute_dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _fill_cache_gqa(p, x, cos, sin, cache):
    """Write the prompt's K/V rows [0, S) into ``cache`` in place."""
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    k = L.apply_rope(k, cos, sin)
    s = x.shape[1]
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    return cache


def lm_prefill(params, token_ids, cfg: LMConfig, cache):
    """Process the prompt (B, S), filling the KV cache in place.  Returns
    (cache, exit hidden states at the last position, list[(B, D)])."""
    s = token_ids.shape[1]
    dev = token_ids.device
    cos, sin = L.rope_freqs(cfg.hd, max(s, cfg.max_seq), cfg.rope_theta,
                            device=dev)
    x = L.embed(params["embed"], token_ids).to(cfg.compute_dtype)
    exit_h = []
    for i in range(cfg.n_layers):
        p = params["layers"][i]
        h = L.rmsnorm(p["attn_norm"], x)
        a = L.gqa_apply(p["attn"], h, cos, sin, causal=True,
                        chunked=cfg.attn_chunked, q_chunk=cfg.q_chunk,
                        kv_chunk=cfg.kv_chunk)
        _fill_cache_gqa(p["attn"], h, cos, sin, cache[i])
        x = x + a
        x = x + ffn_apply(p, L.rmsnorm(p["ffn_norm"], x), cfg)[0]
        if i in cfg.exit_layers:
            exit_h.append(x[:, -1])
    exit_h.append(x[:, -1])
    return cache, exit_h


def lm_prefill_scan(params, token_ids, cfg: LMConfig):
    """Prefill of a ``layer_scan`` tree: the caches of a stacked segment
    come out stacked (L_k, B, S, Hkv, Dh), as JAX's scan ys.  Returns
    (the unstacked dense prefix's caches, a list of {"k", "v"}; the
    segments' caches, a list of stacked {"k", "v"}; exit hidden states
    at the last position list[(B, D)])."""
    s = token_ids.shape[1]
    cos, sin = L.rope_freqs(cfg.hd, max(s, cfg.max_seq), cfg.rope_theta,
                            device=token_ids.device)
    x = L.embed(params["embed"], token_ids).to(cfg.compute_dtype)

    def layer_with_cache(p, h):
        hn = L.rmsnorm(p["attn_norm"], h)
        a = L.gqa_apply(p["attn"], hn, cos, sin, causal=True,
                        chunked=cfg.attn_chunked, q_chunk=cfg.q_chunk,
                        kv_chunk=cfg.kv_chunk)
        k = L.apply_rope(torch.einsum("bsd,dhk->bshk", hn, p["attn"]["wk"]),
                         cos, sin)
        v = torch.einsum("bsd,dhk->bshk", hn, p["attn"]["wv"])
        h = h + a
        h = h + ffn_apply(p, L.rmsnorm(p["ffn_norm"], h), cfg)[0]
        return h, {"k": k, "v": v}

    dense_caches, exit_h, seg_caches = [], [], []
    for i, p in enumerate(params["layers"]):
        x, cache = layer_with_cache(p, x)
        dense_caches.append(cache)
        if i in cfg.exit_layers:
            exit_h.append(x[:, -1])
    for k, (a, bnd) in enumerate(scan_segments(cfg)):
        ys = []
        for j in range(bnd - a):
            x, cache = layer_with_cache(_unstack(params["segments"][k], j),
                                        x)
            ys.append(cache)
        seg_caches.append(_stack(ys))
        if (bnd - 1) in cfg.exit_layers:
            exit_h.append(x[:, -1])
    exit_h.append(x[:, -1])
    return dense_caches, seg_caches, exit_h


def lm_decode_step(params, token_ids, cache, cache_index: int,
                   cfg: LMConfig):
    """One masked-mode decode step: every layer runs (the worst-case
    roofline), Alg. 1 gating is left to the caller.  token_ids (B, 1);
    ``cache`` is written in place at ``cache_index``.  Returns (exit
    hidden states list[(B, D)], one per exit and the final one,
    cache)."""
    max_len = cache[0]["k"].shape[1]
    cos, sin = L.rope_freqs(cfg.hd, max_len, cfg.rope_theta,
                            device=token_ids.device)
    x = L.embed(params["embed"], token_ids).to(cfg.compute_dtype)
    exit_h = []
    for i in range(cfg.n_layers):
        p = params["layers"][i]
        a, _ = L.gqa_decode(p["attn"], L.rmsnorm(p["attn_norm"], x), cos,
                            sin, cache[i], cache_index)
        x = x + a
        x = x + ffn_apply(p, L.rmsnorm(p["ffn_norm"], x), cfg)[0]
        if i in cfg.exit_layers:
            exit_h.append(x[:, 0])
    exit_h.append(x[:, 0])
    return exit_h, cache


def lm_kv_project(params, h_exit, cfg: LMConfig, cache, cache_index,
                  from_layer: int, *, positions=None, max_len=None):
    """Per-layer K/V projections of a frozen exit hidden state (the CALM
    propagation math).  ``cache`` is only probed for ``max_len``; returns
    a list over layers [from_layer, n_layers) of {"k", "v"} rows shaped
    (B', 1, Hkv, Dh).  The paged step passes per-slot ``positions`` (B,)
    and the view length as ``max_len``; ``cache``/``cache_index`` may
    then be None."""
    if max_len is None:
        max_len = cache[0]["k"].shape[1]
    dev = h_exit.device
    cos, sin = L.rope_freqs(cfg.hd, max_len, cfg.rope_theta, device=dev)
    if positions is None:
        positions = torch.full((h_exit.shape[0], 1), cache_index,
                               dtype=torch.long, device=dev)
    elif positions.dim() == 1:
        positions = positions[:, None]
    positions = positions.long()
    x = h_exit[:, None, :]
    rows = []
    for i in range(from_layer, cfg.n_layers):
        p = params["layers"][i]
        hn = L.rmsnorm(p["attn_norm"], x)
        k = torch.einsum("bsd,dhk->bshk", hn, p["attn"]["wk"])
        v = torch.einsum("bsd,dhk->bshk", hn, p["attn"]["wv"])
        rows.append({"k": L.apply_rope(k, cos, sin, positions), "v": v})
    return rows


def lm_kv_propagate(params, h_exit, cfg: LMConfig, cache, cache_index,
                    from_layer: int):
    """CALM-style state propagation: after rows exit at ``from_layer``,
    fill the deeper layers' caches (in place) at ``cache_index`` from the
    frozen exit hidden state, so later tokens can attend to this
    position."""
    rows = lm_kv_project(params, h_exit, cfg, cache, cache_index,
                         from_layer)
    for i, r in zip(range(from_layer, cfg.n_layers), rows):
        for name, val in r.items():
            cache[i][name][:, cache_index] = val[:, 0].to(
                cache[i][name].dtype)
    return cache


# ---------------------------------------------------------------------------
# Analytic parameter and FLOP counts
# ---------------------------------------------------------------------------

def _moe_params(cfg: LMConfig) -> int:
    m = cfg.moe
    return (cfg.d_model * m.n_experts
            + (m.n_experts + m.n_shared) * 3 * cfg.d_model * m.d_ff)


def lm_param_count(cfg: LMConfig) -> int:
    """Parameters but the final and exit-head norms, as JAX counts."""
    d, v = cfg.d_model, cfg.vocab
    emb = v * d
    attn = d * cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
        + cfg.n_heads * cfg.hd * d
    total = emb if cfg.tie_embeddings else 2 * emb
    for i in range(cfg.n_layers):
        total += attn + 2 * d
        total += (_moe_params(cfg) if cfg.layer_is_moe(i)
                  else 3 * d * cfg.d_ff)
    return total


def lm_active_param_count(cfg: LMConfig) -> int:
    """Parameters a token uses: all of them in a dense config; a MoE
    layer's top-k and shared experts only."""
    if cfg.moe is None:
        return lm_param_count(cfg)
    m = cfg.moe
    n_moe = cfg.n_layers - cfg.n_dense_layers
    return lm_param_count(cfg) \
        - n_moe * (m.n_experts - m.top_k) * 3 * cfg.d_model * m.d_ff


def lm_forward_flops(cfg: LMConfig, batch: int, seq: int,
                     n_exits_computed: int | None = None,
                     kv_len: int | None = None) -> int:
    """Analytic forward FLOPs (2 x MACs), the attention's quadratic term
    included; ``kv_len`` set means a decode step (``seq`` tokens, each
    attending ``kv_len`` positions)."""
    d, t = cfg.d_model, batch * seq
    h, hd, kv = cfg.n_heads, cfg.hd, cfg.n_kv_heads
    attn_ctx = kv_len if kv_len is not None else seq / 2
    attn = (2 * t * d * hd * (h + 2 * kv) + 2 * t * h * hd * d
            + 2 * 2 * t * h * hd * attn_ctx)
    fl = 0
    for i in range(cfg.n_layers):
        fl += attn
        fl += (MOE.moe_flops(t, d, cfg.moe) if cfg.layer_is_moe(i)
               else t * 3 * 2 * d * cfg.d_ff)
    n_heads_out = (n_exits_computed if n_exits_computed is not None
                   else cfg.n_exits)
    return int(fl + n_heads_out * 2 * t * d * cfg.vocab)


def lm_train_flops(cfg: LMConfig, batch: int, seq: int) -> int:
    """Forward and backward, about 3 forwards (4 under ``remat``)."""
    return int(lm_forward_flops(cfg, batch, seq) * (4 if cfg.remat else 3))
