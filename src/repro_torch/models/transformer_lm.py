"""LLaMA-family language models with early-exit heads (dense GQA path).

The port of ``repro/models/transformer_lm.py`` as far as early-exit
decode needs it: the config, the non-scan init, the KV cache with
prefill, the exit heads (RMSNorm + unembedding) and the CALM KV
propagation of an exited row.  The MLA, MoE, layer-scan and MTP paths
and the training losses wait for their slices.

Parameters are a dict tree in the JAX layout (``convert.from_jax_params``
maps the JAX tree onto it without transposes):

    embed.table (V, D); layers[i].{attn_norm, ffn_norm}.scale (D,);
    layers[i].attn.{wq (D, H, Dh), wk, wv (D, Hkv, Dh), wo (H, Dh, D)};
    layers[i].ffn.{gate, up}.w (D, F), ffn.down.w (F, D);
    final_norm.scale; exit_heads[str(layer)].norm.scale; unembed (V, D)
    when the embeddings are untied.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as DEV
from repro_torch.models import layers as L


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

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_exits(self) -> int:
        return len(self.exit_layers) + 1   # + final head


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


def _layer_init(gen, cfg: LMConfig, device):
    d, hd = cfg.d_model, cfg.hd
    return {
        "attn_norm": _ones(d, cfg, device),
        "ffn_norm": _ones(d, cfg, device),
        "attn": {
            "wq": _trunc((d, cfg.n_heads, hd), gen, 0.02, cfg, device),
            "wk": _trunc((d, cfg.n_kv_heads, hd), gen, 0.02, cfg, device),
            "wv": _trunc((d, cfg.n_kv_heads, hd), gen, 0.02, cfg, device),
            "wo": _trunc((cfg.n_heads, hd, d), gen, 0.02, cfg, device)},
        "ffn": {
            "gate": {"w": _trunc((d, cfg.d_ff), gen, 0.02, cfg, device)},
            "up": {"w": _trunc((d, cfg.d_ff), gen, 0.02, cfg, device)},
            "down": {"w": _trunc((cfg.d_ff, d), gen, 0.02, cfg, device)}},
    }


def lm_init(cfg: LMConfig, *, seed: int = 0, device=None):
    """Seeded random parameters drawn on ``device`` (``None``: the CUDA
    card), so a 1.1 B-parameter model never passes through the host.
    The JAX init's distributions (embedding std 0.01, everything else
    std 0.02, norms at 1), not its numbers."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else DEV.resolve(device)
    gen = _generator(seed, dev)
    p = {
        "embed": {"table": _trunc((cfg.vocab, cfg.d_model), gen, 0.01, cfg,
                                  dev)},
        "layers": [_layer_init(gen, cfg, dev) for _ in range(cfg.n_layers)],
        "final_norm": _ones(cfg.d_model, cfg, dev),
        "exit_heads": {str(i): {"norm": _ones(cfg.d_model, cfg, dev)}
                       for i in cfg.exit_layers},
    }
    if not cfg.tie_embeddings:
        p["unembed"] = _trunc((cfg.vocab, cfg.d_model), gen, 0.02, cfg, dev)
    return p


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
        a = L.gqa_apply(p["attn"], h, cos, sin, causal=True)
        _fill_cache_gqa(p["attn"], h, cos, sin, cache[i])
        x = x + a
        x = x + L.swiglu(p["ffn"], L.rmsnorm(p["ffn_norm"], x))
        if i in cfg.exit_layers:
            exit_h.append(x[:, -1])
    exit_h.append(x[:, -1])
    return cache, exit_h


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
