"""Building blocks of the testbed CNNs and of the LLaMA-family LMs
(plain functions on tensors).

Parameters are dicts of tensors.  Convolution weights are OIHW and the
activations of these layers are NCHW (torch's own layout); the models'
public entry points take NHWC images, like the JAX package.  Padding
follows JAX's ``"SAME"``: output size ceil(in / stride), with the total
pad split so the larger half comes after — a stride-2 or odd-sized
window therefore pads at the end only, and SAME max-pooling rounds odd
sizes up (28 -> 14 -> 7 -> 4), where torch's defaults would floor.

LeViT's token layers keep the JAX package's forms where torch's
defaults differ: ``layernorm`` with eps 1e-6 in float32, the tanh
``gelu``; ``global_avg_pool`` takes (B, N, D) tokens as well as NCHW.
ViT and ConvNeXt add ``patch_embed`` (a VALID convolution of stride
``patch``, then (B, h*w, D) tokens in the row-major order of the NHWC
map), ``mlp`` (up, GELU, down) and ``mha_init``/``mha_apply``: wq/wk/wv
(D, H, Dh) and wo (H, Dh, D), with biases on q and on the output only,
as in the JAX package; ``conv2d`` takes ``padding="VALID"`` and
``groups`` (ConvNeXt's depthwise 7x7, weight (C, 1, 7, 7)).

Init draws from an explicit ``torch.Generator``: He-normal convolutions
and truncated-normal (std 0.02, cut at 2 std) linears, the same
distributions as the JAX init, not the same numbers.

``count_macs()`` counts the multiply-accumulates of ``conv2d``,
``linear`` and ``einsum`` inside its scope; the token layers (LeViT's
``layernorm``, ``gelu``, ``hard_swish``, and ``count_flops`` at its
softmax, batchnorm, pooling and residual adds; ``dense_attention``'s
scale and softmax, ``mha_apply``'s and ``mlp``'s bias adds) add their
elementwise flops as XLA's cost analysis counts them, halved (the
CNNs' count leaves them out).  A convolution counts only the kernel
taps that land inside its unpadded input, as XLA's cost analysis does,
so the SAME padding adds nothing (a counter at the ``aten.convolution``
level would see ``F.pad``'s zeros as image); a grouped convolution
counts the input channels of one group.

The LM subset keeps the JAX package's layouts and roundings: rmsnorm in
fp32 with eps 1e-6 and a cast back; the half-split ("llama") rope with
cos/sin in fp32; attention scores in the input dtype, then fp32 with a
-inf mask and an fp32 softmax cast back before P.V; einsum weight
layouts wq/wk/wv (D, H, Dh) and wo (H, Dh, D).  The KV-cache writes
update the given cache tensors in place (JAX returns new arrays; the
callers here own the tensors they pass).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch as KD


def trunc_normal(shape, generator, *, std=0.02, device,
                 dtype=torch.float32):
    """Drawn in float32, then cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                       generator=generator).to(dtype)


def he_normal(shape, generator, fan_in, *, device, dtype=torch.float32):
    std = math.sqrt(2.0 / fan_in)
    return std * torch.randn(shape, generator=generator, device=device,
                             dtype=dtype)


def linear_init(generator, in_dim, out_dim, *, device,
                dtype=torch.float32, bias=True):
    """{"w": (in, out), "b": (out,)} — the JAX layout, ``x @ w + b``; no
    "b" when ``bias`` is false."""
    p = {"w": trunc_normal((in_dim, out_dim), generator, device=device,
                           dtype=dtype)}
    if bias:
        p["b"] = torch.zeros(out_dim, device=device, dtype=dtype)
    return p


class MacCount:
    """Multiply-accumulates reported by ``conv2d``, ``linear`` and
    ``einsum``."""

    def __init__(self):
        self.macs = 0


_COUNTER: contextvars.ContextVar[MacCount | None] = contextvars.ContextVar(
    "repro_torch_mac_count", default=None)


def count_flops(flops):
    """Add elementwise work, in flops as XLA's cost analysis counts them
    (a MAC is two), to an open ``count_macs`` scope."""
    c = _COUNTER.get()
    if c is not None:
        c.macs += flops / 2


def count_converts(*tensors):
    """Add the converts of one bf16 op to an open ``count_macs`` scope:
    XLA's CPU backend has no bf16 arithmetic, so it converts each bf16
    operand of an op to float32 and the result back to bf16, and its
    cost analysis counts a flop an element for each convert.  Float32
    tensors add nothing."""
    c = _COUNTER.get()
    if c is not None:
        c.macs += sum(t.numel() for t in tensors
                      if t.dtype == torch.bfloat16) / 2


@contextlib.contextmanager
def count_macs():
    """``with count_macs() as c: ...`` -- ``c.macs`` after the block."""
    c = MacCount()
    token = _COUNTER.set(c)
    try:
        yield c
    finally:
        _COUNTER.reset(token)


def linear(p, x):
    c = _COUNTER.get()
    if c is not None:
        c.macs += x.numel() * p["w"].shape[1]
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    count_converts(x, x, p["w"], y)     # activations: rounded, then in
    return y


def einsum(spec: str, a, b):
    """``torch.einsum`` of two operands, counted: the product of every
    index's size, as XLA counts a ``dot_general`` (LeViT's attention
    products; ``linear`` counts the plain matmuls)."""
    y = torch.einsum(spec, a, b)
    c = _COUNTER.get()
    if c is not None:
        ins = spec.split("->")[0]
        sizes = dict(zip(ins.replace(",", ""),
                         tuple(a.shape) + tuple(b.shape)))
        c.macs += math.prod(sizes.values())
        # an operand with the batch index is an activation: rounded to
        # bf16 and converted in (two converts), a weight converted in
        count_converts(y, *(t for t, sub in zip((a, b), ins.split(","))
                            for _ in range(1 + ("b" in sub))))
    return y


def layernorm_init(dim, dtype, *, device):
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-6):
    """Over the last axis in float32, cast back: the JAX package's chain
    and its eps (torch's ``layer_norm`` defaults to 1e-5)."""
    count_flops(8 * x.numel() + 2 * (x.numel() // x.shape[-1]))
    count_converts(x, p["scale"], p["bias"], x)     # in, params, out
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dtype)


def gelu(x):
    """The tanh form, ``jax.nn.gelu``'s default (torch's is the exact
    erf form)."""
    count_flops(8 * x.numel())
    if x.dtype == torch.bfloat16:
        # each of its nine ops rounds its result to bf16 and back
        count_flops(18 * x.numel())
    return F.gelu(x, approximate="tanh")


def hard_swish(x):
    """``x * relu6(x + 3) / 6``, as ``jax.nn.hard_swish``."""
    count_flops(4 * x.numel())
    return F.hardswish(x)


def conv_init(generator, kh, kw, cin, cout, *, device,
              dtype=torch.float32, bias=True, groups=1):
    """{"w": (cout, cin // groups, kh, kw), "b": (cout,)}, He-normal
    over the fan-in of one group; no "b" when ``bias`` is false."""
    p = {"w": he_normal((cout, cin // groups, kh, kw), generator,
                        kh * kw * cin // groups, device=device,
                        dtype=dtype)}
    if bias:
        p["b"] = torch.zeros(cout, device=device, dtype=dtype)
    return p


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """JAX/XLA "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh, kw, stride, value=0.0):
    """Pad an NCHW tensor for a SAME window; returns (x, symmetric pad)
    — the symmetric case is left to the op's own ``padding``."""
    ph = same_pads(x.shape[2], kh, stride)
    pw = same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def _taps(size: int, window: int, stride: int, padding="SAME") -> int:
    """Taps of a window along one axis that land inside the input,
    summed over the output positions (VALID: every tap of every
    output)."""
    if padding == "VALID":
        return ((size - window) // stride + 1) * window
    lo = same_pads(size, window, stride)[0]
    return sum(max(min(o * stride - lo + window, size)
                   - max(o * stride - lo, 0), 0)
               for o in range(-(-size // stride)))


def conv2d(p, x, *, stride=1, padding="SAME", groups=1):
    """NCHW convolution with JAX's ``"SAME"`` or ``"VALID"`` padding and
    ``groups`` feature groups; ``p["b"]`` optional."""
    cout, cin, kh, kw = p["w"].shape
    c = _COUNTER.get()
    if c is not None:
        c.macs += (x.shape[0] * _taps(x.shape[2], kh, stride, padding)
                   * _taps(x.shape[3], kw, stride, padding) * cin * cout)
    xin = x
    if padding == "SAME":
        x, pad = _pad_same(x, kh, kw, stride)
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"padding {padding!r}; known: SAME, VALID")
    y = F.conv2d(x, p["w"], p.get("b"), stride=stride, padding=pad,
                 groups=groups)
    count_converts(xin, p["w"], y)
    return y


def max_pool(x, window, stride):
    """NCHW max pool with JAX's SAME padding (-inf), so odd sizes round
    up."""
    x, pad = _pad_same(x, window, window, stride, value=-math.inf)
    return F.max_pool2d(x, window, stride, padding=pad)


def global_avg_pool(x):
    """(B, C, H, W) -> (B, C), or (B, N, D) tokens -> (B, D)."""
    return x.mean(dim=(2, 3) if x.dim() == 4 else 1)


# ---------------------------------------------------------------------------
# ViT / ConvNeXt blocks (repro/models/layers.py: mlp, patch_embed, mha)
# ---------------------------------------------------------------------------

def add_bias(x, b):
    """``x + b``, counted as XLA counts a broadcast add (one flop an
    element)."""
    count_flops(x.numel())
    y = x + b
    count_converts(x, b, y)
    return y


def linear_biased(p, x):
    """``linear`` with its bias add counted too (``linear`` counts the
    products only), as XLA counts the JAX package's separate add."""
    y = linear(p, x)
    if "b" in p:
        count_flops(y.numel())
        count_converts(y, p["b"], y)
    return y


def mlp_init(generator, dim, hidden, *, device, dtype=torch.float32):
    kw = dict(device=device, dtype=dtype)
    return {"up": linear_init(generator, dim, hidden, **kw),
            "down": linear_init(generator, hidden, dim, **kw)}


def mlp(p, x):
    """up, the tanh GELU, down (``act="gelu"``, the only one ViT uses)."""
    return linear_biased(p["down"], gelu(linear_biased(p["up"], x)))


def patch_embed_init(generator, patch, cin, dim, *, device,
                     dtype=torch.float32):
    return {"proj": conv_init(generator, patch, patch, cin, dim,
                              device=device, dtype=dtype)}


def patch_embed(p, x, patch):
    """NCHW images -> (B, h*w, D) tokens: a VALID convolution of stride
    ``patch``, its bias added, then the NHWC map flattened row by row
    (the JAX package's token order)."""
    proj = p["proj"]
    y = add_bias(conv2d({"w": proj["w"]}, x, stride=patch,
                        padding="VALID"), proj["b"][:, None, None])
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, y.shape[1])


def mha_init(generator, d_model, n_heads, *, device, dtype=torch.float32,
             head_dim=None):
    """wq/wk/wv (D, H, Dh), wo (H, Dh, D), truncated normal; zero biases
    on q (H, Dh) and on the output (D,) only, as the JAX package."""
    hd = head_dim or d_model // n_heads

    def w(*shape):
        return trunc_normal(shape, generator, device=device, dtype=dtype)
    return {"wq": w(d_model, n_heads, hd), "wk": w(d_model, n_heads, hd),
            "wv": w(d_model, n_heads, hd), "wo": w(n_heads, hd, d_model),
            "bq": torch.zeros((n_heads, hd), device=device, dtype=dtype),
            "bo": torch.zeros(d_model, device=device, dtype=dtype)}


def mha_apply(p, x):
    """Non-causal multi-head attention over (B, S, D) tokens: q with its
    bias, k and v without, ``dense_attention`` (float32 softmax cast
    back), wo, then the output bias."""
    q = add_bias(einsum("bsd,dhk->bshk", x, p["wq"]), p["bq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    o = dense_attention(q, k, v)
    return add_bias(einsum("bshk,hkd->bsd", o, p["wo"]), p["bo"])


# ---------------------------------------------------------------------------
# LM blocks (repro/models/layers.py: rmsnorm, swiglu, rope, attention,
# decode and paged decode)
# ---------------------------------------------------------------------------

def rmsnorm(p, x, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dtype)


def embed(p, ids):
    return p["table"][ids]


def swiglu(p, x):
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


@functools.lru_cache(maxsize=32)
def _rope_table(head_dim, max_seq, theta, device):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def rope_freqs(head_dim, max_seq, theta=10000.0, *, device):
    """(cos, sin), each (max_seq, head_dim / 2) float32 (cached per
    geometry and device; callers never write into them)."""
    return _rope_table(int(head_dim), int(max_seq), float(theta),
                       torch.device(device))


def apply_rope(x, cos, sin, positions=None):
    """x: (B, S, H, Dh); cos/sin: (S_max, Dh/2); positions: (B, S) or
    None.  Half-split: the first and second halves of Dh form the pairs."""
    if positions is None:
        cos_p = cos[: x.shape[1]][None, :, None, :]
        sin_p = sin[: x.shape[1]][None, :, None, :]
    else:
        cos_p = cos[positions][:, :, None, :]
        sin_p = sin[positions][:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos_p - x2 * sin_p, x2 * cos_p + x1 * sin_p],
                    dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def dense_attention(q, k, v, *, causal=False, kv_len=None, scale=None):
    """Materialised-scores attention.  q: (B, Sq, H, Dh); k/v: (B, Skv,
    Hkv, Dh); ``kv_len``: (B,) valid KV lengths (decode against a padded
    cache).  Returns (B, Sq, H, Dh)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    scores = einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    # the scale, then softmax: max, subtract, sum, divide (XLA counts
    # each reduction of n elements as n - 1 flops)
    count_flops(5 * scores.numel() - 2 * (scores.numel() // scores.shape[-1]))
    skv = k.shape[1]
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, -math.inf)
    if kv_len is not None:
        ki = torch.arange(skv, device=q.device)
        scores = scores.masked_fill(
            ki[None, None, None, :] >= kv_len[:, None, None, None],
            -math.inf)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return einsum("bhqk,bkhd->bqhd", w, v)


def chunked_attention(q, k, v, *, causal=True, q_chunk=1024, kv_chunk=1024,
                      scale=None):
    """Flash-style attention in plain torch: for each Q chunk, a loop over
    the KV chunks with an online softmax, so no (Sq, Skv) score matrix
    is held; the peak is O(q_chunk * kv_chunk) per (batch, head).  The
    JAX package's form (a scan over KV chunks mapped over Q chunks):
    scores in the input dtype then fp32, fp32 statistics and P.V, the
    output cast back.  The causal mask compares absolute positions
    (query i sees keys <= i: Sq and Skv aligned at 0, unlike
    :func:`dense_attention`, which aligns their ends)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    n_rep = h // hkv
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"chunks must divide the lengths: Sq={sq}, "
                         f"Skv={skv}, q_chunk={q_chunk}, "
                         f"kv_chunk={kv_chunk}")
    outs = []
    for q0 in range(0, sq, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        m = torch.full((b, h, q_chunk), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, h, q_chunk, dh), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, skv, kv_chunk):
            kc = _repeat_kv(k[:, k0:k0 + kv_chunk], n_rep)
            vc = _repeat_kv(v[:, k0:k0 + kv_chunk], n_rep)
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc).float() * scale
            if causal:
                qpos = q0 + torch.arange(q_chunk, device=q.device)[:, None]
                kpos = k0 + torch.arange(kv_chunk, device=q.device)[None]
                s = s.masked_fill(kpos > qpos, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # a row masked over the whole chunk so far keeps m = -inf
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vc.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, kv_len, *, scale=None):
    """Single-token decode attention against a padded KV cache.
    q: (B, 1, H, Dh); caches: (B, S_max, Hkv, Dh); kv_len: (B,)."""
    return dense_attention(q, k_cache, v_cache, kv_len=kv_len, scale=scale)


def gqa_qkv(p, x, cos, sin, positions=None):
    """Q, K, V projections (B, S, H or Hkv, Dh), rope on Q and K."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return (apply_rope(q, cos, sin, positions),
            apply_rope(k, cos, sin, positions), v)


def gqa_out(p, attn):
    return torch.einsum("bshk,hkd->bsd", attn, p["wo"])


def gqa_apply(p, x, cos, sin, *, causal=True, chunked=False,
              q_chunk=1024, kv_chunk=1024):
    q, k, v = gqa_qkv(p, x, cos, sin)
    if chunked:
        o = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
    else:
        o = dense_attention(q, k, v, causal=causal)
    return gqa_out(p, o)


def gqa_decode(p, x, cos, sin, cache, cache_index: int):
    """One-token decode.  x: (B, 1, D); cache {"k", "v"}: (B, S_max, Hkv,
    Dh), written in place at ``cache_index`` (the same for every row).
    Returns (out (B, 1, D), cache)."""
    positions = torch.full((x.shape[0], 1), cache_index, dtype=torch.long,
                           device=x.device)
    q, k, v = gqa_qkv(p, x, cos, sin, positions)
    cache["k"][:, cache_index] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, cache_index] = v[:, 0].to(cache["v"].dtype)
    kv_len = torch.full((x.shape[0],), cache_index + 1, dtype=torch.long,
                        device=x.device)
    o = decode_attention(q, cache["k"], cache["v"], kv_len)
    return gqa_out(p, o), cache


def paged_write(pages, rows, page_idx, offset):
    """Write one row per slot into ``pages[page_idx[i], offset[i]]``, in
    place.

    pages: (N + 1, psz, ...) — N pages and, last, a sink page that no
    page table references; rows: (S, ...); page_idx/offset: (S,) int.
    As in the JAX package's ``mode="drop"`` scatter, a negative page_idx
    counts from the end (-1 is page N-1) and rows whose page_idx lies
    outside [-N, N) are dropped from ``pages[:N]``: they land in the
    sink.  (An out-of-range ``index_put_`` raises on the CPU and is a
    device-side assert on CUDA; selecting the valid rows with a boolean
    mask would sync the host once per layer.)
    """
    n = pages.shape[0] - 1
    idx = torch.where(page_idx < 0, page_idx + n, page_idx)
    ok = (idx >= 0) & (idx < n)
    pages[torch.where(ok, idx, n).long(), offset.long()] = \
        rows.to(pages.dtype)
    return pages


def gqa_decode_paged(p, x, cos, sin, pages, page_table, page_idx, offset,
                     positions):
    """One-token GQA decode against a paged KV cache.

    x: (S, 1, D); pages {"k", "v"}: (N + 1, psz, Hkv, Dh) with the sink
    page last (see :func:`paged_write`); page_table: (S, P) of ids in
    [0, N); page_idx/offset/positions: (S,) — per-slot write target and
    current position.  Returns (out (S, 1, D), pages), written in place.
    """
    q, k, v = gqa_qkv(p, x, cos, sin, positions[:, None].long())
    paged_write(pages["k"], k[:, 0], page_idx, offset)
    paged_write(pages["v"], v[:, 0], page_idx, offset)
    k_view = KD.paged_gather(pages["k"][:-1], page_table)
    v_view = KD.paged_gather(pages["v"][:-1], page_table)
    o = decode_attention(q, k_view, v_view, positions.long() + 1)
    return gqa_out(p, o), pages
