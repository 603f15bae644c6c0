"""The port's kernel modules against the JAX package: the plain torch
exit gate, difficulty chain, LM exit head and paged gather against the
JAX refs and the Pallas kernels in interpret mode, the device-keyed
dispatch, and the rule that the port imports neither ``jax`` nor
``repro``."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.difficulty.difficulty_kernel import difficulty_pallas
from repro.kernels.difficulty.ref import ref_components as jax_components
from repro.kernels.exit_gate.exit_gate_kernel import exit_gate_pallas
from repro.kernels.exit_head.exit_head_kernel import exit_head_gate_pallas
from repro.kernels.paged_gather.paged_gather_kernel import \
    paged_gather_pallas
from repro.kernels.difficulty import ref as jax_difficulty_ref
from repro.kernels.exit_gate import ref as jax_gate_ref
from repro.kernels.exit_head import ref as jax_head_ref
from repro.kernels.paged_gather import ref as jax_paged_ref
from repro_torch.core.difficulty import DEFAULT
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.difficulty import kernel as dkernel
from repro_torch.kernels.difficulty.ref import ref_components
from repro_torch.kernels.exit_gate import kernel as gkernel
from repro_torch.kernels.exit_gate.ref import ref_exit_gate
from repro_torch.kernels.exit_head import kernel as hkernel
from repro_torch.kernels.exit_head.ref import ref_exit_head_gate
from repro_torch.kernels.paged_gather import kernel as pkernel
from repro_torch.kernels.paged_gather.ref import ref_paged_gather

# tiny tensors: one thread is faster than torch's pool, and leaves the
# cores to the JAX side and to other test workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# one compiled program per shape instead of one per op
jax_exit_gate = jax.jit(jax_gate_ref.ref_exit_gate)
jax_components = jax.jit(jax_difficulty_ref.ref_components)
jax_exit_head = jax.jit(jax_head_ref.ref_exit_head_gate)

# conf and entropy: fp32 sums over V taken in another order -> 1e-6.
# Entropy grows to log V (8.3 at V = 4099, where one ulp is 1e-6), so it
# also gets a relative 1e-6: a few ulps of its own size.
GATE_ATOL = 1e-6
ENT_RTOL = 1e-6
# |conf - tau'| below this may flip the strict `>` between backends
EDGE = 1e-6


def _gate_inputs(b, v, seed):
    """Logits with exact ties in even rows and tau' == conf (the port's)
    in rows i % 3 == 1; returns (logits, thresholds, planted edge rows)."""
    rs = np.random.RandomState(seed)
    lg = (rs.randn(b, v) * 4).astype(np.float32)
    for r in range(0, b, 2):                      # exact tie, first wins
        i, j = sorted(rs.choice(v, 2, replace=False)) if v > 1 else (0, 0)
        lg[r, i] = lg[r, j] = lg[r].max() + 1.0
    th = rs.uniform(0, 1, b).astype(np.float32)
    conf = ref_exit_gate(torch.from_numpy(lg), torch.from_numpy(th))[0]
    edge = np.arange(b) % 3 == 1
    th[edge] = conf.numpy()[edge]
    return lg, th, edge


def _check_gate(port, want, th, planted):
    conf = np.asarray(want[0])
    np.testing.assert_allclose(port[0].numpy(), conf, atol=GATE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(port[1].numpy(), np.asarray(want[1]),
                               atol=GATE_ATOL, rtol=ENT_RTOL)
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(want[2]))
    edge = np.abs(conf - th) < EDGE
    assert int(edge.sum()) == int(planted.sum())
    np.testing.assert_array_equal(port[3].numpy()[~edge],
                                  np.asarray(want[3])[~edge])
    # strict Alg. 1 compare: tau' == conf never fires in the port
    assert not port[3].numpy()[planted].any()


GATE_SHAPES = ([(b, v) for b in (1, 7, 64) for v in (10, 1000, 4099)]
               + [(1, 32000), (3, 129280)])           # LM vocabularies


@pytest.mark.parametrize("b,v", GATE_SHAPES)
def test_exit_gate_plain_matches_jax_ref(b, v):
    lg, th, planted = _gate_inputs(b, v, seed=b * 7919 + v)
    port = ref_exit_gate(torch.from_numpy(lg), torch.from_numpy(th))
    _check_gate(port, jax_exit_gate(jnp.asarray(lg), jnp.asarray(th)), th,
                planted)
    for r in range(0, b, 2):                      # ties go to lowest index
        assert port[2][r] == int(np.argmax(lg[r]))


@pytest.mark.parametrize("block_b", [1, 8])
@pytest.mark.parametrize("b,v", GATE_SHAPES)
def test_exit_gate_plain_matches_pallas_interpret(b, v, block_b):
    lg, th, planted = _gate_inputs(b, v, seed=b * 104729 + v)
    port = ref_exit_gate(torch.from_numpy(lg), torch.from_numpy(th))
    # the Pallas grid needs block_b | B: pad rows, then drop them
    bp = -(-b // block_b) * block_b
    lg_p = np.concatenate([lg, np.zeros((bp - b, v), np.float32)])
    th_p = np.concatenate([th, np.zeros(bp - b, np.float32)])
    got = exit_gate_pallas(jnp.asarray(lg_p), jnp.asarray(th_p),
                           block_b=block_b, interpret=True)
    _check_gate(port, [np.asarray(g)[:b] for g in got], th, planted)


def _split_gate(lg, width, head):
    """conf, entropy and pred of the CUDA gate's split route, its
    arithmetic emulated in fp32 numpy: chunks of 256 threads x 4 vectors
    of ``width`` values; in each chunk ``head`` scalar columns (a row
    that is not 16-byte aligned) go to threads 0.., vector q to thread
    q % 256, the tail to threads 0..; a thread sums its terms in column
    order, a warp by a butterfly, the 8 warps in order; a warp per row
    merges the partials (the row max, then each chunk's sums rescaled).
    e^d is taken as 2^(d log2 e), as the kernel does."""
    b, v = lg.shape
    f32 = np.float32
    g, k = 256, 4
    chunk = g * k * width
    chunks = -(-v // chunk)
    parts = []
    for c in range(chunks):
        x = lg[:, c * chunk:(c + 1) * chunk]
        n = x.shape[1]
        h = min(head, n)
        nvec = (n - h) // width
        cols = np.full((g, k * width + 2), -1)   # each thread's columns
        cols[:h, 0] = np.arange(h)
        for q in range(nvec):
            t, kk = q % g, q // g
            cols[t, 1 + kk * width:1 + (kk + 1) * width] = \
                h + q * width + np.arange(width)
        tail = np.arange(h + nvec * width, n)
        cols[:len(tail), -1] = tail
        m = x.max(axis=1)
        idx = c * chunk + x.argmax(axis=1)
        s = np.zeros((b, g), f32)
        t = np.zeros((b, g), f32)
        for j in range(cols.shape[1]):
            live = cols[:, j] >= 0
            d = (x[:, cols[live, j]] - m[:, None]).astype(f32)
            e = np.exp2(d * LOG2E)
            s[:, live] = s[:, live] + e
            # fmaf(d, e, t): the product is exact in float64
            t[:, live] = (d.astype(np.float64) * e + t[:, live]).astype(f32)
        s, t = (_butterfly(a.reshape(b, g // 32, 32))[:, :, 0] for a in (s, t))
        s_c, t_c = s[:, 0], t[:, 0]
        for w in range(1, g // 32):
            s_c, t_c = s_c + s[:, w], t_c + t[:, w]
        parts.append((m, s_c, t_c, idx))
    m = np.stack([p[0] for p in parts], 1)
    big = m.max(axis=1)
    idx = np.where(m == big[:, None], np.stack([p[3] for p in parts], 1),
                   np.iinfo(np.int32).max).min(axis=1)
    s = np.zeros((b, 32), f32)
    t = np.zeros((b, 32), f32)
    for c, (mc, sc, tc, _) in enumerate(parts):
        d = (mc - big).astype(f32)
        r = np.exp2(d * LOG2E)
        tt = (d.astype(np.float64) * sc + tc).astype(f32)
        s[:, c % 32] = (r.astype(np.float64) * sc + s[:, c % 32]).astype(f32)
        t[:, c % 32] = (r.astype(np.float64) * tt + t[:, c % 32]).astype(f32)
    s, t = (_butterfly(a[:, None, :])[:, 0, 0] for a in (s, t))
    return f32(1) / s, (np.log(s) - t / s).astype(f32), idx


LOG2E = np.float32(1.4426950408889634)


def _butterfly(a):
    """A warp's xor-shuffle sum over the last axis (32 lanes), in fp32."""
    for off in (16, 8, 4, 2, 1):
        a = a + a[..., np.arange(32) ^ off]
    return a


@pytest.mark.parametrize("v,width,head", [
    (2049, 4, 0),            # the narrowest split row: one chunk
    (32000, 4, 0), (32000, 4, 3), (129280, 4, 0),    # f32: 8, 8, 32
    (32000, 8, 1), (129280, 8, 0)])                  # 2-byte: 4, 16
def test_exit_gate_split_route_matches_float64(v, width, head):
    """The split route's chunked merge, emulated in fp32 numpy, against
    float64 and against the plain version: conf within GATE_ATOL,
    entropy within GATE_ATOL plus ENT_RTOL of itself, pred equal, with
    ties across a chunk boundary and the max in the last chunk.

    This checks the arithmetic scheme, not the kernel: it calls no code
    of the port's CUDA gate, so a change to gate_partial_kernel or
    gate_merge_kernel cannot make it fail.  The kernel itself is held to
    float64 at these widths only on the card, by chip_smoke.py's
    check_exit_gate.  Chunk widths are the launcher's: 4096 f32 or 8192
    2-byte columns, so 1 to 32 chunks here; ``head`` is the scalar head
    of a row that does not start on a 16-byte boundary."""
    rs = np.random.RandomState(v + head)
    chunk = 256 * 4 * width
    lg = (rs.randn(4, v) * 4).astype(np.float32)
    top = lg.max() + 1.0
    j = chunk - 1 if v > chunk else v // 2 - 1
    lg[0, j] = lg[0, j + 1] = top                # a tie across a boundary
    lg[1, v - 1] = top                           # the max in the last chunk
    lg[2, 5] = lg[2, v - 2] = top                # first and last chunk
    if width == 8:                               # bf16 values, ties kept
        lg = torch.from_numpy(lg).bfloat16().float().numpy()
    conf, ent, pred = _split_gate(lg, width, head)
    np.testing.assert_array_equal(pred[:3], [j, v - 1, 5])
    x = lg.astype(np.float64)
    d = x - x.max(axis=1, keepdims=True)
    e = np.exp(d)
    s64 = e.sum(axis=1)
    ent64 = np.log(s64) - (d * e).sum(axis=1) / s64
    np.testing.assert_allclose(conf, 1 / s64, atol=GATE_ATOL, rtol=0)
    np.testing.assert_allclose(ent, ent64, atol=GATE_ATOL, rtol=ENT_RTOL)
    want = ref_exit_gate(torch.from_numpy(lg), torch.ones(4))
    np.testing.assert_allclose(conf, want[0].numpy(), atol=GATE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(ent, want[1].numpy(), atol=GATE_ATOL,
                               rtol=ENT_RTOL)
    np.testing.assert_array_equal(pred, want[2].numpy())


DIFF_SHAPES = [(8, 8, 3), (28, 28, 1), (32, 32, 3)]


def _images(h, w, c, seed, b=4):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    x[1] = np.round(x[1])                       # hard edges
    x[2] = x[2] * 0.05 + 0.5                    # nearly flat
    return x


def _check_components(port, want, h, w):
    port, want = port.numpy(), np.asarray(want)
    # alpha_var, alpha_grad: fp32 means in another order -> 1e-6
    np.testing.assert_allclose(port[:, 1:3], want[:, 1:3], atol=1e-6,
                               rtol=0)
    # alpha_edge: a magnitude at tau_edge may flip -> one pixel
    pixel = 1.0 / ((h - 2) * (w - 2))
    np.testing.assert_allclose(port[:, 0], want[:, 0], atol=pixel + 1e-7,
                               rtol=0)
    np.testing.assert_allclose(port[:, 3], want[:, 3],
                               atol=DEFAULT.w_edge * pixel + 1e-6, rtol=0)


@pytest.mark.parametrize("h,w,c", DIFF_SHAPES)
def test_difficulty_plain_matches_jax_ref(h, w, c):
    x = _images(h, w, c, seed=h * 31 + c)
    _check_components(ref_components(torch.from_numpy(x)),
                      jax_components(jnp.asarray(x)), h, w)


@pytest.mark.parametrize("h,w,c", DIFF_SHAPES)
def test_difficulty_plain_matches_pallas_interpret(h, w, c):
    x = _images(h, w, c, seed=h * 37 + c)
    _check_components(ref_components(torch.from_numpy(x)),
                      difficulty_pallas(jnp.asarray(x), interpret=True),
                      h, w)


def _head_inputs(b, d, v, seed):
    """(h, scale, table, thresholds, planted) with exact logit ties in
    even rows (two table rows equal to h's direction) and tau' equal to
    the port's own conf in rows i % 3 == 1."""
    rs = np.random.RandomState(seed)
    h = (rs.randn(b, d) * 2).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(d)).astype(np.float32)
    tab = rs.randn(v, d).astype(np.float32)
    for r in range(0, b, 2):
        i, j = sorted(rs.choice(v, 2, replace=False))
        tab[i] = tab[j] = h[r] * scale * 2.0 / np.abs(h[r]).max()
    th = rs.uniform(0, 1, b).astype(np.float32)
    conf = ref_exit_head_gate(*map(torch.from_numpy, (h, scale, tab, th)))[0]
    planted = np.arange(b) % 3 == 1
    th[planted] = conf.numpy()[planted]
    return h, scale, tab, th, planted


# LM exit head: the logits of these inputs reach ~30 in magnitude, and
# fp32 dot products over D taken in another order move them by ~1e-6
# relative, so conf (and the tau' edge) gets 1e-5
HEAD_ATOL = 1e-5


def _check_head(port, want, th, planted):
    conf = np.asarray(want[0])
    np.testing.assert_allclose(port[0].numpy(), conf, atol=HEAD_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(want[1]))
    edge = np.abs(conf - th) < HEAD_ATOL
    assert int(edge.sum()) >= int(planted.sum())
    np.testing.assert_array_equal(port[2].numpy()[~edge],
                                  np.asarray(want[2])[~edge])
    assert not port[2].numpy()[planted].any()   # strict compare
    return int(edge.sum())


HEAD_SHAPES = [(1, 16, 32, 16), (7, 72, 1003, 59), (16, 64, 256, 64)]


@pytest.mark.parametrize("b,d,v,block_v", HEAD_SHAPES)
def test_exit_head_plain_matches_jax_ref(b, d, v, block_v):
    h, scale, tab, th, planted = _head_inputs(b, d, v, seed=b * 31 + v)
    port = ref_exit_head_gate(*map(torch.from_numpy, (h, scale, tab, th)))
    _check_head(port, jax_exit_head(*map(jnp.asarray, (h, scale, tab, th))),
                th, planted)
    for r in range(0, b, 2):                      # ties go to lowest index
        logits = (h[r] / np.sqrt(np.mean(h[r] ** 2) + 1e-6) * scale) @ tab.T
        assert int(port[1][r]) == int(np.argmax(logits))


@pytest.mark.parametrize("b,d,v,block_v", HEAD_SHAPES)
def test_exit_head_plain_matches_pallas_interpret(b, d, v, block_v):
    assert block_v < v
    h, scale, tab, th, planted = _head_inputs(b, d, v, seed=b * 37 + v)
    port = ref_exit_head_gate(*map(torch.from_numpy, (h, scale, tab, th)))
    got = exit_head_gate_pallas(*map(jnp.asarray, (h, scale, tab, th)),
                                block_v=block_v, interpret=True)
    _check_head(port, got, th, planted)


@pytest.mark.parametrize("backend", ["port", "pallas"])
def test_exit_head_tie_and_threshold_edge(backend):
    """The reference's cross-block tie case (``tests/test_kernels.py``):
    two equal unembedding rows in different vocab blocks; argmax takes
    the first.  tau' is each backend's OWN conf — the plain chain's
    max(softmax) and the kernel's 1/s differ in the low bits — and at
    tau' == conf the strict compare never fires."""
    d, v = 8, 32
    h = np.ones((1, d), np.float32)
    scale = np.ones(d, np.float32)
    tab = np.zeros((v, d), np.float32)
    tab[5] = tab[21] = 0.3
    if backend == "port":
        def run(th):
            return [t.numpy() for t in ref_exit_head_gate(
                *map(torch.from_numpy, (h, scale, tab, th)))]
    else:
        def run(th):
            return [np.asarray(t) for t in exit_head_gate_pallas(
                *map(jnp.asarray, (h, scale, tab, th)), block_v=16,
                interpret=True)]
    conf, pred, _ = run(np.zeros(1, np.float32))
    assert int(pred[0]) == 5
    own = conf.astype(np.float32)
    edge = np.abs(conf - own) < 1e-6
    assert int(edge.sum()) == 1
    assert int(run(own)[2][0]) == 0             # tau' == conf: no fire
    assert int(run(own - 1e-3)[2][0]) == 1
    assert int(run(own + 1e-3)[2][0]) == 0


def _split_inputs(b, d, v, seed):
    """bf16 (h, scale, table) as an LM exit head sees them, with a planted
    top logit near log V + 3 in even rows (two equal table rows along the
    row's own direction), so conf sits near 0.5, where an error in the
    logits moves it most."""
    rs = np.random.RandomState(seed)
    h = rs.randn(b, d).astype(np.float32)
    scale = (1.0 + 0.1 * rs.randn(d)).astype(np.float32)
    tab = (0.02 * rs.randn(v, d)).astype(np.float32)
    rows = np.arange(0, b, 2)
    idx = (rows * 97) % (v // 2)
    dirn = h[rows] * scale
    dirn = (np.log(v) + 3) * dirn / np.sum(dirn ** 2, axis=1, keepdims=True)
    tab[idx] = tab[idx + v // 2] = dirn
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (h, scale, tab)]


def _split_terms(hn, n):
    """The first n bf16 terms of fp32 hn: hi = bf16(hn), mid = bf16(hn -
    hi), lo = bf16(hn - hi - mid), as ``head_split_kernel`` forms them."""
    terms, rest = [], hn
    for _ in range(n):
        terms.append(rest.to(torch.bfloat16))
        rest = rest - terms[-1].float()
    return terms


def _split_head(h, scale, tab, n_terms):
    """conf and pred of the tensor-core design's arithmetic: fp32 hn split
    into bf16 terms, one fp32-accumulated product per term against the
    bf16 table (each product of two bf16 values is exact in fp32), the
    smallest term first, summed in fp32."""
    x = h.float()
    hn = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        * scale.float()
    logits = None
    for term in reversed(_split_terms(hn, n_terms)):
        part = term.float() @ tab.float().T
        logits = part if logits is None else logits + part
    conf = 1.0 / torch.exp(logits - logits.amax(-1, keepdim=True)).sum(-1)
    return conf, logits.argmax(-1)


@pytest.mark.parametrize("b,d,v", [(8, 2048, 4096), (7, 72, 1003)])
def test_exit_head_split_precision_matches_float64(b, d, v):
    """The bf16 tensor-core exit head's arithmetic, emulated in plain
    torch, against float64 of the kernel's fp32 semantics: conf within
    1e-6, pred equal outside float64 top-2 gaps below 1e-4.

    This checks the arithmetic scheme, not the kernel: it calls no code
    of the port, so a change to head_split_kernel or head_tc_kernel
    cannot make it fail.  The kernel itself is held to float64 only on
    the card, by chip_smoke.py's check_exit_head.

    Why three terms: with these inputs (conf up to ~0.49) one term (hn
    rounded to bf16) is 3.2e-5 (8, 2048, 4096) and 6.5e-5 (7, 72, 1003)
    off float64; two terms (hi + mid, 16 of hn's 24 bits) are 8.4e-8
    and 1.5e-7 off; three are 8.4e-8 and 9.3e-8 off, the rounding of the
    fp32 sums themselves.  Two terms already sit inside the tolerance
    here; the third makes hn exact to fp32, so no input can leave it
    short.  The tensor cores' own accumulation, and the promotion of
    each K tile's sum into fp32 registers that the kernel does about it,
    cannot be emulated here: the card's check covers them."""
    h, scale, tab = _split_inputs(b, d, v, seed=b * 7 + v)
    x = h.double()
    hn = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        * scale.double()
    lg = hn @ tab.double().T
    top2 = lg.topk(2, dim=-1).values
    want = 1.0 / torch.exp(lg - top2[:, :1]).sum(-1)
    assert float(want.max()) > 0.4                 # the planted rows
    conf, pred = _split_head(h, scale, tab, 3)
    assert float((conf.double() - want).abs().max()) <= 1e-6
    near = (top2[:, 0] - top2[:, 1]) < 1e-4
    assert torch.equal(pred[~near], lg.argmax(-1)[~near])
    # the split is exact to fp32: hi + mid + lo gives hn back
    x = h.float()
    hn32 = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) \
        * scale.float()
    hi, mid, lo = (t.double() for t in _split_terms(hn32, 3))
    assert float(((hi + mid + lo) - hn32.double()).abs().max()) \
        <= 2.0 ** -24 * float(hn32.abs().max())


def _page_inputs(seed, n=7, psz=3, trailing=(2, 5), s=4, p=5, lo=0):
    rs = np.random.RandomState(seed)
    pages = rs.randn(n, psz, *trailing).astype(np.float32)
    table = rs.randint(lo, n + 3, (s, p)).astype(np.int32)
    table[0, 0] = n                                   # just past the end
    return pages, table


def test_paged_gather_plain_matches_jax_ref_bit_for_bit():
    # ids past the end and below zero: clipped to [0, N-1] (mode="clip")
    for seed, lo in ((0, 0), (1, -3)):
        pages, table = _page_inputs(seed, lo=lo)
        got = ref_paged_gather(torch.from_numpy(pages),
                               torch.from_numpy(table))
        want = jax_paged_ref.ref_paged_gather(jnp.asarray(pages),
                                              jnp.asarray(table))
        assert got.shape == (4, 15, 2, 5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (table < 0).any() and (table >= 7).any()


def test_paged_gather_plain_matches_pallas_interpret_bit_for_bit():
    # ids past the end clip to the last page in both; the Pallas kernel
    # wraps a negative id to the last page (its block index) where the
    # JAX ref and the port clip to 0, so negative ids are held against
    # the ref only (the decoder never writes one into a page table)
    pages, table = _page_inputs(2)
    assert (table >= 7).any()
    got = ref_paged_gather(torch.from_numpy(pages), torch.from_numpy(table))
    want = paged_gather_pallas(jnp.asarray(pages), jnp.asarray(table),
                               interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dispatch_on_cpu_takes_ref_and_never_builds(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernels/build.py touched on a CPU tensor")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load_library", refuse)
    monkeypatch.setattr(build, "nvcc", refuse)
    dispatch.reset_launch_counts()
    lg, th, _ = _gate_inputs(5, 10, seed=1)
    lg, th = torch.from_numpy(lg), torch.from_numpy(th)
    for got, want in zip(dispatch.exit_gate(lg, th), ref_exit_gate(lg, th)):
        assert torch.equal(got, want)
    conf, pred = dispatch.softmax_confidence(lg.reshape(5, 1, 10))
    assert conf.shape == (5, 1) and torch.equal(
        conf[:, 0], ref_exit_gate(lg, th)[0])
    assert torch.equal(pred[:, 0], lg.argmax(-1).int())
    x = torch.from_numpy(_images(32, 32, 3, seed=2))
    assert torch.equal(dispatch.difficulty_components(x),
                       ref_components(x))
    assert torch.equal(dispatch.image_difficulty(x), ref_components(x)[:, 3])
    h, scale, tab, th, _ = _head_inputs(3, 16, 40, seed=3)
    args = [torch.from_numpy(a) for a in (h, scale, tab, th)]
    for got, want in zip(dispatch.exit_head_gate(*args),
                         ref_exit_head_gate(*args)):
        assert torch.equal(got, want)
    pages, table = _page_inputs(4, lo=-2)
    pages, table = torch.from_numpy(pages), torch.from_numpy(table)
    assert torch.equal(dispatch.paged_gather(pages, table),
                       ref_paged_gather(pages, table))
    assert dispatch.launch_counts() == {"exit_gate": 0, "difficulty": 0,
                                        "exit_head": 0, "paged_gather": 0}


def test_dispatch_and_wrappers_refuse_other_devices():
    meta = torch.empty((4, 10), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        dispatch.exit_gate(meta, torch.empty(4, device="meta"))
    # the CUDA wrappers launch or raise; a CPU tensor never reaches them
    with pytest.raises(ValueError, match="CUDA"):
        gkernel.exit_gate_cuda(torch.zeros(4, 10), torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        dkernel.difficulty_cuda(torch.zeros(1, 8, 8, 3), tau_edge=0.1,
                                var_scale=0.05, grad_scale=0.2, w1=0.4,
                                w2=0.3, w3=0.3)
    with pytest.raises(ValueError, match="no kernel for device"):
        dispatch.paged_gather(torch.empty((3, 2, 4), device="meta"),
                              torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        hkernel.exit_head_gate_cuda(torch.zeros(2, 8), torch.ones(8),
                                    torch.zeros(16, 8), torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.paged_gather_cuda(torch.zeros(3, 2, 4),
                                  torch.zeros((1, 2), dtype=torch.int32))


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & {"jax", "jaxlib", "repro"})
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_build_names_every_source_and_keys_on_content():
    names = {s.name for s in build.sources()}
    assert names == {"exit_gate.cu", "difficulty.cu", "exit_head.cu",
                     "paged_gather.cu"}
    lib = build.library_path()
    assert lib.parent == ROOT / "build" / "repro_torch"
    assert lib == build.library_path()
    assert set(build.SIGNATURES) == {
        "exit_gate_plan", "exit_gate_launch", "difficulty_launch",
        "exit_head_plan", "exit_head_launch", "paged_gather_launch"}
    # every C entry point is declared where its source defines it
    text = "".join(src.read_text() for src in build.sources())
    for name in build.SIGNATURES:
        assert f'extern "C" int {name}(' in text
