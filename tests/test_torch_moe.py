"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's ``repro/models/moe.py`` on the CPU, mesh-less, float32.

Same numpy inputs and weights on both sides.  Held to JAX: the output,
the Switch aux loss and the router's top-k ids at REDUCED granite widths
(8 experts, top-2) and at granite's 40 experts top-8 with a narrow
d_model (granite's capacity arithmetic), over T in {1, 7, 16, 64, 100};
a crafted router that sends every token to the same experts, so that
the capacity drops the late tokens (the dropped pairs, the output);
ties (a zero router picks experts 0..k-1, as ``lax.top_k`` does); row
order (permuting the rows changes the output as it does in JAX, since
the capacity keeps the first tokens of each expert's queue); the
gradients with respect to x, the router and the expert weights; a shared
expert.  The kept pairs are also held to a numpy transcription of the
capacity rule, and the output to a per-token numpy sum over them.

Tolerances: outputs and the aux loss within FWD_TOL (float32 products
and sums in another order), gradients within GRAD_RTOL of each leaf's
norm.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jMOE
from repro_torch.models import moe as MOE

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_RTOL = 1e-4

#: (name, MoEConfig, d_model): REDUCED granite's MoE, and granite's
#: expert count and top-k at a narrow width
CASES = {"reduced": (MOE.MoEConfig(n_experts=8, top_k=2, d_ff=64), 64),
         "granite-e40k8": (MOE.MoEConfig(n_experts=40, top_k=8, d_ff=16),
                           32)}
TOKENS = (1, 7, 16, 64, 100)


def _jcfg(cfg):
    return jMOE.MoEConfig(**dataclasses.asdict(cfg))


def _weights(cfg, d, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    p = MOE.moe_init(gen, d, cfg, dtype, device="cpu")
    return p, jax.tree.map(lambda t: jnp.asarray(t.float().numpy()), p)


def _x(t, d, seed=1):
    return np.random.RandomState(seed).normal(size=(t, d)).astype(np.float32)


def _close(got, want, tol=FWD_TOL, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(
        got) else got, np.float32), np.asarray(want, np.float32), rtol=tol,
        atol=tol, err_msg=what)


def _kept_numpy(ids, cfg):
    """The capacity rule in numpy: each expert keeps the first
    ``capacity`` (token, choice) pairs in token order."""
    t = ids.shape[0]
    cap = MOE.capacity(t, cfg)
    seen = {}
    kept = set()
    for tok in range(t):
        for e in ids[tok]:
            seen[e] = seen.get(e, 0) + 1
            if seen[e] <= cap:
                kept.add((tok, int(e)))
    return kept


def _kept_port(ids, cfg):
    plan = MOE.dispatch_plan(torch.as_tensor(ids), cfg)
    keep = plan["keep"].numpy()
    return {(int(t), int(e)) for t, e, k in zip(plan["s_tok"].numpy(),
                                               plan["s_eid"].numpy(), keep)
            if k}


def _per_token_numpy(x, p, ids, p_top, kept):
    """y_t = sum over t's kept pairs of p * W_down(silu(W_gate x) * W_up x),
    in float64."""
    wg, wu, wd = (p[k].double().numpy() for k in ("w_gate", "w_up",
                                                  "w_down"))
    out = np.zeros(x.shape, np.float64)
    for t in range(x.shape[0]):
        for j, e in enumerate(ids[t]):
            if (t, int(e)) in kept:
                g = x[t] @ wg[e]
                h = g / (1 + np.exp(-g)) * (x[t] @ wu[e])
                out[t] += p_top[t, j] * (h @ wd[e])
    return out


@pytest.mark.parametrize("t", TOKENS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case, t):
    cfg, d = CASES[case]
    p, jp = _weights(cfg, d)
    x = _x(t, d, seed=t)
    out, aux = MOE.moe_apply(p, torch.from_numpy(x), cfg)
    jout, jaux = jax.jit(lambda p, x: jMOE.moe_apply(p, x, _jcfg(cfg)))(
        jp, jnp.asarray(x))
    _close(out, jout, what="out")
    _close(aux, jaux, what="aux")
    p_top, ids, _ = MOE._route(torch.from_numpy(x), p["router"], cfg)
    jp_top, jids, _ = jMOE._route(jnp.asarray(x), jp["router"], _jcfg(cfg))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(p_top, jp_top, what="p_top")
    kept = _kept_port(ids.numpy(), cfg)
    assert kept == _kept_numpy(ids.numpy(), cfg)
    _close(out, _per_token_numpy(x, p, ids.numpy(), p_top.numpy(), kept),
           what="per-token sum")
    if (case, t) == ("granite-e40k8", 64):
        # granite's 64-token call: capacity 16 against a mean load of 12.8
        assert MOE.capacity(t, cfg) == 16
        assert len(kept) < t * cfg.top_k, "no pair dropped"


def test_capacity_at_granite_sizes():
    """Capacity = min(max(8, ceil(T k / E * 1.25 / 8) * 8), T) at granite's
    E 40, k 8: a 16-slot decode step, a 64-token call, one token."""
    cfg = CASES["granite-e40k8"][0]
    assert [MOE.capacity(t, cfg) for t in (1, 7, 16, 64, 100, 2048)] == \
        [1, 7, 8, 16, 32, 512]


def test_forced_drops_match_jax():
    """A zero router ties every expert: each token picks experts 0..k-1
    (``lax.top_k``'s order), so those experts' queues hold every token and
    keep the first ``capacity``; the later tokens' pairs are dropped and
    their output is 0 in both packages."""
    cfg, d = CASES["reduced"]
    p, jp = _weights(cfg, d)
    p["router"] = torch.zeros_like(p["router"])
    jp["router"] = jnp.zeros_like(jp["router"])
    t = 64
    x = _x(t, d, seed=5)
    out, _ = MOE.moe_apply(p, torch.from_numpy(x), cfg)
    jout, _ = jMOE.moe_apply(jp, jnp.asarray(x), _jcfg(cfg))
    _close(out, jout)
    cap = MOE.capacity(t, cfg)
    assert cap == 24
    ids = np.tile(np.arange(cfg.top_k), (t, 1))
    kept = _kept_port(ids, cfg)
    assert kept == {(tok, e) for tok in range(cap) for e in range(2)}
    np.testing.assert_array_equal(np.asarray(jout)[cap:], 0.0)
    np.testing.assert_array_equal(out[cap:].numpy(), 0.0)
    assert np.abs(out[:cap].numpy()).min(axis=1).max() > 0


def test_ties_go_to_the_lower_expert_index():
    for case in sorted(CASES):
        cfg, d = CASES[case]
        x = _x(5, d)
        zero = np.zeros((d, cfg.n_experts), np.float32)
        _, ids, _ = MOE._route(torch.from_numpy(x), torch.from_numpy(zero),
                               cfg)
        _, jids, _ = jMOE._route(jnp.asarray(x), jnp.asarray(zero),
                                 _jcfg(cfg))
        want = np.tile(np.arange(cfg.top_k), (5, 1))
        np.testing.assert_array_equal(np.asarray(jids), want)
        np.testing.assert_array_equal(ids.numpy(), want)
        # a tie among the top-k and the next: equal columns 3 and 5 both
        # top, 3 first
        r = np.random.RandomState(0).normal(size=(d, cfg.n_experts)) * 1e-3
        r[:, 5] = r[:, 3] = 1.0
        _, ids, _ = MOE._route(torch.ones(1, d), torch.from_numpy(
            r.astype(np.float32)), cfg)
        assert ids[0, :2].tolist() == [3, 5]


def test_row_order_changes_the_output_as_in_jax():
    """Permuting the rows of a call that drops pairs moves which tokens
    an expert keeps: the port's output under the permutation equals
    JAX's under it, and is not the permuted output."""
    cfg, d = CASES["granite-e40k8"]
    p, jp = _weights(cfg, d, seed=3)
    t = 64
    x = _x(t, d, seed=64)
    perm = np.random.RandomState(7).permutation(t)
    out, _ = MOE.moe_apply(p, torch.from_numpy(x), cfg)
    pout, _ = MOE.moe_apply(p, torch.from_numpy(x[perm]), cfg)
    jpout, _ = jMOE.moe_apply(jp, jnp.asarray(x[perm]), _jcfg(cfg))
    _close(pout, jpout)
    moved = np.abs(pout.numpy() - out.numpy()[perm]).max(axis=1) > 1e-4
    assert moved.any(), "the permutation changed no token's output"
    # without drops the order does not matter
    big = dataclasses.replace(cfg, capacity_factor=100.0)
    a, _ = MOE.moe_apply(p, torch.from_numpy(x), big)
    b, _ = MOE.moe_apply(p, torch.from_numpy(x[perm]), big)
    _close(b, a.numpy()[perm])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    """d(sum(out * g) + aux) with respect to x, the router and each expert
    weight, at 64 tokens (the capacity drops pairs)."""
    cfg, d = CASES[case]
    p, jp = _weights(cfg, d, seed=4)
    t = 64
    x = _x(t, d, seed=9)
    g = np.random.RandomState(10).normal(size=(t, d)).astype(np.float32)

    def jloss(p, x):
        out, aux = jMOE.moe_apply(p, x, _jcfg(cfg))
        return jnp.sum(out * g) + aux
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))

    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = MOE.moe_apply(leaves, xt, cfg)
    ((out * torch.from_numpy(g)).sum() + aux).backward()
    grads = {"x": (xt.grad, jgx)}
    grads.update({k: (v.grad, jgp[k]) for k, v in leaves.items()})
    for name, (got, want) in grads.items():
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err <= GRAD_RTOL, (name, err)


def test_shared_expert_matches_jax():
    cfg = dataclasses.replace(CASES["reduced"][0], n_shared=1)
    d = CASES["reduced"][1]
    p, jp = _weights(cfg, d, seed=6)
    assert p["shared"]["down"]["w"].shape == (cfg.d_ff, d)
    x = _x(16, d)
    out, aux = MOE.moe_apply(p, torch.from_numpy(x), cfg)
    jout, jaux = jMOE.moe_apply(jp, jnp.asarray(x), _jcfg(cfg))
    _close(out, jout)
    _close(aux, jaux)


def test_router_stays_float32_in_bf16():
    """A bf16 init keeps the router float32 and the experts bf16; a bf16
    call routes on float32 logits and returns bf16.  (B, S, D) input
    routes its B * S tokens together, row-major."""
    cfg, d = CASES["reduced"]
    p, _ = _weights(cfg, d, dtype=torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert {p[k].dtype for k in ("w_gate", "w_up", "w_down")} == \
        {torch.bfloat16}
    x = torch.from_numpy(_x(12, d)).to(torch.bfloat16)
    out, aux = MOE.moe_apply(p, x.reshape(3, 4, d), cfg)
    assert out.dtype == torch.bfloat16 and out.shape == (3, 4, d)
    assert aux.dtype == torch.float32
    flat, _ = MOE.moe_apply(p, x, cfg)
    assert torch.equal(out.reshape(12, d), flat)
    with pytest.raises(ValueError, match="ep_mode"):
        MOE.moe_apply(p, x, cfg, ep_mode="pp")


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_flops_match_jax(case):
    cfg, d = CASES[case]
    for t in (1, 64, 4096):
        assert MOE.moe_flops(t, d, cfg) == jMOE.moe_flops(t, d, _jcfg(cfg))
    assert math.isclose(MOE.moe_flops(1, d, cfg),
                        2 * d * cfg.n_experts
                        + 6 * cfg.top_k * d * cfg.d_ff)
