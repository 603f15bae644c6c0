"""DART adaptive coefficient management — paper section II.C (Eqs. 13-15).

State is a dict of tensors on the engine's device:

* sliding window (w = 1000) of per-inference records: exit index, class
  (pseudo-label), confidence, correctness-proxy, cost;
* per-exit temporal coefficients (Eq. 13, exponential decay);
* per-(class, exit) coefficients (Eq. 14, pseudo-label updates);
* UCB1 bandit counters over adaptation strategies (Eq. 15).

Every update returns a new dict and leaves its input untouched, like the
JAX reference; the buffers are small (one window), so the copies cost
nothing next to a forward pass.  With UCB disabled the system reduces to
deterministic threshold adaptation (paper section II.C.2).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve

STRATEGIES = ("temporal", "class_aware", "hybrid", "frozen")


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    n_exits: int
    n_classes: int
    window: int = 1000              # paper: w = 1000
    alpha_decay: float = 0.95       # paper: alpha_decay
    eta: float = 0.05               # Eq. 14 adaptation rate
    a_target: float = 0.85          # Eq. 14 target accuracy
    kappa: float = 0.5              # Eq. 13 performance->coefficient gain
    coef_min: float = 0.5
    coef_max: float = 1.5
    pseudo_label_conf: float = 0.9  # min confidence to accept pseudo-label
    ucb_enabled: bool = True
    update_every: int = 100         # small periodic updates


def init_state(cfg: AdaptiveConfig, device=None):
    """Fresh state on ``device`` (``None``: the CUDA card)."""
    device = resolve(device)
    e1 = cfg.n_exits - 1
    w = cfg.window

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32, f32 = torch.int32, torch.float32
    return {
        # ring buffers (sliding window)
        "buf_exit": z((w,), i32),
        "buf_class": z((w,), i32),
        "buf_conf": z((w,), f32),
        "buf_correct": z((w,), f32),   # pseudo-correctness
        "buf_cost": z((w,), f32),
        "buf_valid": z((w,), f32),
        "ptr": z((), i32),
        "seen": z((), i32),
        # coefficients
        "coef_temporal": torch.ones((e1,), dtype=f32, device=device),
        "coef_class": torch.ones((cfg.n_classes, e1), dtype=f32,
                                 device=device),
        # UCB1 (Eq. 15)
        "ucb_counts": z((len(STRATEGIES),), f32),
        "ucb_rewards": z((len(STRATEGIES),), f32),
        "active_strategy": z((), i32),
        "t": z((), i32),
    }


def record_batch(state, cfg: AdaptiveConfig, exit_idx, pseudo_class, conf,
                 correct, cost, valid=None):
    """Append a batch of inference records into the ring buffer.  All
    args: (B,) tensors on the state's device.  ``valid``: optional (B,)
    0/1 mask of lanes that are padding, not samples.

    A batch longer than the window keeps only its last ``window`` rows,
    which is what writing every row in order would leave behind."""
    b = exit_idx.shape[0]
    w = cfg.window
    first = max(b - w, 0)
    idx = (state["ptr"].long() + first
           + torch.arange(b - first, device=exit_idx.device)) % w
    s = dict(state)

    def put(key, vals, dtype):
        s[key] = state[key].index_copy(0, idx, vals[first:].to(dtype))

    put("buf_exit", exit_idx, torch.int32)
    put("buf_class", pseudo_class, torch.int32)
    put("buf_conf", conf, torch.float32)
    put("buf_correct", correct, torch.float32)
    put("buf_cost", cost, torch.float32)
    if valid is None:
        put("buf_valid", torch.ones(b, device=exit_idx.device),
            torch.float32)
        n_real = b
    else:
        validf = torch.as_tensor(valid, dtype=torch.float32,
                                 device=exit_idx.device)
        put("buf_valid", validf, torch.float32)
        n_real = validf.sum().to(torch.int32)
    s["ptr"] = (state["ptr"] + b) % w
    s["seen"] = state["seen"] + n_real
    return s


def window_stats(state, cfg: AdaptiveConfig):
    """Windowed accuracy / cost / per-class accuracy / per-exit counts."""
    v = state["buf_valid"]
    n = torch.clamp(v.sum(), min=1.0)
    acc = (state["buf_correct"] * v).sum() / n
    cost = (state["buf_cost"] * v).sum() / n
    onehot_c = F.one_hot(state["buf_class"].long(),
                         cfg.n_classes).float() * v[:, None]
    cls_n = torch.clamp(onehot_c.sum(dim=0), min=1.0)
    cls_acc = (onehot_c * state["buf_correct"][:, None]).sum(dim=0) / cls_n
    onehot_e = F.one_hot(state["buf_exit"].long(),
                         cfg.n_exits).float() * v[:, None]
    exit_frac = onehot_e.sum(dim=0) / n
    return {"acc": acc, "cost": cost, "class_acc": cls_acc,
            "class_n": onehot_c.sum(dim=0), "exit_frac": exit_frac,
            "n": n}


def window_exit_depth(state, cfg: AdaptiveConfig):
    """Mean routed exit index over the valid window — at what depth
    traffic has actually been exiting."""
    st = window_stats(state, cfg)
    depth = torch.arange(cfg.n_exits, dtype=torch.float32,
                         device=st["exit_frac"].device)
    return (st["exit_frac"] * depth).sum()


def temporal_update(state, cfg: AdaptiveConfig):
    """Eq. 13: c_t = alpha_decay*c_{t-1} + (1-alpha_decay)*f(performance_t);
    accuracy below the target raises coefficients (more conservative
    exits)."""
    st = window_stats(state, cfg)
    target = 1.0 + cfg.kappa * (cfg.a_target - st["acc"])
    c = cfg.alpha_decay * state["coef_temporal"] \
        + (1.0 - cfg.alpha_decay) * target
    s = dict(state)
    s["coef_temporal"] = torch.clamp(c, cfg.coef_min, cfg.coef_max)
    return s


def class_aware_update(state, cfg: AdaptiveConfig):
    """Eq. 14: c_class += eta*(A_target - A_class), from pseudo-labels."""
    st = window_stats(state, cfg)
    has_data = (st["class_n"] > 0).float()[:, None]
    delta = cfg.eta * (cfg.a_target - st["class_acc"])[:, None] * has_data
    s = dict(state)
    s["coef_class"] = torch.clamp(state["coef_class"] + delta,
                                  cfg.coef_min, cfg.coef_max)
    return s


def ucb_select(state, cfg: AdaptiveConfig):
    """Eq. 15: UCB_i(t) = mean r_i + sqrt(2 ln t / n_i).  Untried arms
    first."""
    t = torch.clamp(state["t"].float(), min=1.0)
    n = state["ucb_counts"]
    n1 = torch.clamp(n, min=1.0)
    mean_r = state["ucb_rewards"] / n1
    ucb = torch.where(n > 0, mean_r + torch.sqrt(2.0 * torch.log(t) / n1),
                      torch.full_like(n, float("inf")))
    return ucb.argmax().to(torch.int32)


def ucb_update(state, cfg: AdaptiveConfig, reward):
    """Credit the active strategy with the windowed Eq. 10 reward."""
    arm = state["active_strategy"].long().reshape(1)
    s = dict(state)
    s["ucb_counts"] = state["ucb_counts"].index_add(
        0, arm, torch.ones(1, device=arm.device))
    s["ucb_rewards"] = state["ucb_rewards"].index_add(
        0, arm, torch.as_tensor(reward, dtype=torch.float32,
                                device=arm.device).reshape(1))
    s["t"] = state["t"] + 1
    if cfg.ucb_enabled:
        s["active_strategy"] = ucb_select(s, cfg)
    return s


def effective_coef(state, cfg: AdaptiveConfig, pseudo_class=None):
    """Coefficient vector for the *active* strategy.

    pseudo_class: (B,) predicted classes (class-aware strategies index the
    per-class table with them); None -> batch-agnostic (E-1,)."""
    temporal = state["coef_temporal"]
    if pseudo_class is None:
        class_c = state["coef_class"].mean(dim=0)
    else:
        class_c = state["coef_class"][pseudo_class.long()]   # (B, E-1)
        temporal = temporal.expand_as(class_c)
    frozen = torch.ones_like(temporal)
    hybrid = 0.5 * (temporal + class_c)
    stacked = torch.stack([temporal, class_c, hybrid, frozen])
    return stacked[state["active_strategy"].long()]


def periodic_update(state, cfg: AdaptiveConfig, beta_opt=0.5):
    """One small periodic refinement step (paper section II.C.2): run both
    adaptation laws, score the window with the Eq. 10 reward, update
    UCB."""
    st = window_stats(state, cfg)
    reward = st["acc"] - beta_opt * st["cost"]
    state = temporal_update(state, cfg)
    state = class_aware_update(state, cfg)
    return ucb_update(state, cfg, reward)
