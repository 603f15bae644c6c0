"""EngineState — the complete DART serving state in one object.

Threshold parameters, the section II.C sliding-window state and the
serving counters, as tensors on the engine's device.  The fields are
those of the JAX package's ``engine/state.py`` (the latency, slot and
quote telemetry is written by the serving layers of later slices);
scalar knobs such as ``beta_diff`` are 0-d tensors.  Checkpointing waits
for the checkpoint slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import adaptive as AD
from repro_torch.core.routing import DartParams
from repro_torch.device import resolve

#: Default size of the per-request latency ring buffer.
LAT_WINDOW = 2048


@dataclasses.dataclass
class EngineState:
    """tau / coef:   (E-1,) Eq. 19 base thresholds and coefficients
    beta_diff:    () difficulty sensitivity (Eq. 19)
    beta_opt:     () accuracy/cost trade-off (Eq. 10)
    adaptive:     the ``core.adaptive.init_state`` dict (ring buffers,
                  per-class coefficients, UCB1 counters)
    served:       () int32 — total samples served
    exit_counts:  (E,) int32 — per-exit routed counts
    total_macs:   () float32 — cumulative MACs actually spent
    since_update: () int32 — samples since the last periodic update
    lat_ms, lat_ptr, lat_count, deadline_miss: per-request latency ring
                  and deadline misses (serving layer)
    slot_steps, decode_steps, pages_peak: continuous-batching counters
    quote_ms_sum, quote_err_ms_sum, quote_count: admission-quote error
    """
    tau: torch.Tensor
    coef: torch.Tensor
    beta_diff: torch.Tensor
    beta_opt: torch.Tensor
    adaptive: dict
    served: torch.Tensor
    exit_counts: torch.Tensor
    total_macs: torch.Tensor
    since_update: torch.Tensor
    lat_ms: torch.Tensor
    lat_ptr: torch.Tensor
    lat_count: torch.Tensor
    deadline_miss: torch.Tensor
    slot_steps: torch.Tensor
    decode_steps: torch.Tensor
    pages_peak: torch.Tensor
    quote_ms_sum: torch.Tensor
    quote_err_ms_sum: torch.Tensor
    quote_count: torch.Tensor

    @classmethod
    def create(cls, n_exits: int, acfg: AD.AdaptiveConfig,
               dart: DartParams | None = None,
               lat_window: int = LAT_WINDOW, device=None) -> "EngineState":
        """Fresh state on ``device`` (``None``: the CUDA card)."""
        device = resolve(device)
        dart = dart or DartParams.default(n_exits)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        def zeros(shape=(), dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            tau=f32(dart.tau), coef=f32(dart.coef),
            beta_diff=f32(dart.beta_diff), beta_opt=f32(dart.beta_opt),
            adaptive=AD.init_state(acfg, device),
            served=zeros(), exit_counts=zeros((n_exits,)),
            total_macs=zeros(dtype=torch.float32), since_update=zeros(),
            lat_ms=zeros((lat_window,), torch.float32), lat_ptr=zeros(),
            lat_count=zeros(), deadline_miss=zeros(),
            slot_steps=zeros(), decode_steps=zeros(), pages_peak=zeros(),
            quote_ms_sum=zeros(dtype=torch.float32),
            quote_err_ms_sum=zeros(dtype=torch.float32),
            quote_count=zeros())

    def with_policy(self, tau=None, coef=None, beta_diff=None,
                    beta_opt=None) -> "EngineState":
        """Functional update of the threshold parameters."""
        dev = self.tau.device
        rep = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
               for k, v in (("tau", tau), ("coef", coef),
                            ("beta_diff", beta_diff),
                            ("beta_opt", beta_opt)) if v is not None}
        return dataclasses.replace(self, **rep)
