"""EngineState — the complete DART serving state in one object.

Threshold parameters, the section II.C sliding-window state and the
serving counters, as tensors on the engine's device.  The fields are
those of the JAX package's ``engine/state.py``; the latency and quote
telemetry is written from the host by the async scheduler
(``repro_torch.serving``), the slot counters wait for the LM session.
Scalar knobs such as ``beta_diff`` are 0-d tensors.  The state flattens
in ``_FIELDS`` order (the ``adaptive`` dict by sorted key), as the JAX
package's pytree does, so either package restores the other's
checkpoint; ``restore_with_migration`` also reads the older layouts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import adaptive as AD
from repro_torch.core.routing import DartParams
from repro_torch.device import resolve

#: The flatten order of an EngineState (the JAX package's).
_FIELDS = ("tau", "coef", "beta_diff", "beta_opt", "adaptive",
           "served", "exit_counts", "total_macs", "since_update",
           "lat_ms", "lat_ptr", "lat_count", "deadline_miss",
           "slot_steps", "decode_steps", "pages_peak",
           "quote_ms_sum", "quote_err_ms_sum", "quote_count")

#: The pre-latency-telemetry field set.  New telemetry leaves are only
#: ever appended to ``_FIELDS``, so every older checkpoint is a strict
#: prefix of the current flatten order.
LEGACY_FIELDS = _FIELDS[:-10]

#: Known older flatten orders, newest first: before the admission-quote
#: counters, before the slot/page counters, before latency telemetry.
#: Trying the longer prefix first keeps a latency-era checkpoint from
#: dropping its latency window.
_LAYOUT_PREFIXES = (_FIELDS[:-3], _FIELDS[:-6], LEGACY_FIELDS)

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

    #: flatten order for ``repro_torch.checkpoint``
    CKPT_FIELDS = _FIELDS

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


# ---------------------------------------------------------------------------
# Per-request serving telemetry (latency / deadline SLO)
# ---------------------------------------------------------------------------
# Request latency is a host quantity (the clock starts at submit() and
# stops when the scheduler completes the bucket), so these helpers run on
# numpy and write the result back as tensors on the state's device.

#: EngineState fields that carry per-sample serving telemetry
TELEMETRY_FIELDS = ("served", "exit_counts", "total_macs", "since_update",
                    "slot_steps", "decode_steps")


def telemetry_totals(state: EngineState) -> dict:
    """Host numpy copies of the telemetry leaves (what ``stats()``
    summarises)."""
    return {f: getattr(state, f).cpu().numpy() for f in TELEMETRY_FIELDS}


def record_requests(state: EngineState, latencies_ms,
                    missed=None) -> EngineState:
    """Fold a batch of completed requests into the latency ring buffer.

    latencies_ms: (k,) per-request wall latency; ``missed``: optional
    (k,) bools — completed after the request's deadline."""
    lat = np.atleast_1d(np.asarray(latencies_ms, np.float32))
    k, w = lat.shape[0], state.lat_ms.shape[0]
    if k == 0:
        return state
    ptr = int(state.lat_ptr)
    buf = state.lat_ms.cpu().numpy().copy()
    buf[(ptr + np.arange(k)) % w] = lat
    n_miss = int(np.sum(missed)) if missed is not None else 0
    dev = state.lat_ms.device
    return dataclasses.replace(
        state,
        lat_ms=torch.as_tensor(buf, device=dev),
        lat_ptr=torch.full_like(state.lat_ptr, (ptr + k) % w),
        lat_count=state.lat_count + k,
        deadline_miss=state.deadline_miss + n_miss)


def record_quotes(state: EngineState, quotes_ms,
                  realized_ms) -> EngineState:
    """Fold admission-time latency quotes vs realized latency for a
    batch of completed requests.  Entries with a None/NaN quote
    (admitted before the service EMA seeded) are skipped."""
    q = np.asarray([np.nan if v is None else v for v in quotes_ms],
                   np.float32)
    r = np.asarray(realized_ms, np.float32)
    ok = ~np.isnan(q)
    k = int(ok.sum())
    if k == 0:
        return state
    # float32 sums, as the JAX package adds float32 scalars
    return dataclasses.replace(
        state,
        quote_ms_sum=state.quote_ms_sum + float(q[ok].sum()),
        quote_err_ms_sum=state.quote_err_ms_sum
        + float(np.abs(q[ok] - r[ok]).sum()),
        quote_count=state.quote_count + k)


def latency_percentiles(lat_ms) -> dict:
    """p50/p95/p99/mean summary of a latency sample (ms)."""
    lat = np.asarray(lat_ms, np.float32)
    p50, p95, p99 = np.percentile(lat, [50.0, 95.0, 99.0])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
            "mean": float(lat.mean())}


def request_stats(state: EngineState) -> dict:
    """Windowed latency percentiles + lifetime deadline-miss rate."""
    n = int(state.lat_count)
    miss = int(state.deadline_miss)
    out = {"requests": n, "deadline_miss": miss,
           "miss_rate": miss / max(n, 1)}
    if n:
        out["latency_ms"] = latency_percentiles(
            state.lat_ms.cpu().numpy()[:min(n, state.lat_ms.shape[0])])
    qn = int(state.quote_count)
    if qn:
        out["quote"] = {
            "quoted": qn,
            "mean_quote_ms": float(state.quote_ms_sum) / qn,
            "mean_abs_err_ms": float(state.quote_err_ms_sum) / qn}
    return out


def restore_with_migration(path: str, template: EngineState,
                           step: int | None = None, *, device=None):
    """``checkpoint.restore`` with legacy-layout migration: a checkpoint
    whose leaves are a strict prefix of the current flatten order (an
    older ``_LAYOUT_PREFIXES`` layout) restores those fields and keeps
    the template's values for the rest.  Prefixes are tried newest
    first, so a checkpoint restores the LONGEST layout it matches.
    Every leaf lands on ``device`` (default: the template's).  Returns
    ``(state, step)``."""
    from repro_torch import checkpoint as CK
    try:
        restored, step, _ = CK.restore(path, template, step, device=device)
        return restored, step
    except ValueError as e:
        if "leaf count" not in str(e):
            raise
    for i, fields in enumerate(_LAYOUT_PREFIXES):
        legacy = [getattr(template, f) for f in fields]
        try:
            leaves, step, _ = CK.restore(path, legacy, step, device=device)
        except ValueError as e:
            if "leaf count" not in str(e) or i == len(_LAYOUT_PREFIXES) - 1:
                raise
            continue
        return dataclasses.replace(
            template, **dict(zip(fields, leaves))), step
    raise AssertionError("unreachable")
