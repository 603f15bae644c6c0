"""repro_torch.obs.stats — the one ``stats()`` assembly of the engines.

    tel = ST.telemetry_totals(self.state)            # host copies
    out = OBS_STATS.engine_summary(tel)              # one key set
    ...engine-specific extras...
    return OBS_STATS.attach_requests(out, self.state)

so key naming cannot drift between engines, and the obs adapters (which
join the tracer's host spans against these reductions) read one shape.
"""
from __future__ import annotations

import numpy as np

__all__ = ["engine_summary", "attach_requests"]

#: keys every engine's stats() is guaranteed to carry
SUMMARY_KEYS = ("served", "exit_counts", "exit_frac", "total_macs",
                "mean_macs")


def engine_summary(telemetry: dict) -> dict:
    """Serving summary from host telemetry totals (the output of
    :func:`repro_torch.engine.state.telemetry_totals`)."""
    served = int(telemetry["served"])
    counts = np.asarray(telemetry["exit_counts"])
    total_macs = float(telemetry["total_macs"])
    return {"served": served,
            "exit_counts": counts,
            "exit_frac": counts / max(served, 1),
            "total_macs": total_macs,
            "mean_macs": total_macs / max(served, 1)}


def attach_requests(out: dict, state) -> dict:
    """Attach the latency-ring percentiles/miss-rate block (if any
    requests were recorded)."""
    from repro_torch.engine import state as ST
    req = ST.request_stats(state)
    if req["requests"]:
        out["requests"] = req
    return out
