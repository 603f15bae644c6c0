"""DART evaluation metrics — DAES (Eq. 9) and Eqs. 20–22.

    Speedup(m)          = T_static / T_m                     (Eq. 20)
    P_m                 = E_m / T_m                           (Eq. 21)
    Power_Efficiency(m) = E_static / E_m                      (Eq. 22)
    DAES                = Acc × Speedup × PowerEff / (1 + ᾱ)  (Eq. 9)

On hardware the paper integrates NVIDIA-SMI power.  Energy here is the
paper's own "architecture-agnostic" model, E ∝ MACs.

A copy of the JAX package's ``core/daes.py`` under its ``macs`` energy
model: the offline Table I rows and the serving half,
:class:`LaneDaesAccumulator`, which folds Eq. 9 per scheduler lane.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np


@dataclasses.dataclass
class MethodMeasurement:
    name: str
    accuracy: float              # top-1 in [0, 1]
    time_s: float                # median per-inference wall clock
    macs: float                  # mean MACs per inference


def speedup(static: MethodMeasurement, m: MethodMeasurement) -> float:
    return static.time_s / max(m.time_s, 1e-12)


def power_efficiency(static: MethodMeasurement,
                     m: MethodMeasurement) -> float:
    return static.macs / max(m.macs, 1e-12)


def daes(static: MethodMeasurement, m: MethodMeasurement,
         mean_alpha: float) -> float:
    """Eq. 9.  ``mean_alpha`` = dataset mean difficulty (paper: MNIST 0.76,
    CIFAR-10 0.85)."""
    return (m.accuracy * speedup(static, m)
            * power_efficiency(static, m)) / (1.0 + mean_alpha)


def summary_row(static: MethodMeasurement, m: MethodMeasurement,
                mean_alpha: float) -> dict:
    return {
        "method": m.name,
        "acc_pct": 100.0 * m.accuracy,
        "time_ms": 1e3 * m.time_s,
        "macs_m": m.macs / 1e6,
        "speedup": speedup(static, m),
        "power_eff": power_efficiency(static, m),
        "daes": daes(static, m, mean_alpha),
    }


# ---------------------------------------------------------------------------
# Streaming per-lane DAES (serving telemetry)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _LaneAccum:
    n: int = 0
    sum_conf: float = 0.0
    sum_macs: float = 0.0
    sum_alpha: float = 0.0


class LaneDaesAccumulator:
    """Eq. 9 folded online, one accumulator per scheduler lane.

    At serving time there are no labels, so accuracy is the section II.C
    confidence-calibrated pseudo-correctness (mean exited confidence),
    and the energy/time reference is the ``macs`` model: the static
    baseline always pays ``static_macs`` (the full network), a lane pays
    its mean routed MACs.  ``rows()`` renders everything through
    :func:`summary_row`, so the serving report and the offline Table I
    report share one formula."""

    def __init__(self, static_macs: float = 1.0):
        self.static_macs = float(static_macs)
        self._lanes: dict = {}
        self._lock = threading.Lock()

    def observe(self, lane, conf, macs, alpha) -> None:
        """Fold one completed request's per-sample conf/macs/alpha."""
        conf = np.asarray(conf, np.float64)
        with self._lock:
            a = self._lanes.setdefault(lane, _LaneAccum())
            a.n += int(conf.size)
            a.sum_conf += float(conf.sum())
            a.sum_macs += float(np.sum(macs))
            a.sum_alpha += float(np.sum(alpha))

    def rows(self) -> dict:
        """lane -> :func:`summary_row` dict (+ sample count ``n``)."""
        static = MethodMeasurement("static", accuracy=1.0,
                                   time_s=self.static_macs,
                                   macs=self.static_macs)
        out = {}
        with self._lock:
            lanes = list(self._lanes.items())
        for lane, a in sorted(lanes, key=lambda kv: str(kv[0])):
            if not a.n:
                continue
            mean_macs = a.sum_macs / a.n
            m = MethodMeasurement(name=str(lane), accuracy=a.sum_conf / a.n,
                                  time_s=mean_macs, macs=mean_macs)
            row = summary_row(static, m, a.sum_alpha / a.n)
            row["n"] = a.n
            out[lane] = row
        return out
