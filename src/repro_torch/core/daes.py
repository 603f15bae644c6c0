"""DART evaluation metrics — DAES (Eq. 9) and Eqs. 20–22.

    Speedup(m)          = T_static / T_m                     (Eq. 20)
    P_m                 = E_m / T_m                           (Eq. 21)
    Power_Efficiency(m) = E_static / E_m                      (Eq. 22)
    DAES                = Acc × Speedup × PowerEff / (1 + ᾱ)  (Eq. 9)

On hardware the paper integrates NVIDIA-SMI power.  Energy here is the
paper's own "architecture-agnostic" model, E ∝ MACs.

A numpy-free copy of the offline rows of the JAX package's
``core/daes.py`` (its ``macs`` energy model).
"""
from __future__ import annotations

import dataclasses


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
