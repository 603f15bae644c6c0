"""Request objects and completion futures for the async scheduler.

A ``Request`` is one caller-submitted sample batch travelling through
the scheduler: admitted (difficulty estimated, cost predicted), queued
in a difficulty-class lane, flushed as part of a consolidated bucket,
and finally resolved through its ``concurrent.futures.Future``.

Backpressure outcomes surface as exceptions ON THE FUTURE — submit
itself never raises for load reasons, so producers keep a uniform
``submit(...).result()`` call shape:

* :class:`RequestShed`     — evicted by a higher-priority arrival
  (``policy="shed"``).
* :class:`RequestRejected` — refused at admission because the lane was
  full (``policy="reject"``).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import Future

import numpy as np


class RequestShed(RuntimeError):
    """Queued request evicted to make room for higher-priority work."""


class RequestRejected(RuntimeError):
    """Request refused at admission (lane over its queue limit)."""


class DispatchError(RuntimeError):
    """Structured failure of one dispatched/materialized bucket.

    Futures fail with THIS (never a raw engine exception): callers see
    which stage broke (``dispatch`` | ``complete`` | ``step``), which
    lane and rids were affected, and the underlying ``cause`` — enough
    to tell an injected fault from a malformed input without scraping
    tracebacks.  Output-validation quarantine failures surface here too
    (stage ``complete``, cause :class:`InvalidEngineOutput`).
    """

    def __init__(self, stage: str, lane, rids, cause: BaseException):
        self.stage = stage
        self.lane = lane
        self.rids = list(rids)
        self.cause = cause
        super().__init__(
            f"bucket {stage} failed (lane={lane!r}, "
            f"rids={self.rids[:8]}): {type(cause).__name__}: {cause}")
        self.__cause__ = cause


class InvalidEngineOutput(RuntimeError):
    """An engine call returned values that fail validation (non-finite
    confidence or out-of-range exit stage) — quarantined instead of
    being folded into telemetry."""


@dataclasses.dataclass
class Request:
    """One in-flight request (a sample batch + its admission metadata).

    rid:            monotonically increasing id (FIFO tiebreaker)
    x:              (n, ...) the request's samples
    n:              number of samples
    alpha:          (n,) Eq. 8 difficulty, estimated once at admission
    lane:           scheduler lane key (difficulty class, or (S, n_new)
                    for LM decode)
    predicted_cost: expected normalized MACs/sample (admission planner)
    priority:       larger = more important; sheds last
    t_submit:       scheduler-clock seconds at submit
    deadline_s:     absolute scheduler-clock deadline (None = best effort)
    future:         resolves to the per-request result dict
    """
    rid: int
    x: np.ndarray
    n: int
    alpha: np.ndarray
    lane: object
    predicted_cost: float
    priority: int
    t_submit: float
    deadline_s: float | None
    future: Future
    payload: dict = dataclasses.field(default_factory=dict)

    def fail(self, exc: Exception) -> None:
        if not self.future.done():
            self.future.set_exception(exc)

    def resolve(self, result: dict) -> None:
        if not self.future.done():
            self.future.set_result(result)
