"""repro_torch.obs.trace — lock-light per-request span recorder.

Spans follow a request through the scheduler lifecycle::

    admit -> queue_wait -> bucket -> compiled_step -> exit
                                                    | shed / reject

carrying difficulty class (lane), predicted vs realized exit depth and
deadline slack.  Spans are recorded on the host only, from scheduler
code, never between kernel launches of a forward: device telemetry
keeps flowing through the ``EngineState`` fold, and the tracer is joined
against it after ``stats()``.  (``compiled_step`` keeps the JAX
package's name for the dispatch-to-completion span.)

The ring is a ``collections.deque(maxlen=capacity)``: append is O(1),
overflow drops the OLDEST span, and CPython's deque append is atomic
under the GIL, so the record path takes no lock (the ``dropped`` counter
is therefore approximate under contention: a gauge of pressure, not an
audit log).

Export: JSONL (one span per line) and Chrome ``trace_event`` JSON via
:func:`chrome_trace`, which Perfetto / ``chrome://tracing`` load.
"""
from __future__ import annotations

import json
from collections import deque

__all__ = ["Tracer", "chrome_trace", "load_jsonl"]

#: canonical span names (informational; the tracer accepts any name)
SPAN_NAMES = ("admit", "queue_wait", "bucket", "slot", "compiled_step",
              "exit", "escalate", "shed", "reject")


def _jsonable(v):
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, tuple):
        return list(v)
    return str(v)


class Tracer:
    """Bounded span ring.  ``record`` is the only hot-path method; it
    builds one dict and appends — no locks, no syncs, no I/O."""

    def __init__(self, capacity: int = 16384):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=max(self.capacity, 1))
        self.dropped = 0

    def record(self, name: str, *, ts: float, dur: float = 0.0,
               rid=None, lane=None, **attrs) -> None:
        """One span: ``ts``/``dur`` in scheduler-clock seconds."""
        if self.capacity <= 0:
            return
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1                      # approximate, lock-free
        span = {"name": name, "ts": ts, "dur": dur}
        if rid is not None:
            span["rid"] = rid
        if lane is not None:
            span["lane"] = lane
        if attrs:
            span.update(attrs)
        self._ring.append(span)

    def __len__(self) -> int:
        return len(self._ring)

    def spans(self, name: str | None = None) -> list:
        """Snapshot (oldest first), optionally filtered by span name."""
        out = list(self._ring)
        if name is not None:
            out = [s for s in out if s["name"] == name]
        return out

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0

    def export_jsonl(self, path: str) -> int:
        """Write one span per line; returns the number written."""
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s, default=_jsonable) + "\n")
        return len(spans)


def load_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def chrome_trace(spans) -> dict:
    """Chrome ``trace_event`` JSON (the object format Perfetto and
    ``chrome://tracing`` load).  Each lane becomes a named thread;
    span attrs ride along in ``args``."""
    tids: dict = {}
    events = []
    for s in spans:
        lane = s.get("lane", "-")
        key = repr(lane)
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = len(tids) + 1
            events.append({"ph": "M", "pid": 0, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": f"lane {key}"}})
        args = {k: _jsonable(v) if not isinstance(
                    v, (int, float, str, bool, type(None))) else v
                for k, v in s.items() if k not in ("name", "ts", "dur")}
        events.append({"name": s["name"], "ph": "X", "pid": 0, "tid": tid,
                       "ts": float(s["ts"]) * 1e6,
                       "dur": max(float(s.get("dur", 0.0)), 0.0) * 1e6,
                       "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
