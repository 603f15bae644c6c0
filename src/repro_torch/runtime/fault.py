"""Fault tolerance: heartbeats, checkpoint-restart, straggler mitigation.

The port of the JAX package's ``runtime/fault.py`` on one device.  The
cluster's control plane is simulated in one process (threads stand for
workers); the data-plane mechanisms (atomic checkpoints, stateless data
seeding) are the real ones:

* **HeartbeatMonitor** — workers tick; a missed deadline marks the worker
  dead and fires the recovery callback.
* **checkpoint-restart** — ``Trainer`` checkpoints are atomic and carry
  the step; ``resume`` rebuilds a Trainer and restores, and the
  stateless data pipeline replays the exact batch sequence from that
  step (no skipped or duplicated data).
* **straggler mitigation** — a per-step deadline over a rolling median;
  a slow worker's shard is re-sliced across the others (``ShardPlan``).

Restarting onto another mesh (``mesh=`` / ``new_mesh=``) waits for the
multi-device slice (ROADMAP queue 1, item 9) and raises.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np

from repro_torch.runtime.trainer import TrainConfig, Trainer


# ---------------------------------------------------------------------------
# Heartbeats
# ---------------------------------------------------------------------------

class HeartbeatMonitor:
    """Deadline-based liveness with elastic membership.

    ``on_failure`` callbacks fire OUTSIDE the internal lock: a callback
    is allowed to call ``beat``/``add_worker``/``remove_worker`` (a
    recovery path that re-registers a replacement worker does exactly
    that) without deadlocking the watch thread.
    """

    def __init__(self, workers: list[str], timeout_s: float = 1.0,
                 on_failure: Callable[[str], None] | None = None):
        self.timeout_s = timeout_s
        self.on_failure = on_failure
        self.last = {w: time.monotonic() for w in workers}
        self.dead: set[str] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def beat(self, worker: str):
        with self._lock:
            self.last[worker] = time.monotonic()

    def add_worker(self, worker: str):
        """(Re-)register a worker: fresh deadline, cleared death mark."""
        with self._lock:
            self.last[worker] = time.monotonic()
            self.dead.discard(worker)

    def remove_worker(self, worker: str):
        """Deregister a worker (drained/decommissioned — not a failure:
        no callback fires and it is not marked dead)."""
        with self._lock:
            self.last.pop(worker, None)
            self.dead.discard(worker)

    def workers(self) -> list[str]:
        with self._lock:
            return list(self.last)

    def _watch(self):
        while not self._stop.is_set():
            now = time.monotonic()
            newly_dead = []
            with self._lock:
                for w, t in self.last.items():
                    if w not in self.dead and now - t > self.timeout_s:
                        self.dead.add(w)
                        newly_dead.append(w)
            # callbacks outside the lock: they may beat/re-register
            for w in newly_dead:
                if self.on_failure:
                    self.on_failure(w)
            time.sleep(self.timeout_s / 4)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)


# ---------------------------------------------------------------------------
# Straggler mitigation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardPlan:
    """Assignment of batch index ranges to workers for one step."""
    assignments: dict[str, np.ndarray]

    @staticmethod
    def even(workers: list[str], indices: np.ndarray) -> "ShardPlan":
        parts = np.array_split(indices, len(workers))
        return ShardPlan(dict(zip(workers, parts)))

    def reassign(self, straggler: str) -> "ShardPlan":
        """Re-slice the straggler's shard across the healthy workers.
        Because batches are stateless-seeded, this loses no data."""
        healthy = [w for w in self.assignments if w != straggler]
        orphan = self.assignments[straggler]
        parts = np.array_split(orphan, len(healthy))
        new = {w: self.assignments[w] for w in healthy}
        for w, extra in zip(healthy, parts):
            new[w] = np.concatenate([new[w], extra])
        return ShardPlan(new)


class StragglerPolicy:
    """Deadline-based detection over a rolling step-time estimate."""

    def __init__(self, factor: float = 3.0, window: int = 20):
        self.factor = factor
        self.times: list[float] = []
        self.window = window

    def deadline(self) -> float:
        if not self.times:
            return float("inf")
        return self.factor * float(np.median(self.times[-self.window:]))

    def record(self, dt: float):
        self.times.append(dt)

    def is_straggling(self, dt: float) -> bool:
        return dt > self.deadline()


# ---------------------------------------------------------------------------
# Checkpoint-restart
# ---------------------------------------------------------------------------

def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what} onto a mesh is not ported yet (ROADMAP queue 1, "
            "item 9)")


def resume(model_cfg, train_cfg: TrainConfig, *, mesh=None,
           data_cfg=None, device=None) -> Trainer:
    """Rebuild a Trainer and restore the latest checkpoint if one
    exists."""
    _no_mesh(mesh, "resuming")
    t = Trainer(model_cfg, train_cfg, data_cfg, device=device)
    t.restore()
    return t


def simulate_failure_and_recover(model_cfg, train_cfg: TrainConfig, *,
                                 fail_at: int, total_steps: int,
                                 data_cfg=None, new_mesh=None,
                                 device=None):
    """Train -> kill at ``fail_at`` -> restart -> finish.  Returns
    (losses_before, losses_after, trainer)."""
    _no_mesh(new_mesh, "restarting")
    t1 = Trainer(model_cfg, train_cfg, data_cfg, device=device)
    t1.run(steps=fail_at)
    t1.manager.wait()
    before = list(t1.history)
    del t1                                   # the "crash"

    t2 = resume(model_cfg, train_cfg, data_cfg=data_cfg, device=device)
    assert t2.step == fail_at or t2.step % train_cfg.ckpt_every == 0, \
        f"resumed at {t2.step}"
    t2.run(steps=total_steps)
    return before, t2.history, t2
