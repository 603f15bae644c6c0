"""RequestQueue — thread-safe, lane-keyed admission queue with
backpressure.

Lanes are FIFO deques keyed by whatever the scheduler packs together
(the difficulty class, with the predicted-depth band when exit-depth
prediction is on, for classifier serving; ``(prompt_len, n_new)`` for
LM decode).  Keeping lanes cost-homogeneous is the difficulty-aware part
of the design: a bucket flushed from one lane contains requests with
similar predicted exit depth, so one hard straggler never drags a
bucket of easy requests through every stage.

Backpressure triggers when a lane holds ``max_queue`` requests:

* ``shed``   — evict the lowest-priority request (FIFO-newest among
  ties) to admit the new one; if the new request itself has the lowest
  priority, IT is shed.  Eviction resolves the victim's future with
  :class:`RequestShed`.
* ``reject`` — refuse the new request (:class:`RequestRejected` on its
  future); queued work is never dropped.
* ``degrade-alpha`` — handled upstream by the admission planner (the
  request is admitted with a scaled-down difficulty so it exits
  earlier and costs less); the queue falls back to ``shed`` if the
  degraded lane is also full.
"""
from __future__ import annotations

import threading
from collections import deque

from repro_torch.serving.request import (Request, RequestRejected,
                                         RequestShed)

POLICIES = ("shed", "reject", "degrade-alpha")


class RequestQueue:
    def __init__(self, max_queue: int = 256, policy: str = "shed"):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
        self.max_queue = max_queue
        self.policy = policy
        self._lanes: dict = {}
        self._lock = threading.Lock()
        self.shed = 0
        self.rejected = 0
        self.starved = 0    # pop_next held capacity for a senior head

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def push(self, req: Request) -> str:
        """Enqueue under the backpressure policy.  Returns the action
        taken: "queued" | "shed" (a victim was evicted or the new
        request itself was) | "rejected"."""
        with self._lock:
            lane = self._lanes.setdefault(req.lane, deque())
            if len(lane) < self.max_queue:
                lane.append(req)
                return "queued"
            if self.policy == "reject":
                self.rejected += 1
                req.fail(RequestRejected(
                    f"lane {req.lane!r} at its limit of {self.max_queue}"))
                return "rejected"
            # shed (also the fallback for degrade-alpha): lowest
            # priority goes first, FIFO-newest among equals.
            victim = min(lane, key=lambda r: (r.priority, -r.rid))
            if req.priority <= victim.priority:
                victim = req          # the newcomer is the least urgent
            else:
                lane.remove(victim)
                lane.append(req)
            self.shed += 1
            victim.fail(RequestShed(
                f"shed from lane {victim.lane!r} "
                f"(priority {victim.priority})"))
            return "shed"

    def requeue(self, req: Request) -> str:
        """Re-admit a request whose bucket lost its engine (the engine
        pool's requeue), BYPASSING the backpressure policy: the request
        already passed admission, and shedding it now would break the
        invariant that an admitted request eventually resolves.  The
        pool bounds how often one request comes back, so this cannot
        grow a lane unboundedly."""
        with self._lock:
            self._lanes.setdefault(req.lane, deque()).append(req)
        return "queued"

    # ------------------------------------------------------------------
    # lane views (all O(lane) worst case; lanes are short)
    # ------------------------------------------------------------------
    def keys(self) -> list:
        with self._lock:
            return [k for k, lane in self._lanes.items() if lane]

    def depth(self, key) -> int:
        with self._lock:
            return len(self._lanes.get(key, ()))

    def samples(self, key) -> int:
        with self._lock:
            return sum(r.n for r in self._lanes.get(key, ()))

    @property
    def empty(self) -> bool:
        with self._lock:
            return not any(self._lanes.values())

    def oldest_submit(self, key) -> float | None:
        with self._lock:
            lane = self._lanes.get(key)
            return lane[0].t_submit if lane else None

    def oldest_undeadlined(self, key) -> float | None:
        """Submit time of the oldest BEST-EFFORT (deadline-less) request
        — the hold-flush clock.  Deadline'd requests are governed by
        deadline pressure instead, so they can wait for consolidation
        as long as their SLO allows."""
        with self._lock:
            lane = self._lanes.get(key) or ()
            ts = [r.t_submit for r in lane if r.deadline_s is None]
            return min(ts) if ts else None

    def earliest_deadline(self, key) -> float | None:
        with self._lock:
            lane = self._lanes.get(key) or ()
            ds = [r.deadline_s for r in lane if r.deadline_s is not None]
            return min(ds) if ds else None

    def pop_next(self, fits, *, reserve_after_s: float = 0.05,
                 now: float | None = None,
                 prefer=None) -> Request | None:
        """Pop the most urgent lane head that ``fits`` — the continuous
        slot-refill primitive (no bucket consolidation; one request at
        a time as slots free up).

        Lane heads are ranked (priority desc, submit time asc, rid
        asc).  If the MOST urgent head does not fit right now and has
        already waited ``reserve_after_s``, returns None WITHOUT
        considering junior heads: freed capacity is reserved for the
        starved senior instead of an endless stream of smaller juniors
        backfilling around it.

        ``prefer`` (optional, ``Request -> float``) breaks ties among
        SAME-URGENCY fitting heads (equal priority, submit times within
        ``reserve_after_s``): the LM continuous session scores
        candidates by how well their predicted exit depth matches the
        slot pool's current stage mix.  Urgency order is never
        violated: a strictly more urgent fitting head still wins
        regardless of score."""
        with self._lock:
            heads = [lane[0] for lane in self._lanes.values() if lane]
            heads.sort(key=lambda r: (-r.priority, r.t_submit, r.rid))
            best = None
            for r in heads:
                if fits(r):
                    if prefer is None:
                        self._lanes[r.lane].popleft()
                        return r
                    if best is None:
                        best = r
                    elif (r.priority == best.priority
                            and r.t_submit - best.t_submit
                            <= reserve_after_s):
                        if prefer(r) > prefer(best):
                            best = r
                    else:
                        break   # strictly less urgent: stop scanning
                    continue
                if best is None and now is not None \
                        and now - r.t_submit >= reserve_after_s:
                    self.starved += 1
                    return None     # hold capacity for this head
            if best is not None:
                self._lanes[best.lane].popleft()
            return best

    # ------------------------------------------------------------------
    # flush
    # ------------------------------------------------------------------
    def take(self, key, max_samples: int, bucket_key, *,
             min_fill: float = 0.5, force: bool = False) -> list[Request]:
        """Pop a FIFO run of whole requests totalling ≤ ``max_samples``.

        ``bucket_key(n)`` maps a sample count to its padded shape.
        Unless ``force`` (deadline pressure), the run stops
        before a request that would grow the padded shape into the next
        bucket while filling it below ``min_fill`` — flushing now at
        the smaller bucket beats padding waste at the larger one."""
        with self._lock:
            lane = self._lanes.get(key)
            out: list[Request] = []
            total = 0
            while lane:
                nxt = lane[0]
                new_total = total + nxt.n
                if new_total > max_samples:
                    if not out:
                        # oversized single request: dispatch it alone
                        # (the engine chunk-splits internally)
                        out.append(lane.popleft())
                    break
                if out and not force:
                    b_old, b_new = bucket_key(total), bucket_key(new_total)
                    if b_new > b_old and new_total / b_new < min_fill:
                        break
                out.append(lane.popleft())
                total = new_total
            return out

    def drain(self) -> list[Request]:
        """Pop everything (close/shutdown path), FIFO by admission id."""
        with self._lock:
            reqs = [r for lane in self._lanes.values() for r in lane]
            self._lanes.clear()
        return sorted(reqs, key=lambda r: r.rid)
