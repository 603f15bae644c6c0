"""BatchCompactor — bucket-padded batch compaction for staged serving.

Survivors of each stage run through power-of-two buckets, so a stage
sees at most #buckets distinct batch shapes:

* ``bucket_for(n)``   — smallest bucket >= n; raises on overflow.
* ``chunks(n)``       — split an oversized request into <= max_bucket
  spans.
* ``pad(arr, bucket, fill)`` — pad axis 0 up to the bucket.  The engine
  pads the gate thresholds with 2.0, which no confidence exceeds, so
  padded lanes never fire.
* ``gather(arr, idx)`` — compact the survivors in one take.

The continuous LM decoder's host-side allocators (``OutOfCapacity``,
``PageAllocator``, ``SlotPool``) are copied from the JAX package with
their invariants.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_BUCKETS = tuple(2 ** i for i in range(0, 11))       # 1 .. 1024


class BatchTooLarge(ValueError):
    """Raised when a batch exceeds the largest bucket (use ``chunks``)."""


class BatchCompactor:
    def __init__(self, buckets=None):
        buckets = DEFAULT_BUCKETS if buckets is None \
            else tuple(sorted(buckets))
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"invalid buckets {buckets!r}")
        self.buckets = buckets

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        if n > self.max_bucket:
            raise BatchTooLarge(
                f"batch of {n} exceeds largest bucket {self.max_bucket}; "
                f"split it with .chunks({n})")
        return next(b for b in self.buckets if n <= b)

    def padded_size(self, n: int, multiple_of: int = 1) -> int:
        """Fixed serving shape for an ``n``-sample batch: the bucket for
        ``n``, rounded up to a multiple of ``multiple_of``."""
        b = self.bucket_for(n)
        return -(-b // multiple_of) * multiple_of

    def chunks(self, n: int) -> list[tuple[int, int]]:
        """[(start, end)) spans covering an n-sample request, each span
        no larger than the biggest bucket."""
        m = self.max_bucket
        return [(s, min(s + m, n)) for s in range(0, max(n, 0), m)]

    @staticmethod
    def pad(arr, bucket: int, fill=0.0):
        """Pad axis 0 of ``arr`` (tensor or numpy) up to ``bucket`` with
        ``fill``."""
        n = arr.shape[0]
        pad = bucket - n
        if pad < 0:
            raise BatchTooLarge(f"array of {n} rows > bucket {bucket}")
        if pad == 0:
            return arr
        if isinstance(arr, np.ndarray):
            return np.concatenate(
                [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])
        return torch.cat([arr, arr.new_full((pad,) + tuple(arr.shape[1:]),
                                            fill)])

    @staticmethod
    def gather(arr, idx):
        """Rows ``idx`` of ``arr``, compacted."""
        return arr.index_select(
            0, torch.as_tensor(idx, dtype=torch.long, device=arr.device))


# ---------------------------------------------------------------------------
# Slot-pool continuous batching: host-side resource accounting
# ---------------------------------------------------------------------------
#
# Both allocators partition their id space into ``n_ranges`` contiguous
# ranges (one per mesh replica in the JAX package).  The continuous
# decoder keeps the invariant "slot s draws KV pages only from
# range(s)", so a replica's page-table entries resolve into its own page
# shard.  The port is mesh-less so far and uses one range.


class OutOfCapacity(RuntimeError):
    """Raised on alloc from an exhausted slot/page range (callers are
    expected to gate on ``available`` / ``can_admit`` first)."""


class PageAllocator:
    """Free-list allocator over ``n_pages`` fixed-size KV pages.

    Double-alloc and double-free are programming errors and raise —
    the continuous-batching property harness leans on that.
    """

    def __init__(self, n_pages: int, n_ranges: int = 1):
        if n_pages <= 0 or n_ranges <= 0 or n_pages % n_ranges:
            raise ValueError(f"n_pages={n_pages} not divisible into "
                             f"{n_ranges} ranges")
        self.n_pages = n_pages
        self.n_ranges = n_ranges
        self.per_range = n_pages // n_ranges
        self._free = [list(range(r * self.per_range,
                                 (r + 1) * self.per_range))
                      for r in range(n_ranges)]
        self._held: set[int] = set()

    def available(self, rng: int = 0) -> int:
        return len(self._free[rng])

    @property
    def in_use(self) -> int:
        return len(self._held)

    def alloc(self, n: int, rng: int = 0) -> list[int]:
        free = self._free[rng]
        if n > len(free):
            raise OutOfCapacity(
                f"need {n} pages, range {rng} has {len(free)}")
        pages, self._free[rng] = free[:n], free[n:]
        for p in pages:
            if p in self._held:
                raise AssertionError(f"page {p} double-allocated")
            self._held.add(p)
        return pages

    def free(self, pages) -> None:
        for p in pages:
            if p not in self._held:
                raise AssertionError(f"page {p} freed but not held")
            self._held.discard(p)
            self._free[p // self.per_range].append(p)

    def occupancy(self) -> dict:
        """Host-side occupancy snapshot (the obs gauge source)."""
        return {"total": self.n_pages, "in_use": self.in_use,
                "free_per_range": [len(f) for f in self._free]}


class SlotPool:
    """Free-list over ``n_slots`` decode slots, range-partitioned like
    :class:`PageAllocator`."""

    def __init__(self, n_slots: int, n_ranges: int = 1):
        if n_slots <= 0 or n_ranges <= 0 or n_slots % n_ranges:
            raise ValueError(f"n_slots={n_slots} not divisible into "
                             f"{n_ranges} ranges")
        self.n_slots = n_slots
        self.n_ranges = n_ranges
        self.per_range = n_slots // n_ranges
        self._free = [list(range(r * self.per_range,
                                 (r + 1) * self.per_range))
                      for r in range(n_ranges)]
        self._held: set[int] = set()

    def available(self, rng: int = 0) -> int:
        return len(self._free[rng])

    @property
    def in_use(self) -> int:
        return len(self._held)

    def range_of(self, slot: int) -> int:
        return slot // self.per_range

    def acquire(self, rng: int = 0) -> int:
        free = self._free[rng]
        if not free:
            raise OutOfCapacity(f"slot range {rng} exhausted")
        slot = free.pop(0)
        if slot in self._held:
            raise AssertionError(f"slot {slot} double-allocated")
        self._held.add(slot)
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._held:
            raise AssertionError(f"slot {slot} released but not held")
        self._held.discard(slot)
        self._free[self.range_of(slot)].append(slot)

    def occupancy(self) -> dict:
        """Host-side occupancy snapshot (the obs gauge source)."""
        return {"total": self.n_slots, "in_use": self.in_use,
                "free_per_range": [len(f) for f in self._free]}
