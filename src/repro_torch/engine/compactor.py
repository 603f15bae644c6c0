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
