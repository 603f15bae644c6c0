"""The port's checkpoints, in the JAX package's on-disk format
(``checkpoint/checkpoint.py``)."""
from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               latest_step, read_manifest,
                                               restore, save, save_async)

__all__ = ["save", "save_async", "restore", "latest_step", "read_manifest",
           "CheckpointManager"]
