"""The port's DART serving engine: ``DartEngine`` over one
``EngineState``, ``BatchCompactor`` buckets, the strategy
registries and ``route_policy`` (offline routing under a fitted
policy)."""
from repro_torch.engine.compactor import (DEFAULT_BUCKETS, BatchCompactor,
                                          BatchTooLarge)
from repro_torch.engine.engine import DartEngine
from repro_torch.engine.registry import (get_confidence, get_difficulty,
                                         get_optimizer, route_policy)
from repro_torch.engine.state import EngineState

__all__ = ["DEFAULT_BUCKETS", "BatchCompactor", "BatchTooLarge",
           "DartEngine", "EngineState", "get_confidence", "get_difficulty",
           "get_optimizer", "route_policy"]
