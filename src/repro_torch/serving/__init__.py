"""repro_torch.serving — async, difficulty-aware request scheduling.

Callers submit individual requests (with deadlines and priorities) and
a scheduler consolidates them into ``BatchCompactor`` buckets, packing
by PREDICTED cost — the Eq. 8 difficulty estimator runs at admission,
before the model executes — so easy traffic never waits behind hard
traffic:

    from repro_torch.engine import DartEngine
    from repro_torch.serving import AsyncDartServer

    engine = DartEngine.from_config(model_cfg, params)   # on the card
    with AsyncDartServer(engine) as server:
        fut = server.submit(x, deadline_ms=50, priority=1)
        out = fut.result()        # engine.infer keys + latency_ms + SLO
        print(server.stats()["requests"]["latency_ms"])   # p50/p95/p99

Pieces (a port of the JAX package's ``repro/serving`` for the
classifier and LM engines):

* :class:`AsyncDartServer` — the scheduler façade (loop.py): background
  dispatcher, size-or-deadline flush.
* :class:`SchedulerConfig` — its knobs (flush/hold timing, backpressure
  policy ``shed`` | ``reject`` | ``degrade-alpha``, bucket targets).
* :class:`AdmissionPlanner` — Eq. 8 difficulty (the ``difficulty``
  kernel on a card) + telemetry-prior cost prediction at enqueue
  (planner.py), and per-request latency QUOTES when prediction is on.
* :class:`ExitDepthPredictor` — admission-time exit-depth prediction
  (predict.py) feeding head-skip (``min_exit``), predicted-depth lanes
  and SLO quotes.  Enable via ``SchedulerConfig(predict="conservative")``
  (same decisions) or ``"aggressive"`` (opt-in).
* :class:`RequestQueue` — lane-keyed backpressure queue (queue.py).
* :class:`LMDecodeSession` / :class:`LMContinuousSession` — the LM
  decode engine behind the same scheduler (lm_session.py;
  ``LMDecodeEngine.session()``): bucketed ``generate`` calls laned by
  ``(prompt_len, n_new)``, or continuous slot refill.
* :class:`EnginePool` / :class:`PooledDartServer` — fault-tolerant
  serving over several engines (resilience.py): retry, hedging,
  quarantine, the degradation ladder, drain/join from an
  ``EngineState`` snapshot; ``pooled_lm_session`` pools LM engines.

Scheduling never changes routing under a fixed policy: every completed
request's outputs are those of serving it alone through
``engine.infer`` (the admission alpha is handed to the engine, Alg. 1
runs unchanged).
"""
from repro_torch.serving.lm_session import (LMContinuousSession,
                                            LMDecodeSession)
from repro_torch.serving.loop import AsyncDartServer, SchedulerConfig
from repro_torch.serving.planner import AdmissionPlanner
from repro_torch.serving.predict import ExitDepthPredictor
from repro_torch.serving.queue import RequestQueue
from repro_torch.serving.request import (DispatchError, InvalidEngineOutput,
                                         Request, RequestRejected,
                                         RequestShed)
from repro_torch.serving.resilience import (EnginePool, NoHealthyEngines,
                                            PooledDartServer,
                                            ResilienceConfig,
                                            pooled_lm_session)

__all__ = ["AsyncDartServer", "SchedulerConfig", "AdmissionPlanner",
           "ExitDepthPredictor", "RequestQueue", "Request",
           "RequestRejected", "RequestShed", "DispatchError",
           "InvalidEngineOutput", "EnginePool", "PooledDartServer",
           "ResilienceConfig", "NoHealthyEngines", "LMDecodeSession",
           "LMContinuousSession", "pooled_lm_session"]
