"""LMDecodeSession — queue-backed session handle over LMDecodeEngine.

The port of ``repro/serving/lm_session.py``: early-exit LM decoding
driven through the same scheduler machinery as classifier serving:

    session = engine.session()                 # LMDecodeEngine.session
    fut = session.submit(prompt_tokens, n_new=16, deadline_ms=500)
    out = fut.result()                         # {"tokens", "stages", ...}

Requests are laned by ``(prompt_len, n_new)`` — the two quantities that
fix a decode loop's shapes — and consolidated into one ``generate``
call per flushed bucket, so N concurrent callers share one bucketed
decode loop instead of N; consolidation sizes are padded with
``engine.bucket_key``.  Deadlines, priorities, backpressure and the
size-or-deadline flush policy behave exactly as in
:class:`~repro_torch.serving.loop.AsyncDartServer`.

:class:`LMContinuousSession` (``engine.session(continuous=True)``)
replaces bucket flushes with continuous slot refill: requests are
admitted one at a time into a :class:`~repro_torch.engine.lm
.ContinuousLMDecoder` slot pool the moment capacity frees up, so a long
request never holds a bucket open and a finished (or early-exited)
request's slot serves the queue that step.
"""
from __future__ import annotations

from concurrent.futures import Future

import numpy as np

from repro_torch.engine.state import request_stats
from repro_torch.obs import OBS
from repro_torch.obs import adapters as OBS_A
from repro_torch.obs import log as OBS_LOG
from repro_torch.serving.loop import SchedulerConfig, _BucketScheduler
from repro_torch.serving.predict import ExitDepthPredictor
from repro_torch.serving.request import (DispatchError, Request,
                                         RequestRejected)


class LMDecodeSession(_BucketScheduler):
    """Bucketed decode session: one ``generate`` per flushed lane run."""

    def __init__(self, engine, cfg: SchedulerConfig | None = None, **kw):
        self.engine = engine
        cfg = cfg or SchedulerConfig(max_batch=engine.compactor.max_bucket,
                                     policy="reject")
        self.predictor = None if cfg.predict == "off" else \
            ExitDepthPredictor(engine.n_exits, edges=cfg.edges,
                               mode=cfg.predict)
        super().__init__(cfg, **kw)

    # -- hooks ----------------------------------------------------------
    def _bucket_key(self, n: int) -> int:
        if n > self.engine.compactor.max_bucket:
            return n            # oversized: generate() chunk-splits
        return self.engine.bucket_key(n)

    def _max_batch_cap(self) -> int:
        return self.engine.compactor.max_bucket

    def _admit(self, prompt_tokens, deadline_ms, priority, *, now,
               n_new: int) -> Request:
        x = np.asarray(prompt_tokens)
        if x.ndim == 1:
            x = x[None]
        alpha = np.zeros(x.shape[0], np.float32)
        lane = (x.shape[1], int(n_new))
        payload = {"n_new": int(n_new)}
        if self.predictor is not None:
            # admission-time Eq. 8 difficulty of the prompt: the
            # pre-backbone signal the depth predictor conditions on
            alpha = self.engine.prompt_alpha(x).astype(np.float32)
            band = self.predictor.depth_band(float(np.mean(alpha)))
            lane = lane + (band,)    # predicted-depth lane component
            payload["band"] = band
        return Request(
            rid=next(self._rid), x=x, n=x.shape[0], alpha=alpha,
            lane=lane, predicted_cost=float(n_new),
            priority=priority, t_submit=now,
            deadline_s=None if deadline_ms is None
            else now + deadline_ms / 1e3,
            future=Future(), payload=payload)

    def _dispatch(self, reqs: list, reason: str) -> None:
        n_new = reqs[0].payload["n_new"]
        prompts = np.concatenate([r.x for r in reqs])
        t0 = self._clock()
        tokens, stages = self._engine_call(
            lambda eng: eng.generate(prompts, n_new))
        now = self._clock()
        ends = np.cumsum([r.n for r in reqs])
        starts = np.concatenate([[0], ends[:-1]])
        lats = [(now - r.t_submit) * 1e3 for r in reqs]
        missed = [r.deadline_s is not None and now > r.deadline_s
                  for r in reqs]
        # latency/deadline telemetry folds into the EngineState — the
        # one store behind session.stats() and engine.stats() — before
        # any future resolves
        self.engine.record_requests(lats, missed)
        if self.predictor is not None:
            # realized depth per row = mean decode exit stage
            self.predictor.observe(
                np.concatenate([r.alpha for r in reqs]),
                np.rint(np.asarray(stages).mean(axis=1)))
        if OBS.enabled:
            OBS_A.record_lm_bucket(self, reqs,
                                   [stages[a:z] for a, z in
                                    zip(starts, ends)], t0, now)
        for r, a, z, lat_ms, miss in zip(reqs, starts, ends, lats, missed):
            r.resolve({"tokens": tokens[a:z], "stages": stages[a:z],
                       "latency_ms": lat_ms, "deadline_missed": miss,
                       "lane": r.lane})
        self.counters["completed"] += len(reqs)

    # -- metering -------------------------------------------------------
    def stats(self) -> dict:
        out = {"scheduler": {**self.counters, "shed": self.queue.shed,
                             "rejected": self.queue.rejected,
                             "starved": self.queue.starved},
               "requests": request_stats(self.engine.state),
               "exit_hist": np.asarray(self.engine.stats_exit).tolist(),
               "layers_run": self.engine.layers_run,
               "layers_skipped": self.engine.layers_skipped}
        if self.predictor is not None:
            out["scheduler"]["predictor"] = self.predictor.stats()
        return out


class LMContinuousSession(LMDecodeSession):
    """Continuous-batching session over a :class:`ContinuousLMDecoder`:
    requests stream through the slot pool one at a time as slots and KV
    pages free up — no bucket consolidation, no flush barriers, and rows
    of different requests (at different depths) share every decode step.

        session = engine.session(continuous=True, n_slots=8)
        fut = session.submit(prompt_tokens, n_new=16)

    Admission order is (priority desc, submit time asc) across lanes via
    ``RequestQueue.pop_next``; a senior request that cannot fit right
    now reserves freed capacity after ``cfg.starve_ms`` instead of being
    backfilled around forever.  A request whose shape can never fit the
    decoder is rejected at submit.  Early exits free pages mid-stream:
    Alg. 1 early termination is what creates admission capacity."""

    def __init__(self, engine, cfg: SchedulerConfig | None = None, *,
                 n_slots=None, page_size=8, max_len=None, decoder=None,
                 **kw):
        self.decoder = decoder if decoder is not None else \
            engine.continuous(n_slots=n_slots, page_size=page_size,
                              max_len=max_len)
        self._pending: dict = {}      # rid -> Request (rows in the pool)
        super().__init__(engine, cfg=cfg, **kw)

    # -- hooks ----------------------------------------------------------
    def _bucket_key(self, n: int) -> int:
        return n                      # no bucket shapes to consolidate

    def _max_batch_cap(self) -> int:
        return self.decoder.n_slots

    def submit(self, prompt_tokens, deadline_ms: float | None = None,
               priority: int = 0, **kw) -> Future:
        x = np.asarray(prompt_tokens)
        if x.ndim == 1:
            x = x[None]
        n_new = int(kw.get("n_new", 0))
        if not self.decoder.fits_ever(x.shape[0], x.shape[1], n_new):
            fut: Future = Future()
            fut.set_exception(RequestRejected(
                f"request (rows={x.shape[0]}, s0={x.shape[1]}, "
                f"n_new={n_new}) can never fit the decoder "
                f"(n_slots={self.decoder.n_slots}, "
                f"max_len={self.decoder.max_len})"))
            return fut
        return super().submit(x, deadline_ms, priority, **kw)

    def _fits(self, req: Request) -> bool:
        return self.decoder.can_admit(req.n, req.x.shape[1],
                                      req.payload["n_new"])

    # -- the scheduling loop --------------------------------------------
    def pump(self) -> bool:
        """One continuous-serving turn: refill free slots from the lane
        queues (most urgent head first, with head-of-line capacity
        reservation), then advance the pool one decode step and resolve
        whatever finished.  Returns False when fully idle."""
        did = False
        now = self._clock()
        while True:
            req = self.queue.pop_next(
                self._fits, reserve_after_s=self.cfg.starve_ms / 1e3,
                now=now, prefer=self._refill_prefer())
            if req is None:
                break
            self.decoder.admit(req.x, req.payload["n_new"], tag=req.rid)
            self._pending[req.rid] = req
            if OBS.enabled:
                OBS_A.record_slot_admit(self, req, self._clock())
            did = True
        if self.decoder.active_rows:
            try:
                stepped = self.decoder.step()
            except Exception as e:                 # noqa: BLE001
                self._fail_pool(e)
                return True
            done = []
            for tag, toks, stgs in stepped:
                req = self._pending.pop(tag)
                t_done = self._clock()
                lat_ms = (t_done - req.t_submit) * 1e3
                miss = req.deadline_s is not None \
                    and t_done > req.deadline_s
                done.append((req, toks, stgs, lat_ms, miss))
            # fold telemetry BEFORE resolving: a caller that waited on
            # result() then reads stats() must see its request counted
            if done:
                self.engine.record_requests(
                    [d[3] for d in done], [d[4] for d in done])
                if self.predictor is not None:
                    for req, toks, stgs, _, _ in done:
                        self.predictor.observe(
                            req.alpha,
                            np.rint(np.asarray(stgs).mean(axis=1)))
            for req, toks, stgs, lat_ms, miss in done:
                if OBS.enabled:
                    OBS_A.record_slot_exit(self, req, stgs, lat_ms, miss,
                                           self._clock())
                req.resolve({"tokens": toks, "stages": stgs,
                             "latency_ms": lat_ms,
                             "deadline_missed": miss, "lane": req.lane})
                self.counters["completed"] += 1
            did = True
        return did

    def _fail_pool(self, exc: Exception) -> None:
        """Contain a decode-step failure: fail exactly the pooled
        requests with a structured error, release their slots (freeing
        pages for the next admissions), and leave the daemon serving.
        Queued requests are untouched: the next pump() admits them into
        the recovered pool."""
        self.counters["step_errors"] = \
            self.counters.get("step_errors", 0) + 1
        self.last_error = exc
        victims = list(self._pending.values())
        OBS_LOG.error("lm_step", "continuous decode step failed",
                      exc=exc, n_requests=len(victims),
                      rids=[r.rid for r in victims[:8]])
        err = DispatchError("step",
                            victims[0].lane if victims else None,
                            [r.rid for r in victims], exc)
        for r in victims:
            self.decoder.release(r.rid)
            r.fail(err)
        self._pending.clear()

    def _refill_prefer(self):
        """Depth-aware refill score (``pop_next``'s ``prefer`` hook):
        among equally urgent fitting heads, favour the request whose
        predicted exit depth matches the pool's current mix, so the
        slots step in lock-step and free together.  None (urgency only)
        when prediction is off or the pool is empty."""
        if self.predictor is None or not self._pending:
            return None
        mix = float(np.mean([q.payload.get("band", 0)
                             for q in self._pending.values()]))
        return lambda r: -abs(r.payload.get("band", 0) - mix)

    def _wait_timeout(self, now: float) -> float | None:
        if self.decoder.active_rows:
            return 1e-4               # keep stepping the pool
        return super()._wait_timeout(now)

    def _has_inflight(self) -> bool:
        return bool(self.decoder.active_rows or self._pending)

    def flush(self) -> None:
        """Serve everything queued or in flight to completion (shutdown
        / test barrier).  Always terminates: an empty pool admits any
        admissible request, and a stepped pool frees capacity."""
        while (not self.queue.empty) or self.decoder.active_rows:
            if not self.pump():
                break

    def stats(self) -> dict:
        out = super().stats()
        out["continuous"] = self.decoder.stats()
        return out
