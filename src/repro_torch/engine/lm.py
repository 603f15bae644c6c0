"""LM decode engine — early-exit autoregressive serving on the DART gate.

The port of ``repro/engine/lm.py`` (mesh-less): per decode step the
layer stack runs stage by stage, and each stage's exit head decides, per
row, whether the token leaves there (Alg. 1 with the Eq. 19 threshold
``clip(c*tau + beta_diff*alpha)`` and the ``lm-token`` confidence; the
final head always accepts).  Rows that leave skip the remaining stages;
their deeper KV entries are filled by CALM-style state propagation.

Two paths decide the same tokens:

* ``generate(mode="eager")`` — the oracle: each stage runs on the
  compacted survivors (padded to a power-of-two bucket), with the plain
  exit head (``exit_logits`` + the registry confidence).
* ``generate(mode="continuous")`` / ``engine.continuous()`` — the
  :class:`ContinuousLMDecoder`: a slot pool over a paged KV cache; every
  stage runs for every slot each step, rows that fired stop writing,
  and the exit head is one ``kernels.dispatch.exit_head_gate`` call per
  stage (the CUDA kernel on a card, the plain chain on the CPU).  Each
  layer reads its K/V view through ``kernels.dispatch.paged_gather``.

``engine.session()`` serves concurrent callers through the async
scheduler (``serving.lm_session.LMDecodeSession``: requests laned by
``(prompt_len, n_new)``, one ``generate`` per flushed bucket), and
``engine.session(continuous=True)`` through the slot pool
(``LMContinuousSession``).

The JAX package compiles each step with ``jax.jit`` and donates its
buffers; here each step is plain Python over tensors updated in place,
and ``engine.step_counts`` counts the calls of each step kind where the
JAX engine counts traces.  The sharded mode (``mode="sharded"``) needs a
mesh, which the port does not have yet; it raises, as the JAX engine
does without a mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch import device as DEV
from repro_torch.core import adaptive as AD
from repro_torch.core import difficulty as DIFF
from repro_torch.core import thresholds as TH
from repro_torch.core.routing import DartParams
from repro_torch.engine import registry as REG
from repro_torch.engine import state as ST
from repro_torch.engine.compactor import (BatchCompactor, OutOfCapacity,
                                          PageAllocator, SlotPool)
from repro_torch.engine.state import EngineState
from repro_torch.kernels import dispatch as KD
from repro_torch.models import layers as L
from repro_torch.models import transformer_lm as TLM
from repro_torch.obs import stats as OBS_STATS


def _stages(cfg):
    """[(start, end)) layer ranges; stage k ends at exit_layers[k]."""
    bounds = [0] + [e + 1 for e in sorted(cfg.exit_layers)] + [cfg.n_layers]
    return [(a, b) for a, b in zip(bounds[:-1], bounds[1:])]


def _stage_apply(params, x, cache_sl, cache_index, *, cfg, a, b):
    """Run layers [a, b) for one decode position.  x: (B', 1, D);
    cache_sl: the caches of exactly these layers, for these rows
    (written in place).  A MoE layer routes the B' rows of this call
    together: which rows share a call (the compacted survivors and
    their pad rows) is part of what a row's output depends on."""
    cos, sin = L.rope_freqs(cfg.hd, cache_sl[0]["k"].shape[1],
                            cfg.rope_theta, device=x.device)
    new_sl = []
    for j, i in enumerate(range(a, b)):
        p = params["layers"][i]
        att, c = L.gqa_decode(p["attn"], L.rmsnorm(p["attn_norm"], x), cos,
                              sin, cache_sl[j], cache_index)
        new_sl.append(c)
        x = x + att
        x = x + TLM.ffn_apply(p, L.rmsnorm(p["ffn_norm"], x), cfg)[0]
    return x, new_sl


def _stage_apply_paged(params, x, pages_sl, page_table, page_idx, offset,
                       positions, *, cfg, a, b):
    """Run layers [a, b) for one decode position against the PAGED KV
    store — the continuous-batching mirror of :func:`_stage_apply`.
    x: (S, 1, D), the whole slot pool; ``positions`` is per slot, so rows
    at different depths share one pass; ``page_idx`` is the write page
    per slot (out of range for rows that must not write).  A MoE layer
    routes every slot, idle and fired ones too, in slot order."""
    psz = pages_sl[0]["k"].shape[1]
    view_len = page_table.shape[1] * psz
    cos, sin = L.rope_freqs(cfg.hd, view_len, cfg.rope_theta,
                            device=x.device)
    new_sl = []
    for j, i in enumerate(range(a, b)):
        p = params["layers"][i]
        att, c = L.gqa_decode_paged(p["attn"], L.rmsnorm(p["attn_norm"], x),
                                    cos, sin, pages_sl[j], page_table,
                                    page_idx, offset, positions)
        new_sl.append(c)
        x = x + att
        x = x + TLM.ffn_apply(p, L.rmsnorm(p["ffn_norm"], x), cfg)[0]
    return x, new_sl


class LMDecodeEngine:
    """Early-exit LM decoding behind the engine API.

        engine = LMDecodeEngine(cfg, params, dart)       # the CUDA card
        tokens, stages = engine.generate(prompts, n_new=16)
        dec = engine.continuous(n_slots=16, max_len=1024)

    ``device=None`` is the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain torch versions of the kernels.  All
    policy and telemetry lives in ``engine.state`` (an
    :class:`EngineState`).
    """

    def __init__(self, cfg, params, dart: DartParams, *,
                 buckets=(1, 2, 4, 8, 16, 32, 64, 128),
                 confidence: str = "lm-token", device=None):
        if cfg.layer_scan:
            raise ValueError(
                f"{cfg.name}: the decode engine serves the per-layer tree; "
                "layer_scan is a train and prefill layout")
        self.device = DEV.resolve(device)
        self.cfg = cfg
        self.params = convert.tree_map(lambda t: t.to(self.device), params)
        self.compactor = BatchCompactor(buckets)
        self.confidence = confidence
        self._conf_fn = REG.get_confidence(confidence)
        self.stages = _stages(cfg)
        self.n_exits = len(self.stages)
        self.exit_names = [str(i) for i in sorted(cfg.exit_layers)] \
            + ["final"]
        # cumulative layer fraction spent by a token exiting at stage s
        self.cum_costs = np.asarray(
            [b / cfg.n_layers for _, b in self.stages], np.float32)
        self.stats_exit = np.zeros(len(self.stages), np.int64)
        self.layers_run = 0
        self.layers_skipped = 0
        self.step_counts: dict = {}   # step key -> number of calls
        self.acfg = AD.AdaptiveConfig(n_exits=self.n_exits,
                                      n_classes=min(cfg.vocab, 64))
        self.state = EngineState.create(self.n_exits, self.acfg, dart,
                                        device=self.device)
        self._cont_default = None  # lazy decoder for generate("continuous")
        self._policy_mirror = None

    # ------------------------------------------------------------------
    @property
    def dart(self) -> DartParams:
        """The routing-parameter view (reads the live EngineState)."""
        s = self.state
        return DartParams(tau=s.tau, coef=s.coef,
                          beta_diff=float(s.beta_diff),
                          beta_opt=float(s.beta_opt))

    #: confidence functionals bounded above by 1.0, for which the Eq. 19
    #: rule-out bound is sound (see thresholds.min_exit_bound)
    _BOUNDED_CONF = ("softmax-max", "lm-token")

    def min_exit_bound(self, alpha_lo: float = 0.0) -> int:
        """Sound per-batch ``min_exit`` under the current policy: gates
        0..m-1 can never fire for any row with decode-time difficulty
        >= ``alpha_lo``.  The routing alpha is the Eq. 8 decode EMA
        (infimum 0.0), so callers without a tighter bound pass 0.0."""
        if self.confidence not in self._BOUNDED_CONF or self.n_exits < 2:
            return 0
        tau, coef, beta_diff = self._policy_host()
        return TH.min_exit_bound(tau, coef, beta_diff, alpha_lo)

    def _policy_host(self):
        """Host mirror of (tau, coef, beta_diff), cached until a policy
        install replaces the tau/coef tensors, so the serving path does
        not copy the policy off the card on every bucket."""
        # the key holds the tensors themselves: an id could be reused
        key = (self.state.tau, self.state.coef)
        m = self._policy_mirror
        if m is None or m[0][0] is not key[0] or m[0][1] is not key[1]:
            self._policy_mirror = (key, (
                self.state.tau.cpu().numpy().astype(np.float32),
                self.state.coef.cpu().numpy().astype(np.float32),
                float(self.state.beta_diff)))
        return self._policy_mirror[1]

    def prompt_alpha(self, prompt_tokens) -> np.ndarray:
        """Admission-time Eq. 8 difficulty of a prompt batch (B, S): the
        token-domain estimator over the input embeddings, what the
        exit-depth predictor conditions on before any layer runs.  One
        plain torch pass; host numpy out."""
        toks = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.long,
                               device=self.device)
        self._count_step(("lm-prompt-alpha", toks.shape[1]))
        x = L.embed(self.params["embed"], toks).to(self.cfg.compute_dtype)
        return DIFF.token_difficulty(x).cpu().numpy()

    def bucket_key(self, n: int) -> int:
        """The padded shape of an ``n``-row decode bucket (the
        ``BatchCompactor`` bucket), the key every serving path shares."""
        return self.compactor.padded_size(n)

    def session(self, cfg=None, *, continuous: bool = False, **kw):
        """Queue-backed session handle: drive this engine through the
        async scheduler (deadlines, priorities, concurrent ``generate``
        callers consolidated into shared bucketed decode loops).
        ``continuous=True`` returns the slot-refill session over a
        :class:`ContinuousLMDecoder` instead (no bucket flushes).  See
        :class:`repro_torch.serving.lm_session.LMDecodeSession` and
        :class:`~repro_torch.serving.lm_session.LMContinuousSession`."""
        from repro_torch.serving.lm_session import (LMContinuousSession,
                                                    LMDecodeSession)
        if continuous:
            return LMContinuousSession(self, cfg=cfg, **kw)
        return LMDecodeSession(self, cfg=cfg, **kw)

    def continuous(self, n_slots=None, page_size=8, max_len=None):
        """A slot-based continuous-batching decoder over a paged KV cache.
        Each call returns a fresh :class:`ContinuousLMDecoder` (its slot
        pool and page store are its own serving state)."""
        return ContinuousLMDecoder(self, n_slots=n_slots,
                                   page_size=page_size, max_len=max_len)

    # ------------------------------------------------------------------
    # state round-trip (as DartEngine's)
    # ------------------------------------------------------------------
    def save_state(self, path: str, step: int = 0):
        from repro_torch import checkpoint as CK
        return CK.save(path, step, self.state)

    def restore_state(self, path: str, step: int | None = None, *,
                      mesh=None):
        """Restore ``self.state`` (see ``DartEngine.restore_state``).  A
        sharded engine's state would be re-placed on its mesh, which the
        port does not have yet (ROADMAP queue 1, item 9): ``mesh``
        raises."""
        if mesh is not None:
            raise NotImplementedError(
                "restoring onto a mesh is not ported yet (ROADMAP queue "
                "1, item 9)")
        self.state, step = ST.restore_with_migration(
            path, self.state, step, device=self.device)
        self._policy_mirror = None
        return step

    def stats(self) -> dict:
        """Decode telemetry: per-stage exit counts, tokens served, mean
        layer fraction spent, continuous-batching counters, and
        ``requests`` (latency percentiles, deadline misses) once a
        session recorded any."""
        tel = ST.telemetry_totals(self.state)
        out = OBS_STATS.engine_summary(tel)
        out.update(
            layers_run=self.layers_run,
            layers_skipped=self.layers_skipped,
            replicas=1,
            continuous={"slot_steps": int(tel["slot_steps"]),
                        "decode_steps": int(tel["decode_steps"]),
                        "pages_peak": int(self.state.pages_peak)})
        return OBS_STATS.attach_requests(out, self.state)

    def record_requests(self, latencies_ms, missed=None) -> None:
        """Fold completed-request latency and deadline telemetry into the
        engine state (host-side write; the LM sessions call this once
        per completed bucket or pool step)."""
        self.state = ST.record_requests(self.state, latencies_ms, missed)

    def record_quotes(self, quotes_ms, realized_ms) -> None:
        """Fold admission-time SLO quote error telemetry (quote vs
        realized latency; host-side write, like record_requests)."""
        self.state = ST.record_quotes(self.state, quotes_ms, realized_ms)

    def _count_step(self, key):
        self.step_counts[key] = self.step_counts.get(key, 0) + 1

    # ------------------------------------------------------------------
    # eager path (the oracle)
    # ------------------------------------------------------------------
    def init_cache(self, batch, max_len):
        return TLM.lm_init_cache(self.cfg, batch, max_len,
                                 device=self.device)

    def prefill(self, tokens, cache):
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)
        cache, _ = TLM.lm_prefill(self.params, toks, self.cfg, cache)
        return cache

    def decode_step(self, tokens, cache, cache_index, alpha, *,
                    record: bool = True, probe=None):
        """tokens: (B,) ints; cache: the full-depth list, updated in
        place; alpha: (B,) difficulty.  Returns (next_token (B,),
        exit_stage (B,), cache, new_alpha), numpy on the host.

        ``record`` folds the step into ``state`` telemetry and the host
        diagnostics (stats_exit / layers_run / layers_skipped).
        ``probe(s, active, h, logits, conf, eff)``, if given, sees each
        stage's exit head on its survivors: their hidden rows, logits,
        confidences and thresholds (``eff`` is None at the final stage,
        which always accepts); it observes and changes nothing."""
        dev = self.device
        cfg = self.cfg
        b = len(tokens)
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=dev)
        x_full = L.embed(self.params["embed"], toks[:, None]).to(
            cfg.compute_dtype)
        alpha = DIFF.token_difficulty_ema(
            torch.as_tensor(np.asarray(alpha, np.float32), device=dev),
            x_full)
        st = self.state

        out_tok = np.zeros(b, np.int64)
        out_stage = np.zeros(b, np.int64)
        active = np.arange(b)
        x = x_full
        n_stages = len(self.stages)
        cache = list(cache)

        for s, (a, bnd) in enumerate(self.stages):
            n = len(active)
            bucket = self.compactor.bucket_for(n)
            act = torch.as_tensor(active, device=dev)
            # gather cache rows for the active set (+pad with row 0)
            gather_idx = torch.as_tensor(
                self.compactor.pad(active, bucket, fill=0), device=dev)
            cache_sl = [{k: c.index_select(0, gather_idx)
                         for k, c in cache[i].items()} for i in range(a, bnd)]
            x_pad = self.compactor.pad(x, bucket)
            x_new, new_sl = _stage_apply(self.params, x_pad, cache_sl,
                                         cache_index, cfg=cfg, a=a, b=bnd)
            # scatter updated cache rows back
            for j, i in enumerate(range(a, bnd)):
                for k, c in cache[i].items():
                    c.index_copy_(0, act, new_sl[j][k][:n])
            if record:
                self.layers_run += (bnd - a) * n

            logits = TLM.exit_logits(self.params, cfg, x_new[:n, 0],
                                     self.exit_names[s])
            conf = self._conf_fn(logits)
            pred = logits.argmax(dim=-1)
            if s < n_stages - 1:
                eff = TH.stage_threshold(st.tau[s], st.coef[s], alpha[act],
                                         st.beta_diff)
                fire = (conf > eff).cpu().numpy()
            else:
                eff = None
                fire = np.ones(n, bool)
            if probe is not None:
                probe(s, active, x_new[:n, 0], logits, conf, eff)
            pred = pred.cpu().numpy()
            done = active[fire]
            out_tok[done] = pred[fire]
            out_stage[done] = s
            if record:
                self.stats_exit[s] += int(fire.sum())

            if s < n_stages - 1 and fire.any():
                # CALM state propagation for the exited rows
                h_exit = x_new[:n].index_select(
                    0, torch.as_tensor(np.nonzero(fire)[0], device=dev))
                done_t = torch.as_tensor(done, device=dev)
                sub = [{k: c.index_select(0, done_t)
                        for k, c in cache[i].items()}
                       for i in range(len(cache))]
                sub = TLM.lm_kv_propagate(self.params, h_exit[:, 0], cfg,
                                          sub, cache_index, from_layer=bnd)
                for i in range(bnd, cfg.n_layers):
                    for k, c in cache[i].items():
                        c.index_copy_(0, done_t, sub[i][k])
                if record:
                    self.layers_skipped += \
                        (cfg.n_layers - bnd) * int(fire.sum())
            keep = ~fire
            if not keep.any():
                break
            x = x_new[:n].index_select(
                0, torch.as_tensor(np.nonzero(keep)[0], device=dev))
            active = active[keep]
        if record:
            self._record_host(out_stage)
        return out_tok, out_stage, cache, alpha.cpu().numpy()

    def _record_host(self, out_stage) -> None:
        """Eager-path telemetry fold (one decode step)."""
        s = self.state
        b = len(out_stage)
        counts = np.bincount(out_stage, minlength=self.n_exits)
        self.state = dataclasses.replace(
            s, served=s.served + b,
            exit_counts=s.exit_counts + torch.as_tensor(
                counts, dtype=torch.int32, device=self.device),
            total_macs=s.total_macs + float(np.sum(
                self.cum_costs[out_stage])),
            since_update=s.since_update + b)

    def _head_traced(self, params, h, exit_name: str, eff):
        """The decode-time exit decision for one stage: rmsnorm ->
        unembedding -> softmax confidence -> Eq. 19 gate, as ONE
        ``kernels.dispatch`` call for the ``lm-token`` functional.
        Returns (conf, pred, fire bool)."""
        cfg = self.cfg
        if self.confidence == "lm-token":
            norm = params["final_norm"] if exit_name == "final" \
                else params["exit_heads"][exit_name]["norm"]
            conf, pred, fire = KD.exit_head_gate(
                h, norm["scale"], TLM._unembed_table(params, cfg), eff)
            return conf, pred, fire > 0
        logits = TLM.exit_logits(params, cfg, h, exit_name)
        conf = self._conf_fn(logits)
        return conf, logits.argmax(dim=-1), conf > eff

    def _fold_decode_dense(self, state: EngineState, s: int,
                           fire) -> EngineState:
        """Telemetry fold of one stage of a continuous step, on the
        device (no host sync)."""
        n_new = fire.sum(dtype=torch.int32)
        exit_counts = state.exit_counts.clone()
        exit_counts[s] += n_new
        return dataclasses.replace(
            state,
            served=state.served + n_new,
            exit_counts=exit_counts,
            total_macs=state.total_macs
            + n_new.float() * float(self.cum_costs[s]),
            since_update=state.since_update + n_new)

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------
    def generate(self, prompt_tokens: np.ndarray, n_new: int,
                 max_len: int | None = None, mode: str | None = None):
        """prompt_tokens: (B, S0).  Greedy generation with early exits.
        Returns (tokens (B, n_new), exit stages (B, n_new)), numpy.

        mode — "eager" (the default): the per-stage oracle; batches
        larger than the biggest bucket are split into chunks, each with
        its own KV cache.  "continuous": the slot-pool decoder over the
        paged KV cache (rows admitted as slots free up).  "sharded" needs
        a mesh, which the port does not have yet, and raises.  Every
        path runs every gate (the JAX package skips gates below
        ``min_exit`` only on its sharded path)."""
        if mode is None:
            mode = "eager"
        if mode not in ("sharded", "eager", "continuous"):
            raise ValueError(
                f"unknown mode {mode!r}; known: sharded, eager, "
                "continuous")
        if mode == "sharded":
            raise ValueError(
                "mode='sharded' needs a mesh; the port has no mesh yet "
                "(the multi-device slice brings it)")
        prompt_tokens = np.asarray(prompt_tokens)
        if mode == "continuous":
            return self._generate_continuous(prompt_tokens, n_new)
        b, s0 = prompt_tokens.shape
        if b > self.compactor.max_bucket:
            outs, stgs = [], []
            for a, z in self.compactor.chunks(b):
                o, st = self.generate(prompt_tokens[a:z], n_new, max_len,
                                      mode=mode)
                outs.append(o)
                stgs.append(st)
            return np.concatenate(outs), np.concatenate(stgs)
        return self._generate_eager(prompt_tokens, n_new, max_len)

    def _generate_eager(self, prompt_tokens, n_new, max_len=None, *,
                        probe=None):
        b, s0 = prompt_tokens.shape
        max_len = max_len or (s0 + n_new + 1)
        cache = self.init_cache(b, max_len)
        if s0 > 1:
            cache = self.prefill(prompt_tokens[:, :-1], cache)
        alpha = np.full((b,), 0.5, np.float32)
        toks = prompt_tokens[:, -1]
        out = []
        stages = []
        for t in range(n_new):
            toks, stage, cache, alpha = self.decode_step(
                toks, cache, s0 - 1 + t, alpha,
                probe=None if probe is None else
                (lambda *a, t=t: probe(t, *a)))
            out.append(toks.copy())
            stages.append(stage.copy())
        return np.stack(out, 1), np.stack(stages, 1)

    def _generate_continuous(self, prompts, n_new):
        """Drive the engine-owned default continuous decoder: admit each
        prompt row as its own request whenever the pool has room, step
        until every row finished."""
        b, s0 = prompts.shape
        if self._cont_default is None:
            self._cont_default = self.continuous()
        dec = self._cont_default
        if not dec.fits_ever(1, s0, n_new):
            raise ValueError(
                f"prompt_len={s0} + n_new={n_new} exceeds the default "
                f"continuous decoder's max_len={dec.max_len}; build one "
                "via engine.continuous(max_len=...) and admit directly")
        out_t: list = [None] * b
        out_s: list = [None] * b
        pending = list(range(b))
        done = 0
        while done < b:
            while pending and dec.can_admit(1, s0, n_new):
                i = pending.pop(0)
                dec.admit(prompts[i:i + 1], n_new, tag=("gen", i))
            if not dec.active_rows:
                raise RuntimeError("continuous generate stalled with "
                                   "pending rows and an empty pool")
            for tag, toks, stgs in dec.step():
                if isinstance(tag, tuple) and tag[0] == "gen":
                    out_t[tag[1]] = toks[0]
                    out_s[tag[1]] = stgs[0]
                    done += 1
        return np.stack(out_t), np.stack(out_s)


class ContinuousLMDecoder:
    """Slot-based continuous batching over a paged KV cache.

        dec = engine.continuous(n_slots=8, page_size=8, max_len=64)
        dec.admit(prompts, n_new=12, tag="req-0")   # any step
        events = dec.step()   # [(tag, tokens (B, n), stages (B, n))]

    One fixed-shape decode step serves the whole pool: an active mask
    and a per-slot position let rows at different depths (and of
    different requests) share every launch.  Every stage runs for every
    slot; a row that fired its exit gate stops writing KV within the
    same step (its write page goes out of range and lands in the sink
    page, see ``layers.paged_write``), and a finished request frees its
    slot and pages to admission that step.

    KV lives in a page store of ``n_pages`` pages (plus the sink) per
    layer under a free-list :class:`PageAllocator`; each slot reads its
    pages through ``kernels.dispatch.paged_gather`` and writes one row a
    step at (page, offset).  Tokens and exit stages match the eager
    oracle run at ``max_len=dec.view_len`` row for row, up to rows whose
    decision lies at a near-tie (the step's matmuls run over other batch
    shapes than the oracle's, which may round differently).  In a MoE
    model they need not match: the step routes all slots together (idle
    ones and rows that fired too) where the oracle routes the compacted
    survivors, and an expert past its capacity drops other pairs in
    each.
    """

    def __init__(self, engine: LMDecodeEngine, *, n_slots=None,
                 page_size=8, max_len=None):
        self.eng = engine
        cfg = engine.cfg
        if max_len is None:
            max_len = cfg.max_seq
        if n_slots is None:
            n_slots = min(16, engine.compactor.max_bucket)
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.n_slots = int(n_slots)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.pages_per_slot = -(-self.max_len // self.page_size)
        #: dense attention view length (page-table width x page size);
        #: the eager oracle must be run at THIS max_len to match
        self.view_len = self.pages_per_slot * self.page_size
        self.n_pages = self.n_slots * self.pages_per_slot
        self.pool = SlotPool(self.n_slots)
        self.allocator = PageAllocator(self.n_pages)

        # device state: per-layer page stores (n_pages and the sink page)
        # and the Eq. 8 difficulty EMA
        dev = engine.device
        self.pages = TLM.lm_init_cache(cfg, self.n_pages + 1, self.page_size,
                                       device=dev)
        self.alpha = torch.full((self.n_slots,), 0.5, dtype=torch.float32,
                                device=dev)

        # host bookkeeping (numpy; shipped into each step)
        s = self.n_slots
        self.pos = np.zeros(s, np.int32)        # next KV write position
        self.active = np.zeros(s, np.int32)
        self.fresh = np.zeros(s, np.int32)      # reset EMA to 0.5
        self.tokens = np.zeros(s, np.int32)     # last emitted token
        self.page_table = np.zeros((s, self.pages_per_slot), np.int32)
        self._requests: dict = {}               # rid -> record
        self._slot_req: dict = {}               # slot -> (rid, row)
        self._slot_pages: dict = {}             # slot -> [page ids]
        self._next_rid = 0
        self._pages_hwm = 0

    # -- admission ------------------------------------------------------
    @property
    def active_rows(self) -> int:
        return int(self.active.sum())

    def pages_needed(self, s0: int, n_new: int) -> int:
        """Pages reserved up front at admission: the last KV position a
        request writes is ``s0 + n_new - 2``."""
        return max(1, -(-(s0 + n_new - 1) // self.page_size))

    def fits_ever(self, n_rows: int, s0: int, n_new: int) -> bool:
        """Could this request ever be admitted (even into an empty
        pool)?"""
        return (n_rows <= self.n_slots
                and self.pages_needed(s0, n_new) <= self.pages_per_slot)

    def _placement(self, n_rows: int, npg: int):
        """First fit of ``n_rows`` (a slot and npg pages each) into the
        allocators' ranges; None if it does not fit now."""
        r = self.pool.n_ranges
        slots = [self.pool.available(i) for i in range(r)]
        pages = [self.allocator.available(i) for i in range(r)]
        plan = []
        for _ in range(n_rows):
            for i in range(r):
                if slots[i] and pages[i] >= npg:
                    plan.append(i)
                    slots[i] -= 1
                    pages[i] -= npg
                    break
            else:
                return None
        return plan

    def can_admit(self, n_rows: int, s0: int, n_new: int) -> bool:
        if not self.fits_ever(n_rows, s0, n_new):
            return False
        return self._placement(n_rows,
                               self.pages_needed(s0, n_new)) is not None

    def admit(self, prompt_tokens, n_new: int, tag=None):
        """Admit one request (B rows, shared prompt length and n_new).
        All or nothing: raises :class:`OutOfCapacity` when the pool
        cannot place every row now.  Prompts prefill straight into the
        request's own pages; decode joins the pool next step."""
        prompts = np.asarray(prompt_tokens)
        b, s0 = prompts.shape
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        if not self.fits_ever(b, s0, n_new):
            raise ValueError(
                f"request (rows={b}, s0={s0}, n_new={n_new}) can never "
                f"fit this decoder (n_slots={self.n_slots}, "
                f"max_len={self.max_len})")
        npg = self.pages_needed(s0, n_new)
        plan = self._placement(b, npg)
        if plan is None:
            raise OutOfCapacity(
                f"pool full: rows={b} x pages={npg} don't fit "
                f"({self.pool.in_use}/{self.n_slots} slots, "
                f"{self.allocator.in_use}/{self.n_pages} pages in use)")
        rid = self._next_rid
        self._next_rid += 1
        rec = {"rid": rid, "tag": rid if tag is None else tag,
               "slots": [], "remaining": int(n_new),
               "toks": [[] for _ in range(b)],
               "stgs": [[] for _ in range(b)]}
        for row in range(b):
            slot = self.pool.acquire(plan[row])
            pg = self.allocator.alloc(npg, plan[row])
            self._slot_pages[slot] = pg
            self._slot_req[slot] = (rid, row)
            rec["slots"].append(slot)
            self.page_table[slot, :] = 0
            self.page_table[slot, :npg] = pg
            self.pos[slot] = s0 - 1
            self.tokens[slot] = int(prompts[row, -1])
            self.active[slot] = 1
            self.fresh[slot] = 1
            if s0 > 1:
                self._prefill_row(prompts[row, :-1], pg)
        self._requests[rid] = rec
        self._pages_hwm = max(self._pages_hwm, self.allocator.in_use)
        st = self.eng.state
        if self._pages_hwm > int(st.pages_peak):
            self.eng.state = dataclasses.replace(
                st, pages_peak=torch.full_like(st.pages_peak,
                                               self._pages_hwm))
        return rec["tag"]

    def release(self, tag) -> bool:
        """Cancel an in-flight request mid-cascade: frees its slots and
        KV pages at once (no completion event is emitted)."""
        for rid, rec in list(self._requests.items()):
            if rec["tag"] == tag or rid == tag:
                self._release_slots(rec["slots"])
                del self._requests[rid]
                return True
        return False

    def _release_slots(self, slots) -> None:
        for slot in slots:
            self.allocator.free(self._slot_pages.pop(slot))
            self.pool.release(slot)
            del self._slot_req[slot]
            self.active[slot] = 0
            self.fresh[slot] = 0
            self.pos[slot] = 0
            self.tokens[slot] = 0
            self.page_table[slot, :] = 0

    # -- the steps ------------------------------------------------------
    def _prefill_row(self, prompt, pg) -> None:
        """Prefill one row into its reserved pages: the same
        ``lm_prefill`` as the oracle into a temporary dense cache,
        reshaped to (npre, psz, ...) page rows and written at the row's
        page ids."""
        eng = self.eng
        cfg = eng.cfg
        dev = eng.device
        psz = self.page_size
        plen = int(prompt.shape[0])
        npre = -(-plen // psz)
        eng._count_step(("lm-cont-prefill", plen, npre, psz))
        tmp = TLM.lm_init_cache(cfg, 1, npre * psz, device=dev)
        TLM.lm_prefill(eng.params,
                       torch.as_tensor(prompt[None, :], dtype=torch.long,
                                       device=dev), cfg, tmp)
        ids = torch.as_tensor(np.asarray(pg[:npre]), dtype=torch.long,
                              device=dev)
        for i in range(cfg.n_layers):
            for name, leaf in tmp[i].items():
                page = self.pages[i][name]
                page[ids] = leaf[0].reshape(
                    (npre, psz) + tuple(leaf.shape[2:])).to(page.dtype)

    def _embed_step(self, toks, fresh):
        """Embed + fresh-slot EMA reset + Eq. 8 decode-time difficulty
        EMA for the whole pool."""
        eng = self.eng
        eng._count_step(("lm-cont-embed", self.n_slots))
        x = L.embed(eng.params["embed"], toks[:, None]).to(
            eng.cfg.compute_dtype)
        alpha = torch.where(fresh > 0, 0.5, self.alpha)
        self.alpha = DIFF.token_difficulty_ema(alpha, x)
        return x

    def _decode_step(self, x, pos, active, page_table):
        """THE continuous decode step: every stage for every slot.
        ``run`` masks inactive slots and rows that fired at an earlier
        stage this step (their KV write goes to the sink page; their
        token and stage stop updating).  Returns (tokens (S,), stages
        (S,)) on the device and folds the telemetry into
        ``engine.state``."""
        eng = self.eng
        cfg = eng.cfg
        eng._count_step(("lm-cont-decode", self.n_slots, self.page_size,
                         self.pages_per_slot))
        psz = self.page_size
        n_pages = self.n_pages
        state = eng.state
        s_pool = pos.shape[0]
        run = active > 0
        page_w = page_table.gather(1, (pos // psz)[:, None].long())[:, 0]
        off = pos % psz
        toks_out = torch.zeros(s_pool, dtype=torch.int32, device=pos.device)
        stg_out = torch.zeros(s_pool, dtype=torch.int32, device=pos.device)
        final_s = len(eng.stages) - 1
        for s, (a, bnd) in enumerate(eng.stages):
            final = s == final_s
            pidx = torch.where(run, page_w, n_pages)    # OOB -> no write
            x, _ = _stage_apply_paged(eng.params, x, self.pages[a:bnd],
                                      page_table, pidx, off, pos, cfg=cfg,
                                      a=a, b=bnd)
            if final:
                # Alg. 1 line 12: the final head always accepts
                eff = torch.full((s_pool,), -1.0, dtype=torch.float32,
                                 device=pos.device)
            else:
                eff = TH.stage_threshold(state.tau[s], state.coef[s],
                                         self.alpha, state.beta_diff)
            conf, pred, fire = eng._head_traced(eng.params, x[:, 0],
                                                eng.exit_names[s], eff)
            fire = run if final else (fire & run)
            toks_out = torch.where(fire, pred.to(torch.int32), toks_out)
            stg_out = torch.where(fire, s, stg_out)
            if not final:
                # CALM propagation for the fired rows, written at their
                # (page, offset) for layers [bnd, n_layers)
                rows = TLM.lm_kv_project(eng.params, x[:, 0], cfg, None,
                                         None, bnd, positions=pos,
                                         max_len=self.view_len)
                pidx_f = torch.where(fire, page_w, n_pages)
                for i, rr in zip(range(bnd, cfg.n_layers), rows):
                    for name, val in rr.items():
                        L.paged_write(self.pages[i][name], val[:, 0],
                                      pidx_f, off)
            state = eng._fold_decode_dense(state, s, fire)
            run = run & ~fire
        eng.state = self._fold_slots(state, active)
        return toks_out, stg_out

    def _fold_slots(self, state: EngineState, active) -> EngineState:
        """Continuous-batching occupancy telemetry, folded on the
        device."""
        return dataclasses.replace(
            state,
            slot_steps=state.slot_steps + (active > 0).sum(
                dtype=torch.int32),
            decode_steps=state.decode_steps + 1)

    def step(self):
        """Advance every active slot one token.  Returns completion
        events ``[(tag, tokens (B, n_new), stages (B, n_new)), ...]``;
        finished requests free their slots and KV pages before this
        returns, so the capacity is admittable at once."""
        eng = self.eng
        if not self.active.any():
            return []
        dev = eng.device
        x = self._embed_step(
            torch.as_tensor(self.tokens, dtype=torch.long, device=dev),
            torch.as_tensor(self.fresh, device=dev))
        self.fresh[:] = 0
        toks_out, stg_out = self._decode_step(
            x, torch.as_tensor(self.pos, device=dev),
            torch.as_tensor(self.active, device=dev),
            torch.as_tensor(self.page_table, device=dev))
        tok_np = toks_out.cpu().numpy()     # the ONE host sync per step
        stg_np = stg_out.cpu().numpy()
        events = []
        finished = []
        stepped: set = set()
        for slot in np.nonzero(self.active)[0]:
            slot = int(slot)
            rid, row = self._slot_req[slot]
            rec = self._requests[rid]
            rec["toks"][row].append(int(tok_np[slot]))
            rec["stgs"][row].append(int(stg_np[slot]))
            self.pos[slot] += 1
            self.tokens[slot] = int(tok_np[slot])
            # host diagnostics use the eager engine's accounting: layers
            # a token needed vs skipped
            st = int(stg_np[slot])
            bnd = eng.stages[st][1]
            eng.stats_exit[st] += 1
            eng.layers_run += bnd
            eng.layers_skipped += eng.cfg.n_layers - bnd
            if rid not in stepped:
                stepped.add(rid)
                rec["remaining"] -= 1
                if rec["remaining"] == 0:
                    finished.append(rid)
        for rid in finished:
            rec = self._requests.pop(rid)
            self._release_slots(rec["slots"])
            events.append((rec["tag"],
                           np.asarray(rec["toks"], np.int64),
                           np.asarray(rec["stgs"], np.int64)))
        return events

    # -- introspection --------------------------------------------------
    def slots_of(self, tag) -> list:
        """Slot ids held by the request admitted under ``tag`` (empty
        once it has retired)."""
        for rec in self._requests.values():
            if rec["tag"] == tag:
                return [int(s) for s in rec["slots"]]
        return []

    def occupancy(self) -> dict:
        """Slot-pool / page-allocator occupancy (host ints only)."""
        return {"slots_total": self.n_slots,
                "slots_in_use": self.active_rows,
                "pages_total": self.n_pages,
                "pages_in_use": self.allocator.in_use,
                "pages_peak": self._pages_hwm}

    def stats(self) -> dict:
        return {"n_slots": self.n_slots,
                "active": self.active_rows,
                "page_size": self.page_size,
                "pages_total": self.n_pages,
                "pages_in_use": self.allocator.in_use,
                "pages_peak": self._pages_hwm}

    def check_invariants(self) -> None:
        """Assert the slot-pool / page-table / free-list consistency:
        active mask and ownership agree, no page is shared between
        slots, every page not held is on a free list."""
        active_slots = {int(s) for s in np.nonzero(self.active)[0]}
        assert active_slots == set(self._slot_req), \
            (active_slots, set(self._slot_req))
        assert active_slots == self.pool._held
        used = []
        for slot in active_slots:
            pg = self._slot_pages[slot]
            used.extend(pg)
            assert list(self.page_table[slot, :len(pg)]) == list(pg)
            rng = self.pool.range_of(slot)
            assert all(p // self.allocator.per_range == rng for p in pg)
        assert len(used) == len(set(used)), "page double-booked"
        assert set(used) == self.allocator._held
        n_free = sum(self.allocator.available(i)
                     for i in range(self.allocator.n_ranges))
        assert n_free + len(used) == self.n_pages
        s_free = sum(self.pool.available(i)
                     for i in range(self.pool.n_ranges))
        assert s_free + len(active_slots) == self.n_slots
