"""DartEngine — the façade over the DART lifecycle, on torch.

    engine = DartEngine.from_config(cfg, params)        # wire up (cuda)
    engine = DartEngine.from_config("vit-s16", params)  # or an arch id
    engine.calibrate(cal_data)                          # section II.B
    out = engine.infer(x, mode="compacted")             # Alg. 1 serving
    engine.update()                                     # section II.C
    engine.stats()                                      # metering

Strategies are strings looked up in ``repro_torch.engine.registry``.
All mutable serving state lives in one ``EngineState`` on the engine's
device.  ``from_config`` resolves ``device=None`` to the CUDA card and
raises when there is none; pass ``device="cpu"`` to run on the CPU with
the plain torch versions of the kernels.

Execution modes:

* ``masked``    — full forward, Alg. 1 on the stacked exit confidences
  (the registry functional) with alpha from the difficulty kernel.
* ``compacted`` — stage-segmented: the difficulty kernel runs once, then
  for each stage the survivors are padded to a power-of-two bucket, the
  stage and its exit head run, and the fused exit-gate kernel decides
  who leaves (padded lanes get the threshold 2.0 and never fire).
  Oversized request batches are split into max-bucket chunks.

Images are NHWC ``(B, H, W, C)``: a numpy array, or a tensor on the
engine's device.

Every read-modify-write of ``state`` holds the engine's state lock, so a
policy installed from another thread (:meth:`set_policy`, as a serving
pool's degradation ladder does) is never overwritten by a call that
folds its telemetry at the same time.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch import device as DEV
from repro_torch.configs import registry as CFG_REGISTRY
from repro_torch.core import adaptive as AD
from repro_torch.core import difficulty as DIFF
from repro_torch.core import routing as R
from repro_torch.core import thresholds as TH
from repro_torch.core.policy import CalibrationData, PolicyResult
from repro_torch.core.routing import DartParams
from repro_torch.engine import registry as REG
from repro_torch.engine import state as ST
from repro_torch.engine.compactor import BatchCompactor
from repro_torch.engine.state import EngineState
from repro_torch.kernels import dispatch as KD
from repro_torch.models import get_family
from repro_torch.models import layers as L
from repro_torch.obs import stats as OBS_STATS


class DartEngine:
    """Session object for DART inference (calibrate -> serve -> adapt).

    Construct via :meth:`from_config`; mutable state is ``self.state``
    (an :class:`EngineState`), everything else is static wiring.
    """

    #: confidence functionals bounded above by 1.0 — the precondition
    #: for the sound head-skip bound (core.thresholds.min_exit_bound)
    _BOUNDED_CONF = ("softmax-max",)

    def __init__(self, model_cfg, params, *, state: EngineState,
                 acfg: AD.AdaptiveConfig, device: torch.device,
                 dcfg: DIFF.DifficultyConfig = DIFF.DEFAULT,
                 confidence: str = "softmax-max",
                 difficulty: str = "image",
                 optimizer: str = "joint_dp",
                 cum_costs=None, buckets=None,
                 adapt: bool = True, update_every: int = 100):
        self.cfg = model_cfg
        self.device = device
        self.params = convert.tree_map(lambda t: t.to(device), params)
        self.state = state
        self._state_lock = threading.RLock()
        self.acfg = acfg
        self.dcfg = dcfg
        self.family = get_family(model_cfg)
        self.n_exits = self.family.num_stages(model_cfg)
        self.confidence = confidence
        self.difficulty = difficulty
        self.optimizer = optimizer
        self._conf_fn = REG.get_confidence(confidence)
        self._diff_fn = REG.get_difficulty(difficulty)
        self._opt_fn = REG.get_optimizer(optimizer)
        self.compactor = BatchCompactor(buckets)
        self.adapt = adapt
        self.update_every = update_every
        self.total_latency_s = 0.0
        self._policy_mirror = None
        if cum_costs is None:
            cum_costs = np.arange(1, self.n_exits + 1) / self.n_exits
        self.cum_costs = np.asarray(cum_costs, float)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, model_cfg, params, *, device=None,
                    dart: DartParams | None = None,
                    adaptive_cfg: AD.AdaptiveConfig | None = None,
                    n_classes: int | None = None,
                    beta_opt: float | None = None, **kw) -> "DartEngine":
        """Build an engine from a model config + params on ``device``
        (``None`` = the CUDA card; raises when CUDA is absent).
        ``model_cfg`` may be a config object or an arch id resolved by
        ``configs.registry`` (e.g. ``"vit-s16"``)."""
        if isinstance(model_cfg, str):
            model_cfg = CFG_REGISTRY.get(model_cfg)
        dev = DEV.resolve(device)
        family = get_family(model_cfg)
        e = family.num_stages(model_cfg)
        acfg = adaptive_cfg or AD.AdaptiveConfig(
            n_exits=e,
            n_classes=n_classes or getattr(model_cfg, "n_classes", 10))
        state = EngineState.create(e, acfg, dart, device=dev)
        if beta_opt is not None:
            state = state.with_policy(beta_opt=beta_opt)
        return cls(model_cfg, params, state=state, acfg=acfg, device=dev,
                   **kw)

    def _input(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"input on {x.device}, engine on "
                                 f"{self.device}")
            return x.float().contiguous()
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _alpha(self, x):
        return self._diff_fn(x, self.dcfg)

    def _forward(self, x):
        return self.family.forward(self.params, x, self.cfg)

    # ------------------------------------------------------------------
    # cost measurement
    # ------------------------------------------------------------------
    def measure_costs(self, img_shape) -> np.ndarray:
        """Cumulative MACs per exit for one image of ``img_shape`` (H, W,
        C), counted by ``layers.count_macs`` as XLA's cost analysis counts
        them in the JAX engine: convolution taps inside the unpadded
        input, linear and attention products, and LeViT's elementwise
        work, for the stages up to exit s plus exit s's own head (the stem
        is not counted).  Installs the result as ``self.cum_costs``."""
        if not self.family.staged:
            raise ValueError("measure_costs needs a staged family")
        fam, cfg = self.family, self.cfg
        h = fam.apply_stem(self.params, torch.zeros(
            (1,) + tuple(img_shape), device=self.device), cfg)
        cum, total = [], 0
        for s in range(self.n_exits):
            with L.count_macs() as stage:
                h = fam.apply_stage(self.params, h, s, cfg)
            total += stage.macs
            with L.count_macs() as head:
                fam.apply_exit(self.params, h, s, cfg)
            cum.append(total + head.macs)
        self.cum_costs = np.asarray(cum, float)
        return self.cum_costs

    # ------------------------------------------------------------------
    # section II.B — calibration / policy fitting
    # ------------------------------------------------------------------
    def collect_calibration(self, data, *, n=512, split="eval",
                            offset=0, batch=64) -> CalibrationData:
        """Run the model over ``n`` samples and build per-exit calibration
        measurements (confidence, correctness, difficulty, entropy).
        ``data``: a ``DatasetConfig`` the samples are drawn from, or an
        (images, labels) pair of arrays already drawn (all of them are
        used; ``n``, ``split`` and ``offset`` are then ignored)."""
        if isinstance(data, tuple):
            images, y_all = data
            batches = ((images[a:a + batch], y_all[a:a + batch])
                       for a in range(0, len(images), batch))
        else:
            from repro_torch.data.datasets import make_batch
            batches = (make_batch(data, range(a, a + batch), split=split)
                       for a in range(offset, offset + n, batch))
        confs, ents, corrects, alphas, labels = [], [], [], [], []
        for x, y in batches:
            xt = self._input(x)
            logits = self._forward(xt)["exit_logits"]       # (E, B, C)
            conf = self._conf_fn(logits).cpu().numpy()
            ent = R.entropy_from_logits(logits).cpu().numpy()
            pred = logits.argmax(dim=-1).cpu().numpy()
            confs.append(conf.T)
            ents.append(ent.T)
            corrects.append((pred == y[None]).T.astype(float))
            alphas.append(self._alpha(xt).cpu().numpy())
            labels.append(y)
        return CalibrationData(
            conf=np.concatenate(confs),
            correct=np.concatenate(corrects),
            alpha=np.concatenate(alphas),
            cum_costs=self.cum_costs / self.cum_costs[-1],
            labels=np.concatenate(labels),
            entropy=np.concatenate(ents))

    def calibrate(self, data, **kw) -> PolicyResult:
        """Fit the exit policy with the registered optimizer and install
        it.  ``data``: a :class:`CalibrationData`, or what
        :meth:`collect_calibration` takes (the engine collects
        measurements itself)."""
        if not isinstance(data, CalibrationData):
            data = self.collect_calibration(data, **{
                k: kw.pop(k) for k in ("n", "split", "offset", "batch")
                if k in kw})
        kw.setdefault("beta_opt", float(self.state.beta_opt))
        pol = self._opt_fn(data, **kw)
        self.set_policy(tau=pol.tau, coef=pol.coef, beta_diff=pol.beta_diff)
        return pol

    def set_policy(self, **policy) -> None:
        """Install policy leaves (``EngineState.with_policy``'s keywords)
        under the state lock; the host copy of the policy is dropped."""
        with self._state_lock:
            self.state = self.state.with_policy(**policy)
            self._policy_mirror = None

    # ------------------------------------------------------------------
    # serving helpers
    # ------------------------------------------------------------------
    def dart_params(self) -> DartParams:
        """Current routing parameters (adaptive coefficients folded in)."""
        s = self.state
        return DartParams(tau=s.tau, coef=self._coef(),
                          beta_diff=float(s.beta_diff),
                          beta_opt=float(s.beta_opt))

    def _coef(self):
        if self.adapt:
            return AD.effective_coef(self.state.adaptive, self.acfg)
        return self.state.coef

    def min_exit_bound(self, alpha_lo: float = 0.0) -> int:
        """Sound head-skip depth under the current policy: the number of
        leading gates Eq. 19 provably rules out for every input with
        difficulty >= ``alpha_lo``.  0 for unbounded confidences."""
        if self.confidence not in self._BOUNDED_CONF or self.n_exits < 2:
            return 0
        tau, coef, beta_diff = self._policy_host()
        return TH.min_exit_bound(tau, coef, beta_diff, alpha_lo)

    def _policy_host(self):
        """Host mirror of (tau, effective coef, beta_diff), cached until
        calibrate()/update() or a ``with_policy`` install replaces the
        tau/coef tensors."""
        # the key holds the tensors themselves: an id could be reused
        key = (self.state.tau, self.state.coef)
        m = self._policy_mirror
        if m is None or m[0][0] is not key[0] or m[0][1] is not key[1]:
            self._policy_mirror = (key, (
                self.state.tau.cpu().numpy().astype(np.float32),
                self._coef().cpu().numpy().astype(np.float32),
                float(self.state.beta_diff)))
        return self._policy_mirror[1]

    def bucket_key(self, n: int) -> int:
        """The padded batch shape for an ``n``-sample batch."""
        return self.compactor.padded_size(n)

    def _gate(self, logits, eff_thresh):
        if self.confidence == "softmax-max":
            conf, _, pred, fire = KD.exit_gate(logits, eff_thresh)
            return conf, pred, fire.bool()
        conf = self._conf_fn(logits)
        return conf, logits.argmax(dim=-1), conf > eff_thresh

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def infer(self, x, mode: str = "compacted", record: bool | None = None,
              alpha=None, pad_to: int | None = None,
              min_exit: int = 0) -> dict:
        """Serve one request batch.

        mode="masked"    — full forward, Alg. 1 on stacked confidences;
                           returns tensors on the engine's device.
        mode="compacted" — stage-segmented with batch compaction (same
                           decisions); returns numpy arrays.
        record — update serving counters + the section II.C window
                 (default on for compacted, off for masked).
        alpha  — optional (B,) precomputed Eq. 8 difficulty.
        pad_to — masked mode only: zero-pad the batch to this size.
        min_exit — head-skip depth: gates s < min_exit are skipped (no
                 exit head, no gate); with ``min_exit_bound`` they
                 provably never fire.  Masked mode ignores it."""
        if not 0 <= int(min_exit) < self.n_exits:
            raise ValueError(f"min_exit {min_exit} out of range for "
                             f"{self.n_exits} exits")
        if mode == "masked":
            return self._infer_masked(x, record=bool(record), alpha=alpha,
                                      pad_to=pad_to)
        if mode == "compacted":
            record = True if record is None else record
            return self._infer_compacted(x, record=record, alpha=alpha,
                                         min_exit=int(min_exit))
        raise ValueError(f"unknown mode {mode!r}; known: masked, compacted")

    def _alpha_input(self, alpha) -> torch.Tensor:
        return torch.as_tensor(np.asarray(alpha, np.float32),
                               device=self.device)

    # -- masked ---------------------------------------------------------
    def _infer_masked(self, x, record: bool = False, alpha=None,
                      pad_to: int | None = None) -> dict:
        t0 = time.time()
        x = self._input(x)
        b = x.shape[0]
        if alpha is not None:
            alpha = self._alpha_input(alpha)
        if pad_to is not None and pad_to > b:
            x = self.compactor.pad(x, pad_to)
            if alpha is not None:
                alpha = self.compactor.pad(alpha, pad_to)
        logits = self._forward(x)["exit_logits"]           # (E, bp, C)
        conf_stack = self._conf_fn(logits)
        alpha = self._alpha(x) if alpha is None else alpha
        r = R.route(conf_stack, alpha, self.dart_params())
        preds_all = logits.argmax(dim=-1)
        pred = preds_all.gather(0, r["exit_idx"][None])[0]
        if x.shape[0] > b:                  # strip padded lanes
            r = {k: v[:b] for k, v in r.items()}
            pred = pred[:b]
            preds_all = preds_all[:, :b]
            conf_stack = conf_stack[:, :b]
        idx = r["exit_idx"].cpu().numpy()
        macs = self.cum_costs[idx]
        res = {**r, "pred": pred, "preds_all": preds_all,
               "conf_stack": conf_stack, "macs": macs,
               "latency_s": time.time() - t0}
        if record:
            self._record(idx, pred.cpu().numpy(), r["conf"].cpu().numpy(),
                         macs, latency_s=res["latency_s"],
                         exit_counts=np.bincount(idx,
                                                 minlength=self.n_exits))
            self._maybe_update()
        return res

    # -- compacted ------------------------------------------------------
    def _infer_compacted(self, x, record: bool = True, alpha=None,
                         min_exit: int = 0) -> dict:
        b = x.shape[0]
        if b > self.compactor.max_bucket:
            # One request = one policy: the section II.C update waits
            # until every chunk of the request has been gated.
            parts = [self._infer_compacted_chunk(
                x[a:z], record=record,
                alpha=None if alpha is None else alpha[a:z],
                min_exit=min_exit)
                for a, z in self.compactor.chunks(b)]
            out = {k: np.concatenate([p[k] for p in parts])
                   for k in ("pred", "conf", "exit_idx", "alpha", "macs")}
            out["latency_s"] = sum(p["latency_s"] for p in parts)
        else:
            out = self._infer_compacted_chunk(x, record=record, alpha=alpha,
                                              min_exit=min_exit)
        if record:
            self._maybe_update()
        return out

    def _infer_compacted_chunk(self, x, record: bool, alpha=None,
                               min_exit: int = 0) -> dict:
        t0 = time.time()
        x = self._input(x)
        b = x.shape[0]
        alpha = self._alpha(x) if alpha is None else self._alpha_input(alpha)

        out_pred = np.zeros(b, np.int64)
        out_conf = np.zeros(b, np.float32)
        out_exit = np.zeros(b, np.int64)

        coef = self._coef().float()
        tau = self.state.tau
        beta_diff = float(self.state.beta_diff)

        h_active = self.family.apply_stem(self.params, x, self.cfg)
        active = np.arange(b)
        alpha_active = alpha
        exit_counts = np.zeros(self.n_exits, np.int32)
        last = self.n_exits - 1
        for s in range(self.n_exits):
            n = len(active)
            bucket = self.bucket_key(n)
            h_pad = self.family.apply_stage(
                self.params, self.compactor.pad(h_active, bucket), s,
                self.cfg)
            if s < min_exit and s < last:
                # gate ruled out for every row: no exit head, no gate
                h_active = h_pad[:n]
                continue
            logits = self.family.apply_exit(self.params, h_pad, s, self.cfg)
            if s < last:
                eff = TH.stage_threshold(tau[s], coef[s], alpha_active,
                                         beta_diff).float()
                conf, pred, fire = self._gate(
                    logits, self.compactor.pad(eff, bucket, fill=2.0))
                fire = fire[:n].cpu().numpy()
            else:
                conf, pred, _ = self._gate(
                    logits, torch.zeros(bucket, dtype=torch.float32,
                                        device=self.device))
                fire = np.ones(n, bool)
            conf = conf[:n].cpu().numpy()
            pred = pred[:n].cpu().numpy()

            done = active[fire]
            out_pred[done] = pred[fire]
            out_conf[done] = conf[fire]
            out_exit[done] = s
            exit_counts[s] += int(fire.sum())
            keep = ~fire
            if not keep.any():
                break
            keep_idx = torch.as_tensor(np.nonzero(keep)[0],
                                       device=self.device)
            h_active = self.compactor.gather(h_pad[:n], keep_idx)
            alpha_active = alpha_active[keep_idx]
            active = active[keep]

        macs = self.cum_costs[out_exit]
        latency = time.time() - t0
        if record:
            self._record(out_exit, out_pred, out_conf, macs,
                         latency_s=latency, exit_counts=exit_counts)
        return {"pred": out_pred, "conf": out_conf, "exit_idx": out_exit,
                "alpha": alpha.cpu().numpy(), "macs": macs,
                "latency_s": latency}

    # ------------------------------------------------------------------
    # section II.C — adaptation + metering
    # ------------------------------------------------------------------
    def _record(self, exit_idx, pred, conf, macs, *, latency_s=0.0,
                exit_counts=None):
        """Fold one served batch (host numpy arrays) into the state:
        counters always, the section II.C window only when adaptation is
        on."""
        b = len(exit_idx)
        if exit_counts is None:
            exit_counts = np.bincount(exit_idx, minlength=self.n_exits)
        dev = self.device

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        with self._state_lock:
            s = self.state
            adaptive = s.adaptive
            if self.adapt:
                # confidence-calibrated pseudo-correctness (section II.C.1)
                adaptive = AD.record_batch(
                    adaptive, self.acfg, t(exit_idx, torch.int32),
                    t(pred % self.acfg.n_classes, torch.int32), t(conf),
                    t(conf), t(macs / self.cum_costs[-1]))
            self.state = dataclasses.replace(
                s, adaptive=adaptive, served=s.served + b,
                exit_counts=s.exit_counts + t(exit_counts, torch.int32),
                total_macs=s.total_macs + float(np.sum(macs)),
                since_update=s.since_update + b)
            self.total_latency_s += latency_s

    def _maybe_update(self):
        with self._state_lock:
            if self.adapt and \
                    int(self.state.since_update) >= self.update_every:
                self.update()

    def update(self) -> None:
        """One section II.C periodic refinement: run both adaptation laws
        on the sliding window, score with the Eq. 10 reward, update
        UCB1."""
        with self._state_lock:
            s = self.state
            adaptive = AD.periodic_update(s.adaptive, self.acfg,
                                          beta_opt=float(s.beta_opt))
            self.state = dataclasses.replace(
                s, adaptive=adaptive, since_update=torch.zeros_like(
                    s.since_update))
            self._policy_mirror = None

    def record_requests(self, latencies_ms, missed=None) -> None:
        """Fold completed-request latency/deadline telemetry into the
        engine state (host-side write; the async scheduler calls this
        once per completed bucket)."""
        with self._state_lock:
            self.state = ST.record_requests(self.state, latencies_ms,
                                            missed)

    def record_quotes(self, quotes_ms, realized_ms) -> None:
        """Fold admission-time SLO quote error telemetry (quote vs
        realized latency; host-side write, like record_requests)."""
        with self._state_lock:
            self.state = ST.record_quotes(self.state, quotes_ms,
                                          realized_ms)

    # ------------------------------------------------------------------
    # state round-trip
    # ------------------------------------------------------------------
    def save_state(self, path: str, step: int = 0):
        """Checkpoint the whole serving state (one tree) atomically, in
        the JAX package's format."""
        from repro_torch import checkpoint as CK
        return CK.save(path, step, self.state)

    def restore_state(self, path: str, step: int | None = None):
        """Restore ``self.state`` from a checkpoint of either package
        (older layouts through ``restore_with_migration``), every leaf on
        the engine's device; the host copy of the policy is dropped."""
        with self._state_lock:
            self.state, step = ST.restore_with_migration(
                path, self.state, step, device=self.device)
            self._policy_mirror = None
        return step

    def stats(self) -> dict:
        """Serving counters + windowed section II.C statistics (numpy),
        and ``requests`` (latency percentiles, deadline misses) once the
        scheduler recorded any."""
        s = self.state
        out = OBS_STATS.engine_summary(ST.telemetry_totals(s))
        out["total_latency_s"] = self.total_latency_s
        out["active_strategy"] = AD.STRATEGIES[
            int(s.adaptive["active_strategy"])]
        if out["served"]:
            w = AD.window_stats(s.adaptive, self.acfg)
            out["window"] = {k: v.cpu().numpy() for k, v in w.items()}
        return OBS_STATS.attach_requests(out, s)
