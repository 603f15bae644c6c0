"""The training loop with the paper's multi-exit objective.

``Trainer(cfg, TrainConfig(...), data_cfg).run()`` trains an AlexNet,
VGG, ResNet, LeViT, ViT or ConvNeXt of ``repro_torch.models`` on one
device with the Eq. 18 loss (``core.routing.multi_exit_xent``), AdamW
or SGD under a warmup-cosine schedule with the batchnorm running
statistics masked out, and microbatch accumulation; a step then merges
the train-mode batchnorm statistics into the tree.  An ``LMConfig``
trains with the Eq. 18 loss over a chunked-vocabulary cross-entropy
(``transformer_lm.lm_multi_exit_loss``) on ``synth-tokens`` sequences of
``max_seq + 1`` tokens, each input predicting its next token.  With
``ckpt_dir``
set, ``run`` checkpoints ``state_tree()`` every ``ckpt_every`` steps
and at its end (``repro_torch.checkpoint``, the JAX package's format),
and ``restore`` resumes the latest one, the port's or the JAX
package's (``convert.restore_checkpoint``).  ViT-H/14's and the LMs'
``remat`` recomputes each block in the backward pass.
``trainer.params`` is a tree that
``DartEngine.from_config`` (or ``LMDecodeEngine``) serves as it is: its
leaves never require grad.

The reference's other options wait for later slices and raise here:
the diffusion family (ROADMAP queue 1, item 8), a mesh, FSDP and
gradient compression (item 9).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch import convert
from repro_torch import device as DEV
from repro_torch.core import routing as R
from repro_torch.data.datasets import DatasetConfig
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models import batchnorm as BN
from repro_torch.models import family_of, get_family
from repro_torch.models.transformer_lm import lm_multi_exit_loss
from repro_torch.optim import (GradAccumulator, adamw, sgd, trainable_mask,
                               value_and_grad, warmup_cosine)


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 32
    steps: int = 200
    lr: float = 1e-3
    warmup: int = 20
    optimizer: str = "adamw"
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    microbatches: int = 1
    seed: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    log_every: int = 20
    fsdp: bool = False
    compression: str = "none"
    policy_weight: float = 0.01


def _refuse(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported yet "
                              f"(ROADMAP queue 1, item {item})")


class Trainer:
    """Trains ``model_cfg`` from the port's seeded init (``seed`` of the
    train config) or from ``params`` (a tree such as
    ``convert.from_jax_params`` makes) on ``device`` (``None`` = the
    CUDA card)."""

    def __init__(self, model_cfg, train_cfg: TrainConfig,
                 data_cfg: DatasetConfig | None = None, *, mesh=None,
                 params=None, device=None):
        try:
            self.family_name = family_of(model_cfg)
        except KeyError:
            _refuse(f"training {type(model_cfg).__name__}", 8)
        if mesh is not None or train_cfg.fsdp:
            _refuse("training on a mesh or with FSDP", 9)
        if train_cfg.compression not in (None, "none"):
            _refuse("gradient compression", 9)
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.family = get_family(model_cfg)
        self.data_cfg = data_cfg or DatasetConfig()
        self.device = DEV.resolve(device)
        if params is None:
            params = self.family.init(model_cfg, seed=train_cfg.seed,
                                      device=self.device)
        self.params = convert.tree_map(
            lambda t: t.detach().to(self.device), params)

        mask = trainable_mask(self.params)
        schedule = warmup_cosine(train_cfg.lr, train_cfg.warmup,
                                 train_cfg.steps)
        if train_cfg.optimizer == "adamw":
            self.opt = adamw(schedule, weight_decay=train_cfg.weight_decay,
                             max_grad_norm=train_cfg.max_grad_norm,
                             mask=mask)
        else:
            self.opt = sgd(schedule, max_grad_norm=train_cfg.max_grad_norm,
                           mask=mask)
        self.opt_state = self.opt.init(self.params)
        self.step = 0
        self._acc = GradAccumulator(train_cfg.microbatches)
        self.manager = (ckpt_lib.CheckpointManager(
            train_cfg.ckpt_dir, save_every=train_cfg.ckpt_every)
            if train_cfg.ckpt_dir else None)
        self.history: list[dict] = []

    def _loss_fn(self, params, batch):
        x, y = batch
        if self.family_name == "lm":
            return lm_multi_exit_loss(params, x, y, self.model_cfg,
                                      policy_weight=self.cfg.policy_weight)
        out = self.family.forward(params, x, self.model_cfg, train=True)
        loss, aux = R.multi_exit_xent(out["exit_logits"], y,
                                      policy_weight=self.cfg.policy_weight)
        aux["bn_updates"] = out.get("bn_updates", {})
        return loss, aux

    def _prepare(self, x, y):
        """An LM's labels are its inputs shifted by one token."""
        if self.family_name == "lm":
            return x[:, :-1], x[:, 1:]
        return x, y

    def train_step(self, batch) -> float:
        """One step on ``batch`` = (x NHWC images, y labels), or for an LM
        (x (B, S + 1) tokens, y unused), numpy or tensors: the loss of the
        forward before the update, then the optimizer, then the
        batchnorm merge."""
        x, y = self._prepare(*(torch.as_tensor(a, device=self.device)
                               for a in batch))
        if self.cfg.microbatches > 1:
            loss, grads, aux = self._acc.accumulate(self._loss_fn,
                                                    self.params, (x, y))
        else:
            (loss, aux), grads = value_and_grad(self._loss_fn, self.params,
                                                (x, y))
        params, self.opt_state = self.opt.update(grads, self.opt_state,
                                                 self.params)
        bn_updates = aux.pop("bn_updates", {})
        self.params = (BN.merge_updates(params, bn_updates) if bn_updates
                       else params)
        self.step += 1
        return float(loss)

    def run(self, steps: int | None = None,
            pipeline: DataPipeline | None = None):
        """Train to ``steps`` (default: the config's), logging
        ``{"step", "loss", "elapsed_s"}`` every ``log_every`` steps and
        at the last one; returns ``history``."""
        steps = steps or self.cfg.steps
        own_pipe = pipeline is None
        if own_pipe:
            lm = self.family_name == "lm"
            pipeline = DataPipeline(
                self.data_cfg, self.cfg.batch_size,
                kind="tokens" if lm else None,
                seq_len=self.model_cfg.max_seq + 1 if lm else None,
                vocab=self.model_cfg.vocab if lm else None,
                start_step=self.step, device=self.device)
        t0 = time.time()
        try:
            while self.step < steps:
                _, x, y = next(pipeline)
                loss = self.train_step((x, y))
                if self.step % self.cfg.log_every == 0 or self.step == steps:
                    self.history.append({"step": self.step, "loss": loss,
                                         "elapsed_s": time.time() - t0})
                if self.manager:
                    self.manager.maybe_save(self.step, self.state_tree(),
                                            extra={"loss": loss})
        finally:
            if own_pipe:
                pipeline.close()
            if self.manager:
                self.manager.maybe_save(self.step, self.state_tree(),
                                        extra={}, force=True)
                self.manager.wait()
        return self.history

    # -- checkpoint plumbing -------------------------------------------------
    def state_tree(self):
        """What a checkpoint holds: the params, the optimizer state and
        the step (the JAX trainer's tree)."""
        return {"params": self.params, "opt": self.opt_state,
                "step": self.step}

    def restore(self, path=None) -> bool:
        """Resume the latest checkpoint under ``path`` (default: the
        train config's ``ckpt_dir``), written by either package, onto
        this trainer's device.  False when there is none."""
        path = self.manager.path if path is None else path
        if ckpt_lib.latest_step(path) is None:
            return False
        tree, _, _ = convert.restore_checkpoint(path, self.state_tree(),
                                                device=self.device)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.step = int(tree["step"])
        return True
