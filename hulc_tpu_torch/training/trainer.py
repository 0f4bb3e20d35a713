"""The training loop (port of hulc_tpu/training/trainer.py:51-121, 174-488).

``Trainer(cfg, tcfg)`` builds the model on the card (CUDA unless the
caller passes ``device``), randomly initialized from ``tcfg.seed``, in
train mode, and one ``torch.Generator`` (seeded ``tcfg.seed + 1``) from
which the train step draws its random shifts and depth noise (first), the
plan's noise and every dropout mask. ``init_state`` builds the optimizer (``AdamLowp``: bf16
moments, fp32 math, the JAX trainer's default) over the learning-rate
schedule.

* ``train_step(raw_batch, kl_beta)``: the random-shift preprocess and the
  depth noise (``training.preprocess``), ``HulcModel.train_losses``, the
  backward and the Adam update, which also returns the global gradient
  norm (``grad_norm``). The losses stay on the device. Tests pass the
  shifts, the depth noise and the plan noise JAX drew (``shifts=``,
  ``depth_noise=``, ``gumbel=`` or ``normal=``).
* ``val_step(raw_batch, kl_beta)``: the eval preprocess and
  ``HulcModel.val_metrics``, the scalar metrics only; ``validate`` runs it
  over a val loader in eval mode under ``torch.no_grad`` (the model is back
  in train mode after), its noise from a generator seeded ``tcfg.seed + 2``
  at every call (JAX folds one fixed key), and averages on the host with
  one copy per batch.
* ``fit(train_loader, val_loader)``: epochs of train steps with the KL beta
  of ``tcfg.kl_schedule``, a log line every ``log_every`` batches (the only
  reads of the losses), validation and callbacks every ``val_every_epochs``,
  checkpoints (``training.checkpoint``) every ``checkpoint_every_epochs``
  and ``checkpoint_every_steps``, and the JAX package's ``max_steps`` (this
  call's steps), ``max_total_steps`` (the run's) and resume semantics. It
  starts from fresh weights (``reset_state``) unless a checkpoint resumes
  it; a checkpoint holds the parameters, the Adam state, the step, the
  epoch and the generator's state, so a resumed run draws what an
  uninterrupted one would. Host batches go up through the trainer's
  ``data.loader.StagingPool`` (``staging``): two pinned staging slots and a
  copy on a side stream that runs under the previous step.

Metrics go to ``<run_dir>/metrics.jsonl`` (``utils.loggers.MetricLogger``)
under the prefixes ``train``, ``val``, ``epoch`` (and a callback's own).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.data.loader import DeviceLoader, StagingPool
from hulc_tpu_torch.device import resolve_device
from hulc_tpu_torch.models.hulc import HulcModel, ModalityBatch, init_weights_, make_model
from hulc_tpu_torch.models.layers import set_dropout_generator
from hulc_tpu_torch.training import checkpoint as ckpt
from hulc_tpu_torch.training.optimizers import AdamLowp
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from hulc_tpu_torch.training.schedules import KLSchedule, make_lr_schedule
from hulc_tpu_torch.utils.loggers import MetricLogger


@dataclasses.dataclass
class TrainerConfig:
    """The JAX TrainerConfig's fields that the port's loop reads. The
    optimizer is its default, Adam with bf16-stored moments."""

    run_dir: str = "runs/dev"
    max_epochs: int = 100
    lr: float = 2e-4
    lr_schedule: str = "constant"
    num_warmup_steps: float = 0.1
    kl_schedule: KLSchedule = dataclasses.field(default_factory=KLSchedule)
    seed: int = 42
    log_every: int = 50
    val_every_epochs: int = 1
    checkpoint_every_epochs: int = 1
    # also checkpoint every N optimizer steps (None: at epoch ends only); a
    # mid-epoch save replaces the current epoch's checkpoint atomically
    checkpoint_every_steps: Optional[int] = None
    # a preset of checkpoint.CHECKPOINT_PRESETS or a CheckpointPolicy
    checkpoint_policy: Any = "all"
    # validation batches per epoch (None: the whole val set)
    val_max_batches: Optional[int] = None
    # optimizer steps per uploaded batch, each with fresh shifts and noise
    echo_factor: int = 1


class Trainer:
    def __init__(self, cfg: HulcConfig, tcfg: TrainerConfig, device="cuda", use_kernels: bool = True):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.model: HulcModel = make_model(cfg, self.device, seed=tcfg.seed, use_kernels=use_kernels).train()
        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed + 1)
        set_dropout_generator(self.model, self.generator)
        self.optimizer: Optional[AdamLowp] = None
        self.step = 0
        self.epoch = 0
        self.checkpointer = ckpt.MonitoredCheckpointer(tcfg.run_dir, tcfg.checkpoint_policy)
        self._logger: Optional[MetricLogger] = None
        # the pinned staging slots every loader's batches go up through
        self.staging = StagingPool(self.device) if self.device.type == "cuda" else None

    @property
    def logger(self) -> MetricLogger:
        """The run's JSONL sink, opened at its first use."""
        if self._logger is None:
            self._logger = MetricLogger(self.tcfg.run_dir)
        return self._logger

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def build_optimizer(self, steps_per_epoch: int) -> AdamLowp:
        num_training_steps = min(steps_per_epoch * self.tcfg.max_epochs, 2**31 - 1)
        self.lr_schedule = make_lr_schedule(
            self.tcfg.lr_schedule, self.tcfg.lr, num_training_steps, self.tcfg.num_warmup_steps
        )
        return AdamLowp(self.model.parameters(), lr=self.lr_schedule, use_kernels=self.use_kernels)

    def init_state(self, steps_per_epoch: int = 1) -> None:
        self.optimizer = self.build_optimizer(steps_per_epoch)
        self.step = 0

    def reset_state(self, steps_per_epoch: int = 1) -> None:
        """Fresh weights from ``tcfg.seed``, the generator back at
        ``tcfg.seed + 1``, a new optimizer at step 0: where ``fit`` starts."""
        init_weights_(self.model, torch.Generator(device=self.device).manual_seed(self.tcfg.seed))
        self.generator.manual_seed(self.tcfg.seed + 1)
        self.init_state(steps_per_epoch)

    def checkpoint_state(self) -> Dict[str, Any]:
        return {
            "params": self.model.state_dict(),
            "optimizer": self.optimizer.checkpoint_state(),
            "step": self.step,
            "epoch": self.epoch,
            "generator": self.generator.get_state(),
        }

    def restore(self, path) -> None:
        """Load a checkpoint's parameters, Adam state, step, epoch and
        generator state."""
        state = ckpt.restore_checkpoint(path, map_location="cpu")
        self.model.load_state_dict(state["params"])
        self.optimizer.load_checkpoint_state(state["optimizer"])
        self.step, self.epoch = int(state["step"]), int(state["epoch"])
        self.generator.set_state(state["generator"])

    def _save(self, epoch: int, metrics: Dict[str, float]) -> None:
        self.checkpointer.save(epoch, self.checkpoint_state(), metrics)

    def _device_batches(self, loader):
        """``loader``'s batches on the device, through the trainer's staging
        pool."""
        return loader if isinstance(loader, DeviceLoader) else DeviceLoader(loader, self.device, self.staging)

    @staticmethod
    def _host_scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Scalar tensors as floats, in one copy to the host."""
        keys = list(metrics)
        values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys]).cpu().tolist()
        return dict(zip(keys, values))

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def train_step(
        self,
        raw_batch: Dict[str, ModalityBatch],
        kl_beta: float,
        *,
        shifts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        depth_noise: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        gumbel=None,
        normal=None,
    ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a raw batch (uint8 frames, fp32 depth);
        returns the losses and ``grad_norm``."""
        if self.optimizer is None:
            raise RuntimeError("call init_state before train_step")
        batch = preprocess_batch(
            self.cfg, batch_to_device(raw_batch, self.device), train=True,
            generator=self.generator, shifts=shifts, depth_noise=depth_noise, use_kernels=self.use_kernels,
        )
        self.optimizer.zero_grad(set_to_none=True)
        losses = self.model.train_losses(batch, kl_beta, generator=self.generator, gumbel=gumbel, normal=normal)
        losses["total_loss"].backward()
        losses["grad_norm"] = self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def train_steps(self, n: int, batches: Sequence[Dict[str, ModalityBatch]], kl_beta: float) -> List[Dict[str, torch.Tensor]]:
        """``n`` steps, cycling over ``batches``."""
        return [self.train_step(b, kl_beta) for b in itertools.islice(itertools.cycle(batches), n)]

    def val_step(
        self,
        raw_batch: Dict[str, ModalityBatch],
        kl_beta: Optional[float] = None,
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    ) -> Dict[str, torch.Tensor]:
        """The scalar validation metrics of one raw uint8 batch, on the
        device; the model must be in eval mode (``validate`` sees to it)."""
        batch = preprocess_batch(
            self.cfg, batch_to_device(raw_batch, self.device), train=False, use_kernels=self.use_kernels
        )
        metrics = self.model.val_metrics(batch, kl_beta, generator=generator, noise=noise)
        return {k: v for k, v in metrics.items() if v.dim() == 0}

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def validate(self, val_loader, max_batches: Optional[int] = None, kl_beta: Optional[float] = None) -> Dict[str, float]:
        """The mean val metrics over ``val_loader`` (at most ``max_batches``,
        default ``tcfg.val_max_batches``), logged under ``val``."""
        if max_batches is None:
            max_batches = self.tcfg.val_max_batches or len(val_loader)
        if max_batches < len(val_loader):
            print(f"[trainer] validation capped at {max_batches}/{len(val_loader)} batches")
        if kl_beta is None:
            kl_beta = self.cfg.loss.kl_beta
        generator = torch.Generator(device=self.device).manual_seed(self.tcfg.seed + 2)
        keys, rows = None, []
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                for raw_batch in itertools.islice(self._device_batches(val_loader), max_batches):
                    metrics = self.val_step(raw_batch, kl_beta, generator=generator)
                    keys = list(metrics)
                    rows.append(torch.stack([metrics[k].float() for k in keys]).cpu().numpy())
        finally:
            self.model.train(was_training)
        mean = {} if keys is None else dict(zip(keys, np.mean(np.stack(rows).astype(np.float64), axis=0).tolist()))
        self.logger.log(mean, self.step, "val")
        print("[trainer] val:", {k: round(v, 4) for k, v in mean.items() if "act_loss" in k or "mae" in k or "sr" in k})
        return mean

    def fit(
        self,
        train_loader,
        val_loader=None,
        max_epochs: Optional[int] = None,
        max_steps: Optional[int] = None,
        resume: bool = True,
        callbacks: Optional[list] = None,
        max_total_steps: Optional[int] = None,
    ) -> int:
        """Train; returns the step count. ``max_steps`` caps the steps of this
        call (they add up across resumes), ``max_total_steps`` the run's step
        count (a relaunch trains only the remainder). A callback's
        ``on_epoch_end(trainer, epoch)`` runs at the validation cadence; a
        dict it returns joins the epoch's metrics."""
        tcfg = self.tcfg
        steps_per_epoch = len(train_loader)
        self.reset_state(steps_per_epoch)

        start_epoch = 0
        if resume:
            latest = ckpt.latest_checkpoint(tcfg.run_dir)
            if latest is not None:
                self.restore(latest)
                start_epoch = ckpt.checkpoint_epoch(latest) + 1
                print(f"[trainer] resumed from {latest} (epoch {start_epoch})")

        base_step = self.step
        if max_total_steps is not None and base_step >= max_total_steps:
            print(f"[trainer] already at step {base_step} >= {max_total_steps}; nothing to do")
            return self.step

        def hit_cap(total_steps: int) -> bool:
            if max_steps is not None and total_steps >= max_steps:
                return True
            return max_total_steps is not None and base_step + total_steps >= max_total_steps

        total_steps = 0
        max_epochs = tcfg.max_epochs if max_epochs is None else max_epochs
        batches = self._device_batches(train_loader)
        losses = None
        for epoch in range(start_epoch, max_epochs):
            self.epoch = epoch
            kl_beta = float(tcfg.kl_schedule(epoch, self.cfg.loss.kl_beta))
            t_epoch = time.time()
            seqs = 0
            for i, batch in enumerate(batches):
                for _ in range(max(1, tcfg.echo_factor)):
                    losses = self.train_step(batch, kl_beta)
                    seqs += sum(b.actions.shape[0] for b in batch.values())
                    total_steps += 1
                    if (
                        tcfg.checkpoint_every_steps
                        and total_steps % tcfg.checkpoint_every_steps == 0
                        and not hit_cap(total_steps)  # the end-of-run save covers the cap
                    ):
                        self._save(epoch, {})
                    if hit_cap(total_steps):
                        break
                if i % tcfg.log_every == 0:
                    host = self._host_scalars(losses)
                    host["lr"] = float(self.lr_schedule(self.step))
                    self.logger.log(host, self.step, "train")
                    print(
                        f"[trainer] epoch {epoch} step {i}/{steps_per_epoch} loss={host['total_loss']:.4f} "
                        f"act={host['action_loss']:.4f} kl={host['kl_loss']:.5f}"
                    )
                if hit_cap(total_steps):
                    break
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the epoch's time includes its last steps
            dt = time.time() - t_epoch
            self.logger.log(
                {"epoch_time_s": dt, "seq_per_sec": seqs / max(dt, 1e-9), "kl_beta": kl_beta}, self.step, "epoch"
            )

            # what the monitored checkpointer sees this epoch: the last step's
            # losses (train/), the val means (val/) and the callbacks' metrics
            epoch_metrics: Dict[str, float] = (
                {} if losses is None else {f"train/{k}": v for k, v in self._host_scalars(losses).items()}
            )
            hit_max_steps = hit_cap(total_steps)
            # a capped or final epoch always validates, so the run ends with
            # fresh val metrics
            val_epoch = (epoch + 1) % tcfg.val_every_epochs == 0 or epoch == max_epochs - 1 or hit_max_steps
            if val_loader is not None and val_epoch:
                val_mean = self.validate(val_loader, kl_beta=kl_beta)
                epoch_metrics.update({f"val/{k}": v for k, v in val_mean.items()})
            if val_epoch:
                for cb in callbacks or ():
                    cb_metrics = cb.on_epoch_end(self, epoch)
                    if isinstance(cb_metrics, dict):
                        epoch_metrics.update({k: v for k, v in cb_metrics.items() if isinstance(v, (int, float))})
            if (epoch + 1) % tcfg.checkpoint_every_epochs == 0 or epoch == max_epochs - 1 or hit_max_steps:
                self._save(epoch, epoch_metrics)
            if hit_max_steps:
                break
        return self.step
