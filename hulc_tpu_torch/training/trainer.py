"""The training loop (port of hulc_tpu/training/trainer.py:51-121, 174-488).

``Trainer(cfg, tcfg)`` builds the model on the card (CUDA unless the
caller passes ``device``), randomly initialized from ``tcfg.seed``, in
train mode, and one ``torch.Generator`` (seeded ``tcfg.seed + 1``) from
which the train step draws its random shifts and depth noise (first), the
plan's noise and every dropout mask. ``init_state`` builds the optimizer over the
learning-rate schedule as the JAX trainer chooses it (``build_optimizer``:
``tcfg.optimizer`` adam, adamw or sgd; adam's moments in ``tcfg.adam_mv_dtype``,
bf16 by default).

* ``train_step(raw_batch, kl_beta)``: the random-shift preprocess and the
  depth noise (``training.preprocess``), ``HulcModel.train_losses``, the
  backward and the optimizer's update, which also returns the global
  gradient norm (``grad_norm``). The losses stay on the device. Tests pass the
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
  it; a checkpoint holds the parameters, the optimizer's state (its kind
  named), the step, the epoch and the generator's state, so a resumed run
  draws what an uninterrupted one would. A params-only checkpoint
  (``training.import_checkpoint``) is refused: it cannot resume a run.
  With ``tcfg.profile_start``, steps ``[profile_start, profile_start +
  profile_steps)`` of the call run under ``torch.profiler``, whose Chrome
  trace goes to ``<run_dir>/profile``. Host batches go up through the trainer's
  ``data.loader.StagingPool`` (``staging``): two pinned staging slots and a
  copy on a side stream that runs under the previous step.

Metrics go to ``<run_dir>/metrics.jsonl`` (``utils.loggers.MetricLogger``)
under the prefixes ``train``, ``val``, ``epoch`` (and a callback's own).

Several devices (port of the JAX trainer's ``num_devices`` and ``fsdp``):
in a process group (``parallel.mesh.initialize_distributed``, one process
per GPU under ``torchrun``) each rank trains on its rows of every global
batch (``make_loaders(rank=, world=)`` or ``parallel.mesh.shard_rows``) and
the step computes what one device computes on the whole batch: the
model is wrapped in ``DistributedDataParallel`` (gradients averaged) when
there is more than one rank, or sharded ZeRO-3 style with
``tcfg.fsdp`` (``parallel.mesh.fsdp_shard``, one rank too). The steps run
under ``parallel.mesh.sharded_rows``: each draw is the global batch's, cut to
this rank's rows, and injected noise is global. The logged losses and the
val metrics are averaged over the ranks before they are written; rank 0
alone writes the JSONL and the checkpoints (full tensors, the one-device
format, so a run resumes on any number of devices) while the others wait.
"""

from __future__ import annotations

import dataclasses
import itertools
import pathlib
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.data.loader import DeviceLoader, StagingPool
from hulc_tpu_torch.device import resolve_device
from hulc_tpu_torch.models.hulc import HulcModel, ModalityBatch, init_weights_, make_model
from hulc_tpu_torch.models.layers import set_dropout_generator
from hulc_tpu_torch.parallel import mesh
from hulc_tpu_torch.training import checkpoint as ckpt
from hulc_tpu_torch.training.optimizers import SGD, Adam, AdamLowp, AdamW
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from hulc_tpu_torch.training.schedules import KLSchedule, make_lr_schedule
from hulc_tpu_torch.utils.loggers import MetricLogger, NullLogger


@dataclasses.dataclass
class TrainerConfig:
    """The JAX TrainerConfig's fields that the port's loop reads (its ``tp``
    and ``sp`` are not ported yet)."""

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
    # the optimizer family: adam, adamw (weight decay 1e-6) or sgd (momentum 0.9)
    optimizer: str = "adam"
    # adam's moment storage: "bfloat16" (AdamLowp) or "float32" / None (Adam);
    # the arithmetic is fp32 either way
    adam_mv_dtype: Optional[str] = "bfloat16"
    # torch.profiler trace of steps [profile_start, profile_start + profile_steps)
    # of a fit call, written to <run_dir>/profile (None: no trace)
    profile_start: Optional[int] = None
    profile_steps: int = 5
    # the devices of the data axis: None (every rank of the process group) or
    # the world size; any other count is refused (torchrun sets the count)
    num_devices: Optional[int] = None
    # ZeRO-3 over the data axis (parallel.mesh.fsdp_shard); needs a process
    # group, of one rank too
    fsdp: bool = False
    # DistributedDataParallel over the process group: None turns it on above
    # one rank, True at one rank too (its reducer and collectives run)
    data_parallel: Optional[bool] = None


class _TrainLosses(torch.nn.Module):
    """``model.train_losses`` as a forward, for DistributedDataParallel (its
    gradient hooks are armed by its forward)."""

    def __init__(self, model: HulcModel):
        super().__init__()
        self.model = model

    def forward(self, batch, kl_beta, **kwargs):
        return self.model.train_losses(batch, kl_beta, **kwargs)


class Trainer:
    def __init__(self, cfg: HulcConfig, tcfg: TrainerConfig, device="cuda", use_kernels: bool = True):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        if mesh.active() and self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())  # this rank's (initialize_distributed)
        if tcfg.num_devices not in (None, mesh.world()):
            raise ValueError(f"num_devices={tcfg.num_devices}: the port trains on every rank of its process group "
                             f"({mesh.world()}); launch that many ranks (torchrun --nproc-per-node)")
        self.use_kernels = use_kernels
        self.model: HulcModel = make_model(cfg, self.device, seed=tcfg.seed, use_kernels=use_kernels).train()
        self._ddp: Optional[torch.nn.Module] = None
        if tcfg.fsdp:
            if not mesh.active():
                raise ValueError("fsdp needs a process group: launch under torchrun "
                                 "(parallel.mesh.initialize_distributed)")
            mesh.fsdp_shard(self.model, self.device)
        elif tcfg.data_parallel or (tcfg.data_parallel is None and mesh.world() > 1):
            from torch.nn.parallel import DistributedDataParallel

            if not mesh.active():
                raise ValueError("data_parallel needs a process group: launch under torchrun")

            self._ddp = DistributedDataParallel(
                _TrainLosses(self.model), device_ids=[self.device.index] if self.device.type == "cuda" else None,
            )
        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed + 1)
        set_dropout_generator(self.model, self.generator)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.epoch = 0
        self.checkpointer = ckpt.MonitoredCheckpointer(tcfg.run_dir, tcfg.checkpoint_policy)
        self._logger: Optional[MetricLogger] = None
        self._profiler: Optional[torch.profiler.profile] = None
        self._profile_first_step = 0
        # the pinned staging slots every loader's batches go up through
        self.staging = StagingPool(self.device) if self.device.type == "cuda" else None

    @property
    def logger(self) -> MetricLogger:
        """The run's JSONL sink, opened at its first use (rank 0's; the other
        ranks' writes nothing)."""
        if self._logger is None:
            self._logger = MetricLogger(self.tcfg.run_dir) if mesh.rank() == 0 else NullLogger()
        return self._logger

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def build_optimizer(self, steps_per_epoch: int) -> torch.optim.Optimizer:
        """The JAX trainer's choice (hulc_tpu/training/trainer.py:183-194):
        adam with moments stored in any dtype but fp32 is AdamLowp (bf16, the
        only low-precision storage ported), adam with fp32 moments (or none
        named) is Adam, adamw is AdamW with fp32 moments whatever
        ``adam_mv_dtype`` says, sgd is SGD."""
        num_training_steps = min(steps_per_epoch * self.tcfg.max_epochs, 2**31 - 1)
        self.lr_schedule = make_lr_schedule(
            self.tcfg.lr_schedule, self.tcfg.lr, num_training_steps, self.tcfg.num_warmup_steps
        )
        name, mv_dtype = self.tcfg.optimizer, self.tcfg.adam_mv_dtype
        kwargs = dict(lr=self.lr_schedule, use_kernels=self.use_kernels)
        if name == "adam":
            if mv_dtype and mv_dtype != "float32":
                if mv_dtype != "bfloat16":
                    raise ValueError(f"adam_mv_dtype {mv_dtype!r}: the port stores adam's moments in "
                                     f"bfloat16 or float32")
                return AdamLowp(self.model.parameters(), **kwargs)
            return Adam(self.model.parameters(), **kwargs)
        if name == "adamw":
            return AdamW(self.model.parameters(), **kwargs)
        if name == "sgd":
            return SGD(self.model.parameters(), **kwargs)
        raise ValueError(f"unknown optimizer {name!r} (adam|adamw|sgd)")

    def init_state(self, steps_per_epoch: int = 1) -> None:
        self.optimizer = self.build_optimizer(steps_per_epoch)
        self.step = 0

    def reset_state(self, steps_per_epoch: int = 1) -> None:
        """Fresh weights from ``tcfg.seed``, the generator back at
        ``tcfg.seed + 1``, a new optimizer at step 0: where ``fit`` starts."""
        if self.tcfg.fsdp:  # the one-device model's fresh weights, each rank keeping its shards
            fresh = make_model(self.cfg, self.device, seed=self.tcfg.seed, use_kernels=self.use_kernels)
            self.load_params(fresh.state_dict())
        else:
            init_weights_(self.model, torch.Generator(device=self.device).manual_seed(self.tcfg.seed))
        self.generator.manual_seed(self.tcfg.seed + 1)
        self.init_state(steps_per_epoch)

    def params(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict as one device holds it (sharded parameters
        gathered: every rank takes part)."""
        if self.tcfg.fsdp:
            mesh.reshard(self.model)
        return {k: mesh.full_tensor(mesh.local(v), v) for k, v in self.model.state_dict().items()}

    @torch.no_grad()
    def load_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load a one-device state_dict (each rank its shards of sharded
        parameters); strict, as ``load_state_dict``."""
        if not self.tcfg.fsdp:
            self.model.load_state_dict(state_dict)
            return
        mesh.reshard(self.model)
        own = self.model.state_dict()
        if set(own) != set(state_dict):
            raise ValueError(f"state_dict keys differ: missing {sorted(set(own) - set(state_dict))[:5]}, "
                             f"unexpected {sorted(set(state_dict) - set(own))[:5]}")
        for k, v in own.items():
            mesh.local(v).copy_(mesh.local_shard(state_dict[k].to(self.device), v))

    def checkpoint_state(self) -> Dict[str, Any]:
        return {
            "params": self.params(),
            "optimizer": self.optimizer.checkpoint_state(),
            "step": self.step,
            "epoch": self.epoch,
            "generator": self.generator.get_state(),
        }

    def restore(self, path) -> None:
        """Load a checkpoint's parameters, optimizer state, step, epoch and
        generator state. A params-only checkpoint is refused."""
        state = ckpt.restore_checkpoint(path, map_location="cpu")
        if state.get("optimizer") is None:
            raise ValueError(
                f"{path} holds parameters only (an imported checkpoint, training.import_checkpoint): it has no "
                f"optimizer state, step or generator to resume a run from. Evaluate it, or warm-start a new run "
                f"from it (training.pretrain.load_pretrained) in another run_dir"
            )
        self.load_params(state["params"])
        self.optimizer.load_checkpoint_state(state["optimizer"])
        self.step, self.epoch = int(state["step"]), int(state["epoch"])
        self.generator.set_state(state["generator"])

    def _profile_start(self) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()
        self._profile_first_step = self.step

    def _profile_stop(self) -> None:
        """End an open profile window: wait for its steps' device work, then
        write ``<run_dir>/profile/trace_steps_<first>-<last>.json`` (the
        run's step numbers)."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = pathlib.Path(self.tcfg.run_dir) / "profile"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"trace_steps_{self._profile_first_step}-{self.step - 1}.json"
        self._profiler.export_chrome_trace(str(path))
        self._profiler = None
        print(f"[trainer] profile of steps {self._profile_first_step}-{self.step - 1} written to {path}")

    def _save(self, epoch: int, metrics: Dict[str, float]) -> None:
        """Rank 0 writes the checkpoint (every rank gathers its state); the
        others wait for it."""
        state = self.checkpoint_state()
        if mesh.rank() == 0:
            self.checkpointer.save(epoch, state, metrics)
        mesh.barrier()

    def _device_batches(self, loader):
        """``loader``'s batches on the device, through the trainer's staging
        pool."""
        return loader if isinstance(loader, DeviceLoader) else DeviceLoader(loader, self.device, self.staging)

    @staticmethod
    def host_scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Scalar tensors as floats, averaged over the ranks, in one copy to
        the host."""
        keys = list(metrics)
        values = mesh.mean_across_ranks(torch.stack([metrics[k].detach().float().reshape(()) for k in keys]))
        return dict(zip(keys, values.cpu().tolist()))

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
        """One optimizer step on a raw batch (uint8 frames, fp32 depth; this
        rank's rows); returns the losses (means over this rank's rows) and
        ``grad_norm`` (global). Injected noise is the global batch's."""
        if self.optimizer is None:
            raise RuntimeError("call init_state before train_step")
        with mesh.sharded_rows():
            batch = preprocess_batch(
                self.cfg, batch_to_device(raw_batch, self.device), train=True,
                generator=self.generator, shifts=shifts, depth_noise=depth_noise, use_kernels=self.use_kernels,
            )
            self.optimizer.zero_grad(set_to_none=True)
            forward = self.model.train_losses if self._ddp is None else self._ddp
            losses = forward(batch, kl_beta, generator=self.generator, gumbel=gumbel, normal=normal)
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
        with mesh.sharded_rows():
            metrics = self.model.val_metrics(batch, kl_beta, generator=generator, noise=noise)
        return {k: v for k, v in metrics.items() if v.dim() == 0}

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------

    def validate(self, val_loader, max_batches: Optional[int] = None, kl_beta: Optional[float] = None) -> Dict[str, float]:
        """The mean val metrics over ``val_loader`` (at most ``max_batches``,
        default ``tcfg.val_max_batches``), averaged over the ranks, logged
        under ``val``."""
        if max_batches is None:
            max_batches = self.tcfg.val_max_batches or len(val_loader)
        if max_batches < len(val_loader):
            _print(f"[trainer] validation capped at {max_batches}/{len(val_loader)} batches")
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
                    rows.append(mesh.mean_across_ranks(torch.stack([metrics[k].float() for k in keys])).cpu().numpy())
        finally:
            self.model.train(was_training)
            if self.tcfg.fsdp:
                mesh.reshard(self.model)  # the root keeps its gathered parameters after a forward alone
        mean = {} if keys is None else dict(zip(keys, np.mean(np.stack(rows).astype(np.float64), axis=0).tolist()))
        self.logger.log(mean, self.step, "val")
        _print("[trainer] val:", {k: round(v, 4) for k, v in mean.items() if "act_loss" in k or "mae" in k or "sr" in k})
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
                _print(f"[trainer] resumed from {latest} (epoch {start_epoch})")

        base_step = self.step
        if max_total_steps is not None and base_step >= max_total_steps:
            _print(f"[trainer] already at step {base_step} >= {max_total_steps}; nothing to do")
            return self.step

        def hit_cap(total_steps: int) -> bool:
            if max_steps is not None and total_steps >= max_steps:
                return True
            return max_total_steps is not None and base_step + total_steps >= max_total_steps

        total_steps = 0
        profiling = tcfg.profile_start is not None and mesh.rank() == 0  # rank 0's trace
        max_epochs = tcfg.max_epochs if max_epochs is None else max_epochs
        batches = self._device_batches(train_loader)
        losses = None
        try:
            for epoch in range(start_epoch, max_epochs):
                self.epoch = epoch
                kl_beta = float(tcfg.kl_schedule(epoch, self.cfg.loss.kl_beta))
                t_epoch = time.time()
                seqs = 0
                for i, batch in enumerate(batches):
                    for _ in range(max(1, tcfg.echo_factor)):
                        if profiling and total_steps == tcfg.profile_start:
                            self._profile_start()
                        losses = self.train_step(batch, kl_beta)
                        seqs += sum(b.actions.shape[0] for b in batch.values()) * mesh.world()
                        total_steps += 1
                        if profiling and total_steps == tcfg.profile_start + tcfg.profile_steps:
                            self._profile_stop()
                        if (
                            tcfg.checkpoint_every_steps
                            and total_steps % tcfg.checkpoint_every_steps == 0
                            and not hit_cap(total_steps)  # the end-of-run save covers the cap
                        ):
                            self._save(epoch, {})
                        if hit_cap(total_steps):
                            break
                    if i % tcfg.log_every == 0:
                        host = self.host_scalars(losses)
                        host["lr"] = float(self.lr_schedule(self.step))
                        self.logger.log(host, self.step, "train")
                        _print(
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
                    {} if losses is None else {f"train/{k}": v for k, v in self.host_scalars(losses).items()}
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
        finally:
            self._profile_stop()  # a window the run ended inside
        return self.step


def _print(*args) -> None:
    """Print on rank 0 only."""
    if mesh.rank() == 0:
        print(*args)
