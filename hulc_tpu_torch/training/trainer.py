"""The training step (port of hulc_tpu/training/trainer.py:51-121, 174-259).

``Trainer(cfg, tcfg)`` builds the model on the card (CUDA unless the
caller passes ``device``), randomly initialized from ``tcfg.seed``, in
train mode, and one ``torch.Generator`` (seeded ``tcfg.seed + 1``) from
which the step draws its random shifts, the plan's Gumbel noise and every
dropout mask. ``init_state`` builds the optimizer (``AdamLowp``: bf16
moments, fp32 math, the JAX trainer's default) over the learning-rate
schedule. ``train_step(raw_batch, kl_beta)`` runs one optimizer step:

1. on-device preprocessing with the random shift (``training.preprocess``);
2. ``HulcModel.train_losses`` (the fused pass for a ``{"fused": 2B}`` batch);
3. the backward of ``total_loss``;
4. the Adam update (``AdamLowp.step``), which also returns the global
   gradient norm, reported as ``grad_norm``: on the card it comes from the
   Adam kernel's pass over the gradients and a one-block finish launch
   (``csrc/adam_lowp.cu``), on the CPU from the plain ``global_norm``.

It returns the losses (detached, on the device); the gradients stay on the
parameters until the next step. Tests pass the shifts and the plan noise
JAX drew (``shifts=``, ``gumbel=``). ``fit``, validation and checkpoints
wait for the data layer.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import torch

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.device import resolve_device
from hulc_tpu_torch.models.hulc import HulcModel, ModalityBatch, make_model
from hulc_tpu_torch.models.layers import set_dropout_generator
from hulc_tpu_torch.training.optimizers import AdamLowp
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from hulc_tpu_torch.training.schedules import make_lr_schedule


@dataclasses.dataclass
class TrainerConfig:
    """The JAX TrainerConfig's fields that the training step reads. The
    optimizer is its default, Adam with bf16-stored moments; the other
    optimizers and the per-epoch KL schedule wait for ``fit``."""

    max_epochs: int = 100
    lr: float = 2e-4
    lr_schedule: str = "constant"
    num_warmup_steps: float = 0.1
    seed: int = 42


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

    def build_optimizer(self, steps_per_epoch: int) -> AdamLowp:
        num_training_steps = min(steps_per_epoch * self.tcfg.max_epochs, 2**31 - 1)
        self.lr_schedule = make_lr_schedule(
            self.tcfg.lr_schedule, self.tcfg.lr, num_training_steps, self.tcfg.num_warmup_steps
        )
        return AdamLowp(self.model.parameters(), lr=self.lr_schedule, use_kernels=self.use_kernels)

    def init_state(self, steps_per_epoch: int = 1) -> None:
        self.optimizer = self.build_optimizer(steps_per_epoch)
        self.step = 0

    def train_step(
        self,
        raw_batch: Dict[str, ModalityBatch],
        kl_beta: float,
        *,
        shifts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        gumbel=None,
    ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a raw uint8 batch; returns the losses and
        ``grad_norm``."""
        if self.optimizer is None:
            raise RuntimeError("call init_state before train_step")
        batch = preprocess_batch(
            self.cfg, batch_to_device(raw_batch, self.device), train=True,
            generator=self.generator, shifts=shifts, use_kernels=self.use_kernels,
        )
        self.optimizer.zero_grad(set_to_none=True)
        losses = self.model.train_losses(batch, kl_beta, generator=self.generator, gumbel=gumbel)
        losses["total_loss"].backward()
        losses["grad_norm"] = self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def train_steps(self, n: int, batches: Sequence[Dict[str, ModalityBatch]], kl_beta: float) -> List[Dict[str, torch.Tensor]]:
        """``n`` steps, cycling over ``batches``."""
        return [self.train_step(b, kl_beta) for b in itertools.islice(itertools.cycle(batches), n)]
