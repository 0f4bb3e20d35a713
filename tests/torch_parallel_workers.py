"""What each rank runs for tests/test_torch_parallel.py. The ranks are fresh
processes (``parallel.mesh.Ranks``, gloo on the CPU): this module
imports torch and the port only. Each function takes global inputs, trains
on its rank's rows and returns CPU tensors and floats for the parent to
hold against the one-process port and JAX."""

import dataclasses
import os

import numpy as np
import torch
import torch.nn as nn

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.models.aux_heads import BCZLangDecoder, MIALangDiscriminator, ProjVisLang
from hulc_tpu_torch.models.hulc import ModalityBatch, masked_bc_z_loss, masked_clip_loss, masked_mia_loss
from hulc_tpu_torch.parallel import mesh

KL_BETA, LR = 0.01, 2e-4
# dropout at every site of hulc_debug's path: the towers after fc1, the word
# dropout of the language goal, the recognition transformer (its attention's
# mask is shared over the batch)
DROPOUT_OVERRIDES = ["perceptual_encoder.rgb_static.dropout=0.2", "perceptual_encoder.rgb_gripper.dropout=0.2",
                     "language_goal.word_dropout=0.2", "plan_recognition.dropout=0.2"]


def debug_cfg(m):
    """``hulc_debug`` of config module ``m`` (either package's) with an 84 px
    gripper camera and no recognition dropout, as test_torch_train_step.py
    builds it."""
    cfg = m.get_config("hulc_debug")
    pe = cfg.perceptual_encoder
    pe = dataclasses.replace(pe, rgb_gripper=dataclasses.replace(pe.rgb_gripper, input_size=84))
    pr = dataclasses.replace(cfg.plan_recognition, dropout=0.0)
    return dataclasses.replace(cfg, perceptual_encoder=pe, plan_recognition=pr).resolve()


def dropout_cfg():
    return port_config.apply_overrides(debug_cfg(port_config), DROPOUT_OVERRIDES)


def as_batch(batch):
    return {scope: ModalityBatch(*mod) for scope, mod in batch.items()}


class ClipHead(nn.Module):
    """The CLIP loss's trainable part: ``proj_vis_lang`` and ``logit_scale``."""

    def __init__(self, vis_features=16, lang_features=12):
        super().__init__()
        self.proj_vis_lang = ProjVisLang(vis_features, lang_features, 8)
        self.logit_scale = nn.Parameter(torch.tensor(2.5))

    def forward(self, seq_feat, goal, mask):
        img, txt = self.proj_vis_lang(seq_feat, goal)
        return masked_clip_loss(img, txt, torch.exp(self.logit_scale), mask)


def clip_grads(state, seq_feat, goal, mask):
    """The CLIP loss over this rank's rows of the global inputs, under DDP:
    (loss, the features' gradients of this rank's rows, the parameters'
    gradients after DDP's average)."""
    head = ClipHead()
    head.load_state_dict(state)
    model = torch.nn.parallel.DistributedDataParallel(head) if mesh.world() > 1 else head
    rows = [mesh.rows_of(t, 1, mesh.world(), mesh.rank()) for t in (seq_feat, goal, mask)]
    x, g = (t.clone().requires_grad_() for t in rows[:2])
    loss = model(x, g, rows[2])
    loss.backward()
    return {"loss": loss.detach(), "seq_feat": x.grad, "goal": g.grad,
            "params": {k: p.grad.clone() for k, p in head.named_parameters()}}


class AuxHead(nn.Module):
    """The BC-Z and MIA losses' trainable parts, under the port model's names."""

    def __init__(self, seq_features, goal_features, lang_dim, proj_dim):
        super().__init__()
        self.proj_vis_lang = ProjVisLang(seq_features, goal_features, proj_dim)
        self.bc_z_lang_decoder = BCZLangDecoder(seq_features, lang_dim)
        self.mia_lang_discriminator = MIALangDiscriminator(2 * proj_dim)

    def forward(self, seq_feat, goal, lang, mask):
        bc_z = masked_bc_z_loss(self.bc_z_lang_decoder(seq_feat), lang, mask)
        return bc_z, masked_mia_loss(self.mia_lang_discriminator, *self.proj_vis_lang(seq_feat, goal), mask)


def aux_grads(state, shapes, seq_feat, goal, lang, mask):
    """The BC-Z and MIA losses over this rank's rows of the global inputs,
    under DDP: (both losses, the inputs' gradients of this rank's rows, the
    parameters' gradients after DDP's average) of their sum."""
    head = AuxHead(*shapes)
    head.load_state_dict(state)
    model = torch.nn.parallel.DistributedDataParallel(head) if mesh.world() > 1 else head
    rows = [mesh.rows_of(t, 1, mesh.world(), mesh.rank()) for t in (seq_feat, goal, lang, mask)]
    x, g = (t.clone().requires_grad_() for t in rows[:2])
    bc_z, mia = model(x, g, rows[2], rows[3])
    (bc_z + mia).backward()
    return {"bc_z": bc_z.detach(), "mia": mia.detach(), "seq_feat": x.grad, "goal": g.grad,
            "params": {k: p.grad.clone() for k, p in head.named_parameters()}}


def train_steps(mode, state, raw, noise, cfg=None, seed=42):
    """Steps of a ``Trainer`` (DDP across the ranks, or ``fsdp``) on this
    rank's rows of the global ``raw`` batch, one per entry of ``noise``
    (global ``shifts`` / ``gumbel``, or None: drawn). Returns each step's
    losses averaged over the ranks and, after the last, the one-device
    parameters and optimizer state."""
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    trainer = Trainer(cfg or debug_cfg(port_config), TrainerConfig(lr=LR, seed=seed, fsdp=mode == "fsdp"),
                      device="cpu")
    if state is not None:
        trainer.load_params(state)
    trainer.init_state(1)
    steps = []
    for kw in noise:
        losses = trainer.train_step(mesh.shard_rows(as_batch(raw)), KL_BETA, **(kw or {}))
        steps.append(trainer.host_scalars(losses))
    return {"steps": steps, "params": {k: v.clone() for k, v in trainer.params().items()},
            "optimizer": trainer.optimizer.checkpoint_state(), "grad_copies": trainer.optimizer.grad_copies}


def first_batches(root, batch_size):
    """This rank's first batch of the fused and of the per-modality train
    loader and of the validation loader (``make_loaders(rank=, world=)``)."""
    from hulc_tpu_torch.data.loader import make_loaders

    cfg = port_config.get_config("hulc_debug")
    out = {}
    for name, kw in (("fused", dict(fuse=True)), ("split", dict(fuse=False)),
                     ("val", dict(split="validation", deterministic=True))):
        loader = make_loaders(cfg, root, batch_size=batch_size, min_window=8, max_window=8, cache="none", seed=3,
                              rank=mesh.rank(), world=mesh.world(), **kw)
        out[name] = next(iter(loader))
    return out


def fsdp_fit(run_dir, raw_batches):
    """Two FSDP ``fit`` runs over this rank's rows of the global batches
    (two a epoch): 3 steps uninterrupted, and 2 steps (one epoch), whose
    checkpoint rank 0 saves. Each run's step count and directory, and the
    uninterrupted run's one-device parameters."""
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    batches = [mesh.shard_rows(as_batch(b)) for b in raw_batches]
    out = {}
    for name, kw in (("whole", dict(max_epochs=2, max_total_steps=3)), ("cut", dict(max_epochs=1))):
        path = os.path.join(run_dir, name)
        trainer = Trainer(debug_cfg(port_config), TrainerConfig(run_dir=path, lr=LR, seed=7, log_every=1, fsdp=True),
                          device="cpu")
        trainer.fit(batches, None, **kw)
        out[name] = {"step": trainer.step, "run_dir": path, "params": trainer.params() if name == "whole" else None}
    return out


def cli(run_dir):
    """The train CLI with ``--fsdp`` for 2 steps, then the refusals of
    ``--tp 2`` and of a batch the ranks do not divide."""
    from hulc_tpu_torch.training import train

    base = ["--config", "hulc_debug", "--fixture", "--cache", "none", "--device", "cpu", "--val-max-batches", "1"]
    trainer = train.main(base + ["--steps", "2", "--batch-size", "2", "--run-dir", run_dir, "--fsdp"])
    refusals = {}
    for name, extra in (("tp", ["--tp", "2", "--batch-size", "2"]), ("batch", ["--batch-size", "3"])):
        try:
            train.main(base + ["--steps", "1", "--run-dir", run_dir + "_" + name] + extra)
        except SystemExit as e:
            refusals[name] = str(e)
    return {"step": trainer.step, "refusals": refusals,
            "saved": sorted(os.listdir(os.path.join(run_dir, "saved_models")))}


def rank_checks(spec):
    """Every check of one spawn, in one group."""
    torch.set_num_threads(1)
    out = {"rank": mesh.rank(), "world": mesh.world()}
    out["clip"] = clip_grads(*spec["clip"])
    out["aux"] = aux_grads(*spec["aux"])
    out["steps"] = {mode: train_steps(mode, spec["state"], spec["raw"], spec["noise"]) for mode in ("ddp", "fsdp")}
    out["dropout"] = {mode: train_steps(mode, None, spec["raw"], [None], dropout_cfg(), seed=5)
                      for mode in ("ddp", "fsdp")}
    out["loader"] = first_batches(spec["data_root"], 4)
    out["fit"] = fsdp_fit(spec["fit_dir"], spec["fit_batches"])
    out["cli"] = cli(spec["cli_dir"])
    return out
