"""The equal-loss check of several ranks (port of
``__graft_entry__.dryrun_multichip``, less its sequence- and
tensor-parallel blocks).

``dryrun_multichip(n, device)`` runs, at ``n`` ranks and at one rank
(``parallel.mesh.spawn_ranks``), from one seed and one global batch of 2n
windows per modality: a data-parallel train step on the per-modality
``{"vis", "lang"}`` batch, a second step of the same trainer on the
loader-fused ``{"fused": 4n}`` batch, and a ZeRO-3 (``fsdp``) step on the
first batch from fresh weights. Each rank trains on its rows
(``parallel.mesh.shard_rows``). Each ``total_loss``, averaged over the
ranks, must equal the one-rank loss by the JAX package's rule: relative
1e-4 at ``hulc_debug``, 1e-3 at full size.

    python -m hulc_tpu_torch.parallel.dryrun --ranks 2 --device cpu
"""

from __future__ import annotations

import argparse
import math
from typing import Dict

import torch

from hulc_tpu_torch.config import get_config
from hulc_tpu_torch.models.hulc import ModalityBatch
from hulc_tpu_torch.parallel import mesh

KL_BETA = 0.01
SEQ = 8  # frames per window, as the JAX dry run's


def split_fused(batch: Dict[str, ModalityBatch]) -> Dict[str, ModalityBatch]:
    """``{"fused": 2B}`` as the per-modality ``{"vis": B, "lang": B}`` batch
    it was stacked from (``fuse_batch``'s inverse)."""
    fused = batch["fused"]
    b = fused.actions.shape[0] // 2

    def half(lang):
        return ModalityBatch(*(
            None if x is None else x if name in ModalityBatch.LANG_ONLY_FIELDS else (x[b:] if lang else x[:b])
            for name, x in zip(ModalityBatch._fields, fused)
        ))

    vis = half(False)._replace(lang=None, use_for_aux_lang_loss=None, idx=None)
    return {"vis": vis, "lang": half(True)}


def _losses(config: str, windows: int, device: str) -> Dict[str, float]:
    """One rank's part: the three steps' ``total_loss``, averaged over the
    ranks."""
    from hulc_tpu_torch.training.profile_train import synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    if device == "cpu":
        torch.set_num_threads(1)
    cfg = get_config(config)
    fused = synthetic_fused_batch(cfg, windows, SEQ, seed=11, device="cpu")
    per_mod = split_fused(fused)
    out = {}
    trainer = Trainer(cfg, TrainerConfig(seed=0), device=device)
    trainer.init_state(1)
    for name, batch in (("dp", per_mod), ("fused", fused)):
        out[name] = trainer.train_step(mesh.shard_rows(batch), KL_BETA)["total_loss"]
    sharded = Trainer(cfg, TrainerConfig(seed=0, fsdp=True), device=device)
    sharded.init_state(1)
    out["fsdp"] = sharded.train_step(mesh.shard_rows(per_mod), KL_BETA)["total_loss"]
    return {k: float(mesh.mean_across_ranks(v)) for k, v in out.items()}


def dryrun_multichip(n_devices: int, device: str = "cuda", config: str = "hulc_debug") -> Dict[str, Dict[str, float]]:
    """The three steps at ``n_devices`` ranks against one rank; raises unless
    every loss is finite and equal by the JAX rule. Returns both sets."""
    windows = 2 * n_devices
    args = (config, windows, device)
    if device == "cpu":  # both groups at once
        ranks = [mesh.Ranks(_losses, n, device, args) for n in (1, n_devices)]
        one, many = ranks[0].results()[0], ranks[1].results()
    else:  # each group on cards 0..n-1
        one = mesh.spawn_ranks(_losses, 1, device, args)[0]
        many = mesh.spawn_ranks(_losses, n_devices, device, args)
    rel = 1e-4 if config.endswith("_debug") else 1e-3
    for name, want in one.items():
        for r, got in enumerate(many):
            if not math.isfinite(got[name]) or abs(got[name] - want) / max(1.0, abs(want)) >= rel:
                raise AssertionError(f"dryrun_multichip({n_devices}): rank {r}'s {name} total_loss {got[name]} "
                                     f"is not the one-rank {want} (relative {rel})")
        print(f"dryrun_multichip({n_devices}): {name} total_loss={many[0][name]:.6f} one-rank {want:.6f} ok")
    return {"one": one, "many": many[0]}


def main(argv=None):
    p = argparse.ArgumentParser(description="equal-loss check of N ranks against one")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default="hulc_debug")
    args = p.parse_args(argv)
    dryrun_multichip(args.ranks, args.device, args.config)


if __name__ == "__main__":
    main()
