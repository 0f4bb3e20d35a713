"""Import a reference PyTorch checkpoint into an evaluable run directory
(port of hulc_tpu/training/import_checkpoint.py).

Reads a published HULC ``.ckpt`` (or a raw state_dict ``.pt``), grafts its
state_dict onto a fresh model of the config (subtrees the checkpoint lacks
keep their init; ``training.pretrain``), and writes a params-only
checkpoint at ``<run_dir>/saved_models/epoch_<N>`` (N from the file name,
as ``epoch=30.ckpt``, unless given). The evaluate CLI and
``checkpoint.restore_params`` load it; ``Trainer.restore`` refuses it, as it
holds no optimizer state to resume from::

    python -m hulc_tpu_torch.training.import_checkpoint \\
        --ckpt HULC_D_D/epoch=30.ckpt --config hulc --run-dir runs/imported
    python -m hulc_tpu_torch.evaluation.evaluate --run-dir runs/imported ...

The port's modules carry the reference's state_dict keys, so no converter
runs; the checkpoint's keys the port lacks are returned (and printed).
"""

from __future__ import annotations

import argparse
import re


def import_checkpoint(ckpt_path, cfg, run_dir, epoch=None, exclude_plan_recognition=False, device="cuda"):
    """Write the imported checkpoint; returns (its path, the sorted keys of
    the ``.ckpt`` the port's state_dict lacks). The fresh init is built on
    ``device`` (CUDA unless the caller asks for the CPU); the checkpoint is
    written from the CPU."""
    from hulc_tpu_torch.models.hulc import make_model
    from hulc_tpu_torch.training import checkpoint as ckpt
    from hulc_tpu_torch.training.pretrain import initialize_pretrained_weights, read_torch_checkpoint

    template = {k: v.cpu() for k, v in make_model(cfg, device, seed=0).state_dict().items()}
    source, unused = read_torch_checkpoint(ckpt_path, template)
    params = initialize_pretrained_weights(template, source, exclude_plan_recognition)
    if epoch is None:
        m = re.search(r"epoch[=_-]?(\d+)", str(ckpt_path))
        epoch = int(m.group(1)) if m else 0
    path = ckpt.save_checkpoint(run_dir, epoch, {"params": params, "optimizer": None, "step": 0, "epoch": epoch})
    return path, unused


def main(argv=None):
    p = argparse.ArgumentParser(description="import a reference torch checkpoint")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--config", default="hulc")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--exclude-plan-recognition", action="store_true")
    p.add_argument("--device", default="cuda", help="where the fresh init is built (cuda | cpu)")
    args = p.parse_args(argv)

    from hulc_tpu_torch.config import get_config

    path, unused = import_checkpoint(args.ckpt, get_config(args.config), args.run_dir, args.epoch,
                                     args.exclude_plan_recognition, args.device)
    print(f"[import] wrote {path}")
    if unused:
        print(f"[import] {len(unused)} reference keys the port has no parameter for (buffers/aux): {unused[:5]}...")


if __name__ == "__main__":
    main()
