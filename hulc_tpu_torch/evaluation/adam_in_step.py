"""Why the Adam kernel (B.5) reads longer in the train step than alone:
the gradients a real step leaves, and the L2 cache.

    python hulc_tpu_torch/evaluation/adam_in_step.py [--tree DIR] [--config hulc] [--device cuda] [--steps 2]

Imports ``hulc_tpu_torch`` from ``DIR`` (default: the tree this file is
in; run it as a file, not with ``-m``), builds a ``Trainer`` (random
weights from seed 0) and takes ``--steps`` steps on the synthetic
loader-fused batch of ``training.profile_train`` (by default 32 + 32
windows of 32 frames, the train step's load). On the gradients the last
step left it reports the share that is exactly zero, the share whose
square is subnormal in fp32, and for each parameter tensor with zeros its
size, its zeros and how many of them lie in a zero line: a row or a
column of the tensor as a matrix (its first dimension against the rest;
each entry of a 1-d tensor is a line) whose gradient is zero whole, the
mark of a unit that no window of the batch activates. On a CUDA device it
also times the tree's Adam kernel (device ms per launch, torch.profiler,
over ITERS launches): on that state, on random gradients of the same
shapes from seed 0, and on those with a 256 MB write before each launch
that flushes the 50 MB L2 cache. Prints one JSON line, with the card's
name and power limit on CUDA.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ITERS, SEED = 50, 0


def zero_lines(g: torch.Tensor) -> int:
    """The zeros of ``g`` that lie in a zero row or a zero column of ``g``
    as a (first dimension, rest) matrix; for a 1-d ``g``, all its zeros."""
    if g.dim() < 2:
        return int((g == 0).sum())
    z = g.reshape(g.shape[0], -1) == 0
    return int((z & (z.all(1, keepdim=True) | z.all(0, keepdim=True))).sum())


def gradient_zeros(named_grads) -> dict:
    """The zero and subnormal-square shares of all the gradients, and each
    tensor with zeros as [numel, zeros, zeros in zero lines]."""
    total = zeros = in_lines = subnormal = 0
    tensors = {}
    for name, g in named_grads:
        n, z = g.numel(), int((g == 0).sum())
        total += n
        subnormal += int(((g != 0) & (g.double() ** 2 < torch.finfo(torch.float32).tiny)).sum())
        if z:
            lines = zero_lines(g)
            tensors[name] = [n, z, lines]
            zeros, in_lines = zeros + z, in_lines + lines
    return {
        "n_params": total, "zero_share": zeros / total, "zeros_in_zero_lines_share": in_lines / max(zeros, 1),
        "square_subnormal_share": subnormal / total, "tensors_with_zeros": len(tensors), "tensors": tensors,
    }


def adam_kernel_ms(step, before=None) -> float:
    """Device ms per launch of the Adam kernel over ITERS calls of ``step``
    (each after ``before``), after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def call():
        if before is not None:
            before()
        step()

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        for _ in range(ITERS):
            call()
        torch.cuda.synchronize()
        time.sleep(0.01)
    return next(e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "adam_lowp_kernel" in e.key)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", type=pathlib.Path, default=pathlib.Path(__file__).resolve().parents[2])
    p.add_argument("--config", default="hulc")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--batch", type=int, default=32, help="windows per modality")
    p.add_argument("--seq", type=int, default=32, help="frames per window")
    args = p.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.training.optimizers import AdamLowp
    from hulc_tpu_torch.training.profile_train import synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg = get_config(args.config)
    trainer = Trainer(cfg, TrainerConfig(seed=SEED), device=args.device)
    trainer.init_state(1)
    batch = synthetic_fused_batch(cfg, args.batch, args.seq, SEED, args.device)
    for _ in range(args.steps):
        trainer.train_step(batch, cfg.loss.kl_beta)
    named = [(n, p.grad) for n, p in trainer.model.named_parameters() if p.grad is not None]
    out = {"tree": str(args.tree), "config": args.config, "steps": args.steps, "gradients": gradient_zeros(named)}
    if args.device == "cuda":
        out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        out["adam_kernel_ms_on_step_state"] = adam_kernel_ms(trainer.optimizer.step)
        shapes = [g.shape for _, g in named]
        del trainer, named
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = [torch.nn.Parameter(0.05 * torch.randn(s, generator=gen, device="cuda")) for s in shapes]
        for q in params:
            q.grad = 1e-3 * torch.randn(q.shape, generator=gen, device="cuda")
        opt = AdamLowp(params, lr=2e-4)
        flush = torch.empty(64 * 2**20, device="cuda")  # 256 MB, five times the L2 cache
        out["adam_kernel_ms_random"] = adam_kernel_ms(opt.step)
        out["adam_kernel_ms_random_l2_flushed"] = adam_kernel_ms(opt.step, lambda: flush.fill_(1.0))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
