"""Where the closed-loop policy step spends its time on the GPU.

    python -m hulc_tpu_torch.evaluation.profile_policy [--lanes 64] [--steps 20] [--out DIR]

Runs the full-width ``hulc`` policy (random weights) through its entry
points, ``HulcPolicy.step`` at one lane and ``BatchedHulcPolicy.step`` at
``--lanes`` lanes, under ``torch.profiler`` for ``--steps`` steady steps
each, and prints one JSON line per lane count: host-clock ms per step,
device ms per step (the sum of the CUDA activity the profiler recorded),
the device's idle share of the window, the device operations per step
(kernels, and copies and fills apart), the device time by kind (hand
kernels, matmuls, convolutions, copies, other) and of each hand kernel,
and the ten CUDA operations that take the most device time. With
``--out`` it also writes each window's Chrome trace there. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from hulc_tpu_torch.config import get_config
from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
from hulc_tpu_torch.evaluation.policy import HulcPolicy
from hulc_tpu_torch.models import make_model


def _obs(rng, cfg):
    pe = cfg.perceptual_encoder
    s, g = pe.rgb_static.input_size, pe.rgb_gripper.input_size
    return {
        "rgb_obs": {
            "rgb_static": rng.integers(0, 256, (s, s, 3), np.uint8),
            "rgb_gripper": rng.integers(0, 256, (g, g, 3), np.uint8),
        },
        "robot_obs": rng.normal(size=15).astype(np.float32),
    }


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0.0)))


# idle host time at each end of a profiled window. At 10 ms, some runs of chip_smoke.py lost one
# of the empty kernel's 100 launches in every window of its launch floor, and other runs none;
# why is not known (chip_smoke.py's lost_launches prints where a window lost them)
WINDOW_PAD_S = 0.05


def profile_calls(fn, iters: int, trace_path=None):
    """Run ``fn`` ``iters`` times under torch.profiler after a warm-up.
    Returns (host-clock ms per call, device ms per call, the CUDA
    operations with device time, by name). The window is padded with
    ``WINDOW_PAD_S`` of idle host time at each end: the profiler drops
    device activity whose timestamps fall outside it, and the device's
    clock, as the profiler maps it, can run tens of microseconds or more
    ahead of the host's, enough to lose every launch of a short window."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_PAD_S)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(WINDOW_PAD_S)
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    device = device_events(prof)
    return wall_ms / iters, device_ms(device) / iters, device


def device_events(prof):
    """The CUDA operations with device time that ``prof`` recorded, by name.
    A record_function span also shows on the device timeline, over the
    kernels it launched: each kernel is counted once."""
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_us(e) > 0
            and not getattr(e, "is_user_annotation", False)]


def device_ms(events) -> float:
    """Device ms of ``device_events``."""
    return sum(_device_us(e) for e in events) / 1e3


HAND_KERNELS = (
    "preprocess_rgb_kernel", "preprocess_rgb_shift_kernel", "spatial_softmax_kernel",
    "spatial_softmax_bwd_kernel", "spatial_softmax_temperature_grad_kernel", "logistic_mixture_sample_kernel",
    "mixture_nll_fwd_kernel", "mixture_nll_bwd_kernel", "plan_st_kl_fwd_kernel", "plan_st_kl_bwd_kernel",
    "adam_lowp_kernel", "grad_norm_finish_kernel",
    "rnn_fwd_kernel", "rnn_bwd_kernel", "rnn_step_kernel",  # csrc/rnn.cu, either cell
    "gated_fwd_kernel", "gated_bwd_kernel", "gated_step_kernel",  # csrc/rnn_gates.cu, gru and lstm
    "gated_transpose_kernel",  # csrc/rnn_gates.cu: W^T for the dh chain
    "depth_noise_kernel", "depth_noise_draw_kernel", "resize_preprocess_kernel",
)


def kind_of(name: str) -> str:
    """Coarse class of a CUDA operation, from its name."""
    if any(k in name for k in HAND_KERNELS):
        return "hand kernels"
    if name.startswith(("Memcpy", "Memset")):
        return "copies and fills"
    if any(k in name for k in ("fprop", "convolve", "dgrad", "wgrad")):
        return "convolutions"
    if any(k in name for k in ("gemm", "gemv", "dot_kernel", "nvjet")):  # nvjet: cuBLAS's tensor-core GEMMs
        return "matmuls"
    return "other"


def profile_steps(step, steps: int, trace_path=None) -> dict:
    step_ms, device_ms, device = profile_calls(step, steps, trace_path)
    top = sorted(device, key=_device_us, reverse=True)[:10]
    by_kind = {}
    for e in device:
        by_kind[kind_of(e.key)] = by_kind.get(kind_of(e.key), 0.0) + _device_us(e) / 1e3 / steps
    hand = {}  # by kernel, each template instance's time added in (rnn.cu's relu and tanh cells)
    for e in device:
        for k in HAND_KERNELS:
            if k in e.key:
                hand[k] = hand.get(k, 0.0) + _device_us(e) / 1e3 / steps
    copies = sum(e.count for e in device if kind_of(e.key) == "copies and fills") / steps
    return {
        "step_ms": step_ms,
        "device_ms_per_step": device_ms,
        "idle_share": 1.0 - device_ms / step_ms if device_ms else None,
        "device_ops_per_step": {"kernels": sum(e.count for e in device) / steps - copies, "copies_and_fills": copies},
        "device_ms_per_step_by_kind": by_kind,
        "hand_kernel_ms_per_step": hand,
        "top": [
            {"name": e.key[:80], "calls_per_step": e.count / steps, "ms_per_step": _device_us(e) / 1e3 / steps}
            for e in top
        ],
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lanes", type=int, default=64)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=pathlib.Path, default=None)
    args = p.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hulc")
    model = make_model(cfg, "cuda", seed=args.seed)
    rng = np.random.default_rng(args.seed)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)

    def trace(name):
        return None if args.out is None else args.out / f"{name}.json"

    single = HulcPolicy(cfg, model, seed=args.seed)
    obs, lang = _obs(rng, cfg), rng.normal(size=384).astype(np.float32)
    single.step(obs, lang)  # plan once; the profiled steps act
    single.replan_freq = 10**9
    result = profile_steps(lambda: single.step(obs, lang), args.steps, trace("policy_step_1_lane"))
    print(json.dumps({"lanes": 1, "step": "HulcPolicy.step (act)", **result}))

    batched = BatchedHulcPolicy(cfg, model, args.lanes, seed=args.seed)
    obs_batch = [_obs(rng, cfg) for _ in range(args.lanes)]
    langs = rng.normal(size=(args.lanes, 384)).astype(np.float32)
    state = [batched.initial_state()]
    mask = np.zeros(args.lanes, bool)

    def step():
        _, state[0] = batched.step(obs_batch, langs, state[0], mask)

    result = profile_steps(step, args.steps, trace(f"policy_step_{args.lanes}_lanes"))
    print(json.dumps({"lanes": args.lanes, "step": "BatchedHulcPolicy.step", **result}))


if __name__ == "__main__":
    main()
