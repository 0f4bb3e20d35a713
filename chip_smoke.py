"""Drive the PyTorch/CUDA port of hulc on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--steps 35] [--lanes 64]

Run from the repository root. Phases, each of which exits non-zero when
it fails:

1. device: requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit`` gives them. TF32 is turned
   off for cuDNN convolutions and cuBLAS matmuls: the policy computes in
   fp32, and TF32 convolutions would break parity with the plain path.
2. build: compiles ``hulc_tpu_torch/csrc/*.cu`` for sm_90a (kernels.build).
3. kernels: each hand-written kernel against its plain PyTorch version at
   the policy's shapes, one lane and ``--lanes`` lanes.
4. main path, single lane: the full-width ``hulc`` HulcPolicy (random
   weights from ``--seed``, synthetic uint8 frames, 15-d robot_obs, 384-d
   language embedding) for ``--steps`` steps, across the replan at
   replan_freq=30.
5. main path, batched: BatchedHulcPolicy with ``--lanes`` lanes and
   staggered per-lane replans.
   Launch counts are zeroed just before phase 4 and read just after
   phase 5; every kernel must have launched.
6. plain path: the same steps through a model built with
   use_kernels=False on the card, fed each step the state the kernel path
   had and the same noise (same generator seed); the actions must agree.
7. timing: policy step times through the entry points, and each kernel
   against its plain version: device time (the CUDA activity
   torch.profiler records) and time per call (CUDA events around
   back-to-back calls, so the host's launch cost is included).

Prints a ``{"kernels": [...]}`` JSON line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): device memory rate and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

ACTION_ATOL = 1e-4  # kernel path vs plain path, per action entry
PLAN_TIE_BUDGET = 1e-3  # share of replanned plan categories allowed to differ


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time per call of ``iters``
    back-to-back calls, from CUDA events, after a warm-up: the rate at
    which the host issues the calls when it is slower than the device."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int) -> float:
    """Device time per call: the CUDA activity torch.profiler records over
    ``iters`` calls (every kernel the call launches), after a warm-up."""
    from hulc_tpu_torch.evaluation.profile_policy import profile_calls

    _, ms, _ = profile_calls(fn, iters)
    if not ms > 0:
        fail("the profiler recorded no device time")
    return ms


def host_ms(fn, iters: int) -> float:
    """Median host-clock time of ``fn`` (which ends in a device sync)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


# --------------------------------------------------------------------------
# synthetic observations
# --------------------------------------------------------------------------


def make_obs(rng, cfg, n):
    pe = cfg.perceptual_encoder
    s, g = pe.rgb_static.input_size, pe.rgb_gripper.input_size
    out = []
    for _ in range(n):
        robot_obs = rng.normal(size=15).astype(np.float32)
        robot_obs[3:6] = rng.uniform(-1.0, 1.0, 3)
        out.append({
            "rgb_obs": {
                "rgb_static": rng.integers(0, 256, (s, s, 3), np.uint8),
                "rgb_gripper": rng.integers(0, 256, (g, g, 3), np.uint8),
            },
            "robot_obs": robot_obs,
        })
    return out


def replan_mask(t: int, lanes: int, freq: int) -> np.ndarray:
    """Every lane plans at t=0, then each lane every ``freq`` steps with a
    per-lane phase, so replans are staggered across steps."""
    return np.array([t == 0 or (t + lane) % freq == 0 for lane in range(lanes)])


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def check_kernels(model, cfg, lane_counts, rng):
    from hulc_tpu_torch.models.vision import spatial_softmax, spatial_softmax_plain
    from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq, preprocess_rgb_seq_plain
    from hulc_tpu_torch.ops.logistic_mixture import (
        draw_uniforms,
        logistic_mixture_sample,
        logistic_mixture_sample_plain,
    )

    dev = model.device
    pe, ad = cfg.perceptual_encoder, cfg.action_decoder
    errs = {"preprocess_rgb": 0.0, "spatial_softmax": 0.0, "logistic_mixture_sample": 0.0}
    gen = torch.Generator(device=dev).manual_seed(1)
    for e in lane_counts:
        for size in (pe.rgb_static.input_size, pe.rgb_gripper.input_size):
            imgs = torch.as_tensor(rng.integers(0, 256, (e, 1, size, size, 3), np.uint8), device=dev)
            got, want = preprocess_rgb_seq(imgs), preprocess_rgb_seq_plain(imgs)
            err = max_abs(got, want)
            if got.shape != want.shape or not err <= 2.4e-7:  # 2 ulp near 1.0
                fail(f"preprocess kernel at {tuple(imgs.shape)}: max abs err {err}")
            errs["preprocess_rgb"] = max(errs["preprocess_rgb"], err)

        s = pe.rgb_static.input_size
        frames = preprocess_rgb_seq_plain(
            torch.as_tensor(rng.integers(0, 256, (e, 1, s, s, 3), np.uint8), device=dev)
        )[:, 0]
        with torch.no_grad():
            conv_map = model.perceptual_encoder.rgb_static_encoder.conv_model(frames).contiguous()
        for temp in (1.0, torch.tensor([0.7], device=dev)):
            got, want = spatial_softmax(conv_map, temp), spatial_softmax_plain(conv_map, temp)
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):  # reduction order
                fail(f"spatial_softmax kernel at {tuple(conv_map.shape)}: max abs err {max_abs(got, want)}")
            errs["spatial_softmax"] = max(errs["spatial_softmax"], max_abs(got, want))

        shape = (e, 1, ad.out_features - 1, ad.n_mixtures)
        logits, means = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
        log_scales = torch.clamp_min(torch.randn(shape, generator=gen, device=dev) - 2.0, ad.log_scale_min)
        u_mix, u_inv = draw_uniforms(shape, gen, dev)
        got = logistic_mixture_sample(logits, log_scales, means, u_mix=u_mix, u_inv=u_inv)
        want = logistic_mixture_sample_plain(logits, log_scales, means, u_mix, u_inv)
        if not torch.allclose(got, want, rtol=0, atol=1e-5):
            fail(f"mixture sample kernel at {shape}: max abs err {max_abs(got, want)}")
        errs["logistic_mixture_sample"] = max(errs["logistic_mixture_sample"], max_abs(got, want))
        # with u_inv = 0.5 the inverse CDF term is exactly 0, so each sample
        # IS the picked component's mean: equal samples = identical picks
        half = torch.full_like(u_inv, 0.5)
        got = logistic_mixture_sample(logits, log_scales, means, u_mix=u_mix, u_inv=half)
        want = logistic_mixture_sample_plain(logits, log_scales, means, u_mix, half)
        if not torch.equal(got, want):
            fail(f"mixture sample kernel picked other components than the plain version at {shape}")
    return errs


# --------------------------------------------------------------------------
# phases 4-6: the policy, kernel path and plain path
# --------------------------------------------------------------------------


def drive_single(cfg, model, obs, lang, seed):
    """HulcPolicy.reset/step over ``obs``; returns (actions, pre-step states)."""
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    policy = HulcPolicy(cfg, model, seed=seed)
    policy.reset()
    actions, states = [], []
    for o in obs:
        states.append(policy._state)
        actions.append(policy.step(o, lang))
    states.append(policy._state)
    return np.stack(actions), states


def drive_batched(cfg, model, obs_steps, langs, seed):
    """BatchedHulcPolicy.step over ``obs_steps``; returns (actions, states)."""
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy

    lanes = len(langs)
    policy = BatchedHulcPolicy(cfg, model, lanes, seed=seed)
    state = policy.initial_state()
    actions, states = [], [state]
    for t, obs in enumerate(obs_steps):
        act, state = policy.step(obs, langs, state, replan_mask(t, lanes, cfg.replan_freq))
        actions.append(act)
        states.append(state)
    return np.stack(actions), states


def check_actions(name, actions, lanes):
    if actions.shape[-1] != 7 or not np.isfinite(actions).all():
        fail(f"{name}: actions not finite of shape (..., 7): {actions.shape}")
    if not set(np.unique(actions[..., 6])) <= {-1.0, 1.0}:
        fail(f"{name}: gripper actions outside {{-1, 1}}")
    print(f"[{name}] {actions.shape[0]} steps x {lanes} lanes: actions finite, shape (7,), gripper in {{-1, 1}}")


def compare_plain(name, kern_actions, plain_actions, kern_plans, plain_plans, replanned, cfg):
    """Actions must agree within ACTION_ATOL. A plan category whose argmax
    differs is a tie within float noise of the static-camera encoder; the
    (step, lane) pairs it touches are counted and left out, and at most
    PLAN_TIE_BUDGET of the replanned categories may differ."""
    d = cfg.distribution
    grid = (d.category_size, d.class_size)
    k_idx = kern_plans.reshape(kern_plans.shape[:-1] + grid).argmax(-1)
    p_idx = plain_plans.reshape(plain_plans.shape[:-1] + grid).argmax(-1)
    differing = (k_idx != p_idx) & replanned[..., None]
    tie = differing.any(-1)
    n_replanned = int(replanned.sum()) * d.category_size
    if differing.sum() > max(1, PLAN_TIE_BUDGET * n_replanned):
        fail(f"{name}: {int(differing.sum())} of {n_replanned} replanned plan categories differ")
    err = np.abs(kern_actions - plain_actions)[~tie]
    if not err.max() <= ACTION_ATOL:
        fail(f"{name}: kernel and plain actions differ by {err.max()}")
    print(f"[{name}] plain path on the card agrees: max abs action err {err.max():.3g} "
          f"(atol {ACTION_ATOL}); plan ties {int(differing.sum())} of {n_replanned} categories")
    return float(err.max())


def plain_single(cfg, plain_model, obs, lang, seed, kern_states):
    """The single-lane steps through the plain model, each step from the
    kernel path's state; returns (actions, post-step plans)."""
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    policy = HulcPolicy(cfg, plain_model, seed=seed)
    actions, plans = [], []
    for t, o in enumerate(obs):
        policy._state = kern_states[t]
        actions.append(policy.step(o, lang))
        plans.append(policy._state.plan[0].cpu().numpy())
    return np.stack(actions), np.stack(plans)


def plain_batched(cfg, plain_model, obs_steps, langs, seed, kern_states):
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy

    lanes = len(langs)
    policy = BatchedHulcPolicy(cfg, plain_model, lanes, seed=seed)
    actions, plans = [], []
    for t, obs in enumerate(obs_steps):
        act, state = policy.step(obs, langs, kern_states[t], replan_mask(t, lanes, cfg.replan_freq))
        actions.append(act)
        plans.append(state[0].cpu().numpy())
    return np.stack(actions), np.stack(plans)


# --------------------------------------------------------------------------
# phase 7: timing
# --------------------------------------------------------------------------


def time_kernels(model, cfg, lanes, rng):
    """Per-launch ms of each kernel and of its plain version on the same
    inputs, at ``lanes`` lanes; and the least time the card could take."""
    from hulc_tpu_torch.models.vision import spatial_softmax, spatial_softmax_plain
    from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq, preprocess_rgb_seq_plain
    from hulc_tpu_torch.ops.logistic_mixture import (
        draw_uniforms,
        logistic_mixture_sample,
        logistic_mixture_sample_plain,
    )

    dev = model.device
    pe, ad = cfg.perceptual_encoder, cfg.action_decoder
    s = pe.rgb_static.input_size
    imgs = torch.as_tensor(rng.integers(0, 256, (lanes, 1, s, s, 3), np.uint8), device=dev)
    with torch.no_grad():
        conv_map = model.perceptual_encoder.rgb_static_encoder.conv_model(
            preprocess_rgb_seq_plain(imgs)[:, 0]
        ).contiguous()
    shape = (lanes, 1, ad.out_features - 1, ad.n_mixtures)
    gen = torch.Generator(device=dev).manual_seed(2)
    lp, ls, mu = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
    u_mix, u_inv = draw_uniforms(shape, gen, dev)

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    n_px = imgs.numel()
    n_logits = conv_map.numel()
    rows = lp.numel() // ad.n_mixtures
    cases = {
        # u8 read once, fp32 written once; mul, sub, div per element
        "preprocess_rgb": (
            lambda: preprocess_rgb_seq(imgs), lambda: preprocess_rgb_seq_plain(imgs),
            bound(n_px * (1 + 4), 3 * n_px), tuple(imgs.shape),
        ),
        # fp32 map read once, (N, 2C) written once; ~9 flops per logit
        "spatial_softmax": (
            lambda: spatial_softmax(conv_map, 1.0), lambda: spatial_softmax_plain(conv_map, 1.0),
            bound(4 * n_logits + 4 * 2 * conv_map.shape[0] * conv_map.shape[1], 9 * n_logits),
            tuple(conv_map.shape),
        ),
        # four (…, A, K) fp32 inputs, u_inv and the output; ~4 flops per
        # component plus ~6 per sample
        "logistic_mixture_sample": (
            lambda: logistic_mixture_sample(lp, ls, mu, u_mix=u_mix, u_inv=u_inv),
            lambda: logistic_mixture_sample_plain(lp, ls, mu, u_mix, u_inv),
            bound(4 * 4 * lp.numel() + 4 * 2 * rows, 4 * lp.numel() + 6 * rows), tuple(shape),
        ),
    }
    out = {}
    for name, (kernel_fn, plain_fn, (bound_ms, bound_by), shp) in cases.items():
        # plain, kernel, kernel, plain: the same card, in turns
        ms = [device_ms(plain_fn, 100), device_ms(kernel_fn, 100),
              device_ms(kernel_fn, 100), device_ms(plain_fn, 100)]
        out[name] = {
            "ms": min(ms[1], ms[2]), "plain_ms": min(ms[0], ms[3]),
            "bound_ms": bound_ms, "bound_by": bound_by, "shape": list(shp),
            "call_ms": call_ms(kernel_fn, 100), "plain_call_ms": call_ms(plain_fn, 100),
        }
    return out


def time_policy(cfg, model, rng, lanes):
    """Median ms per step through the entry points (host clock; includes
    the frames' host-to-device copy and the action's copy back)."""
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    lang = rng.normal(size=384).astype(np.float32)
    single_obs = make_obs(rng, cfg, 1)[0]
    policy = HulcPolicy(cfg, model, seed=0)
    policy.reset()
    policy.step(single_obs, lang)  # plan once; the timed steps act
    policy.replan_freq = 10**9
    single_ms = host_ms(lambda: policy.step(single_obs, lang), 50)

    batched = BatchedHulcPolicy(cfg, model, lanes, seed=0)
    obs = make_obs(rng, cfg, lanes)
    langs = rng.normal(size=(lanes, 384)).astype(np.float32)
    state = [batched.initial_state()]
    mask = np.zeros(lanes, bool)

    def step():
        _, state[0] = batched.step(obs, langs, state[0], mask)

    return single_ms, host_ms(step, 30)


# --------------------------------------------------------------------------


KERNEL_INFO = {
    "preprocess_rgb": ("hulc_preprocess_rgb", "hulc_tpu_torch/csrc/preprocess.cu", "hulc_tpu/ops/image_ops.py:85"),
    "spatial_softmax": ("hulc_spatial_softmax", "hulc_tpu_torch/csrc/spatial_softmax.cu", "hulc_tpu/models/vision.py:38"),
    "logistic_mixture_sample": (
        "hulc_logistic_mixture_sample", "hulc_tpu_torch/csrc/logistic_mixture.cu",
        "hulc_tpu/ops/logistic_mixture.py:114",
    ),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=35)
    p.add_argument("--lanes", type=int, default=64)
    args = p.parse_args(argv)

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs the port on an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[device] TF32 off for cuDNN convolutions and cuBLAS matmuls (fp32 parity)")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    card = card_line()
    print(card)

    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.models import make_model

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    cfg = get_config("hulc")
    model = make_model(cfg, "cuda", seed=args.seed)
    plain_model = make_model(cfg, "cuda", seed=args.seed, use_kernels=False)
    plain_model.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] hulc preset, {n_params} parameters, random init from seed {args.seed}")
    rng = np.random.default_rng(args.seed)

    # ---- 3. kernels against plain versions ---------------------------------
    errs = check_kernels(model, cfg, (1, args.lanes), rng)
    print(f"[kernels] agree with their plain versions at 1 and {args.lanes} lanes: "
          + ", ".join(f"{k} max abs err {v:.3g}" for k, v in errs.items()))

    # ---- 4-5. main path ------------------------------------------------------
    lang = rng.normal(size=384).astype(np.float32)
    single_obs = make_obs(rng, cfg, args.steps)
    langs = rng.normal(size=(args.lanes, 384)).astype(np.float32)
    batched_obs = [make_obs(rng, cfg, args.lanes) for _ in range(args.steps)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    single_actions, single_states = drive_single(cfg, model, single_obs, lang, args.seed)
    batched_actions, batched_states = drive_batched(cfg, model, batched_obs, langs, args.seed)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels.ALL_KERNELS}
    print(f"[main path] launches: {launches}")
    if not all(n > 0 for n in launches.values()):
        fail(f"a kernel of the main path was never launched: {launches}")
    check_actions("single lane", single_actions, 1)
    check_actions("batched", batched_actions, args.lanes)

    # ---- 6. plain path -------------------------------------------------------
    p_actions, p_plans = plain_single(cfg, plain_model, single_obs, lang, args.seed, single_states)
    k_plans = np.stack([s.plan[0].cpu().numpy() for s in single_states[1:]])
    replanned = np.array([t % cfg.replan_freq == 0 for t in range(args.steps)])
    compare_plain("single lane", single_actions, p_actions, k_plans, p_plans, replanned, cfg)
    p_actions, p_plans = plain_batched(cfg, plain_model, batched_obs, langs, args.seed, batched_states)
    k_plans = np.stack([s[0].cpu().numpy() for s in batched_states[1:]])
    replanned = np.stack([replan_mask(t, args.lanes, cfg.replan_freq) for t in range(args.steps)])
    compare_plain("batched", batched_actions, p_actions, k_plans, p_plans, replanned, cfg)

    # ---- 7. timing -------------------------------------------------------------
    single_ms, batched_ms = time_policy(cfg, model, rng, args.lanes)
    print(f"[timing] policy step (entry point, host clock, median): 1 lane {single_ms:.4f} ms, "
          f"{args.lanes} lanes {batched_ms:.4f} ms ({card})")
    timing = time_kernels(model, cfg, args.lanes, rng)
    for name, t in timing.items():
        print(f"[timing] {name} at {t['shape']}: device time kernel {t['ms']:.5f} ms, plain "
              f"{t['plain_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}); per call "
              f"with the host's launch cost kernel {t['call_ms']:.5f} ms, plain {t['plain_call_ms']:.5f} ms")

    rows = []
    for name, (symbol, source, replaces) in KERNEL_INFO.items():
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[symbol], "max_abs_err": errs[name], **timing[name],
            "library_ms": None,
        })
    print(json.dumps({"policy_step_ms": {"1": single_ms, str(args.lanes): batched_ms}, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
