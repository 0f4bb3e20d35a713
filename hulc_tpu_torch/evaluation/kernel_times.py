"""Device times of the image, SpatialSoftmax, recurrence and optimizer
kernels, and the policy and train steps' host-clock times, of one tree of
this repository: for comparing two trees (a parent commit unpacked beside
the working tree) on one card.

    python hulc_tpu_torch/evaluation/kernel_times.py --tree DIR

Imports ``hulc_tpu_torch`` from ``DIR`` (run as a file, not with ``-m``, so
that the package comes from ``DIR``), builds that tree's kernels, and times,
through the wrappers a caller uses: the eval preprocess (B.1) on one and 64
frames of the static (200 px) and the gripper (84 px) camera; the
SpatialSoftmax forward (B.2) at one lane, 64 lanes and the training step's
(2048, 64, 21, 21); the training shift (B.1') on the step's two cameras and
the SpatialSoftmax backward (B.2') at the step's shape; the bf16 instances
(B.14) of the four, the eval preprocess at the validation window's (32,
32) frames of each camera. Device time is the
CUDA activity torch.profiler records per call (the window padded with idle
host time, as ``profile_policy.profile_calls`` does). The decoder RNN's
recurrence (B.6), forward and dh chain at (64, 32, 2048), (64, 1, 2048)
and (1, 1, 2048), is timed by CUDA events instead (``event_ms``: the
profiler drops some of its cooperative launches), and so are the gated
cells' (B.11 gru, B.12 lstm): the inference forward and the dh chain at
the same three shapes, on inputs made from seed 0 by the plain loop (the
saved gates), the same on any tree; and, on a tree that has them, the
bidirectional layers of the relu and gru cells (B.13: two chains into one
(64, 32, 4096) output, the gru's training forward, which saves its gates,
and each layer's two dh chains) at the train step's (64, 32, 2048). It also gives a
digest of each kernel's output on fixed inputs from seed 0 (equal digests:
bit-equal results) and the full-width ``hulc`` policy step's median
host-clock ms at 1 and 64 lanes.

The ``hulc_depth`` train step (case ``depth_step``) the same way.

The optimizer tail (B.5 and B.7), ``AdamLowp.step``, which returns the
gradient norm, runs on the full model's 47,053,559 parameters with random
gradients from seed 0. It is timed by CUDA events, by the profiler (with
its device launches per call, and the Adam kernel alone) and by the host
clock to a sync; beside it the eager norm the step no longer runs
(``optimizers.global_norm``, three launches per tensor) on the same
gradients, timed the same ways; digests of the parameters, the moments and
the norm after one step from the same state. The train step (the full-width ``Trainer``,
2B = 64, S = 32): device operations and host-to-device copies per step
under the profiler, device ms per step and the median host-clock step.

The two sampling tails, through the calls the step and the policy make:
the plan's straight-through sample and balanced KL from the generator
(``rsample_balanced_kl``: the noise draw, its Gumbel transform and B.4's
forward) at (64, 32, 32) and its backward alone (the sample's and the KL's
cotangents to the logits' gradients); the decoder's action sample from the
generator (``_sample_from_outputs``: the two draws, their map, B.3 and
the gripper column) at 64 lanes and at one. Each by CUDA events, with its
device operations per call, device ms under the profiler and its hand
kernel's device ms per recorded launch, and a digest of its result from a
fixed generator seed. Beside them the two forward kernels alone, each by
CUDA events and by the profiler: B.4's forward on injected Gumbel noise,
and B.3 on uniforms already mapped (through ``sample_action``, with the
gripper column; on a tree from before it, ``logistic_mixture_sample``).
The backward tail is its kernel alone. The policy steps' device
operations per step come with their host clock.

The training preprocess, by CUDA events through the calls the train step
makes, at the step's shapes (2B x S = 2048 frames): B.15 through
``training.preprocess.prep_camera`` on ``hulc_clip_vision``'s CLIP camera
(200 px frames to 224, training fp32 and bf16 out, validation fp32) and
``hulc_tactile``'s tactile tower (160 x 120 x 6 frames, and frames at 64
px), on fixed shifts, with digests; B.10 as the step calls it, depth frames
and a CUDA generator seeded 0 through ``preprocess_modality``'s depth
branch, one camera at a time (gamma: the static camera, gaussian: the
gripper's): on a tree from before the draw mode ``torch.randn`` and the z
mode's launch, on a later one the draw mode's one launch. B.10's digests
(of one call on a fresh generator) differ between those trees by design:
the draws are other numbers. Beside it, in any tree, ``torch.randn`` +
``torch.add(x, z, alpha=0.01)`` at the gripper's shape.

Prints one JSON line, with the card's name and power limit. Needs a CUDA
device. ``--only NAME[,NAME...]`` times only the cases whose names start
with one of them; the policy steps are the case ``policy``.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

PAD_S = 0.01
ITERS, LANES, SEED = 50, 64, 0
SAMPLING_KERNELS = ("plan_st_kl_fwd", "plan_st_kl_bwd", "logistic_mixture_sample")


def device_ms(fn, iters: int) -> float:
    """CUDA activity per call of ``fn`` over ``iters`` calls, after a warm-up."""
    return op_counts(device_ops(fn, iters), iters)["device_ms"]


def event_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Device ms per call of ``fn`` by CUDA events around ``iters``
    back-to-back calls, median of ``repeats``. Each window is queued behind
    a spin of the device (``torch.cuda._sleep``) that outlasts the host's
    queueing of the calls, so the host's launch cost does not enter: a
    window whose spin had ended before the host queued its last call is
    run again behind a spin twice as long, at most three times (a call
    that waits for the device is late behind any spin)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0  # an upper bound on queueing one call
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    end.synchronize()
    cycles_per_s = 1e6 / (start.elapsed_time(end) / 1e3)
    spin_s, retries, times = iters * host_s + 2e-3, 3, []
    while len(times) < repeats:
        torch.cuda._sleep(int(cycles_per_s * spin_s))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_late = start.query()  # the device reached the window before the host had queued it
        end.synchronize()
        if host_late and retries:
            spin_s, retries = 2 * spin_s, retries - 1
        else:
            times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ops(fn, iters: int) -> list:
    """torch.profiler's CUDA operations (kernels, copies, fills; no
    ``record_function`` ranges) over ``iters`` calls of ``fn`` after a
    warm-up, each window padded with idle host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and _device_us(e) > 0]


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total", 0.0))


def op_counts(ops, iters: int) -> dict:
    """Per call: device ms, kernels, host-to-device copies from pinned and
    from pageable memory."""
    def count(pred):
        return sum(e.count for e in ops if pred(e.key)) / iters

    return {
        "device_ms": sum(_device_us(e) for e in ops) / 1e3 / iters,
        "kernels": count(lambda k: not k.startswith(("Memcpy", "Memset"))),
        "h2d_pinned": count(lambda k: k.startswith("Memcpy HtoD (Pinned")),
        "h2d_pageable": count(lambda k: k.startswith("Memcpy HtoD (Pageable")),
    }


def optimizer_tail(cfg, out: dict) -> None:
    """The optimizer tail of the tree (see the module's note) into ``out``."""
    from hulc_tpu_torch.models import make_model
    from hulc_tpu_torch.training import optimizers

    shapes = [p.shape for p in make_model(cfg, "cuda", seed=SEED).parameters()]

    def fresh():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = [torch.nn.Parameter(0.05 * torch.randn(s, generator=gen, device="cuda")) for s in shapes]
        for p in params:
            p.grad = 1e-3 * torch.randn(p.shape, generator=gen, device="cuda")
        return params, optimizers.AdamLowp(params, lr=2e-4)

    params, opt = fresh()
    norm = opt.step()
    moments = [opt.state[p][k].flatten().view(torch.int16) for k in ("exp_avg", "exp_avg_sq") for p in params]
    out["digest"].update({
        "optimizer_tail params": digest(torch.cat([p.detach().flatten() for p in params])),
        "optimizer_tail moments": digest(torch.cat(moments)),
        "optimizer_tail grad_norm": digest(norm),
    })
    out["grad_norm"] = float(norm)
    del moments
    params, opt = fresh()

    def synced():
        opt.step()
        torch.cuda.synchronize()

    grads = [p.grad for p in params]

    def eager_norm():
        return optimizers.global_norm(grads)

    def eager_synced():
        eager_norm()
        torch.cuda.synchronize()

    out["event_ms"]["optimizer_tail"] = event_ms(opt.step)
    out["event_ms"]["eager_norm"] = event_ms(eager_norm)
    ops = device_ops(opt.step, ITERS)
    out["optimizer_tail"] = {
        "n_params": sum(p.numel() for p in params), **op_counts(ops, ITERS),
        "host_ms_to_sync": host_ms(synced, 30),
        "adam_kernel_ms": next(_device_us(e) / 1e3 / e.count for e in ops if "adam_lowp_kernel" in e.key),
    }
    out["eager_norm"] = {**op_counts(device_ops(eager_norm, ITERS), ITERS), "host_ms_to_sync": host_ms(eager_synced, 30)}


def train_step_counts(cfg, out: dict, key: str = "train_step") -> None:
    """Device operations, copies and device ms per train step under the
    profiler, and the median host-clock step, into ``out[key]``."""
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    trainer = Trainer(cfg, TrainerConfig(seed=SEED), device="cuda")
    trainer.init_state(1)
    batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, SEED, "cuda")

    def step():
        trainer.train_step(batch, cfg.loss.kl_beta)

    def synced():
        step()
        torch.cuda.synchronize()

    out[key] = {**op_counts(device_ops(step, 5), 5), "host_ms": host_ms(synced, 10)}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def digest(t: torch.Tensor) -> str:
    t = t.detach().contiguous().cpu()
    return hashlib.sha256((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()).hexdigest()[:16]


def host_ms(fn, iters: int) -> float:
    for _ in range(5):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_ms(ops) -> float:
    """Device ms per recorded launch of the sampling kernels among ``ops``
    (the profiler drops some short launches)."""
    mine = [e for e in ops if any(name in e.key for name in SAMPLING_KERNELS)]
    return sum(_device_us(e) for e in mine) / 1e3 / sum(e.count for e in mine)


def mixture_kernel(lp, ls, mu, u_mix, u_inv, grip, bounds):
    """B.3's launch alone on mapped uniforms: the fused sampler with the
    gripper column, or on a tree from before it the sample alone."""
    from hulc_tpu_torch.ops import logistic_mixture

    if hasattr(logistic_mixture, "sample_action"):
        return logistic_mixture.sample_action(lp, ls, mu, u_mix, u_inv, grip, bounds, (0.0, 1.0))
    return logistic_mixture.logistic_mixture_sample(lp, ls, mu, u_mix, u_inv)


def sampling_tails(cfg, out: dict) -> None:
    """The plan's and the action's sampling tails and their forward kernels
    alone (see the module's note) into ``out``."""
    from hulc_tpu_torch.models.decoders import DecoderOutputs, LogisticPolicyDecoder
    from hulc_tpu_torch.ops.plan_distributions import DiscretePlanState, PlanDistribution, gumbel_noise

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    d, ad = cfg.distribution, cfg.action_decoder
    dist = PlanDistribution(category_size=d.category_size, class_size=d.class_size)
    post, prior = (2.0 * torch.randn((64, d.plan_dim), generator=gen, device="cuda") for _ in range(2))
    leaves = [post.clone().requires_grad_(), prior.clone().requires_grad_()]
    st, kl = dist.rsample_balanced_kl(*map(DiscretePlanState, leaves), cfg.loss.kl_balancing_mix, generator=gen)
    d_st, d_kl = torch.randn_like(st), torch.randn_like(kl)
    decoder = LogisticPolicyDecoder(ad).cuda()

    def seeded(fn):
        """``fn`` with a generator at a fixed seed: its result's digest."""
        return digest(torch.cat([t.flatten() for t in fn(torch.Generator(device="cuda").manual_seed(SEED + 1))]))

    def plan_fwd(g):
        with torch.no_grad():
            return dist.rsample_balanced_kl(DiscretePlanState(post), DiscretePlanState(prior),
                                            cfg.loss.kl_balancing_mix, generator=g)

    tails = {"plan_fwd 64": (plan_fwd, True),
             "plan_bwd 64": (lambda g: torch.autograd.grad((st, kl), leaves, (d_st, d_kl), retain_graph=True), False)}
    for lanes in (LANES, 1):
        shape = (lanes, 1, ad.out_features - 1, ad.n_mixtures)
        outs = DecoderOutputs(*(torch.randn(shape, generator=gen, device="cuda") for _ in range(3)),
                              torch.randn((lanes, 1, 2), generator=gen, device="cuda"), None)
        tails[f"action_sample {lanes}"] = (lambda g, outs=outs: (decoder._sample_from_outputs(outs, g, None, None),),
                                           True)
    out["sampling_tail"] = {}
    for name, (fn, draws) in tails.items():
        call = functools.partial(fn, torch.Generator(device="cuda").manual_seed(SEED + 2))
        ops = device_ops(call, ITERS)
        out["sampling_tail"][name] = {**op_counts(ops, ITERS), "kernel_ms": kernel_ms(ops), "event_ms": event_ms(call)}
        if draws:
            out["digest"][f"sampling_tail {name}"] = seeded(fn)

    gumbel = gumbel_noise((64, d.category_size, d.class_size), gen, "cuda")

    def plan_kernel():
        with torch.no_grad():
            return dist.rsample_balanced_kl(DiscretePlanState(post), DiscretePlanState(prior),
                                            cfg.loss.kl_balancing_mix, gumbel=gumbel)

    alone = {"plan_fwd 64": plan_kernel}
    bounds = (ad.act_min_bound[-1], ad.act_max_bound[-1])
    for lanes in (LANES, 1):
        shape = (lanes, 1, ad.out_features - 1, ad.n_mixtures)
        lp, ls, mu = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        u_mix, u_inv = (torch.rand(s, generator=gen, device="cuda").clamp_(1e-5, 1.0 - 1e-5) for s in (shape, shape[:-1]))
        grip = torch.randn((lanes, 1, 2), generator=gen, device="cuda")
        alone[f"action_sample {lanes}"] = functools.partial(mixture_kernel, lp, ls, mu, u_mix, u_inv, grip, bounds)
    out["sampling_kernel"] = {}
    for name, fn in alone.items():
        ops = device_ops(fn, ITERS)
        out["sampling_kernel"][name] = {**op_counts(ops, ITERS), "kernel_ms": kernel_ms(ops), "event_ms": event_ms(fn)}


def gated_cases(hidden: int, gen) -> dict:
    """{name: call} of B.11 and B.12, forward and dh chain, at (64, 32),
    (64, 1) and (1, 1) rows and steps of ``hidden`` columns: W_hh and b_hh
    at torch's U(-1/sqrt(H), 1/sqrt(H)), xp, dy, the carries and their
    cotangents ~ N(0, 1), the saved gates from the plain loop. Each call
    returns the wrapper's outputs."""
    from hulc_tpu_torch.ops import recurrence as rec

    cases = {}
    for cell, g in (("gru", 3), ("lstm", 4)):
        w = (2.0 * torch.rand(g * hidden, hidden, generator=gen, device="cuda") - 1.0) / hidden**0.5
        bias = (2.0 * torch.rand(g * hidden, generator=gen, device="cuda") - 1.0) / hidden**0.5
        for b, s in ((64, 32), (64, 1), (1, 1)):
            xp = torch.randn((b, s, g * hidden), generator=gen, device="cuda")
            h0, c0, dh, dc = (torch.randn((b, hidden), generator=gen, device="cuda") for _ in range(4))
            dy = torch.randn((b, s, hidden), generator=gen, device="cuda")
            if cell == "lstm":
                _, _, saved = rec._gated_loop(cell, xp, h0, c0, w, bias, True)
                fwd = functools.partial(rec.rnn_lstm_fwd_kernel, xp, h0, c0, w, bias)
                bwd = functools.partial(rec.rnn_lstm_bwd, dy, dh, dc, saved, c0, w)
            else:
                y, _, saved = rec._gated_loop(cell, xp, h0, None, w, bias, True)
                fwd = functools.partial(rec.rnn_gru_fwd_kernel, xp, h0, w, bias)
                bwd = functools.partial(rec.rnn_gru_bwd, dy, dh, y, h0, saved, w)
            cases[f"rnn_{cell}_fwd {b} {s}"] = fwd
            cases[f"rnn_{cell}_bwd {b} {s}"] = bwd
    return cases


def birnn_cases(hidden: int, gen) -> dict:
    """{name: call} of B.13's bidirectional relu and gru layers at the train
    step's (64, 32) and ``hidden`` columns a chain, forward (the gru's
    saving its gates) and backward (both dh chains), on W_hh and b_hh at
    torch's U(-1/sqrt(H), 1/sqrt(H)), xp and dy ~ N(0, 1), from zero
    states; empty on a tree without B.13."""
    from hulc_tpu_torch.ops import recurrence as rec

    if not hasattr(rec, "BIRNN_CELLS"):
        return {}
    b, s = 64, 32
    cases = {}
    for cell, g in (("rnn", 1), ("gru", 3)):
        def uniform(*shape):
            return (2.0 * torch.rand(shape, generator=gen, device="cuda") - 1.0) / hidden**0.5

        w_f, w_b, b_f, b_b = uniform(g * hidden, hidden), uniform(g * hidden, hidden), uniform(g * hidden), \
            uniform(g * hidden)
        xp_f, xp_b = (torch.randn((b, s, g * hidden), generator=gen, device="cuda") for _ in range(2))
        h0s = torch.zeros((2, b, hidden), device="cuda")
        dy = torch.randn((b, s, 2 * hidden), generator=gen, device="cuda")
        saved = xp_f.new_empty(2, b, s, 4 * hidden) if cell == "gru" else None
        args = (xp_f, xp_b, h0s, w_f, w_b, b_f, b_b, cell)
        y = rec.birnn_layer_fwd(*args, saved)
        cases[f"birnn_{cell}_fwd {b} {s}"] = lambda args=args, saved=saved: rec.birnn_layer_fwd(*args, saved)
        cases[f"birnn_{cell}_bwd {b} {s}"] = lambda dy=dy, y=y, w_f=w_f, w_b=w_b, cell=cell, h0s=h0s, saved=saved: (
            rec.birnn_layer_bwd(dy, y, w_f, w_b, cell, h0s, saved))
    return cases


def preprocess_cases(gen) -> dict:
    """{name: (call, digest of one call)} of B.15 and B.10 at the train
    step's shapes (see the module's note)."""
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.training.preprocess import preprocess_modality, prep_camera
    from hulc_tpu_torch.training.profile_train import BATCH_PER_MOD, SEQ, synthetic_fused_batch

    b, s = 2 * BATCH_PER_MOD, SEQ
    shifts = {pad: torch.randint(0, 2 * pad + 1, (b * s, 2), generator=gen, device="cuda", dtype=torch.int32)
              for pad in (3, 10)}

    def fixed(n, pad):
        return shifts[pad]

    clip, tactile = (get_config("hulc_clip_vision").perceptual_encoder.rgb_static,
                     get_config("hulc_tactile").perceptual_encoder.tactile)
    cases = {}
    for name, enc, frame, train, dtype in (
        ("clip_train_fp32", clip, (200, 200, 3), True, torch.float32),
        ("clip_train_bf16", clip, (200, 200, 3), True, torch.bfloat16),
        ("clip_val_fp32", clip, (200, 200, 3), False, torch.float32),
        ("tactile_160x120_train_fp32", tactile, (160, 120, 6), True, torch.float32),
        ("tactile_64_train_fp32", tactile, (64, 64, 6), True, torch.float32),
    ):
        imgs = torch.randint(0, 256, (b, s, *frame), generator=gen, device="cuda", dtype=torch.uint8)
        call = functools.partial(prep_camera, enc, imgs, train, dtype, fixed)
        cases[f"b15 {name}"] = (call, call)

    cfg = get_config("hulc_depth")
    fused = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, SEED, "cuda")["fused"]
    for mode, keep in (("gamma", "depth_static"), ("gaussian", "depth_gripper")):
        batch = fused._replace(rgb_static=None, rgb_gripper=None,
                               **{cam: None for cam in ("depth_static", "depth_gripper") if cam != keep})
        step_gen = torch.Generator(device="cuda").manual_seed(SEED)

        def call(batch=batch, g=step_gen, keep=keep):
            return getattr(preprocess_modality(cfg, batch, True, generator=g), keep)

        def fresh(batch=batch, keep=keep):
            g = torch.Generator(device="cuda").manual_seed(SEED)
            return getattr(preprocess_modality(cfg, batch, True, generator=g), keep)

        cases[f"depth_noise {mode} step"] = (call, fresh)
    x = fused.depth_gripper
    add_gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases["depth_noise gaussian randn_add"] = (
        lambda: torch.add(x, torch.randn(x.shape, generator=add_gen, device="cuda"), alpha=0.01),
        lambda: torch.add(x, torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(SEED),
                                         device="cuda"), alpha=0.01))
    return cases


def policy_times(cfg, seed: int, lanes: int) -> dict:
    """Median host-clock ms of an acting step at 1 lane and at ``lanes``,
    and the device operations per step under the profiler."""
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
    from hulc_tpu_torch.evaluation.policy import HulcPolicy
    from hulc_tpu_torch.models import make_model

    rng = np.random.default_rng(seed)
    pe = cfg.perceptual_encoder
    model = make_model(cfg, "cuda", seed=seed)

    def obs():
        s, g = pe.rgb_static.input_size, pe.rgb_gripper.input_size
        return {"rgb_obs": {"rgb_static": rng.integers(0, 256, (s, s, 3), np.uint8),
                            "rgb_gripper": rng.integers(0, 256, (g, g, 3), np.uint8)},
                "robot_obs": rng.normal(size=15).astype(np.float32)}

    single = HulcPolicy(cfg, model, seed=seed)
    one, lang = obs(), rng.normal(size=384).astype(np.float32)
    single.step(one, lang)  # plan once; the timed steps act
    single.replan_freq = 10**9
    out = {"1": host_ms(lambda: single.step(one, lang), 50)}
    ops = {"1": op_counts(device_ops(lambda: single.step(one, lang), 20), 20)}
    batched = BatchedHulcPolicy(cfg, model, lanes, seed=seed)
    many, langs = [obs() for _ in range(lanes)], rng.normal(size=(lanes, 384)).astype(np.float32)
    state, mask = [batched.initial_state()], np.zeros(lanes, bool)

    def step():
        _, state[0] = batched.step(many, langs, state[0], mask)

    out[str(lanes)] = host_ms(step, 30)
    ops[str(lanes)] = op_counts(device_ops(step, 20), 20)
    return {"host_ms": out, "ops_per_step": ops}


def run(argv=None) -> dict:
    """The measurements ``main`` prints, as a dict (``--tree`` and
    ``--only`` as ``main`` takes them)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", type=pathlib.Path, required=True)
    p.add_argument("--only", default="", help="time only the cases whose names start with one of these "
                                              "(comma-separated)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    sys.path.insert(0, str(args.tree.resolve()))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from hulc_tpu_torch import kernels
    from hulc_tpu_torch.config import get_config
    from hulc_tpu_torch.models.vision import spatial_softmax, spatial_softmax_bwd
    from hulc_tpu_torch.ops.image_ops import draw_shifts, preprocess_rgb_seq, preprocess_rgb_seq_shift
    from hulc_tpu_torch.ops.recurrence import rnn_relu_bwd, rnn_relu_fwd

    kernels.library()
    cfg = get_config("hulc")
    pe = cfg.perceptual_encoder
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def frames(n, s, px):
        return torch.randint(0, 256, (n, s, px, px, 3), generator=gen, device="cuda", dtype=torch.uint8)

    cases = {}
    for lanes in (1, LANES):
        for cam in ("rgb_static", "rgb_gripper"):
            imgs = frames(lanes, 1, getattr(pe, cam).input_size)
            cases[f"preprocess_rgb {cam} {lanes}"] = lambda imgs=imgs: preprocess_rgb_seq(imgs)
    for rows in (1, LANES, 2048):
        x = torch.randn((rows, 64, 21, 21), generator=gen, device="cuda").relu_()
        cases[f"spatial_softmax {rows}"] = lambda x=x: spatial_softmax(x, 1.0)
    conv_map = x  # the step's shape
    train = {cam: frames(64, 32, getattr(pe, cam).input_size) for cam in ("rgb_static", "rgb_gripper")}
    shifts = {cam: draw_shifts(64 * 32, getattr(pe, cam).shift_pad, gen, "cuda") for cam in train}
    cases["preprocess_rgb_shift train"] = lambda: [
        preprocess_rgb_seq_shift(imgs, shifts[cam], getattr(pe, cam).shift_pad) for cam, imgs in train.items()
    ]
    grad = torch.randn((2048, 128), generator=gen, device="cuda")
    cases["spatial_softmax_bwd train"] = lambda: spatial_softmax_bwd(conv_map, grad, 1.0)[0]
    # the bf16 instances (B.14), on the same maps and shifts; the eval preprocess at the val window's frames
    bf16 = torch.bfloat16
    for cam in ("rgb_static", "rgb_gripper"):
        imgs = frames(32, 32, getattr(pe, cam).input_size)
        cases[f"preprocess_rgb window {cam}"] = lambda imgs=imgs: preprocess_rgb_seq(imgs)
        cases[f"preprocess_rgb_bf16 window {cam}"] = lambda imgs=imgs: preprocess_rgb_seq(imgs, out_dtype=bf16)
    cases["preprocess_rgb_shift_bf16 train"] = lambda: [
        preprocess_rgb_seq_shift(imgs, shifts[cam], getattr(pe, cam).shift_pad, out_dtype=bf16)
        for cam, imgs in train.items()
    ]
    conv_map_bf16 = conv_map.to(bf16)
    for rows in (1, LANES, 2048):
        x = conv_map_bf16[:rows]
        cases[f"spatial_softmax_bf16 {rows}"] = lambda x=x: spatial_softmax(x, 1.0)
    cases["spatial_softmax_bwd_bf16 train"] = lambda: spatial_softmax_bwd(conv_map_bf16, grad, 1.0)[0]

    # B.6 at the train step's shape and the serving shapes: W and b_hh at
    # torch's U(-1/sqrt(H), 1/sqrt(H)), xp and dy ~ N(0, 1), a relu'd carry
    hidden = cfg.action_decoder.hidden_size
    w = (2.0 * torch.rand(hidden, hidden, generator=gen, device="cuda") - 1.0) / hidden**0.5
    bias = (2.0 * torch.rand(hidden, generator=gen, device="cuda") - 1.0) / hidden**0.5
    rnn_cases = {}
    for b, s in ((64, 32), (64, 1), (1, 1)):
        xp = torch.randn((b, s, hidden), generator=gen, device="cuda")
        h0 = torch.randn((b, hidden), generator=gen, device="cuda").relu_()
        dy = torch.randn((b, s, hidden), generator=gen, device="cuda")
        y = rnn_relu_fwd(xp, h0, w, bias)[0]
        rnn_cases[f"rnn_relu_fwd {b} {s}"] = lambda xp=xp, h0=h0: rnn_relu_fwd(xp, h0, w, bias)[0]
        rnn_cases[f"rnn_relu_bwd {b} {s}"] = lambda dy=dy, y=y, h0=h0: rnn_relu_bwd(dy, y, h0, w)[0]
    rnn_cases.update(gated_cases(hidden, gen))
    rnn_cases.update(birnn_cases(hidden, gen))

    out = {"tree": str(args.tree), "card": card(), "device_ms": {}, "event_ms": {}, "digest": {}}
    def wanted(name):
        return any(name.startswith(prefix) for prefix in args.only.split(","))

    if wanted("optimizer_tail"):
        optimizer_tail(cfg, out)
    if wanted("sampling_tail"):
        sampling_tails(cfg, out)
    if wanted("train_step"):
        train_step_counts(cfg, out)
    if wanted("depth_step"):
        train_step_counts(get_config("hulc_depth"), out, "depth_step")
    for name, fn in cases.items():
        if not wanted(name):
            continue
        out["device_ms"][name] = device_ms(fn, ITERS)
        result = fn()
        out["digest"][name] = digest(torch.cat([r.flatten() for r in result]) if isinstance(result, list) else result)
    for name, fn in rnn_cases.items():
        if wanted(name):
            out["event_ms"][name] = event_ms(fn)
            result = fn()
            if isinstance(result, tuple):  # a gated cell's outputs, the saved gates None in inference
                result = torch.cat([t.flatten() for t in result if t is not None])
            out["digest"][name] = digest(result)
    del train, shifts
    if any(wanted(name) for name in ("b15", "depth_noise")):
        for name, (fn, once) in preprocess_cases(gen).items():
            if wanted(name):
                out["event_ms"][name] = event_ms(fn)
                out["digest"][name] = digest(once())
        out["digest_note"] = ("depth_noise digests differ between a tree that draws with torch.randn and one "
                              "that draws in B.10's launch: other numbers by design")
        torch.cuda.empty_cache()
    if wanted("policy"):
        policy = policy_times(cfg, SEED, LANES)
        out["policy_step_host_ms"], out["policy_step_ops"] = policy["host_ms"], policy["ops_per_step"]
    return out


def main(argv=None) -> None:
    print(json.dumps(run(argv)))


if __name__ == "__main__":
    main()
