"""Where the training step spends its time on the GPU.

    python -m hulc_tpu_torch.training.profile_train [--steps 5] [--seed 0] [--config hulc] [--set K=V ...] [--out DIR]

Builds a full-width ``Trainer`` of the ``--config`` preset (``hulc``,
``mcil`` or ``hulc_depth``; random weights from ``--seed``), with the
``--set`` dotted-path overrides applied (``config.apply_overrides``, as the
JAX package's CLIs take them: ``--set action_decoder.rnn_cell=lstm``
profiles the lstm decoder)
and a synthetic loader-fused uint8 batch of 32 vision and 32 language
windows of 32 frames (the JAX package's bench shape; with fp32 depth
frames for ``hulc_depth``), takes warm-up steps,
then runs ``--steps`` steps of ``Trainer.train_step`` under
``torch.profiler`` and prints one JSON line: host-clock ms per step under
the profiler and, from ``--steps`` steps just before it, without it;
device ms per step (the CUDA activity the profiler recorded); the device's
idle share against either step time (the profiler's own host work
lengthens the profiled step); device time by kind (hand kernels, matmuls,
convolutions, copies and fills, other) and each hand kernel's; the ten
CUDA operations that take the most device time; and, from ``--steps`` more
steps profiled with shapes and Python stacks, the host-to-device copies
per step, from pageable memory (each blocks the host until the stream
drains) and from pinned memory, by the function of the port that issued
them, the device operations launched per step (kernels, copies, fills),
the device time by kind of those that compute on bf16 (``--set
compute_dtype=bfloat16``: launched by an op that reads a bf16 tensor, or
a hand kernel's bf16 instance), the optimizer tail (``AdamLowp.step``'s span: the Adam kernel and the
gradient norm's finish launch), and the device time of the decoder RNN's
recurrence by part (its forward and backward kernels, the dW product, the
bias sum), and of the plan recognition BiRNN's (``mcil``; ``--set
plan_recognition.birnn_cell=gru`` or ``=rnn`` for B.13's cells) the same way. With ``--out`` it also writes
the Chrome trace there. Needs a CUDA device; TF32 is off, as in the fp32
reference.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import pathlib
import statistics
import tempfile
import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from hulc_tpu_torch.config import HulcConfig, apply_overrides, get_config
from hulc_tpu_torch.evaluation.profile_policy import HAND_KERNELS, WINDOW_PAD_S, kind_of, profile_steps
from hulc_tpu_torch.models.hulc import ModalityBatch
from hulc_tpu_torch.ops.recurrence import BIRNN_SPANS, SPANS
from hulc_tpu_torch.training.optimizers import OPTIMIZER_SPAN
from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

BATCH_PER_MOD, SEQ = 32, 32  # windows per modality, frames per window
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # a Chrome trace's device activity


# CALVIN's tactile frames: 160 x 120, two 3-channel sensors
TACTILE_FRAME = (160, 120, 6)


def synthetic_fused_batch(
    cfg: HulcConfig, batch_per_mod: int, seq_len: int, seed: int, device
) -> Dict[str, ModalityBatch]:
    """A loader-fused ``{"fused": 2B}`` uint8 batch, [vis; lang] rows, built
    as the JAX package's ``__graft_entry__._make_raw_batch``: uniform frames,
    ``tanh(normal)`` actions, normal 15-d ``state_info_robot_obs``, normal
    ``lang_dim``-d language embeddings; every third language window is left out of
    the auxiliary losses. A config draws frames only for its cameras and
    proprio of its width (8 without one); a CLIP camera draws the dataset's
    200 px frames (resized to 224 on the device). A config with depth cameras also gets fp32
    depth frames, uniform in _make_raw_batch's ranges, and one with a
    tactile tower CALVIN's 160 x 120 x 6 tactile frames (drawn last, so the
    other fields do not change)."""
    rng = np.random.default_rng(seed)
    pe = cfg.perceptual_encoder
    n = 2 * batch_per_mod

    def frames(px):
        return rng.integers(0, 255, (n, seq_len, px, px, 3), dtype=np.uint8)

    def depth(enc, lo, hi):
        return None if enc is None else rng.uniform(lo, hi, (n, seq_len, enc.input_size, enc.input_size)).astype(np.float32)

    static_px = None if pe.rgb_static is None else 200 if pe.rgb_static.kind == "clip" else pe.rgb_static.input_size
    batch = ModalityBatch(
        rgb_static=frames(static_px) if pe.rgb_static is not None else None,
        rgb_gripper=frames(pe.rgb_gripper.input_size) if pe.rgb_gripper is not None else None,
        robot_obs=rng.normal(size=(n, seq_len, pe.proprio.n_state_obs if pe.proprio else 8)).astype(np.float32),
        actions=np.tanh(rng.normal(size=(n, seq_len, 7))).astype(np.float32),
        state_info_robot_obs=rng.normal(size=(n, seq_len, 15)).astype(np.float32),
        lang=rng.normal(size=(batch_per_mod, cfg.lang_dim)).astype(np.float32),
        use_for_aux_lang_loss=np.arange(batch_per_mod) % 3 != 2,
        idx=np.arange(batch_per_mod),
        depth_static=depth(pe.depth_static, 0.1, 5.0),
        depth_gripper=depth(pe.depth_gripper, 0.01, 2.0),
        rgb_tactile=None if pe.tactile is None else rng.integers(0, 255, (n, seq_len, *TACTILE_FRAME), dtype=np.uint8),
    )
    return {"fused": ModalityBatch(*(None if x is None else torch.as_tensor(x, device=device) for x in batch))}


def _span_index(spans) -> Dict[int, list]:
    """(start, end) of each span by thread, sorted; the spans of one thread
    must not nest."""
    index = collections.defaultdict(list)
    for e in spans:
        index[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0)))
    for v in index.values():
        v.sort()
    return index


def _inside(event, index) -> bool:
    """Whether ``event`` starts inside one of the indexed spans of its thread."""
    spans = index.get(event["tid"], ())
    i = bisect.bisect_right(spans, (event["ts"], float("inf"))) - 1
    return i >= 0 and event["ts"] <= spans[i][1]


def h2d_sites(events, steps: int) -> Dict[str, Dict[str, float]]:
    """Host-to-device copies per step in a Chrome trace with Python stacks,
    by source memory (``"pageable"``: the host waits for the stream;
    ``"pinned"``: it does not) and by the function of the port that issued
    them: each copy's runtime call (matched by correlation id) and the
    innermost Python function of ``hulc_tpu_torch`` around it on its thread
    ("unknown" where none is, e.g. on autograd's backward thread)."""
    kinds = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "gpu_memcpy" and name.startswith("Memcpy HtoD"):
            kinds[e["args"].get("correlation")] = (
                "pinned" if "Pinned" in name else "pageable" if "Pageable" in name else name
            )
    python = [e for e in events if e.get("cat") == "python_function" and "hulc_tpu_torch/" in e.get("name", "")
              and "profile_train" not in e["name"]]
    sites = {"pageable": collections.Counter(), "pinned": collections.Counter()}
    for call in events:
        kind = kinds.get(call.get("args", {}).get("correlation")) if call.get("cat") == "cuda_runtime" else None
        if kind is None:
            continue
        around = [p for p in python if p["tid"] == call["tid"] and p["ts"] <= call["ts"] <= p["ts"] + p.get("dur", 0)]
        site = "unknown"
        if around:
            name = min(around, key=lambda p: p.get("dur", 0))["name"]
            site = name[name.find("hulc_tpu_torch/"):]
        sites.setdefault(kind, collections.Counter())[site] += 1 / steps
    return {kind: dict(counts) for kind, counts in sites.items()}


def _device_events(events, ops):
    """The device activity (kernels, copies, fills) launched by runtime or
    driver calls (cuBLAS launches through the driver) inside the spans of
    ``ops``, on the op's thread."""
    device = {e["args"].get("correlation"): e for e in events if e.get("cat") in DEVICE_CATS}
    index = _span_index(ops)
    return [device[e["args"]["correlation"]] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("args", {}).get("correlation") in device
            and _inside(e, index)]


def span_part(events, name: str, steps: int) -> dict:
    """What was launched inside each ``record_function`` span ``name`` of a
    Chrome trace, per step: spans, device ms and the names of the device
    operations; per span, the CPU ops inside it."""
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
    launched = _device_events(events, spans)
    index = _span_index(spans)
    inner = collections.Counter(e["name"] for e in ops if _inside(e, index))
    return {
        "calls_per_step": len(spans) / steps,
        "device_ms_per_step": sum(e.get("dur", 0) for e in launched) / 1e3 / steps,
        "device_ops": sorted({e["name"][:80] for e in launched}),
        "ops_per_call": {k: v / len(spans) for k, v in sorted(inner.items())} if spans else {},
    }


def recurrence_split(events, steps: int, spans: Dict[str, str] = SPANS) -> dict:
    """The decoder RNN's recurrence by part, in a Chrome trace: what was
    launched inside each ``record_function`` span of
    ``ops.recurrence.SPANS`` (the forward kernel, the backward kernel, the
    one dW product, the bias sum; the BiRNN's with ``BIRNN_SPANS``), as
    ``span_part`` gives it. Then the recurrence's device ms per step and
    its share of all the device time in the window."""
    device_us = sum(e.get("dur", 0) for e in events if e.get("cat") in DEVICE_CATS)
    parts = {key: span_part(events, name, steps) for key, name in spans.items()}
    total = sum(p["device_ms_per_step"] for p in parts.values())
    return {**parts, "device_ms_per_step": total, "share_of_device": total * 1e3 * steps / device_us if device_us else None}


def innermost_op(ops, starts, ts: float):
    """The innermost of ``ops`` (a thread's CPU ops sorted by start, their
    ``starts``) whose span holds time ``ts``, or None: the latest-starting
    one that holds it (an op starting later and holding it would lie inside
    it)."""
    for i in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
        if ts <= ops[i]["ts"] + ops[i].get("dur", 0):
            return ops[i]
    return None


def bf16_device_ms(events, steps: int) -> Dict[str, float]:
    """Device ms per step by kind (``kind_of``) of the device operations that
    compute on bf16, in a Chrome trace recorded with shapes: each launched by
    a runtime or driver call inside a CPU op that reads a bf16 tensor (its
    "Input type"; the innermost op around the call, on its thread), and each
    hand kernel's bf16 instance (a ctypes launch, inside no op of its own:
    the instance's element type is in its symbol)."""
    device = {e["args"].get("correlation"): e for e in events if e.get("cat") in DEVICE_CATS}
    ops = collections.defaultdict(list)
    for e in sorted((e for e in events if e.get("cat") == "cpu_op"), key=lambda e: e["ts"]):
        ops[e["tid"]].append(e)
    starts = {tid: [o["ts"] for o in v] for tid, v in ops.items()}
    out = collections.Counter()
    for call in events:
        launched = device.get(call.get("args", {}).get("correlation"))
        if call.get("cat") not in ("cuda_runtime", "cuda_driver") or launched is None:
            continue
        name = launched["name"]
        if any(k in name for k in HAND_KERNELS):
            bf16 = "__nv_bfloat16" in name
        else:
            tid = call["tid"]
            op = innermost_op(ops[tid], starts[tid], call["ts"]) if tid in ops else None
            bf16 = op is not None and "c10::BFloat16" in op.get("args", {}).get("Input type", ())
        if bf16:
            out[kind_of(name)] += launched.get("dur", 0) / 1e3 / steps
    return dict(out)


def device_launches(events, steps: int) -> Dict[str, float]:
    """Device operations per step in a Chrome trace, by kind: kernels,
    copies (``gpu_memcpy``) and fills (``gpu_memset``)."""
    counts = collections.Counter(e.get("cat") for e in events if e.get("cat") in DEVICE_CATS)
    return {"kernels": counts["kernel"] / steps, "copies": counts["gpu_memcpy"] / steps,
            "fills": counts["gpu_memset"] / steps}


def trace_breakdown(step, steps: int) -> dict:
    """``steps`` calls of ``step`` under torch.profiler with shapes and Python
    stacks; returns the host-to-device copies per step (``h2d_sites``), the
    device operations per step (``device_launches``), the device ms per
    step of those that compute on bf16, by kind (``bf16_device_ms``), the
    optimizer tail (``span_part`` of ``OPTIMIZER_SPAN``) and the
    recurrence's device time by part (``recurrence_split``)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 with_stack=True) as prof:
        time.sleep(WINDOW_PAD_S)
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return {"h2d_copies_per_step": h2d_sites(events, steps), "device_launches_per_step": device_launches(events, steps),
            "bf16_device_ms_per_step_by_kind": bf16_device_ms(events, steps),
            "optimizer": span_part(events, OPTIMIZER_SPAN, steps), "recurrence": recurrence_split(events, steps),
            "birnn_recurrence": recurrence_split(events, steps, BIRNN_SPANS)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", default="hulc", help="the preset: hulc, mcil or hulc_depth")
    p.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                   help="a dotted-path config override, e.g. action_decoder.rnn_cell=gru (repeatable)")
    p.add_argument("--out", type=pathlib.Path, default=None)
    args = p.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = apply_overrides(get_config(args.config), args.overrides)
    trainer = Trainer(cfg, TrainerConfig(seed=args.seed), device="cuda")
    trainer.init_state(1)
    batch = synthetic_fused_batch(cfg, BATCH_PER_MOD, SEQ, args.seed, "cuda")
    kl_beta = cfg.loss.kl_beta
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    trace = None if args.out is None else args.out / "train_step.json"

    def step():
        trainer.train_step(batch, kl_beta)

    for _ in range(3):
        step()
    host = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    unprofiled_ms = statistics.median(host)
    result = profile_steps(step, args.steps, trace)
    print(json.dumps({
        "step": "Trainer.train_step", "config": args.config, "overrides": args.overrides,
        "compute_dtype": cfg.compute_dtype, "model_compute_dtype": str(trainer.model.cfg.dtype),
        "batch": 2 * BATCH_PER_MOD, "seq": SEQ,
        "card": torch.cuda.get_device_name(0), "unprofiled_step_ms": unprofiled_ms,
        "unprofiled_idle_share": 1.0 - result["device_ms_per_step"] / unprofiled_ms, **result,
        **trace_breakdown(step, args.steps),
    }))


if __name__ == "__main__":
    main()
