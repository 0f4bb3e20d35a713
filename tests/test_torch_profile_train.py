"""The trace readers of hulc_tpu_torch.training.profile_train, on the CPU:
host-to-device copies split by source memory and by issuing function, the
device operations per step by kind, the optimizer tail from the span
``AdamLowp.step`` opens, and the decoder RNN's recurrence split by part
(forward and backward kernels, the dW product, the bias sum) from the spans
its autograd Function opens."""

import json
import pathlib

import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from hulc_tpu_torch.models.layers import MLP, ScanRNN
from hulc_tpu_torch.ops.recurrence import SPANS, rnn_relu
from hulc_tpu_torch.training.optimizers import OPTIMIZER_SPAN, AdamLowp
from hulc_tpu_torch.training.profile_train import device_launches, h2d_sites, recurrence_split, span_part

torch.set_num_threads(1)


def _copy(kind, corr, tid, ts):
    """A host-to-device copy on the device and the runtime call that issued it."""
    return [
        {"cat": "gpu_memcpy", "name": f"Memcpy HtoD ({kind} -> Device)", "ts": ts + 5, "dur": 2,
         "tid": 7, "args": {"correlation": corr}},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": ts, "dur": 3, "tid": tid,
         "args": {"correlation": corr}},
    ]


def test_h2d_sites_split_pageable_and_pinned_copies_by_function():
    adam = "/repo/hulc_tpu_torch/training/optimizers.py(60): adam_lowp_update"
    step = "/repo/hulc_tpu_torch/training/trainer.py(81): train_step"
    events = [
        {"cat": "python_function", "name": step, "ts": 0, "dur": 1000, "tid": 1},
        {"cat": "python_function", "name": adam, "ts": 100, "dur": 50, "tid": 1},
        *_copy("Pinned", 1, 1, 110),  # inside both: the innermost names it
        *_copy("Pageable", 2, 1, 500),
        *_copy("Pageable", 3, 1, 1500),  # outside the port's functions
        *_copy("Pageable", 4, 2, 120),  # another thread
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 200, "dur": 3, "tid": 1, "args": {"correlation": 5}},
    ]
    assert h2d_sites(events, 2) == {
        "pinned": {"hulc_tpu_torch/training/optimizers.py(60): adam_lowp_update": 0.5},
        "pageable": {"hulc_tpu_torch/training/trainer.py(81): train_step": 0.5, "unknown": 1.0},
    }
    assert h2d_sites(events[:2], 1) == {"pageable": {}, "pinned": {}}


def test_recurrence_split_finds_the_recurrent_addmm_and_its_backward(tmp_path: pathlib.Path):
    """Two recurrence layers through ``rnn_relu`` (the autograd Function the
    CUDA path runs; on the CPU its plain versions) between Linear stacks:
    two forward and two backward spans, each backward with ONE dW product
    and one bias sum, and no CPU op of the MLPs inside a span. The CPU runs
    no device kernel."""
    gen = torch.Generator().manual_seed(0)
    rnn, head = ScanRNN(6, 8, 2), MLP(8, [8, 8])
    mlp_in = MLP(5, [6])
    for p in [*rnn.parameters(), *head.parameters(), *mlp_in.parameters()]:
        nn.init.normal_(p, std=0.1, generator=gen)
    x = torch.randn(4, 3, 5, generator=gen)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True, with_stack=True) as prof:
        out = mlp_in(x)
        for k in range(2):
            xp = nn.functional.linear(out, getattr(rnn, f"weight_ih_l{k}"), getattr(rnn, f"bias_ih_l{k}"))
            out, _ = rnn_relu(xp, torch.zeros(4, 8), getattr(rnn, f"weight_hh_l{k}"), getattr(rnn, f"bias_hh_l{k}"))
        head(out).sum().backward()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    split = recurrence_split(json.loads(path.read_text())["traceEvents"], 1)
    assert [split[k]["calls_per_step"] for k in SPANS] == [2, 2, 2, 2]
    assert split["weight_grad"]["ops_per_call"]["aten::mm"] == 1
    assert split["bias_grad"]["ops_per_call"]["aten::sum"] == 1
    assert "aten::addmm" in split["forward"]["ops_per_call"]  # the plain loop, on the CPU
    assert "aten::linear" not in split["forward"]["ops_per_call"]
    assert split["forward"]["device_ms_per_step"] == 0 and split["weight_grad"]["device_ops"] == []
    assert split["device_ms_per_step"] == 0 and split["share_of_device"] is None


def _launch(cat, corr, tid, ts, kernel, dur):
    """A launch call on the host and the kernel it ran."""
    return [
        {"cat": cat, "name": "cuLaunchKernel", "ts": ts, "dur": 2, "tid": tid, "args": {"correlation": corr}},
        {"cat": "kernel", "name": kernel, "ts": ts + 10, "dur": dur, "tid": 7, "args": {"correlation": corr}},
    ]


def test_recurrence_split_times_what_the_ops_launched():
    """Device time goes to the span that holds the launch, through the
    runtime or the driver (cuBLAS), on the span's thread; the share is of
    all device time in the window."""
    def span(name, ts, dur, tid=1):
        return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}

    events = [
        span(SPANS["forward"], 0, 20),
        *_launch("cuda_runtime", 1, 1, 5, "rnn_relu_fwd_kernel", 300),
        *_launch("cuda_driver", 2, 1, 30, "sm90_xmma_gemm_f32f32_head", 50),  # outside every span
        span(SPANS["backward"], 100, 20, tid=2),
        *_launch("cuda_runtime", 3, 2, 105, "rnn_relu_bwd_kernel", 310),
        *_launch("cuda_runtime", 4, 1, 110, "unrelated_on_another_thread", 5),
        span(SPANS["weight_grad"], 130, 20, tid=2),
        *_launch("cuda_runtime", 5, 2, 132, "CatArrayBatchedCopy", 10),
        *_launch("cuda_driver", 6, 2, 135, "sm90_xmma_gemm_f32f32_dw", 120),
        span(SPANS["bias_grad"], 160, 10, tid=2),
        *_launch("cuda_runtime", 7, 2, 162, "reduce_kernel", 15),
    ]
    split = recurrence_split(events, 1)
    assert split["forward"]["calls_per_step"] == 1 and split["forward"]["device_ms_per_step"] == 300 / 1e3
    assert split["forward"]["device_ops"] == ["rnn_relu_fwd_kernel"]
    assert split["backward"]["device_ms_per_step"] == 310 / 1e3
    assert split["weight_grad"]["device_ms_per_step"] == 130 / 1e3
    assert split["weight_grad"]["device_ops"] == ["CatArrayBatchedCopy", "sm90_xmma_gemm_f32f32_dw"]
    assert split["bias_grad"]["device_ms_per_step"] == 15 / 1e3
    assert split["device_ms_per_step"] == 755 / 1e3 and split["share_of_device"] == 755 / 810


def test_span_part_finds_the_optimizer_step(tmp_path: pathlib.Path):
    """Two ``AdamLowp.step`` calls on the CPU: two optimizer spans per
    window, with the plain update's ops inside and no device time."""
    params = [nn.Parameter(torch.randn(5, 3)), nn.Parameter(torch.randn(7))]
    opt = AdamLowp(params, lr=1e-3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            for p in params:
                p.grad = torch.ones_like(p)
            opt.step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    part = span_part(json.loads(path.read_text())["traceEvents"], OPTIMIZER_SPAN, 2)
    assert part["calls_per_step"] == 1 and part["device_ms_per_step"] == 0 and part["device_ops"] == []
    assert part["ops_per_call"]["aten::sqrt"] >= 2  # the plain norm and each tensor's update


def test_device_launches_counts_kernels_copies_and_fills_per_step():
    events = [
        *_launch("cuda_runtime", 1, 1, 0, "adam_lowp_kernel", 5),
        *_launch("cuda_runtime", 2, 1, 10, "grad_norm_finish_kernel", 1),
        *_copy("Pinned", 3, 1, 20),
        {"cat": "gpu_memset", "name": "Memset (Device)", "ts": 30, "dur": 1, "tid": 7, "args": {"correlation": 4}},
        {"cat": "cpu_op", "name": "aten::add", "ts": 40, "dur": 1, "tid": 1},
    ]
    assert device_launches(events, 2) == {"kernels": 1.0, "copies": 0.5, "fills": 0.5}
