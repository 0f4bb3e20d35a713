"""The trace readers of hulc_tpu_torch.training.profile_train, on the CPU:
host-to-device copies split by source memory and by issuing function, and
the decoder RNN's recurrent addmm told apart from the other matmuls."""

import json
import pathlib

import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from hulc_tpu_torch.models.layers import MLP, ScanRNN
from hulc_tpu_torch.training.profile_train import h2d_sites, recurrence_split

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
    """A 2-layer ScanRNN over 3 steps between two Linear stacks: 6 recurrent
    addmm (batch 4, hidden 8) and their 6 backward nodes, none of the
    input projections' or the MLPs'. The CPU runs no device kernel."""
    gen = torch.Generator().manual_seed(0)
    rnn, head = ScanRNN(6, 8, 2), MLP(8, [8, 8])
    mlp_in = MLP(5, [6])
    for p in [*rnn.parameters(), *head.parameters(), *mlp_in.parameters()]:
        nn.init.normal_(p, std=0.1, generator=gen)
    x = torch.randn(4, 3, 5, generator=gen)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True, with_stack=True) as prof:
        y, _ = rnn(mlp_in(x))
        head(y).sum().backward()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    split = recurrence_split(json.loads(path.read_text())["traceEvents"], 1)
    assert split["forward"]["calls_per_step"] == 6 and split["backward"]["calls_per_step"] == 6
    assert split["forward"]["input_dims"] == [json.dumps([[8], [4, 8], [8, 8], [], []])]
    assert split["forward"]["device_ms_per_step"] == 0 and split["backward"]["matmul_ms_per_step"] == 0
    assert split["matmul_ms_per_step"] == 0 and split["share_of_matmuls"] is None


def _launch(cat, corr, tid, ts, kernel, dur):
    """A launch call on the host and the kernel it ran."""
    return [
        {"cat": cat, "name": "cuLaunchKernel", "ts": ts, "dur": 2, "tid": tid, "args": {"correlation": corr}},
        {"cat": "kernel", "name": kernel, "ts": ts + 10, "dur": dur, "tid": 7, "args": {"correlation": corr}},
    ]


def test_recurrence_split_times_what_the_ops_launched():
    """Device time goes to the op whose span holds the launch, through the
    runtime or the driver (cuBLAS); only gemm kernels count as matmuls."""
    def op(name, ts, dur, tid=1, seq=None):
        return {"cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "tid": tid,
                "args": {"Sequence number": seq, "Input Dims": [[8], [4, 8], [8, 8], [], []]}}

    events = [
        {"cat": "python_function", "name": "nn.Module: ScanRNN_0", "ts": 0, "dur": 100, "tid": 1},
        op("aten::linear", 5, 20), op("aten::addmm", 6, 18, seq=1),  # the input projection
        *_launch("cuda_driver", 1, 1, 8, "sm90_xmma_gemm_f32f32_proj", 40),
        op("aten::addmm", 40, 10, seq=2),  # a recurrent step
        *_launch("cuda_driver", 2, 1, 42, "sm90_xmma_gemm_f32f32_rec", 30),
        *_launch("cuda_runtime", 3, 1, 45, "elementwise_copy_bias", 5),
        op("aten::addmm", 200, 10, seq=3),  # outside the RNN
        *_launch("cuda_driver", 4, 1, 202, "sm90_xmma_gemm_f32f32_head", 50),
        op("autograd::engine::evaluate_function: AddmmBackward0", 300, 30, tid=2, seq=2),
        *_launch("cuda_driver", 5, 2, 305, "sm90_xmma_gemm_f32f32_grad_input", 60),
        *_launch("cuda_runtime", 6, 2, 310, "reduce_bias_grad", 8),
        op("autograd::engine::evaluate_function: AddmmBackward0", 400, 30, tid=2, seq=3),
        *_launch("cuda_driver", 7, 2, 405, "sm90_xmma_gemm_f32f32_other", 70),
    ]
    split = recurrence_split(events, 1)
    assert split["forward"]["calls_per_step"] == 1 and split["backward"]["calls_per_step"] == 1
    assert split["forward"]["device_ms_per_step"] == 35 / 1e3 and split["forward"]["matmul_ms_per_step"] == 30 / 1e3
    assert split["backward"]["device_ms_per_step"] == 68 / 1e3 and split["backward"]["matmul_ms_per_step"] == 60 / 1e3
    assert split["matmul_ms_per_step"] == 250 / 1e3 and split["share_of_matmuls"] == 90 / 250
