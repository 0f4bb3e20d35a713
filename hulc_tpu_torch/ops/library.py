"""The serving path's four hand kernels as ``torch.library`` ops (``hulc::``).

Each op has a CPU implementation (the kernel's plain PyTorch version), a
CUDA implementation (the kernel, launched through ``kernels.py``) and a
fake implementation (the output's shape and type, for tracing). The device
choice is the dispatcher's: the wrappers (``ops.image_ops.preprocess_rgb_seq``,
``ops.spatial_softmax.spatial_softmax``, ``ops.logistic_mixture.sample_action``,
``ops.recurrence.rnn_relu_fwd``, ``rnn_gru_fwd``, ``rnn_lstm_fwd``) call the op whatever the device, and a
CUDA tensor launches the kernel or raises. ``torch.export`` keeps each op
as one graph node, so an exported policy (``serving.export``) holds the
kernels themselves and not their plain versions; loaded on the card, it
launches them. ``ops/__init__.py`` imports this module, so the ops are
registered before any of those wrappers runs.

| op | replaces (hulc_tpu) | kernel |
|---|---|---|
| ``hulc::preprocess_rgb`` | ``ops/image_ops.py:85`` (B.1) | ``csrc/preprocess.cu`` |
| ``hulc::spatial_softmax`` | ``models/vision.py:38`` forward (B.2) | ``csrc/spatial_softmax.cu`` |
| ``hulc::sample_action`` | ``ops/logistic_mixture.py:114`` + ``models/decoders.py:157`` (B.3) | ``csrc/logistic_mixture.cu`` |
| ``hulc::rnn_relu_fwd`` | ``models/layers.py:233`` forward (B.6) | ``csrc/rnn.cu`` (the relu instance) |
| ``hulc::rnn_gru_fwd`` | ``models/layers.py:238`` forward (B.11) | ``csrc/rnn_gates.cu`` (the gru instance) |
| ``hulc::rnn_lstm_fwd`` | ``models/layers.py:248`` forward (B.12) | ``csrc/rnn_gates.cu`` (the lstm instance) |

``hulc::spatial_softmax`` takes an fp32 or a bf16 map (a bf16 model's)
and gives fp32 keypoints either way, so a bf16 program holds it as the
same one node; its CUDA implementation launches the map's instance.
``hulc::preprocess_rgb`` writes fp32 only (serving preprocesses to fp32).

Launches are counted where they happen, in ``kernels.Kernel.__call__``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hulc_tpu_torch.ops import image_ops, logistic_mixture, recurrence, spatial_softmax

OPS = ("preprocess_rgb", "spatial_softmax", "sample_action", "rnn_relu_fwd", "rnn_gru_fwd", "rnn_lstm_fwd")


@torch.library.custom_op("hulc::preprocess_rgb", mutates_args=(), device_types="cpu")
def preprocess_rgb(imgs: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """(B, S, H, W, C) uint8 -> (B, S, C, H, W) fp32 ``(v / 255 - mean) / std``."""
    return image_ops.preprocess_rgb_seq_plain(imgs, mean, std)


@preprocess_rgb.register_kernel("cuda")
def _(imgs, mean, std):
    return image_ops.preprocess_rgb_seq_kernel(imgs, mean, std)


@preprocess_rgb.register_fake
def _(imgs, mean, std):
    b, s, h, w, c = imgs.shape
    return imgs.new_empty((b, s, c, h, w), dtype=torch.float32)


@torch.library.custom_op("hulc::spatial_softmax", mutates_args=(), device_types="cpu")
def spatial_softmax_fwd(x: torch.Tensor, temperature: Optional[torch.Tensor], fixed_temperature: float) -> torch.Tensor:
    """(N, C, H, W) fp32 or bf16 -> (N, 2C) fp32 keypoints at
    ``temperature`` (a learnable one-element tensor) or, when it is None, at
    ``fixed_temperature``."""
    return spatial_softmax.spatial_softmax_plain(x, fixed_temperature if temperature is None else temperature)


@spatial_softmax_fwd.register_kernel("cuda")
def _(x, temperature, fixed_temperature):
    return spatial_softmax.spatial_softmax_fwd_kernel(x, fixed_temperature if temperature is None else temperature)


@spatial_softmax_fwd.register_fake
def _(x, temperature, fixed_temperature):
    n, c = x.shape[:2]
    return x.new_empty((n, 2 * c), dtype=torch.float32)


@torch.library.custom_op("hulc::sample_action", mutates_args=(), device_types="cpu")
def sample_action(
    logit_probs: torch.Tensor, log_scales: torch.Tensor, means: torch.Tensor, u_mix: torch.Tensor,
    u_inv: torch.Tensor, gripper_logits: Optional[torch.Tensor], gripper_closed: float, gripper_open: float,
    u_lo: float, u_span: float,
) -> torch.Tensor:
    """(..., A, K) mixture parameters, uniforms mapped as u_lo + u_span * u,
    and optional (..., 2) gripper logits -> the (..., A [+ 1]) action."""
    return logistic_mixture.sample_action_plain(
        logit_probs, log_scales, means, u_mix, u_inv, gripper_logits, (gripper_closed, gripper_open), (u_lo, u_span)
    )


@sample_action.register_kernel("cuda")
def _(logit_probs, log_scales, means, u_mix, u_inv, gripper_logits, gripper_closed, gripper_open, u_lo, u_span):
    return logistic_mixture.sample_action_kernel(
        logit_probs, log_scales, means, u_mix, u_inv, gripper_logits, (gripper_closed, gripper_open), (u_lo, u_span)
    )


@sample_action.register_fake
def _(logit_probs, log_scales, means, u_mix, u_inv, gripper_logits, gripper_closed, gripper_open, u_lo, u_span):
    *lead, a, _ = logit_probs.shape
    return logit_probs.new_empty((*lead, a + (gripper_logits is not None)), dtype=torch.float32)


@torch.library.custom_op("hulc::rnn_relu_fwd", mutates_args=(), device_types="cpu")
def rnn_relu_fwd(
    xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One relu-RNN layer over the projected inputs: (y (B, S, H), y[:, -1]
    as its own (B, H) tensor; an op's outputs alias nothing)."""
    y = recurrence.rnn_relu_fwd_plain(xp, h0, w_hh, b_hh)
    return y, y[:, -1].clone()


@rnn_relu_fwd.register_kernel("cuda")
def _(xp, h0, w_hh, b_hh):
    return recurrence.rnn_relu_fwd_kernel(xp, h0, w_hh, b_hh)


@rnn_relu_fwd.register_fake
def _(xp, h0, w_hh, b_hh):
    b, _, h = xp.shape
    return xp.new_empty(xp.shape), xp.new_empty((b, h))


@torch.library.custom_op("hulc::rnn_gru_fwd", mutates_args=(), device_types="cpu")
def rnn_gru_fwd(
    xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gru layer's inference forward over the projected inputs (B, S,
    3H): (y (B, S, H), the final state as its own (B, H) tensor)."""
    y = recurrence.rnn_gru_fwd_plain(xp, h0, w_hh, b_hh)
    return y, y[:, -1].clone()


@rnn_gru_fwd.register_kernel("cuda")
def _(xp, h0, w_hh, b_hh):
    y, h_last, _ = recurrence.rnn_gru_fwd_kernel(xp, h0, w_hh, b_hh)
    return y, h_last


@rnn_gru_fwd.register_fake
def _(xp, h0, w_hh, b_hh):
    return xp.new_empty((*xp.shape[:2], h0.shape[1])), h0.new_empty(h0.shape)


@torch.library.custom_op("hulc::rnn_lstm_fwd", mutates_args=(), device_types="cpu")
def rnn_lstm_fwd(
    xp: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One lstm layer's inference forward over the projected inputs (B, S,
    4H) from (h0, c0): (y (B, S, H), the final h and c (B, H))."""
    y, c = recurrence.rnn_lstm_fwd_plain(xp, h0, c0, w_hh, b_hh)
    return y, y[:, -1].clone(), c.clone()


@rnn_lstm_fwd.register_kernel("cuda")
def _(xp, h0, c0, w_hh, b_hh):
    y, h_last, c_last, _ = recurrence.rnn_lstm_fwd_kernel(xp, h0, c0, w_hh, b_hh)
    return y, h_last, c_last


@rnn_lstm_fwd.register_fake
def _(xp, h0, c0, w_hh, b_hh):
    return xp.new_empty((*xp.shape[:2], h0.shape[1])), h0.new_empty(h0.shape), c0.new_empty(c0.shape)
