"""Camera-frame preprocessing (port of hulc_tpu/ops/image_ops.py:27-154).

``preprocess_rgb_seq`` turns a (B, S, H, W, C) uint8 batch into normalized
fp32 ``(v / 255 - mean) / std`` in the layout ``nn.Conv2d`` reads,
(B, S, C, H, W). ``preprocess_rgb_seq_shift`` is the training branch: each
frame is first shifted by the DrQ-v2 random shift (an integer crop of the
replicate-padded frame, one (row, column) shift per frame in
``[0, 2 * pad]``), which is a clamped gather and exact on uint8. The shifts
are an input: ``draw_shifts`` draws them from a ``torch.Generator`` as the
JAX package draws them (``randint((B*S, 2), 0, 2*pad + 1)``), and tests
pass the shifts JAX drew. On a CUDA tensor each function launches its
hand-written kernel in ``csrc/preprocess.cu`` (which fuses the NHWC -> NCHW
transpose into the same pass); on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from hulc_tpu_torch import kernels


def preprocess_rgb_seq_plain(imgs: torch.Tensor, mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: the JAX order of operations, then NCHW."""
    x = imgs.to(torch.float32) * (1.0 / 255.0)
    x = (x - mean) / std
    return x.permute(0, 1, 4, 2, 3).contiguous()


def preprocess_rgb_seq(imgs: torch.Tensor, mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """(B, S, H, W, C) uint8 -> (B, S, C, H, W) fp32 in [-1, 1]."""
    if imgs.device.type == "cpu":
        return preprocess_rgb_seq_plain(imgs, mean, std)
    kernels.require_cuda_tensor("imgs", imgs, torch.uint8, 5)
    b, s, h, w, c = imgs.shape
    out = torch.empty((b, s, c, h, w), dtype=torch.float32, device=imgs.device)
    kernels.PREPROCESS_RGB(
        imgs.device, imgs.data_ptr(), out.data_ptr(), b * s, h, w, c, float(mean), float(std)
    )
    return out


def draw_shifts(n: int, pad: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """(n, 2) int32 (row, column) shifts in [0, 2 * pad], one per frame."""
    return torch.randint(0, 2 * pad + 1, (n, 2), generator=generator, device=device, dtype=torch.int32)


def random_shift_plain(imgs: torch.Tensor, shifts: torch.Tensor, pad: int) -> torch.Tensor:
    """(N, H, W, C) frames cropped at ``shifts`` from their replicate-padded
    copy: out[n, y, x] = imgs[n, clip(s_r + y - pad), clip(s_c + x - pad)]."""
    n, h, w, _ = imgs.shape
    shifts = shifts.to(device=imgs.device, dtype=torch.long)
    rows = (shifts[:, :1] + torch.arange(h, device=imgs.device) - pad).clamp(0, h - 1)
    cols = (shifts[:, 1:] + torch.arange(w, device=imgs.device) - pad).clamp(0, w - 1)
    batch = torch.arange(n, device=imgs.device)[:, None, None]
    return imgs[batch, rows[:, :, None], cols[:, None, :]]


def preprocess_rgb_seq_shift_plain(
    imgs: torch.Tensor, shifts: torch.Tensor, pad: int, mean: float = 0.5, std: float = 0.5
) -> torch.Tensor:
    """Plain PyTorch version of the training branch: shift, then normalize."""
    b, s = imgs.shape[:2]
    shifted = random_shift_plain(imgs.reshape((b * s,) + imgs.shape[2:]), shifts, pad)
    return preprocess_rgb_seq_plain(shifted.reshape(imgs.shape), mean, std)


def preprocess_rgb_seq_shift(
    imgs: torch.Tensor, shifts: torch.Tensor, pad: int, mean: float = 0.5, std: float = 0.5
) -> torch.Tensor:
    """(B, S, H, W, C) uint8 and (B*S, 2) shifts -> (B, S, C, H, W) fp32."""
    b, s, h, w, c = imgs.shape
    if shifts.shape != (b * s, 2):
        raise ValueError(f"shifts has shape {tuple(shifts.shape)}, expected {(b * s, 2)}")
    if h != w:
        raise ValueError(f"random_shift requires square frames (got {h}x{w})")
    if imgs.device.type == "cpu":
        return preprocess_rgb_seq_shift_plain(imgs, shifts, pad, mean, std)
    kernels.require_cuda_tensor("imgs", imgs, torch.uint8, 5)
    shifts = shifts.to(device=imgs.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, s, c, h, w), dtype=torch.float32, device=imgs.device)
    kernels.PREPROCESS_RGB_SHIFT(
        imgs.device, imgs.data_ptr(), shifts.data_ptr(), out.data_ptr(), b * s, h, w, c, int(pad),
        float(mean), float(std),
    )
    return out
