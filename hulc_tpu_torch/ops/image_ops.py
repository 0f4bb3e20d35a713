"""Camera-frame preprocessing (port of hulc_tpu/ops/image_ops.py:27-154).

``preprocess_rgb_seq`` turns a (B, S, H, W, C) uint8 batch into normalized
``(v / 255 - mean) / std`` in the layout ``nn.Conv2d`` reads,
(B, S, C, H, W): fp32, or bf16 for a bf16 model's training and validation
(``out_dtype``; JAX's ``out_dtype`` off the TPU: the fp32 normalize
rounded once). ``preprocess_rgb_seq_shift`` is the training branch: each
frame is first shifted by the DrQ-v2 random shift (an integer crop of the
replicate-padded frame, one (row, column) shift per frame in
``[0, 2 * pad]``), which is a clamped gather and exact on uint8. The shifts
are an input: ``draw_shifts`` draws them from a ``torch.Generator`` as the
JAX package draws them (``randint((B*S, 2), 0, 2*pad + 1)``), and tests
pass the shifts JAX drew. On a CUDA tensor each function launches its
hand-written kernel in ``csrc/preprocess.cu`` (which fuses the NHWC -> NCHW
transpose into the same pass); on a CPU tensor it runs the plain version.
The eval branch does so as the ``hulc::preprocess_rgb`` op
(``ops.library``), which ``torch.export`` keeps as one node.
Both kernels normalize through ``normalize_table``, the plain version's own
result for each of the 256 byte values in the output's type, so they are
bit-equal to it; each has an fp32 and a bf16 instance (B.14). The
``hulc::preprocess_rgb`` op is fp32 only: serving preprocesses to fp32, as
JAX's policies do.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from hulc_tpu_torch import kernels


def _normalize_plain(imgs: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    x = imgs.to(torch.float32) * (1.0 / 255.0)
    return (x - mean) / std


def preprocess_rgb_seq_plain(
    imgs: torch.Tensor, mean: float = 0.5, std: float = 0.5, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain PyTorch version: the JAX order of operations, one cast to
    ``out_dtype``, then NCHW."""
    return _normalize_plain(imgs, mean, std).to(out_dtype).permute(0, 1, 4, 2, 3).contiguous()


# the kernels of each output type: (eval, train)
_KERNELS = {
    torch.float32: (kernels.PREPROCESS_RGB, kernels.PREPROCESS_RGB_SHIFT),
    torch.bfloat16: (kernels.PREPROCESS_RGB_BF16, kernels.PREPROCESS_RGB_SHIFT_BF16),
}


def _kernels_for(out_dtype: torch.dtype):
    if out_dtype not in _KERNELS:
        raise TypeError(f"the preprocess kernels write float32 or bfloat16, not {out_dtype}")
    return _KERNELS[out_dtype]


@functools.cache
def normalize_table(mean: float, std: float, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(256,) ``dtype`` on ``device``: the plain normalize of every byte
    value, computed on the CPU, where the divide by ``std`` is a true divide
    (on CUDA a divide by a Python scalar runs as a multiply by its
    reciprocal), then rounded once to ``dtype``."""
    return _normalize_plain(torch.arange(256, dtype=torch.uint8), mean, std).to(dtype).to(device)


def preprocess_rgb_seq(
    imgs: torch.Tensor, mean: float = 0.5, std: float = 0.5, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, S, H, W, C) uint8 -> (B, S, C, H, W) ``out_dtype`` in [-1, 1]:
    fp32 through the ``hulc::preprocess_rgb`` op; bf16 through the bf16
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if out_dtype == torch.float32:
        return torch.ops.hulc.preprocess_rgb(imgs, float(mean), float(std))
    if imgs.device.type == "cpu":
        return preprocess_rgb_seq_plain(imgs, mean, std, out_dtype)
    return preprocess_rgb_seq_kernel(imgs, mean, std, out_dtype)


def preprocess_rgb_seq_kernel(
    imgs: torch.Tensor, mean: float, std: float, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The eval preprocess kernel (its ``out_dtype`` instance) on a CUDA tensor."""
    kernel = _kernels_for(out_dtype)[0]
    kernels.require_cuda_tensor("imgs", imgs, torch.uint8, 5)
    b, s, h, w, c = imgs.shape
    if c != 3:
        raise ValueError(f"the eval preprocess kernel takes RGB frames (C = 3), got C = {c}")
    table = normalize_table(float(mean), float(std), imgs.device, out_dtype)
    out = torch.empty((b, s, c, h, w), dtype=out_dtype, device=imgs.device)
    kernel(imgs.device, imgs.data_ptr(), table.data_ptr(), out.data_ptr(), b * s, h, w, c)
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
    imgs: torch.Tensor, shifts: torch.Tensor, pad: int, mean: float = 0.5, std: float = 0.5,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the training branch: shift, then normalize."""
    b, s = imgs.shape[:2]
    shifted = random_shift_plain(imgs.reshape((b * s,) + imgs.shape[2:]), shifts, pad)
    return preprocess_rgb_seq_plain(shifted.reshape(imgs.shape), mean, std, out_dtype)


def preprocess_rgb_seq_shift(
    imgs: torch.Tensor, shifts: torch.Tensor, pad: int, mean: float = 0.5, std: float = 0.5,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, S, H, W, C) uint8 and (B*S, 2) shifts -> (B, S, C, H, W) ``out_dtype``."""
    b, s, h, w, c = imgs.shape
    if shifts.shape != (b * s, 2):
        raise ValueError(f"shifts has shape {tuple(shifts.shape)}, expected {(b * s, 2)}")
    if h != w:
        raise ValueError(f"random_shift requires square frames (got {h}x{w})")
    if imgs.device.type == "cpu":
        return preprocess_rgb_seq_shift_plain(imgs, shifts, pad, mean, std, out_dtype)
    kernel = _kernels_for(out_dtype)[1]
    kernels.require_cuda_tensor("imgs", imgs, torch.uint8, 5)
    shifts = shifts.to(device=imgs.device, dtype=torch.int32).contiguous()
    table = normalize_table(float(mean), float(std), imgs.device, out_dtype)
    out = torch.empty((b, s, c, h, w), dtype=out_dtype, device=imgs.device)
    kernel(
        imgs.device, imgs.data_ptr(), shifts.data_ptr(), table.data_ptr(), out.data_ptr(), b * s, h, w, c,
        int(pad),
    )
    return out
