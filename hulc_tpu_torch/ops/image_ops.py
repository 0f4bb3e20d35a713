"""Camera-frame preprocessing (port of hulc_tpu/ops/image_ops.py, eval branch).

``preprocess_rgb_seq`` turns a (B, S, H, W, C) uint8 batch into normalized
fp32 ``(v / 255 - mean) / std`` in the layout ``nn.Conv2d`` reads,
(B, S, C, H, W). On a CUDA tensor it launches the hand-written kernel
``csrc/preprocess.cu`` (which fuses the NHWC -> NCHW transpose into the
same pass); on a CPU tensor it runs the plain version. The training-time
random shift waits for the training slice.
"""

from __future__ import annotations

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
