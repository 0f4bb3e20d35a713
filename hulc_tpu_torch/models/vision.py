"""Per-camera CNN encoders (port of hulc_tpu/models/vision.py:28-191), NCHW.

* ``VisionNetworkStatic`` (static camera): three convolutions (8/4, 4/2,
  3/1, VALID), SpatialSoftmax keypoints, FC 512 -> visual_features,
  LayerNorm.
* ``NatureCNN`` (gripper camera): the same convolutions, an NCHW flatten,
  FC -> 128 -> 512 -> visual_features, LayerNorm.
* the ``clip`` and ``tactile`` kinds: frozen backbones with a trainable
  head (``models.clip``, ``models.tactile``).

The JAX package's first convolution is a space-to-depth rewrite for the
TPU's matrix unit; here it is a plain 8x8 stride-4 ``nn.Conv2d``, the same
math. SpatialSoftmax is ``ops.spatial_softmax.spatial_softmax``: a
``torch.autograd.Function`` whose forward is the ``hulc::spatial_softmax``
op (the hand-written kernel of ``csrc/spatial_softmax.cu`` on a CUDA
tensor, the plain version on a CPU tensor) and whose backward is the
backward kernel or its closed form, for a fixed or a learnable temperature
(the backward then also gives the temperature's gradient). Each encoder
takes JAX's options: ``use_sinusoid`` (the static encoder's keypoints as
``[x, sin x, cos x]``, so ``fc1`` reads three times as many), ``dropout``
after ``fc1``'s activation (module ``dropout``) and ``l2_normalize_output``
(``fc2``'s output over its fp32 norm before the LayerNorm).

In bf16 (``dtype``) the convolutions and the FC layers compute in bf16
(``layers.Conv2d`` / ``layers.Linear``), SpatialSoftmax reads the bf16 map
and gives fp32 keypoints (its kernels' bf16 instances), and the LayerNorm
runs on fp32 features (``fc2`` adds its bias in fp32, ``layers.Linear``'s
``fp32_out``), as the JAX package's encoders do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from hulc_tpu_torch.config import VisionEncoderConfig
from hulc_tpu_torch.models.layers import ACTIVATIONS, Conv2d, Dropout, Linear, l2_normalized
from hulc_tpu_torch.ops.spatial_softmax import (  # noqa: F401 (the encoder's SpatialSoftmax, and its kernels' callers)
    _aligned,
    spatial_softmax,
    spatial_softmax_bwd,
    spatial_softmax_bwd_plain,
    spatial_softmax_plain,
)


class SpatialSoftmax(nn.Module):
    """Expected (x, y) keypoint coordinates per channel.

    ``temperature=None`` makes it a learnable parameter (initialized to 1).
    ``use_kernels=False`` runs the plain version on any device; it exists
    to hold the kernel against it on the card.
    """

    def __init__(self, temperature: Optional[float] = 1.0, use_kernels: bool = True):
        super().__init__()
        self.use_kernels = use_kernels
        self.fixed_temperature = temperature
        if temperature is None:
            self.temperature = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        temp = self.temperature if self.fixed_temperature is None else self.fixed_temperature
        if self.use_kernels:
            return spatial_softmax(x, temp)
        return spatial_softmax_plain(x, temp)


def conv_tower(in_channels: int, activation: str, dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """The three VALID convolutions shared by both encoders, as the
    reference's ``conv_model.{0,2,4}``, in ``dtype``."""
    act = ACTIVATIONS[activation]
    return nn.Sequential(
        Conv2d(in_channels, 32, 8, stride=4, dtype=dtype), act(),
        Conv2d(32, 64, 4, stride=2, dtype=dtype), act(),
        Conv2d(64, 64, 3, stride=1, dtype=dtype), act(),
    )


def conv_tower_size(input_size: int) -> int:
    """Side of the conv tower's output map for a square input."""
    s = (input_size - 8) // 4 + 1
    s = (s - 4) // 2 + 1
    return s - 2


def head(x: torch.Tensor, fc1: nn.Module, dropout: Dropout, fc2: Linear, ln: nn.LayerNorm,
         l2_normalize: bool) -> torch.Tensor:
    """The encoders' FC head (JAX vision.py:164-166, 188-190): fc1 and its
    activation, dropout, fc2, the optional division by the fp32 norm, the
    LayerNorm."""
    x = fc2(dropout(fc1(x)))
    return ln(l2_normalized(x) if l2_normalize else x)


class VisionNetworkStatic(nn.Module):
    """Static-camera encoder: convs + SpatialSoftmax + FC head."""

    def __init__(self, cfg: VisionEncoderConfig, use_kernels: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        act = ACTIVATIONS[cfg.activation]
        self.cfg = cfg
        self.conv_model = conv_tower(cfg.num_channels, cfg.activation, dtype)
        self.spatial_softmax = SpatialSoftmax(cfg.spatial_softmax_temp, use_kernels)
        self.fc1 = nn.Sequential(Linear((3 if cfg.use_sinusoid else 1) * 2 * 64, 512, dtype), act())
        self.dropout = Dropout(cfg.dropout)
        self.fc2 = Linear(512, cfg.visual_features, dtype, fp32_out=True)
        self.ln = nn.LayerNorm(cfg.visual_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) preprocessed frames -> (N, visual_features) fp32."""
        x = self.spatial_softmax(self.conv_model(x))
        if self.cfg.use_sinusoid:
            x = torch.cat([x, torch.sin(x), torch.cos(x)], dim=-1)
        return head(x, self.fc1, self.dropout, self.fc2, self.ln, self.cfg.l2_normalize_output)


class NatureCNN(nn.Module):
    """Gripper-camera encoder: nature_cnn convs + NCHW flatten + FC head."""

    def __init__(self, cfg: VisionEncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        act = ACTIVATIONS[cfg.activation]
        self.l2_normalize = cfg.l2_normalize_output
        side = conv_tower_size(cfg.input_size)
        self.conv_model = nn.Sequential(
            *conv_tower(cfg.num_channels, cfg.activation, dtype),
            nn.Flatten(),
            Linear(64 * side * side, 128, dtype),
            act(),
        )
        self.fc1 = nn.Sequential(Linear(128, 512, dtype), act())
        self.dropout = Dropout(cfg.dropout)
        self.fc2 = Linear(512, cfg.visual_features, dtype, fp32_out=True)
        self.ln = nn.LayerNorm(cfg.visual_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return head(self.conv_model(x), self.fc1, self.dropout, self.fc2, self.ln, self.l2_normalize)


def make_vision_encoder(cfg: VisionEncoderConfig, use_kernels: bool = True,
                        dtype: torch.dtype = torch.float32) -> nn.Module:
    """The encoder of ``cfg.kind`` (JAX vision.py:194-210): the frozen CLIP
    image tower of ``cfg.clip_model`` (``models.clip.VisionClip``) and the
    frozen tactile ResNet18 (``models.tactile.TactileEncoder``) besides the
    two CNNs."""
    if cfg.kind == "spatial_softmax":
        return VisionNetworkStatic(cfg, use_kernels, dtype)
    if cfg.kind == "nature_cnn":
        return NatureCNN(cfg, dtype)
    if cfg.kind == "clip":
        from hulc_tpu_torch.models.clip import VisionClip

        return VisionClip(cfg.visual_features, cfg.clip_model, dtype)
    if cfg.kind == "tactile":
        from hulc_tpu_torch.models.tactile import TactileEncoder

        return TactileEncoder(cfg.visual_features, dtype)
    raise ValueError(f"unknown vision encoder kind {cfg.kind!r}")
