"""Per-camera CNN encoders (port of hulc_tpu/models/vision.py:28-191), NCHW.

* ``VisionNetworkStatic`` (static camera): three convolutions (8/4, 4/2,
  3/1, VALID), SpatialSoftmax keypoints, FC 512 -> visual_features,
  LayerNorm.
* ``NatureCNN`` (gripper camera): the same convolutions, an NCHW flatten,
  FC -> 128 -> 512 -> visual_features, LayerNorm.

The JAX package's first convolution is a space-to-depth rewrite for the
TPU's matrix unit; here it is a plain 8x8 stride-4 ``nn.Conv2d``, the same
math. On CUDA tensors SpatialSoftmax is a ``torch.autograd.Function``
whose forward and backward are the hand-written kernels of
``csrc/spatial_softmax.cu``, for a fixed or a learnable temperature (the
backward then also gives the temperature's gradient); on CPU tensors it is
the plain version below, differentiated by autograd.
``spatial_softmax_bwd_plain`` is the closed form the backward kernel
computes. The encoders' dropout, the sinusoid and the L2-normalized
outputs, which no ported preset uses, are not ported yet: a config that
sets them is refused.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from hulc_tpu_torch import kernels
from hulc_tpu_torch.config import VisionEncoderConfig
from hulc_tpu_torch.models.layers import ACTIVATIONS


def spatial_softmax_plain(x: torch.Tensor, temperature: Union[float, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch SpatialSoftmax: (N, C, H, W) -> (N, 2C) interleaved
    (x_0, y_0, x_1, y_1, ...); x is weighted by the row index, y by the
    column index (the reference's square-grid quirk)."""
    n, c, h, w = x.shape
    z = x.float() / temperature
    e = torch.exp(z - z.amax(dim=(2, 3), keepdim=True).detach())
    s = e.sum(dim=(2, 3))
    lin_h = torch.linspace(-1.0, 1.0, h, device=x.device)
    lin_w = torch.linspace(-1.0, 1.0, w, device=x.device)
    expected_x = (e * lin_h[:, None]).sum(dim=(2, 3)) / s
    expected_y = (e * lin_w[None, :]).sum(dim=(2, 3)) / s
    return torch.stack([expected_x, expected_y], dim=-1).reshape(n, 2 * c)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when it starts 16-byte aligned, as the kernels' 16-byte
    loads need, else a copy in a fresh buffer (the caching allocator aligns
    it); ``.contiguous()`` would hand back a contiguous view unchanged."""
    return x if x.data_ptr() % 16 == 0 else x.clone(memory_format=torch.contiguous_format)


def _spatial_softmax_fwd(x: torch.Tensor, temperature: Union[float, torch.Tensor]) -> torch.Tensor:
    n, c, h, w = x.shape
    x = _aligned(x)
    if isinstance(temperature, torch.Tensor):
        kernels.require_cuda_tensor("temperature", temperature, torch.float32)
        temp_ptr, temp_value = temperature.data_ptr(), 1.0
    else:
        temp_ptr, temp_value = None, float(temperature)
    out = torch.empty((n, 2 * c), dtype=torch.float32, device=x.device)
    kernels.SPATIAL_SOFTMAX(x.device, x.data_ptr(), out.data_ptr(), n, c, h, w, temp_ptr, temp_value)
    return out


def spatial_softmax_bwd_plain(
    x: torch.Tensor, grad_out: torch.Tensor, temperature: Union[float, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The closed form the backward kernel computes: with p the row's
    softmax and (E_x, E_y) its expectations,
    dx = p / T * (g_x * (lin_h[i] - E_x) + g_y * (lin_w[j] - E_y)) and
    dT = -(1/T) * sum(x * dx). Returns (dx, dT of shape (1,))."""
    n, c, h, w = x.shape
    x = x.detach().float()
    z = x / temperature
    e = torch.exp(z - z.amax(dim=(2, 3), keepdim=True))
    s = e.sum(dim=(2, 3), keepdim=True)
    lin_h = torch.linspace(-1.0, 1.0, h, device=x.device)[:, None]
    lin_w = torch.linspace(-1.0, 1.0, w, device=x.device)[None, :]
    ex = (e * lin_h).sum(dim=(2, 3), keepdim=True) / s
    ey = (e * lin_w).sum(dim=(2, 3), keepdim=True) / s
    g = grad_out.detach().float().reshape(n, c, 2, 1, 1)
    dx = e / s * (g[:, :, 0] * (lin_h - ex) + g[:, :, 1] * (lin_w - ey)) / temperature
    dtemp = -(x * dx).sum().reshape(1) / temperature
    return dx, dtemp


def spatial_softmax_bwd(
    x: torch.Tensor, grad_out: torch.Tensor, temperature: Union[float, torch.Tensor]
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward kernel: d(out)/dx contracted with ``grad_out`` (N, 2C),
    and, for a tensor ``temperature``, the temperature's gradient as a (1,)
    tensor (None for a float). The temperature is passed by its device
    pointer: no host sync."""
    n, c, h, w = x.shape
    kernels.require_cuda_tensor("x", x, torch.float32, 4)
    x = _aligned(x)
    grad_out = grad_out.float().contiguous()
    kernels.require_cuda_tensor("grad_out", grad_out, torch.float32, 2)
    if grad_out.shape != (n, 2 * c):
        raise ValueError(f"grad_out has shape {tuple(grad_out.shape)}, expected {(n, 2 * c)}")
    dx = torch.empty_like(x)
    row_xdx = dtemp = None
    if isinstance(temperature, torch.Tensor):
        kernels.require_cuda_tensor("temperature", temperature, torch.float32)
        temp_ptr, temp_value = temperature.data_ptr(), 1.0
        row_xdx = torch.empty(n * c, dtype=torch.float32, device=x.device)
        dtemp = torch.empty(1, dtype=torch.float32, device=x.device)
    else:
        temp_ptr, temp_value = None, float(temperature)
    kernels.SPATIAL_SOFTMAX_BWD(
        x.device, x.data_ptr(), grad_out.data_ptr(), dx.data_ptr(),
        None if row_xdx is None else row_xdx.data_ptr(), None if dtemp is None else dtemp.data_ptr(),
        n, c, h, w, temp_ptr, temp_value,
    )
    return dx, dtemp


class _SpatialSoftmax(torch.autograd.Function):
    """Forward and backward kernels of csrc/spatial_softmax.cu; a tensor
    temperature gets its gradient too."""

    @staticmethod
    def forward(ctx, x, temperature):
        is_tensor = isinstance(temperature, torch.Tensor)
        ctx.save_for_backward(x, temperature if is_tensor else None)
        ctx.temperature = None if is_tensor else temperature
        return _spatial_softmax_fwd(x, temperature)

    @staticmethod
    def backward(ctx, grad_out):
        x, temp_tensor = ctx.saved_tensors
        temperature = ctx.temperature if temp_tensor is None else temp_tensor
        dx, dtemp = spatial_softmax_bwd(x, grad_out, temperature)
        if dtemp is not None:
            dtemp = dtemp.reshape(temp_tensor.shape)
        return dx, dtemp


def spatial_softmax(x: torch.Tensor, temperature: Union[float, torch.Tensor]) -> torch.Tensor:
    """SpatialSoftmax; ``temperature`` is a float or a learnable one-element
    tensor on x's device."""
    n, c, h, w = x.shape
    if h != w:
        raise ValueError(f"SpatialSoftmax requires a square feature map (got {h}x{w})")
    if x.device.type == "cpu":
        return spatial_softmax_plain(x, temperature)
    kernels.require_cuda_tensor("x", x, torch.float32, 4)
    if not isinstance(temperature, torch.Tensor):
        temperature = float(temperature)
    return _SpatialSoftmax.apply(x, temperature)


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


def conv_tower(in_channels: int, activation: str) -> nn.Sequential:
    """The three VALID convolutions shared by both encoders, as the
    reference's ``conv_model.{0,2,4}``."""
    act = ACTIVATIONS[activation]
    return nn.Sequential(
        nn.Conv2d(in_channels, 32, 8, stride=4), act(),
        nn.Conv2d(32, 64, 4, stride=2), act(),
        nn.Conv2d(64, 64, 3, stride=1), act(),
    )


def conv_tower_size(input_size: int) -> int:
    """Side of the conv tower's output map for a square input."""
    s = (input_size - 8) // 4 + 1
    s = (s - 4) // 2 + 1
    return s - 2


def _check_ported(cfg: VisionEncoderConfig) -> None:
    if cfg.use_sinusoid or cfg.l2_normalize_output or cfg.dropout > 0.0:
        raise ValueError("use_sinusoid, l2_normalize_output and encoder dropout are not ported yet")


class VisionNetworkStatic(nn.Module):
    """Static-camera encoder: convs + SpatialSoftmax + FC head."""

    def __init__(self, cfg: VisionEncoderConfig, use_kernels: bool = True):
        super().__init__()
        _check_ported(cfg)
        act = ACTIVATIONS[cfg.activation]
        self.conv_model = conv_tower(cfg.num_channels, cfg.activation)
        self.spatial_softmax = SpatialSoftmax(cfg.spatial_softmax_temp, use_kernels)
        self.fc1 = nn.Sequential(nn.Linear(2 * 64, 512), act())
        self.fc2 = nn.Linear(512, cfg.visual_features)
        self.ln = nn.LayerNorm(cfg.visual_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) preprocessed frames -> (N, visual_features)."""
        return self.ln(self.fc2(self.fc1(self.spatial_softmax(self.conv_model(x)))))


class NatureCNN(nn.Module):
    """Gripper-camera encoder: nature_cnn convs + NCHW flatten + FC head."""

    def __init__(self, cfg: VisionEncoderConfig):
        super().__init__()
        _check_ported(cfg)
        act = ACTIVATIONS[cfg.activation]
        side = conv_tower_size(cfg.input_size)
        self.conv_model = nn.Sequential(
            *conv_tower(cfg.num_channels, cfg.activation),
            nn.Flatten(),
            nn.Linear(64 * side * side, 128),
            act(),
        )
        self.fc1 = nn.Sequential(nn.Linear(128, 512), act())
        self.fc2 = nn.Linear(512, cfg.visual_features)
        self.ln = nn.LayerNorm(cfg.visual_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.fc2(self.fc1(self.conv_model(x))))


def make_vision_encoder(cfg: VisionEncoderConfig, use_kernels: bool = True) -> nn.Module:
    if cfg.kind == "spatial_softmax":
        return VisionNetworkStatic(cfg, use_kernels)
    if cfg.kind == "nature_cnn":
        return NatureCNN(cfg)
    raise ValueError(f"vision encoder kind {cfg.kind!r} is not ported yet")
