"""SpatialSoftmax keypoints, forward and backward (port of
hulc_tpu/models/vision.py:38-73).

``spatial_softmax`` is a ``torch.autograd.Function`` on any device: its
forward is the ``hulc::spatial_softmax`` op (``ops.library``), which runs
the hand-written kernel of ``csrc/spatial_softmax.cu`` on a CUDA tensor and
``spatial_softmax_plain`` on a CPU tensor, and its backward is
``spatial_softmax_bwd``: the backward kernel on a CUDA tensor, the closed
form ``spatial_softmax_bwd_plain`` on a CPU tensor. The temperature is a
float or a learnable one-element tensor; the backward then also gives its
gradient. ``models/vision.py`` builds the encoder on these.

The map is fp32, or bf16 in a bf16 model (B.14): the keypoints are fp32
either way (JAX computes on ``x.astype(float32)``), and the gradient to a
bf16 map is the fp32 one rounded once to bf16 (the transpose of that
convert). Each kernel has an fp32 and a bf16 instance.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from hulc_tpu_torch import kernels


def spatial_softmax_plain(x: torch.Tensor, temperature: Union[float, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch SpatialSoftmax: (N, C, H, W) -> (N, 2C) interleaved
    (x_0, y_0, x_1, y_1, ...) fp32, from an fp32 or a bf16 map; x is
    weighted by the row index, y by the column index (the reference's
    square-grid quirk)."""
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


# the kernels of each map type: (forward, backward)
_KERNELS = {
    torch.float32: (kernels.SPATIAL_SOFTMAX, kernels.SPATIAL_SOFTMAX_BWD),
    torch.bfloat16: (kernels.SPATIAL_SOFTMAX_BF16, kernels.SPATIAL_SOFTMAX_BWD_BF16),
}


def _kernels_for(x: torch.Tensor):
    """The fp32 or bf16 instances for a CUDA map ``x`` (checked)."""
    if x.dtype not in _KERNELS:
        raise TypeError(f"x must be torch.float32 or torch.bfloat16, got {x.dtype}")
    kernels.require_cuda_tensor("x", x, x.dtype, 4)
    return _KERNELS[x.dtype]


def spatial_softmax_fwd_kernel(x: torch.Tensor, temperature: Union[float, torch.Tensor]) -> torch.Tensor:
    """The forward kernel (the map's fp32 or bf16 instance) on a CUDA
    tensor; a tensor temperature is passed by its device pointer (no host
    sync)."""
    kernel = _kernels_for(x)[0]
    n, c, h, w = x.shape
    x = _aligned(x)
    if isinstance(temperature, torch.Tensor):
        kernels.require_cuda_tensor("temperature", temperature, torch.float32)
        temp_ptr, temp_value = temperature.data_ptr(), 1.0
    else:
        temp_ptr, temp_value = None, float(temperature)
    out = torch.empty((n, 2 * c), dtype=torch.float32, device=x.device)
    kernel(x.device, x.data_ptr(), out.data_ptr(), n, c, h, w, temp_ptr, temp_value)
    return out


def spatial_softmax_bwd_plain(
    x: torch.Tensor, grad_out: torch.Tensor, temperature: Union[float, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The closed form the backward kernel computes: with p the row's
    softmax and (E_x, E_y) its expectations,
    dx = p / T * (g_x * (lin_h[i] - E_x) + g_y * (lin_w[j] - E_y)) and
    dT = -(1/T) * sum(x * dx), in fp32. Returns (dx in x's type, rounded
    once, dT of shape (1,))."""
    n, c, h, w = x.shape
    dtype = x.dtype
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
    return dx.to(dtype), dtemp


def spatial_softmax_bwd(
    x: torch.Tensor, grad_out: torch.Tensor, temperature: Union[float, torch.Tensor]
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """d(out)/dx contracted with ``grad_out`` (N, 2C), in x's type, and, for a tensor
    ``temperature``, the temperature's gradient as a (1,) tensor (None for
    a float). On a CUDA tensor the backward kernel, the temperature passed
    by its device pointer (no host sync); on a CPU tensor the closed form."""
    if x.device.type == "cpu":
        dx, dtemp = spatial_softmax_bwd_plain(x, grad_out, temperature)
        return dx, dtemp if isinstance(temperature, torch.Tensor) else None
    n, c, h, w = x.shape
    kernel = _kernels_for(x)[1]
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
    kernel(
        x.device, x.data_ptr(), grad_out.data_ptr(), dx.data_ptr(),
        None if row_xdx is None else row_xdx.data_ptr(), None if dtemp is None else dtemp.data_ptr(),
        n, c, h, w, temp_ptr, temp_value,
    )
    return dx, dtemp


class _SpatialSoftmax(torch.autograd.Function):
    """Forward: the ``hulc::spatial_softmax`` op. Backward:
    ``spatial_softmax_bwd``; a tensor temperature gets its gradient too."""

    @staticmethod
    def forward(ctx, x, temperature):
        is_tensor = isinstance(temperature, torch.Tensor)
        ctx.save_for_backward(x, temperature if is_tensor else None)
        ctx.temperature = None if is_tensor else temperature
        return torch.ops.hulc.spatial_softmax(x, temperature if is_tensor else None,
                                              1.0 if is_tensor else temperature)

    @staticmethod
    def backward(ctx, grad_out):
        x, temp_tensor = ctx.saved_tensors
        temperature = ctx.temperature if temp_tensor is None else temp_tensor
        dx, dtemp = spatial_softmax_bwd(x, grad_out, temperature)
        if dtemp is not None:
            dtemp = dtemp.reshape(temp_tensor.shape)
        return dx, dtemp


def spatial_softmax(x: torch.Tensor, temperature: Union[float, torch.Tensor]) -> torch.Tensor:
    """SpatialSoftmax through the ``hulc::spatial_softmax`` op, differentiable
    in x and a tensor temperature; ``temperature`` is a float or a
    learnable one-element tensor on x's device."""
    h, w = x.shape[-2:]
    if h != w:
        raise ValueError(f"SpatialSoftmax requires a square feature map (got {h}x{w})")
    if not isinstance(temperature, torch.Tensor):
        temperature = float(temperature)
    return _SpatialSoftmax.apply(x, temperature)
