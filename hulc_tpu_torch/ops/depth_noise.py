"""Training noise on depth frames (port of hulc_tpu/training/preprocess.py:58-80).

The reference augments depth only while training: ``AddDepthNoise(1000,
1000)`` on the static camera, a multiplicative Gamma(1000) / 1000 draw per
pixel, and ``AddGaussianNoise(0.01)`` on the gripper camera. The JAX
package replaces the Gamma draw by its Wilson-Hilferty form on one
standard-normal draw ``z``,

    gamma:    y = x * (1 - c + z * sqrt(c)) ** 3,  c = 1 / 9000
    gaussian: y = x + std * z

and ``prep_depth`` computes exactly that from the raw draw ``z``, which
the caller draws (``torch.randn``) or passes, as the tests pass the
draw JAX made. The constants round as JAX rounds them: ``c`` from a
Python double to fp32, ``sqrt(c)`` an fp32 square root of that fp32 ``c``,
``1 - c`` a double rounded to fp32; the cube is ``m * (m * m)``, as
``lax.integer_pow`` expands it. On a CUDA tensor ``prep_depth`` launches
the hand-written kernel in ``csrc/depth_noise.cu`` (one elementwise pass,
each product and sum rounded on its own, so it is bit-equal to the plain
version); on a CPU tensor it runs ``prep_depth_plain``. Depth is an input:
nothing takes a gradient through the noise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hulc_tpu_torch import kernels
from hulc_tpu_torch.ops.spatial_softmax import _aligned

GAMMA_K = 1000.0  # reference AddDepthNoise(shape=1000, rate=1000)
_C = np.float32(1.0 / (9.0 * GAMMA_K))
GAMMA_SCALE = float(np.sqrt(_C))  # fp32 sqrt of the fp32 c
GAMMA_SHIFT = float(np.float32(1.0 - 1.0 / (9.0 * GAMMA_K)))  # the double 1 - c, rounded once
MODES = {"gamma": 0, "gaussian": 1}


def _mode_constant(mode: str, std: float) -> float:
    if mode not in MODES:
        raise ValueError(f"depth noise mode {mode!r}: expected one of {sorted(MODES)}")
    if mode == "gaussian" and not std > 0.0:
        raise ValueError(f"the gaussian depth noise needs a positive std, got {std}")
    return float(np.float32(std))


def prep_depth_plain(x: torch.Tensor, z: torch.Tensor, mode: str, std: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version, one eager op per rounding of the JAX form."""
    std32 = _mode_constant(mode, std)
    x = x.to(torch.float32)
    if mode == "gaussian":
        return x + z * std32
    m = z * GAMMA_SCALE + GAMMA_SHIFT
    return x * (m * (m * m))


def prep_depth(
    x: torch.Tensor, z: torch.Tensor, mode: str, std: float = 0.0, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(B, S, H, W) depth frames and the raw draw ``z`` of their shape ->
    the noised fp32 frames. ``mode`` is ``"gamma"`` (static camera) or
    ``"gaussian"`` with ``std`` (gripper camera). ``out`` may be ``z`` itself
    (a fresh draw, read once per element before it is written), never ``x``."""
    std32 = _mode_constant(mode, std)
    if z.requires_grad:
        raise ValueError("the depth noise takes no gradient: pass a draw that does not require one")
    if z.shape != x.shape:
        raise ValueError(f"the draw has shape {tuple(z.shape)}, the frames {tuple(x.shape)}")
    if out is not None and out.data_ptr() == x.data_ptr():
        raise ValueError("the depth noise must not write over the frames it reads")
    if x.device.type == "cpu":
        y = prep_depth_plain(x, z, mode, std)
        return y if out is None else out.copy_(y)
    x = _aligned(x.to(torch.float32).contiguous())  # the kernel's float4 accesses
    kernels.require_cuda_tensor("z", z, torch.float32)
    if out is None or out.data_ptr() != z.data_ptr():
        z = _aligned(z.contiguous())
    if out is None:
        out = torch.empty_like(x)
    kernels.require_cuda_tensor("out", out, torch.float32)
    if out.shape != x.shape or out.data_ptr() % 16 != 0 or z.data_ptr() % 16 != 0:
        raise ValueError("out must be an aligned contiguous fp32 tensor of the frames' shape")
    a, b = (GAMMA_SHIFT, GAMMA_SCALE) if mode == "gamma" else (0.0, std32)
    kernels.DEPTH_NOISE(x.device, x.data_ptr(), z.data_ptr(), out.data_ptr(), x.numel(), MODES[mode], a, b)
    return out
