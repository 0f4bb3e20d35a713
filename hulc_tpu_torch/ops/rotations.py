"""Euler-angle rotation math in fp32 (port of hulc_tpu/ops/rotations.py:26-100).

Only the two conversions the policy's frame transforms use. Like the JAX
package, the asin/acos argument is clamped so near-gimbal inputs stay
finite instead of falling back through a quaternion round trip.
"""

from __future__ import annotations

import torch

_AXES = {"X": 0, "Y": 1, "Z": 2}


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrix about a principal axis. angle: (...,) -> (..., 3, 3)."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    one = torch.ones_like(angle)
    zero = torch.zeros_like(angle)
    if axis == "X":
        rows = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        rows = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        rows = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis}")
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(a not in _AXES for a in convention):
        raise ValueError(f"invalid convention {convention}")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrices R_c0(a0) @ R_c1(a1) @ R_c2(a2)."""
    _check_convention(convention)
    euler_angles = euler_angles.float()
    m0 = _axis_rotation(convention[0], euler_angles[..., 0])
    m1 = _axis_rotation(convention[1], euler_angles[..., 1])
    m2 = _axis_rotation(convention[2], euler_angles[..., 2])
    return m0 @ m1 @ m2


def _angle_from_tan(
    axis: str, other_axis: str, data: torch.Tensor, horizontal: bool, tait_bryan: bool
) -> torch.Tensor:
    """The first or third Euler angle from a matrix row or column."""
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = axis + other_axis in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> Euler angles (..., 3), clamped asin/acos."""
    _check_convention(convention)
    matrix = matrix.float()
    i0 = _AXES[convention[0]]
    i2 = _AXES[convention[2]]
    tait_bryan = i0 != i2
    eps = 1e-7
    if tait_bryan:
        sign = -1.0 if i0 - i2 in (-1, 2) else 1.0
        central = torch.asin(torch.clamp(matrix[..., i0, i2] * sign, -1.0 + eps, 1.0 - eps))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1.0 + eps, 1.0 - eps))
    a0 = _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan)
    a2 = _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan)
    return torch.stack([a0, central, a2], dim=-1)
