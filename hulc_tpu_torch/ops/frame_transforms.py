"""World <-> TCP (tool-center-point) frame conversion of relative actions
(port of hulc_tpu/ops/frame_transforms.py).

The decoder predicts relative end-effector actions in the gripper frame;
``tcp_to_world_frame`` rotates them back for the environment. Rotational
deltas are scaled by 0.01 before composing and by 100 after, so float
noise in the angles is amplified a hundredfold. All math is fp32, and the
inverse of a rotation is its transpose.
"""

from __future__ import annotations

import math

import torch

from hulc_tpu_torch.ops.rotations import euler_angles_to_matrix, matrix_to_euler_angles


def _wrap_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi] the way the reference does (two wheres)."""
    x = torch.where(x < -math.pi, x + 2 * math.pi, x)
    return torch.where(x > math.pi, x - 2 * math.pi, x)


def world_to_tcp_frame(action: torch.Tensor, robot_obs: torch.Tensor) -> torch.Tensor:
    """(..., 7) world-frame relative action -> TCP frame; robot_obs[..., 3:6]
    is the TCP orientation as XYZ Euler angles."""
    action = action.float()
    tcp_orn = robot_obs.float()[..., 3:6]
    world_T_tcp = euler_angles_to_matrix(tcp_orn, "XYZ")
    tcp_T_world = world_T_tcp.transpose(-1, -2)
    pos_tcp_rel = torch.einsum("...ij,...j->...i", tcp_T_world, action[..., :3])
    orn_w_rel = action[..., 3:6] * 0.01
    world_T_tcp_new = euler_angles_to_matrix(tcp_orn + orn_w_rel, "XYZ")
    tcp_new_T_tcp_old = world_T_tcp_new.transpose(-1, -2) @ world_T_tcp
    orn_tcp_rel = _wrap_angle(matrix_to_euler_angles(tcp_new_T_tcp_old, "XYZ")) * 100.0
    return torch.cat([pos_tcp_rel, orn_tcp_rel, action[..., 6:7]], dim=-1)


def tcp_to_world_frame(action: torch.Tensor, robot_obs: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`world_to_tcp_frame`."""
    action = action.float()
    tcp_orn = robot_obs.float()[..., 3:6]
    world_T_tcp = euler_angles_to_matrix(tcp_orn, "XYZ")
    pos_w_rel = torch.einsum("...ij,...j->...i", world_T_tcp, action[..., :3])
    orn_tcp_rel = action[..., 3:6] * 0.01
    tcp_new_T_tcp_old = euler_angles_to_matrix(orn_tcp_rel, "XYZ")
    world_T_tcp_new = world_T_tcp @ tcp_new_T_tcp_old.transpose(-1, -2)
    orn_w_new = matrix_to_euler_angles(world_T_tcp_new, "XYZ")
    orn_w_rel = _wrap_angle(orn_w_new - tcp_orn) * 100.0
    return torch.cat([pos_w_rel, orn_w_rel, action[..., 6:7]], dim=-1)
