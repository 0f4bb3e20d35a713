"""Multi-camera perceptual fusion (port of hulc_tpu/models/perceptual.py:24-136).

Images arrive preprocessed as (B, S, C, H, W) fp32 or in the compute
dtype (the encoders cast them), depth frames as (B, S, H, W) fp32 (they
gain a one-channel axis here, as JAX appends one); batch and time are
flattened into one convolution batch per camera. The CNNs' features come
out fp32 (each ends in a LayerNorm), the CLIP and tactile heads' in the
compute dtype, and the concatenation promotes as JAX's does. The encoders
are the static and gripper cameras (either may be absent: ``fetch_vision``
has a static camera alone; the static one may be a frozen CLIP tower),
their depth towers, the tactile tower and the proprio passthrough. The
features are concatenated in JAX's order: RGB static, depth static, RGB
gripper, depth gripper, tactile, where the gripper depth is encoded only
beside the RGB gripper camera (JAX :108-116). Without any
camera (the state-only presets) ``perceptual_emb`` is the proprio itself
and ``visual_emb`` has width 0. ``use_state_decoder`` (with proprio and
``state_recons``) adds the ``StateDecoder`` that ``state_reconstruction_loss`` reads: the proprio
regressed from ``visual_emb``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from hulc_tpu_torch.config import PerceptualEncoderConfig
from hulc_tpu_torch.models.layers import MLP
from hulc_tpu_torch.models.vision import make_vision_encoder


class StateDecoder(nn.Module):
    """Proprio reconstruction head: ``mlp.{0,2,4}``, 40, 40, n_state_obs
    (the loss reads its output in fp32)."""

    def __init__(self, in_features: int, n_state_obs: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MLP(in_features, [40, 40, n_state_obs], dtype=dtype, fp32_out=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class ConcatEncoders(nn.Module):
    """Fuse per-camera features (+ optional proprio) into perceptual_emb."""

    def __init__(self, cfg: PerceptualEncoderConfig, use_kernels: bool = True, dtype: torch.dtype = torch.float32,
                 state_recons: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        for name in ("rgb_static", "rgb_gripper", "depth_static", "depth_gripper", "tactile"):
            enc = getattr(cfg, name)
            setattr(self, f"{name}_encoder", make_vision_encoder(enc, use_kernels, dtype) if enc else None)
        visual = sum(enc.visual_features for enc in cfg.cameras if enc is not None)
        # JAX creates the head's parameters only where state_recons calls it
        self.state_decoder = (
            StateDecoder(visual, cfg.proprio.n_state_obs, dtype)
            if state_recons and cfg.use_state_decoder and cfg.proprio is not None
            else None
        )

    @staticmethod
    def _encode(encoder: nn.Module, imgs: torch.Tensor) -> torch.Tensor:
        b, s = imgs.shape[:2]
        return encoder(imgs.reshape((b * s,) + imgs.shape[2:])).reshape(b, s, -1)

    def _encode_depth(self, name: str, depth_obs: Dict[str, torch.Tensor], parts: list) -> None:
        encoder = getattr(self, f"{name}_encoder")
        if encoder is not None and name in depth_obs:
            d = depth_obs[name]
            parts.append(self._encode(encoder, d.unsqueeze(2) if d.dim() == 4 else d))

    def forward(
        self,
        rgb_obs: Dict[str, torch.Tensor],
        robot_obs: Optional[torch.Tensor] = None,
        depth_obs: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """rgb_obs: {"rgb_static", "rgb_gripper", "rgb_tactile"}, depth_obs:
        {"depth_static", "depth_gripper"} -> (perceptual_emb, visual_emb),
        each (B, S, F)."""
        depth_obs = depth_obs or {}
        parts = []
        if self.rgb_static_encoder is not None and "rgb_static" in rgb_obs:
            parts.append(self._encode(self.rgb_static_encoder, rgb_obs["rgb_static"]))
        self._encode_depth("depth_static", depth_obs, parts)
        if self.rgb_gripper_encoder is not None and "rgb_gripper" in rgb_obs:
            parts.append(self._encode(self.rgb_gripper_encoder, rgb_obs["rgb_gripper"]))
            self._encode_depth("depth_gripper", depth_obs, parts)
        if self.tactile_encoder is not None and "rgb_tactile" in rgb_obs:
            parts.append(self._encode(self.tactile_encoder, rgb_obs["rgb_tactile"]))
        if not parts:
            # no camera: perceptual_emb is the proprio (JAX :118-125)
            if self.cfg.proprio is None or robot_obs is None:
                raise ValueError("camera-less perceptual encoder needs proprio input")
            b, s = robot_obs.shape[:2]
            return robot_obs.to(self.dtype), robot_obs.new_zeros((b, s, 0), dtype=self.dtype)
        # the CLIP and tactile heads end in the compute dtype, the CNNs in an
        # fp32 LayerNorm: torch.cat promotes, as jnp.concatenate does
        visual_emb = torch.cat(parts, dim=-1)
        if self.cfg.proprio is not None and robot_obs is not None:
            return torch.cat([visual_emb, robot_obs.to(visual_emb.dtype)], dim=-1), visual_emb
        return visual_emb, visual_emb

    def state_reconstruction_loss(self, visual_emb: torch.Tensor, robot_obs: torch.Tensor) -> torch.Tensor:
        """The mean squared error of the proprio regressed from ``visual_emb``, fp32."""
        return (robot_obs.float() - self.state_decoder(visual_emb).float()).square().mean()
