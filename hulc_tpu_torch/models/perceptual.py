"""Multi-camera perceptual fusion (port of hulc_tpu/models/perceptual.py:35-131).

Images arrive preprocessed as (B, S, C, H, W) fp32; batch and time are
flattened into one convolution batch per camera. This slice ports the
static and gripper RGB cameras and the proprio passthrough; depth,
tactile and CLIP encoders, and the camera-less state-only encoder, wait
for later slices.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from hulc_tpu_torch.config import PerceptualEncoderConfig
from hulc_tpu_torch.models.vision import make_vision_encoder


class ConcatEncoders(nn.Module):
    """Fuse per-camera features (+ optional proprio) into perceptual_emb."""

    def __init__(self, cfg: PerceptualEncoderConfig, use_kernels: bool = True):
        super().__init__()
        for name in ("depth_static", "depth_gripper", "tactile"):
            if getattr(cfg, name) is not None:
                raise ValueError(f"perceptual encoder {name!r} is not ported yet")
        if cfg.rgb_static is None and cfg.rgb_gripper is None:
            raise ValueError("the camera-less (state-only) encoder is not ported yet")
        self.cfg = cfg
        self.rgb_static_encoder = (
            make_vision_encoder(cfg.rgb_static, use_kernels) if cfg.rgb_static else None
        )
        self.rgb_gripper_encoder = (
            make_vision_encoder(cfg.rgb_gripper, use_kernels) if cfg.rgb_gripper else None
        )

    @staticmethod
    def _encode(encoder: nn.Module, imgs: torch.Tensor) -> torch.Tensor:
        b, s = imgs.shape[:2]
        return encoder(imgs.reshape((b * s,) + imgs.shape[2:])).reshape(b, s, -1)

    def forward(
        self, rgb_obs: Dict[str, torch.Tensor], robot_obs: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """rgb_obs: {"rgb_static", "rgb_gripper"} -> (perceptual_emb, visual_emb),
        each (B, S, F)."""
        parts = []
        if self.rgb_static_encoder is not None and "rgb_static" in rgb_obs:
            parts.append(self._encode(self.rgb_static_encoder, rgb_obs["rgb_static"]))
        if self.rgb_gripper_encoder is not None and "rgb_gripper" in rgb_obs:
            parts.append(self._encode(self.rgb_gripper_encoder, rgb_obs["rgb_gripper"]))
        visual_emb = torch.cat(parts, dim=-1)
        if self.cfg.proprio is not None and robot_obs is not None:
            return torch.cat([visual_emb, robot_obs.to(visual_emb.dtype)], dim=-1), visual_emb
        return visual_emb, visual_emb
