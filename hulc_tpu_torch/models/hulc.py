"""HULC inference surface (port of hulc_tpu/models/hulc.py:138-190, 644-662).

``HulcModel`` holds the modules the closed-loop policy runs, under the
reference's state_dict names (``perceptual_encoder``, ``plan_proposal``,
``visual_goal``, ``language_goal``, ``action_decoder``), and exposes
``encode``, ``encode_visual_goal``, ``encode_language_goal``,
``propose_plan`` and ``decoder_act``. Closed-loop state (plan, goal,
decoder carry) is passed in and out explicitly. The training losses, the
plan recognition network and the CLIP auxiliary heads wait for the
training slice; GCBC (plan-free) waits too.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.device import resolve_device
from hulc_tpu_torch.models.decoders import LogisticPolicyDecoder, decoder_carry
from hulc_tpu_torch.models.goal_encoders import GoalEncoder, make_language_goal_encoder
from hulc_tpu_torch.models.layers import ScanRNN
from hulc_tpu_torch.models.perceptual import ConcatEncoders
from hulc_tpu_torch.models.plan_nets import PlanProposalNetwork, make_plan_distribution
from hulc_tpu_torch.models.vision import SpatialSoftmax


class HulcModel(nn.Module):
    """The policy's modules. ``use_kernels=False`` runs every hand-written
    kernel's plain version instead, on any device; it exists to hold the
    kernels against their plain versions on the card."""

    def __init__(self, cfg: HulcConfig, use_kernels: bool = True):
        super().__init__()
        if cfg.model_kind != "hulc":
            raise ValueError(f"model_kind {cfg.model_kind!r} is not ported yet")
        if cfg.compute_dtype != "float32":
            raise ValueError("the port computes in float32 only so far")
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.perceptual_encoder = ConcatEncoders(cfg.perceptual_encoder, use_kernels)
        self.dist = make_plan_distribution(cfg.distribution)
        self.plan_proposal = PlanProposalNetwork(cfg.plan_proposal, self.dist)
        self.visual_goal = GoalEncoder(cfg.visual_goal)
        self.language_goal = (
            make_language_goal_encoder(cfg.language_goal) if cfg.language_goal else None
        )
        self.action_decoder = LogisticPolicyDecoder(cfg.action_decoder, use_kernels)

    def encode(
        self, rgb_obs: Dict[str, torch.Tensor], robot_obs: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.perceptual_encoder(rgb_obs, robot_obs)

    def encode_visual_goal(self, last_emb: torch.Tensor) -> torch.Tensor:
        return self.visual_goal(last_emb)

    def encode_language_goal(self, lang: torch.Tensor) -> torch.Tensor:
        return self.language_goal(lang)

    def propose_plan(
        self,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Sample a plan from the proposal prior; gumbel is optional
        (B, category_size, class_size) noise."""
        state = self.plan_proposal(perceptual_emb[:, 0], latent_goal)
        return self.dist.sample(state, generator=generator, gumbel=gumbel)

    def decoder_act(
        self,
        plan: torch.Tensor,
        perceptual_emb: torch.Tensor,
        latent_goal: torch.Tensor,
        robot_obs: torch.Tensor,
        carry: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        u_mix: Optional[torch.Tensor] = None,
        u_inv: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.action_decoder.act(
            plan, perceptual_emb, latent_goal, robot_obs, carry,
            generator=generator, u_mix=u_mix, u_inv=u_inv,
        )

    def init_decoder_carry(self, batch_size: int) -> torch.Tensor:
        return decoder_carry(self.cfg.action_decoder, batch_size, self.device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator``, at torch's default scales: Linear and
    Conv2d U(+-1/sqrt(fan_in)), RNN U(+-1/sqrt(H)), LayerNorm (1, 0)."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, ScanRNN):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                p.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, SpatialSoftmax) and m.fixed_temperature is None:
            m.temperature.fill_(1.0)


def make_model(cfg: HulcConfig, device="cuda", seed: int = 0, use_kernels: bool = True) -> HulcModel:
    """Build the model on ``device`` (CUDA unless the caller asks for
    another), randomly initialized from ``seed``, in eval mode."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = HulcModel(cfg, use_kernels)
    model.to_empty(device=device)
    init_weights_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()
