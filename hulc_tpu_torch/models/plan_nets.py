"""Plan proposal prior (port of hulc_tpu/models/plan_nets.py:30-53).

A ``num_layers`` x ``hidden_size`` relu MLP on concat(initial perceptual
embedding, latent goal) projected to the plan distribution's logits. The
recognition transformer (the posterior) is training-only and waits for
the training slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from hulc_tpu_torch.config import DistributionConfig, PlanProposalConfig
from hulc_tpu_torch.models.layers import MLP
from hulc_tpu_torch.ops.plan_distributions import DiscretePlanState, PlanDistribution


def make_plan_distribution(cfg: DistributionConfig) -> PlanDistribution:
    return PlanDistribution(kind=cfg.kind, category_size=cfg.category_size, class_size=cfg.class_size)


class PlanProposalNetwork(nn.Module):
    """Prior: p(plan | s_0, goal)."""

    def __init__(self, cfg: PlanProposalConfig, dist: PlanDistribution):
        super().__init__()
        self.dist = dist
        self.fc_model = MLP(
            cfg.perceptual_features + cfg.latent_goal_features,
            [cfg.hidden_size] * cfg.num_layers,
            cfg.activation,
            final_activation=True,
        )
        self.fc_state = nn.Sequential(nn.Linear(cfg.hidden_size, dist.state_dim))

    def forward(self, initial_percep_emb: torch.Tensor, latent_goal: torch.Tensor) -> DiscretePlanState:
        x = torch.cat([initial_percep_emb, latent_goal], dim=-1).float()
        return self.dist.make_state(self.fc_state(self.fc_model(x)))
