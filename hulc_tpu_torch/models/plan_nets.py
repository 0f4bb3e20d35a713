"""Latent-plan networks (port of hulc_tpu/models/plan_nets.py:30-110).

* ``PlanProposalNetwork`` (the prior): a ``num_layers`` x ``hidden_size``
  relu MLP on concat(initial perceptual embedding, latent goal) projected
  to the plan distribution's logits.
* ``PlanRecognitionTransformer`` (the posterior, training only): the
  window's perceptual embeddings, zero-padded up to a multiple of the head
  count, plus learned position embeddings, input dropout, a post-LN
  transformer encoder, ``fc`` to ``fc_hidden_size``, the mean over time
  (``seq_feat``, which the CLIP loss also reads) and ``fc_state`` to the
  plan logits. The BiRNN posterior (MCIL) waits for a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc_tpu_torch.config import DistributionConfig, PlanProposalConfig, PlanRecognitionConfig
from hulc_tpu_torch.models.layers import MLP, Dropout, TransformerEncoder
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


def recognition_d_model(cfg: PlanRecognitionConfig) -> int:
    """The encoder width: the input padded up to a multiple of the heads."""
    return cfg.in_features + (-cfg.in_features) % cfg.num_heads


class PlanRecognitionTransformer(nn.Module):
    """Posterior: q(plan | window), and seq_feat for the language aux loss."""

    def __init__(self, cfg: PlanRecognitionConfig, dist: PlanDistribution):
        super().__init__()
        if cfg.kind != "transformer":
            raise ValueError(f"plan recognition {cfg.kind!r} is not ported yet; only 'transformer' is")
        if not cfg.position_embedding or cfg.positional_normalize or cfg.encoder_normalize:
            raise ValueError("sinusoidal positions, positional_normalize and encoder_normalize are not ported yet")
        self.cfg = cfg
        self.dist = dist
        d_model = recognition_d_model(cfg)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d_model)
        self.dropout = Dropout(cfg.dropout)
        self.transformer_encoder = TransformerEncoder(
            cfg.num_layers, d_model, cfg.num_heads, cfg.encoder_hidden_size, cfg.dropout
        )
        self.fc = nn.Linear(d_model, cfg.fc_hidden_size)
        self.fc_state = nn.Sequential(nn.Linear(cfg.fc_hidden_size, dist.state_dim))

    def forward(self, perceptual_emb: torch.Tensor) -> Tuple[DiscretePlanState, torch.Tensor]:
        """(B, S, F) -> (plan state, seq_feat (B, fc_hidden_size))."""
        s, f = perceptual_emb.shape[1:]
        x = F.pad(perceptual_emb.float(), (0, (-f) % self.cfg.num_heads))
        x = x + self.position_embeddings.weight[:s][None]
        x = self.transformer_encoder(self.dropout(x))
        seq_feat = self.fc(x).mean(dim=1)
        return self.dist.make_state(self.fc_state(seq_feat)), seq_feat
