"""Latent-plan networks (port of hulc_tpu/models/plan_nets.py:30-140).

* ``PlanProposalNetwork`` (the prior): a ``num_layers`` x ``hidden_size``
  relu MLP on concat(initial perceptual embedding, latent goal) projected
  to the plan distribution's logits.
* ``PlanRecognitionTransformer`` (the posterior, training only): the
  window's perceptual embeddings, zero-padded up to a multiple of the head
  count, plus learned position embeddings (or, with ``position_embedding``
  off, the fixed sinusoidal ones), optionally a LayerNorm
  (``positional_normalize``), input dropout, a post-LN transformer encoder
  (with ``encoder_normalize`` a final LayerNorm), ``fc`` to
  ``fc_hidden_size``, the mean over time (``seq_feat``, which the CLIP loss
  also reads) and ``fc_state`` to the plan logits.
* ``PlanRecognitionBiRNN`` (MCIL's posterior): a bidirectional tanh, relu
  or gru RNN (``birnn_cell``; ``layers.ScanBiRNN``, module ``birnn_model``,
  ``birnn_dropout`` between its layers) over the window, its last step's
  features ``x[:, -1]`` as ``seq_feat`` (the reverse half of that row is
  the reverse chain's first step, which has seen only the last frame), and
  ``fc_state`` to the Normal's mean and raw std.

In bf16 (``dtype``) the MLPs, the transformer and ``fc`` compute in bf16
and the BiRNN's input projections too; every ``fc_state`` is fp32 (on the
fp32-promoted features), and so are ``seq_feat`` (the mean of ``fc``'s
output taken in fp32) and the LayerNorms, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc_tpu_torch.config import DistributionConfig, PlanProposalConfig, PlanRecognitionConfig
from hulc_tpu_torch.models.layers import MLP, Dropout, Linear, ScanBiRNN, TransformerEncoder
from hulc_tpu_torch.ops.plan_distributions import PlanDistribution, PlanState


def make_plan_distribution(cfg: DistributionConfig) -> PlanDistribution:
    return PlanDistribution(kind=cfg.kind, category_size=cfg.category_size, class_size=cfg.class_size,
                            plan_features=cfg.plan_features)


class PlanProposalNetwork(nn.Module):
    """Prior: p(plan | s_0, goal)."""

    def __init__(self, cfg: PlanProposalConfig, dist: PlanDistribution, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dist = dist
        self.dtype = dtype
        self.fc_model = MLP(
            cfg.perceptual_features + cfg.latent_goal_features,
            [cfg.hidden_size] * cfg.num_layers,
            cfg.activation,
            final_activation=True,
            dtype=dtype,
        )
        self.fc_state = nn.Sequential(Linear(cfg.hidden_size, dist.state_dim))

    def forward(self, initial_percep_emb: torch.Tensor, latent_goal: torch.Tensor) -> PlanState:
        x = torch.cat([initial_percep_emb, latent_goal], dim=-1).to(self.dtype)
        return self.dist.make_state(self.fc_state(self.fc_model(x)))


def sinusoidal_position_encoding(seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """The classic sinusoidal positions (seq_len, d_model), as the JAX
    package's (hulc_tpu/models/plan_nets.py:56-66): sin at the even
    columns, cos at the odd ones (an odd d_model drops the last cos)."""
    position = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros(seq_len, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * (div_term if d_model % 2 == 0 else div_term[:-1]))
    return pe


def recognition_d_model(cfg: PlanRecognitionConfig) -> int:
    """The encoder width: the input padded up to a multiple of the heads."""
    return cfg.in_features + (-cfg.in_features) % cfg.num_heads


class PlanRecognitionTransformer(nn.Module):
    """Posterior: q(plan | window), and seq_feat for the language aux loss."""

    def __init__(self, cfg: PlanRecognitionConfig, dist: PlanDistribution, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.kind != "transformer":
            raise ValueError(f"plan recognition {cfg.kind!r} is not ported yet; only 'transformer' is")
        self.cfg = cfg
        self.dist = dist
        d_model = recognition_d_model(cfg)
        if cfg.position_embedding:
            self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d_model)
        if cfg.positional_normalize:
            self.positional_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(cfg.dropout)
        self.transformer_encoder = TransformerEncoder(
            cfg.num_layers, d_model, cfg.num_heads, cfg.encoder_hidden_size, cfg.dropout, dtype, cfg.encoder_normalize
        )
        self.fc = Linear(d_model, cfg.fc_hidden_size, dtype, fp32_out=True)
        self.fc_state = nn.Sequential(Linear(cfg.fc_hidden_size, dist.state_dim))

    def forward(self, perceptual_emb: torch.Tensor) -> Tuple[PlanState, torch.Tensor]:
        """(B, S, F) -> (plan state, seq_feat (B, fc_hidden_size))."""
        s, f = perceptual_emb.shape[1:]
        x = F.pad(perceptual_emb, (0, (-f) % self.cfg.num_heads))
        if self.cfg.position_embedding:
            x = x + self.position_embeddings.weight[:s][None]
        else:
            x = x + sinusoidal_position_encoding(s, x.shape[-1], x.device)[None]
        if self.cfg.positional_normalize:
            x = self.positional_norm(x)
        x = self.transformer_encoder(self.dropout(x))
        seq_feat = self.fc(x).mean(dim=1)
        return self.dist.make_state(self.fc_state(seq_feat)), seq_feat


class PlanRecognitionBiRNN(nn.Module):
    """MCIL posterior: q(plan | window) from the BiRNN's last step, which is
    also the seq_feat (B, 2 * birnn_hidden_size)."""

    def __init__(self, cfg: PlanRecognitionConfig, dist: PlanDistribution, use_kernels: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dist = dist
        self.birnn_model = ScanBiRNN(cfg.in_features, cfg.birnn_hidden_size, cfg.birnn_num_layers, cfg.birnn_cell,
                                     use_kernels, dtype, cfg.birnn_dropout)
        self.fc_state = nn.Sequential(Linear(2 * cfg.birnn_hidden_size, dist.state_dim))

    def forward(self, perceptual_emb: torch.Tensor) -> Tuple[PlanState, torch.Tensor]:
        seq_feat = self.birnn_model(perceptual_emb)[:, -1]
        return self.dist.make_state(self.fc_state(seq_feat)), seq_feat


def make_plan_recognition(
    cfg: PlanRecognitionConfig, dist: PlanDistribution, use_kernels: bool = True, dtype: torch.dtype = torch.float32
) -> Union[PlanRecognitionTransformer, PlanRecognitionBiRNN]:
    if cfg.kind == "transformer":
        return PlanRecognitionTransformer(cfg, dist, dtype)
    if cfg.kind == "birnn":
        return PlanRecognitionBiRNN(cfg, dist, use_kernels, dtype)
    raise ValueError(f"unknown plan recognition kind {cfg.kind!r}")
