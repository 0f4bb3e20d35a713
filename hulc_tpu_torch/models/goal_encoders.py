"""Goal encoders (port of hulc_tpu/models/goal_encoders.py:20-65).

``GoalEncoder``: an MLP capped by LayerNorm, on the last-frame perceptual
embedding (visual goal) or the 384-d sentence embedding (language goal,
whose ``mlp`` starts with a word Dropout, hence keys ``mlp.{1,3,5}``).
``LanguageEncoder``: the plain three-Linear language head, no LayerNorm.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from hulc_tpu_torch.config import GoalEncoderConfig
from hulc_tpu_torch.models.layers import MLP


class GoalEncoder(nn.Module):
    def __init__(self, cfg: GoalEncoderConfig, word_dropout: bool = False):
        super().__init__()
        if cfg.l2_normalize:
            raise ValueError("l2_normalize goal encoders are not ported yet")
        self.mlp = MLP(
            cfg.in_features,
            [cfg.hidden_size, cfg.hidden_size, cfg.latent_goal_features],
            cfg.activation,
            input_dropout=cfg.word_dropout if word_dropout else None,
        )
        self.ln = nn.LayerNorm(cfg.latent_goal_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.mlp(x.float()))


class LanguageEncoder(nn.Module):
    """Dropout, then three Linear layers with activations between."""

    def __init__(self, cfg: GoalEncoderConfig):
        super().__init__()
        self.mlp = MLP(
            cfg.in_features,
            [cfg.hidden_size, cfg.hidden_size, cfg.latent_goal_features],
            cfg.activation,
            input_dropout=cfg.word_dropout,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x.float())


def make_language_goal_encoder(cfg: GoalEncoderConfig) -> nn.Module:
    if cfg.kind == "mlp":
        return LanguageEncoder(cfg)
    return GoalEncoder(cfg, word_dropout=True)
