"""Goal encoders (port of hulc_tpu/models/goal_encoders.py:20-65).

``GoalEncoder``: an MLP capped by LayerNorm, on the last-frame perceptual
embedding (visual goal) or the 384-d sentence embedding (language goal,
whose ``mlp`` starts with a word Dropout, hence keys ``mlp.{1,3,5}``).
``LanguageEncoder``: the plain three-Linear language head, no LayerNorm.
The Linear layers compute in ``dtype`` (the word Dropout runs before, on
the fp32 input); ``GoalEncoder``'s LayerNorm runs in fp32 (its last Linear
adds its bias in fp32, ``layers.Linear``'s ``fp32_out``), after the
division by the fp32 norm with ``l2_normalize``, while
``LanguageEncoder`` returns its last layer's ``dtype``, as JAX's do.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from hulc_tpu_torch.config import GoalEncoderConfig
from hulc_tpu_torch.models.layers import MLP, l2_normalized


class GoalEncoder(nn.Module):
    def __init__(self, cfg: GoalEncoderConfig, word_dropout: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.l2_normalize = cfg.l2_normalize
        self.mlp = MLP(
            cfg.in_features,
            [cfg.hidden_size, cfg.hidden_size, cfg.latent_goal_features],
            cfg.activation,
            input_dropout=cfg.word_dropout if word_dropout else None,
            dtype=dtype,
            fp32_out=True,  # into the LayerNorm
        )
        self.ln = nn.LayerNorm(cfg.latent_goal_features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mlp(x.float())
        return self.ln(l2_normalized(x) if self.l2_normalize else x)


class LanguageEncoder(nn.Module):
    """Dropout, then three Linear layers with activations between."""

    def __init__(self, cfg: GoalEncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MLP(
            cfg.in_features,
            [cfg.hidden_size, cfg.hidden_size, cfg.latent_goal_features],
            cfg.activation,
            input_dropout=cfg.word_dropout,
            dtype=dtype,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x.float())


def make_language_goal_encoder(cfg: GoalEncoderConfig, dtype: torch.dtype = torch.float32) -> nn.Module:
    if cfg.kind == "mlp":
        return LanguageEncoder(cfg, dtype)
    return GoalEncoder(cfg, word_dropout=True, dtype=dtype)
