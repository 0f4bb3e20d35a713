"""Auxiliary loss heads (port of hulc_tpu/models/aux_heads.py:20-57).

``ProjVisLang``: twin two-layer MLP projections of the recognition
network's ``seq_feat`` and of the language goal, for the CLIP-style
contrastive loss and the MIA loss, under the reference's keys
``mlp_im.{0,2}`` and ``mlp_lang.{0,2}``, computed in ``dtype`` (the losses
cast to fp32). ``BCZLangDecoder``: regress the language embedding from
``seq_feat`` (``fc0``, ``fc1``; BC-Z's auxiliary loss). ``MIALangDiscriminator``:
a match logit of the concatenated projections (``fc0`` in ``dtype``, the
logit ``fc1`` fp32; MIA's auxiliary loss); JAX's model builds it without
dropout, so its dropout option is not carried.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from hulc_tpu_torch.models.layers import MLP, Linear


class ProjVisLang(nn.Module):
    def __init__(self, vis_features: int, lang_features: int, output_dim: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # the CLIP loss reads the outputs in fp32: the last bias adds are fp32 (layers.Linear's fp32_out)
        self.mlp_im = MLP(vis_features, [128, output_dim], dtype=dtype, fp32_out=True)
        self.mlp_lang = MLP(lang_features, [128, output_dim], dtype=dtype, fp32_out=True)

    def forward(self, vis_emb: torch.Tensor, lang_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.mlp_im(vis_emb), self.mlp_lang(lang_emb)


class BCZLangDecoder(nn.Module):
    def __init__(self, in_features: int, lang_dim: int = 384, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc0 = Linear(in_features, 512, dtype)
        self.fc1 = Linear(512, lang_dim, dtype, fp32_out=True)  # the loss reads it in fp32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc1(torch.relu(self.fc0(x)))


class MIALangDiscriminator(nn.Module):
    def __init__(self, in_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc0 = Linear(in_features, 512, dtype)
        self.fc1 = Linear(512, 1)

    def forward(self, vis_emb: torch.Tensor, lang_emb: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc0(torch.cat([vis_emb, lang_emb], dim=-1).to(self.dtype)))
        return self.fc1(x.float())
