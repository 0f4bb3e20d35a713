"""Auxiliary loss heads (port of hulc_tpu/models/aux_heads.py:20-34).

``ProjVisLang``: twin two-layer MLP projections of the recognition
network's ``seq_feat`` and of the language goal, for the CLIP-style
contrastive loss, under the reference's keys ``mlp_im.{0,2}`` and
``mlp_lang.{0,2}``, computed in ``dtype`` (the CLIP loss casts to fp32).
The BC-Z decoder and the MIA discriminator wait for a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from hulc_tpu_torch.models.layers import MLP


class ProjVisLang(nn.Module):
    def __init__(self, vis_features: int, lang_features: int, output_dim: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # the CLIP loss reads the outputs in fp32: the last bias adds are fp32 (layers.Linear's fp32_out)
        self.mlp_im = MLP(vis_features, [128, output_dim], dtype=dtype, fp32_out=True)
        self.mlp_lang = MLP(lang_features, [128, output_dim], dtype=dtype, fp32_out=True)

    def forward(self, vis_emb: torch.Tensor, lang_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.mlp_im(vis_emb), self.mlp_lang(lang_emb)
