"""Shared building blocks (port of hulc_tpu/models/layers.py:25-85, 161-281).

``MLP`` builds the Linear/activation stacks under the reference's
``nn.Sequential`` indices, so state_dict keys such as ``mlp.0`` or
``fc_model.2`` line up with the reference checkpoints. ``ScanRNN`` is the
decoder's multi-layer relu RNN with an explicit (num_layers, B, H) carry:
the input projection of every time step runs as one matmul before the
loop, and the recurrence ``relu(x_t W_ih + b_ih + h W_hh + b_hh)`` is one
fp32 ``addmm`` per step and layer. The transformer and the other cells
wait for the training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

ACTIVATIONS = {
    "relu": nn.ReLU,
    "elu": nn.ELU,
    "gelu": lambda: nn.GELU(approximate="tanh"),  # flax's nn.gelu default
    "tanh": nn.Tanh,
}


def MLP(
    in_features: int,
    features: Sequence[int],
    activation: str = "relu",
    final_activation: bool = False,
    input_dropout: Optional[float] = None,
) -> nn.Sequential:
    """Linear layers with an activation after each but the last (unless
    ``final_activation``); ``input_dropout`` puts a Dropout at index 0, as
    the reference's language heads have."""
    layers = [] if input_dropout is None else [nn.Dropout(input_dropout)]
    for i, feat in enumerate(features):
        layers.append(nn.Linear(in_features, feat))
        if i < len(features) - 1 or final_activation:
            layers.append(ACTIVATIONS[activation]())
        in_features = feat
    return nn.Sequential(*layers)


class ScanRNN(nn.Module):
    """Multi-layer relu RNN over (B, S, F) with an explicit carry.

    Parameters carry torch ``nn.RNN``'s names (``weight_ih_l{k}``,
    ``weight_hh_l{k}``, ``bias_ih_l{k}``, ``bias_hh_l{k}``).
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2, cell: str = "rnn"):
        super().__init__()
        if cell != "rnn":
            raise ValueError(f"rnn cell {cell!r} is not ported yet; only 'rnn' (relu) is")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        for k in range(num_layers):
            in_k = input_size if k == 0 else hidden_size
            self.register_parameter(f"weight_ih_l{k}", nn.Parameter(torch.empty(hidden_size, in_k)))
            self.register_parameter(f"weight_hh_l{k}", nn.Parameter(torch.empty(hidden_size, hidden_size)))
            self.register_parameter(f"bias_ih_l{k}", nn.Parameter(torch.empty(hidden_size)))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(torch.empty(hidden_size)))

    def forward(
        self, x: torch.Tensor, carry: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, F), carry (L, B, H) or None -> (outputs (B, S, H), carry)."""
        if carry is None:
            carry = x.new_zeros(self.num_layers, x.shape[0], self.hidden_size)
        out = x
        finals = []
        for k in range(self.num_layers):
            w_hh = getattr(self, f"weight_hh_l{k}")
            b_hh = getattr(self, f"bias_hh_l{k}")
            x_proj = F.linear(out, getattr(self, f"weight_ih_l{k}"), getattr(self, f"bias_ih_l{k}"))
            h = carry[k]
            steps = []
            for t in range(x_proj.shape[1]):
                h = torch.relu(x_proj[:, t] + torch.addmm(b_hh, h, w_hh.t()))
                steps.append(h)
            out = torch.stack(steps, dim=1)
            finals.append(h)
        return out, torch.stack(finals)
