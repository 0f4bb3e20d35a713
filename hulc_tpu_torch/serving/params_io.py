"""The weights of a serving artifact as ``params.npz`` (port of
hulc_tpu/serving/params_io.py).

A state_dict is already flat (``"action_decoder.rnn.weight_hh_l0"``), so
the two helpers only change the container: numpy arrays to write, tensors
on the serving device to read, in the state_dict's order, which is the
order of the exported programs' first input. numpy and torch only: the
serving runtime imports this without the port's model code.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flatten_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """state_dict -> {name: numpy array} (``np.savez``-able), in its order."""
    return {k: v.detach().cpu().numpy() for k, v in state_dict.items()}


def unflatten_params(flat: Mapping[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_params`: tensors on ``device``, in ``flat``'s order."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in flat.items()}
