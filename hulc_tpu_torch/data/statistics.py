"""Dataset statistics the closed-loop policy normalizes proprioception with
(the dataclass of hulc_tpu/data/dataset.py; loading from a CALVIN split
waits for the data slice)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetStatistics:
    robot_obs_mean: np.ndarray
    robot_obs_std: np.ndarray
    act_min_bound: np.ndarray
    act_max_bound: np.ndarray
    scene_obs_mean: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(24, np.float32)
    )
    scene_obs_std: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(24, np.float32)
    )
