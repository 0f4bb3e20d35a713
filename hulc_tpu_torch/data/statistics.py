"""Dataset statistics (the dataclass of hulc_tpu/data/dataset.py): the
proprioception's normalization, the action bounds and the scene state's
normalization, read from a CALVIN split's ``statistics.yaml``."""

from __future__ import annotations

import dataclasses
import pathlib

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

    @staticmethod
    def _vector_stats(raw: dict, key: str, dim: int):
        entry = raw.get(key)
        if isinstance(entry, list) and entry and isinstance(entry[0], dict):
            return (
                np.asarray(entry[0].get("mean", np.zeros(dim)), np.float32),
                np.asarray(entry[0].get("std", np.ones(dim)), np.float32),
            )
        return np.zeros(dim, np.float32), np.ones(dim, np.float32)

    @staticmethod
    def load(split_dir: pathlib.Path) -> "DatasetStatistics":
        """A split's statistics; zero mean, unit std and [-1, 1] bounds when
        the split has no ``statistics.yaml``."""
        path = pathlib.Path(split_dir) / "statistics.yaml"
        if not path.exists():
            return DatasetStatistics(
                np.zeros(15, np.float32),
                np.ones(15, np.float32),
                np.full(7, -1.0, np.float32),
                np.full(7, 1.0, np.float32),
            )
        import yaml

        raw = yaml.safe_load(path.read_text())
        mean, std = DatasetStatistics._vector_stats(raw, "robot_obs", 15)
        scene_mean, scene_std = DatasetStatistics._vector_stats(raw, "scene_obs", 24)
        return DatasetStatistics(
            mean,
            std,
            np.asarray(raw.get("act_min_bound", [-1.0] * 7), np.float32),
            np.asarray(raw.get("act_max_bound", [1.0] * 7), np.float32),
            scene_mean,
            scene_std,
        )
