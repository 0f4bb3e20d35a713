"""Host-side data transforms (a copy of hulc_tpu/data/transforms.py).

``RelativeActions`` (absolute to relative actions), ``NormalizeVector``,
``AddGaussianNoise`` and ``AddDepthNoise``, in numpy with the same RNG
streams as the JAX package's. Image scaling, normalization and the random
shift run on the device (``ops.image_ops``).
"""

from __future__ import annotations

import numpy as np


class RelativeActions:
    """Absolute -> relative action conversion (reference semantics).

    rel_pos = clip(abs_pos - robot_pos, +-max_pos) / max_pos;
    rel_orn = clip(wrap(abs_orn - robot_orn), +-max_orn) / max_orn;
    gripper passes through.
    """

    def __init__(self, max_pos: float = 0.02, max_orn: float = 0.05):
        self.max_pos = max_pos
        self.max_orn = max_orn

    @staticmethod
    def batch_angle_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        diff = b - a
        return (diff + np.pi) % (2 * np.pi) - np.pi

    def __call__(self, actions: np.ndarray, robot_obs: np.ndarray) -> np.ndarray:
        actions = np.asarray(actions)
        robot_obs = np.asarray(robot_obs)
        rel_pos = np.clip(actions[:, :3] - robot_obs[:, :3], -self.max_pos, self.max_pos) / self.max_pos
        rel_orn = (
            np.clip(
                self.batch_angle_between(robot_obs[:, 3:6], actions[:, 3:6]),
                -self.max_orn,
                self.max_orn,
            )
            / self.max_orn
        )
        return np.concatenate([rel_pos, rel_orn, actions[:, -1:]], axis=1)

    def __repr__(self):
        return f"RelativeActions(max_pos={self.max_pos}, max_orn={self.max_orn})"


class NormalizeVector:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.maximum(np.asarray(std, np.float32), 1e-6)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float32) - self.mean) / self.std


class AddGaussianNoise:
    def __init__(self, mean=0.0, std=0.01, seed: int = 0):
        self.mean = float(np.asarray(mean).reshape(-1)[0])
        self.std = float(np.asarray(std).reshape(-1)[0])
        self.rng = np.random.default_rng(seed)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, np.float32) + self.rng.normal(self.mean, self.std, np.shape(x)).astype(np.float32)


class AddDepthNoise:
    """Multiplicative gamma noise on depth maps (shape/rate 1000 -> mean 1)."""

    def __init__(self, shape=1000.0, rate=1000.0, seed: int = 0):
        self.shape = float(np.asarray(shape).reshape(-1)[0])
        self.rate = float(np.asarray(rate).reshape(-1)[0])
        self.rng = np.random.default_rng(seed)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        mult = self.rng.gamma(self.shape, 1.0 / self.rate, np.shape(x)).astype(np.float32)
        return np.asarray(x, np.float32) * mult
