"""Lockstep batched policy step (port of hulc_tpu/evaluation/batched_eval.py:40-154).

E environments advance through ONE (E, ...) policy step. Replanning is per
lane: a new plan and goal are computed for every lane and merged in where
``replan_mask`` is set, and those lanes' decoder carries restart from
zero, so the step keeps one shape. The LH-MTLC evaluator loop
(``evaluate_policy_batched``) waits for a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.data.statistics import DatasetStatistics
from hulc_tpu_torch.evaluation.policy import StateObsNormalizer
from hulc_tpu_torch.models.hulc import HulcModel
from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq, preprocess_rgb_seq_plain


def build_batched_step(model: HulcModel, cfg: HulcConfig):
    """The lockstep batched policy step as a function of device tensors."""
    preprocess = preprocess_rgb_seq if model.use_kernels else preprocess_rgb_seq_plain

    @torch.no_grad()
    def step_fn(rgb_static, rgb_gripper, rob_norm, rob_raw, lang_emb, plan, latent_goal, carry,
                replan_mask, *, generator=None, gumbel=None, u_mix=None, u_inv=None):
        """One lockstep step over E lanes; replan_mask is (E,) bool.

        Returns (actions (E, 7), plan, latent_goal, carry).
        """
        rgb_obs = {}
        if rgb_static is not None:
            rgb_obs["rgb_static"] = preprocess(rgb_static)
        if rgb_gripper is not None:
            rgb_obs["rgb_gripper"] = preprocess(rgb_gripper)
        emb, _ = model.encode(rgb_obs, rob_norm)  # (E, 1, F)
        new_goal = model.encode_language_goal(lang_emb)
        new_plan = model.propose_plan(emb, new_goal, generator=generator, gumbel=gumbel)
        m = replan_mask[:, None]
        plan = torch.where(m, new_plan, plan)
        latent_goal = torch.where(m, new_goal, latent_goal)
        carry = torch.where(replan_mask[None, :, None], torch.zeros_like(carry), carry)
        action, carry = model.decoder_act(
            plan, emb, latent_goal, rob_raw, carry, generator=generator, u_mix=u_mix, u_inv=u_inv
        )
        return action[:, 0], plan, latent_goal, carry

    return step_fn


class BatchedHulcPolicy:
    """Vectorized step over E concurrent rollouts; the state is a tuple of
    (E, ...) tensors and ``replan_mask`` restarts individual lanes."""

    def __init__(
        self,
        cfg: HulcConfig,
        model: HulcModel,
        num_envs: int,
        statistics: Optional[DatasetStatistics] = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.model = model.eval()
        self.device = model.device
        self.num_envs = num_envs
        self._state_norm = StateObsNormalizer(cfg, statistics)
        self.replan_freq = cfg.replan_freq
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._step = build_batched_step(model, cfg)

    def initial_state(self):
        e = self.num_envs
        return (
            torch.zeros(e, self.cfg.distribution.plan_dim, device=self.device),
            torch.zeros(e, self.cfg.visual_goal.latent_goal_features, device=self.device),
            self.model.init_decoder_carry(e),
        )

    def step(self, obs_batch: List[Dict], lang_embs: np.ndarray, state, replan_mask: np.ndarray):
        """obs_batch: list of E env obs dicts. Returns (actions (E, 7), state)."""
        pe = self.cfg.perceptual_encoder

        def frames(key, enc):
            if enc is None:
                return None
            stacked = np.stack([o["rgb_obs"][key] for o in obs_batch])[:, None]
            return torch.as_tensor(stacked, device=self.device)

        rob_raw = np.stack([o["robot_obs"] for o in obs_batch]).astype(np.float32)[:, None]
        scene_raw = (
            np.stack([o["scene_obs"] for o in obs_batch]).astype(np.float32)[:, None]
            if self._state_norm.include_scene and "scene_obs" in obs_batch[0]
            else None
        )
        rob_norm = self._state_norm(rob_raw, scene_raw)
        plan, goal, carry = state
        actions, plan, goal, carry = self._step(
            frames("rgb_static", pe.rgb_static),
            frames("rgb_gripper", pe.rgb_gripper),
            torch.as_tensor(rob_norm, device=self.device),
            torch.as_tensor(rob_raw, device=self.device),
            torch.as_tensor(np.asarray(lang_embs, np.float32), device=self.device),
            plan, goal, carry,
            torch.as_tensor(np.asarray(replan_mask, bool), device=self.device),
            generator=self.generator,
        )
        return actions.cpu().numpy(), (plan, goal, carry)
