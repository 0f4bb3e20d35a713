"""Closed-loop inference policy (port of hulc_tpu/evaluation/policy.py).

``build_policy_fns`` returns the three device functions that the JAX
package jits and its serving exporter wraps:

* ``replan_lang``: encode the current frame and a language embedding,
  sample a plan from the proposal prior;
* ``replan_vision``: the same with a goal frame stacked on the seq axis;
* ``act``: encode the frame, one decoder step with carry, world-frame
  action.

``HulcPolicy`` drives them through ``reset()`` / ``step(obs, goal)``,
replanning every ``replan_freq`` steps, with its state in an explicit
:class:`PolicyState` and its noise from one seeded ``torch.Generator`` on
the model's device, restarted from the seed by ``reset()``. Every random
draw can instead be passed in (the plan's ``gumbel`` or ``normal`` noise,
by the plan's kind, and ``u_mix``, ``u_inv``), which is how the tests feed
the noise JAX drew. A model draws only the noise it uses: GCBC's plan is
empty and draws nothing, the deterministic decoder draws no ``u_mix`` /
``u_inv``. A config without a camera feeds the proprio alone. A config with a depth camera, a CLIP
camera or a tactile tower is refused (``refuse_unserved``), as the JAX package's policies cannot serve
it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from hulc_tpu_torch.config import TACTILE_REFUSAL, HulcConfig
from hulc_tpu_torch.data.statistics import DatasetStatistics
from hulc_tpu_torch.models.hulc import HulcModel
from hulc_tpu_torch.models.layers import Carry
from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq, preprocess_rgb_seq_plain


def refuse_unserved(cfg: HulcConfig, what: str) -> None:
    """Raise for a config the JAX package's policies cannot serve:

    * a depth camera: the policies feed the encoder RGB frames only, as
      JAX's ``build_policy_fns`` does (its fake env and gym adapter return
      no depth), so the latent would miss the depth features;
    * a CLIP camera: JAX's ``_prep`` sends every camera through
      ``preprocess_rgb_seq``, with no resize and no CLIP normalize, and its
      fake env gives a CLIP camera 200 px frames, on which the RN50's
      attention pool fails ((1, 37, 2048) against a (1, 50, 2048)
      position table);
    * a tactile tower: JAX never loads a tactile frame
      (``TACTILE_REFUSAL``)."""
    pe = cfg.perceptual_encoder
    cams = [c for c in ("depth_static", "depth_gripper") if getattr(pe, c) is not None]
    if cams:
        raise ValueError(
            f"{what} refuses a config with depth cameras ({', '.join(cams)}): the policy feeds the encoder RGB "
            f"frames only, as the JAX package's build_policy_fns does, so the latent would lack the depth features"
        )
    clip = [c for c in ("rgb_static", "rgb_gripper") if getattr(pe, c) is not None and getattr(pe, c).kind == "clip"]
    if clip:
        raise ValueError(
            f"{what} refuses a config with a CLIP camera ({', '.join(clip)}): the JAX package's build_policy_fns "
            f"preprocesses every camera with preprocess_rgb_seq, with no resize and no CLIP normalize, and its fake "
            f"env gives a CLIP camera 200 px frames, on which its RN50's attention pool fails ('add got "
            f"incompatible shapes for broadcasting: (1, 37, 2048), (1, 50, 2048)'); it serves CLIP at no size"
        )
    if pe.tactile is not None:
        raise ValueError(f"{what} refuses a config with a tactile tower: {TACTILE_REFUSAL}")


class PolicyState(NamedTuple):
    plan: torch.Tensor
    latent_goal: torch.Tensor
    carry: Carry  # (L, 1, H), lstm's pair (h, c) of that shape, or the mlp cell's (0,)
    step_count: int


def _keep_indices(robot_obs, keep=((0, 7), (14, 15))):
    return np.concatenate([robot_obs[..., a:b] for a, b in keep], axis=-1)


def proprio_settings(cfg: HulcConfig):
    """(keep_indices, normalize) matching the training loader."""
    p = cfg.perceptual_encoder.proprio
    if p is not None:
        return tuple(p.keep_indices), p.normalize
    return ((0, 7), (14, 15)), True


class StateObsNormalizer:
    """obs -> the proprio vector the training loader feeds: keep_indices
    slicing, normalization with dataset statistics, and the robot_scene
    layout ([robot_obs(15); scene_obs(24)] before slicing)."""

    def __init__(self, cfg: HulcConfig, statistics: Optional[DatasetStatistics]):
        p = cfg.perceptual_encoder.proprio
        self.keep, self.normalize = proprio_settings(cfg)
        self.include_scene = bool(p.include_scene) if p is not None else False
        stats = statistics
        self.rob_mean = stats.robot_obs_mean if stats else np.zeros(15, np.float32)
        self.rob_std = stats.robot_obs_std if stats else np.ones(15, np.float32)
        self.scene_mean = stats.scene_obs_mean if stats else np.zeros(24, np.float32)
        self.scene_std = stats.scene_obs_std if stats else np.ones(24, np.float32)

    def __call__(self, rob_raw: np.ndarray, scene_raw=None) -> np.ndarray:
        """rob_raw (..., 15), scene_raw (..., 24) -> kept proprio (..., k)."""

        def norm(x, mean, std):
            return (x - mean) / np.maximum(std, 1e-6) if self.normalize else x

        state = norm(rob_raw, self.rob_mean, self.rob_std)
        if self.include_scene:
            if scene_raw is None:
                raise ValueError("proprio.include_scene=True needs scene_obs in the env obs")
            state = np.concatenate([state, norm(scene_raw, self.scene_mean, self.scene_std)], axis=-1)
        return _keep_indices(state, self.keep).astype(np.float32)


def build_policy_fns(model: HulcModel, cfg: HulcConfig):
    """The closed-loop device functions, batch-size parametric on the
    leading dim of ``robot_obs_norm`` (single-lane inference passes 1).

    Frames are (E, S, H, W, 3) uint8 on the model's device; embeddings,
    plans, goals and carries (lstm's a pair) are fp32 tensors there. A config with a depth
    camera, a CLIP camera or a tactile tower is refused (``refuse_unserved``).
    """
    refuse_unserved(cfg, "the policy")
    preprocess = preprocess_rgb_seq if model.use_kernels else preprocess_rgb_seq_plain

    def _encode_frame(rgb_static, rgb_gripper, robot_obs_norm):
        rgb_obs = {}
        if rgb_static is not None:
            rgb_obs["rgb_static"] = preprocess(rgb_static)
        if rgb_gripper is not None:
            rgb_obs["rgb_gripper"] = preprocess(rgb_gripper)
        emb, _ = model.encode(rgb_obs, robot_obs_norm)
        return emb

    @torch.no_grad()
    def replan_lang(rgb_static, rgb_gripper, robot_obs_norm, lang_emb, *, generator=None, gumbel=None, normal=None):
        emb = _encode_frame(rgb_static, rgb_gripper, robot_obs_norm)
        latent_goal = model.encode_language_goal(lang_emb)
        plan = model.propose_plan(emb, latent_goal, generator=generator, gumbel=gumbel, normal=normal)
        return plan, latent_goal

    @torch.no_grad()
    def replan_vision(rgb_static2, rgb_gripper2, robot_obs_norm2, *, generator=None, gumbel=None, normal=None):
        """Current + goal frame stacked on the seq axis."""
        emb = _encode_frame(rgb_static2, rgb_gripper2, robot_obs_norm2)
        latent_goal = model.encode_visual_goal(emb[:, -1])
        plan = model.propose_plan(emb[:, :1], latent_goal, generator=generator, gumbel=gumbel, normal=normal)
        return plan, latent_goal

    @torch.no_grad()
    def act(plan, latent_goal, rgb_static, rgb_gripper, robot_obs_norm, robot_obs_raw, carry, *,
            generator=None, u_mix=None, u_inv=None):
        emb = _encode_frame(rgb_static, rgb_gripper, robot_obs_norm)
        action, new_carry = model.decoder_act(
            plan, emb, latent_goal, robot_obs_raw, carry,
            generator=generator, u_mix=u_mix, u_inv=u_inv,
        )
        return action[:, 0], new_carry

    return replan_lang, replan_vision, act


class HulcPolicy:
    """reset()/step(obs, goal) driving the model on its device."""

    def __init__(
        self,
        cfg: HulcConfig,
        model: HulcModel,
        statistics: Optional[DatasetStatistics] = None,
        lang_embeddings: Optional[Dict[str, np.ndarray]] = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.model = model.eval()
        self.device = model.device
        self.replan_freq = cfg.replan_freq
        self.lang_embeddings = lang_embeddings or {}
        self._state_norm = StateObsNormalizer(cfg, statistics)
        self._state: Optional[PolicyState] = None
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._replan_lang, self._replan_vision, self._act = build_policy_fns(model, cfg)

    def reset(self) -> None:
        """Start an episode: no plan, and the noise stream restarted from the
        seed, as the JAX policy restarts from its base key, so every episode
        draws the same noise."""
        self._state = None
        self.generator.manual_seed(self.seed)

    def step(self, obs: Dict, goal, noise: Optional[Dict[str, torch.Tensor]] = None) -> np.ndarray:
        """One env step. goal: instruction str, embedding array, or goal-obs dict.

        noise: optional ``gumbel`` or ``normal`` (the plan's, used when the
        step plans) / ``u_mix`` / ``u_inv`` tensors in place of the
        generator's draws.
        """
        noise = noise or {}
        plan_noise = {k: noise[k] for k in ("gumbel", "normal") if k in noise}
        rgb_static, rgb_gripper, rob_norm, rob_raw = self._split_obs(obs)
        state = self._state
        if state is None or state.step_count % self.replan_freq == 0:
            if isinstance(goal, (str, np.ndarray, torch.Tensor)):
                emb = self.lang_embeddings[goal] if isinstance(goal, str) else goal
                emb = torch.as_tensor(np.asarray(emb, np.float32).reshape(1, -1), device=self.device)
                plan, latent_goal = self._replan_lang(
                    rgb_static, rgb_gripper, rob_norm, emb, generator=self.generator, **plan_noise
                )
            else:
                g_static, g_gripper, g_norm, _ = self._split_obs(goal)

                def _cat_seq(a, b):
                    return torch.cat([a, b], dim=1) if a is not None else None

                plan, latent_goal = self._replan_vision(
                    _cat_seq(rgb_static, g_static),
                    _cat_seq(rgb_gripper, g_gripper),
                    torch.cat([rob_norm, g_norm], dim=1),
                    generator=self.generator,
                    **plan_noise,
                )
            carry = self.model.init_decoder_carry(1)
            state = PolicyState(plan, latent_goal, carry, state.step_count if state else 0)

        action, carry = self._act(
            state.plan, state.latent_goal, rgb_static, rgb_gripper, rob_norm, rob_raw, state.carry,
            generator=self.generator, u_mix=noise.get("u_mix"), u_inv=noise.get("u_inv"),
        )
        self._state = PolicyState(state.plan, state.latent_goal, carry, state.step_count + 1)
        return action[0].cpu().numpy()

    def _split_obs(self, obs: Dict):
        """env obs -> (1, 1, ...) tensors on the device; cameras the config
        does not consume stay on the host."""
        pe = self.cfg.perceptual_encoder
        rgb = obs.get("rgb_obs", {})

        def frame(key, enc):
            if enc is None:
                return None
            return torch.as_tensor(np.asarray(rgb[key], np.uint8)[None, None], device=self.device)

        rob_raw = np.asarray(obs["robot_obs"], np.float32).reshape(1, 1, 15)
        scene_raw = (
            np.asarray(obs["scene_obs"], np.float32).reshape(1, 1, -1)
            if self._state_norm.include_scene and "scene_obs" in obs
            else None
        )
        rob_norm = self._state_norm(rob_raw, scene_raw)
        return (
            frame("rgb_static", pe.rgb_static),
            frame("rgb_gripper", pe.rgb_gripper),
            torch.as_tensor(rob_norm, device=self.device),
            torch.as_tensor(rob_raw, device=self.device),
        )
