"""Serving runtime for exported policy artifacts, without the port's model
code (port of hulc_tpu/serving/runtime.py).

Loads a directory written by :func:`hulc_tpu_torch.serving.export.export_policy`
and serves the ``reset()`` / ``step(obs, goal)`` contract of
``evaluation.policy.HulcPolicy`` (and the lockstep step of
``evaluation.batched_eval.BatchedHulcPolicy``) from the ``torch.export``
programs alone, with torch, numpy and the port's kernel ops
(``ops.library``, registered before a program is loaded): no models, no
config, no evaluator. Everything shape- or semantics-bearing comes from
``meta.json``: the observation normalization, the replan cadence, the
decoder carry (a tensor, lstm's pair (h, c), or the mlp cell's empty
one), the cameras, and the noise.

The programs take their noise as inputs. The runtime draws it from its own
``torch.Generator`` on the serving device, seeded as the live policy's, in
the live policy's order and shapes (``meta.json``'s ``noise``): on a step
that plans, the plan's noise (a discrete plan's one ``torch.rand`` through
``gumbel_of_uniform``, a continuous plan's one ``torch.randn``); on every step
the sampler's two ``torch.rand`` draws, mapped into (U_MIN, U_MAX) by
``map_uniforms`` (the map the sampler kernel applies to raw draws, rounded
alike). An artifact whose model makes no such draw (GCBC's empty plan, the
deterministic decoder) lists none and its programs take none. So a served
step gives the live step's action. ``step(...,
noise=)`` takes injected noise instead, as ``HulcPolicy.step`` does.

Programs exported on another device than the serving one are moved
(``torch.export.passes.move_to_device_pass``); on the card the ``hulc::``
ops launch the hand kernels.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from hulc_tpu_torch.device import resolve_device
from hulc_tpu_torch.ops import library  # noqa: F401 (registers the hulc:: ops the programs call)
from hulc_tpu_torch.ops.logistic_mixture import map_uniforms
from hulc_tpu_torch.ops.plan_distributions import gumbel_of_uniform
from hulc_tpu_torch.serving.params_io import unflatten_params

FORMAT_VERSION = 1


def _zero_carry(spec: Dict, batch: int, device):
    """The decoder's zero carry from meta.json's ``carry``: (L, B, H), for
    lstm the pair (h, c) of that shape, for the stateless mlp cell an empty
    (0,) tensor (JAX's runtime)."""
    if spec["rnn_cell"] == "mlp":
        return torch.zeros((0,), device=device)
    h = torch.zeros((spec["num_layers"], batch, spec["hidden_size"]), device=device)
    return (h, torch.zeros_like(h)) if spec["rnn_cell"] == "lstm" else h


class _MetaNormalizer:
    """``evaluation.policy.StateObsNormalizer`` semantics rebuilt from
    meta.json (no config)."""

    def __init__(self, meta: Dict):
        p = meta["proprio"]
        self.keep = [tuple(k) for k in p["keep"]]
        self.normalize = p["normalize"]
        self.include_scene = p["include_scene"]
        self.rob_mean = np.asarray(p["robot_obs_mean"], np.float32)
        self.rob_std = np.asarray(p["robot_obs_std"], np.float32)
        self.scene_mean = np.asarray(p["scene_obs_mean"], np.float32)
        self.scene_std = np.asarray(p["scene_obs_std"], np.float32)

    def __call__(self, rob_raw: np.ndarray, scene_raw=None) -> np.ndarray:
        def norm(x, mean, std):
            return (x - mean) / np.maximum(std, 1e-6) if self.normalize else x

        state = norm(rob_raw, self.rob_mean, self.rob_std)
        if self.include_scene:
            if scene_raw is None:
                raise ValueError("artifact was exported with include_scene=True; obs needs scene_obs")
            state = np.concatenate([state, norm(scene_raw, self.scene_mean, self.scene_std)], axis=-1)
        return np.concatenate([state[..., a:b] for a, b in self.keep], axis=-1).astype(np.float32)


class _Artifact:
    """The programs, weights, normalizer and embeddings of an artifact
    directory, on ``device``."""

    def __init__(self, artifact_dir, device):
        self.dir = pathlib.Path(artifact_dir)
        self.device = resolve_device(device)
        self.meta = json.loads((self.dir / "meta.json").read_text())
        if self.meta["format_version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported artifact format {self.meta['format_version']}")
        with np.load(self.dir / "params.npz") as z:
            self.params = unflatten_params({k: z[k] for k in z.files}, self.device)
        self._fns = {}
        for path in sorted(self.dir.glob("*.pt2")):
            program = torch.export.load(path)
            if torch.device(self.meta["device"]) != self.device:
                program = move_to_device_pass(program, self.device)
            self._fns[path.stem] = program.module()
        self.norm = _MetaNormalizer(self.meta)
        emb_path = self.dir / "lang_embeddings.npy"
        self.lang_embeddings: Dict[str, np.ndarray] = (
            np.load(emb_path, allow_pickle=True).item() if emb_path.exists() else {}
        )

    def fn(self, name: str):
        if name not in self._fns:
            raise KeyError(f"artifact {self.dir} has no '{name}.pt2' (available: {sorted(self._fns)})")
        return self._fns[name]

    def tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def plan_draws(self, noise: Dict, lanes: int, generator: torch.Generator) -> tuple:
        """The replan's noise inputs: the injected or drawn plan noise
        (``gumbel`` for a discrete plan, ``normal``), or none (GCBC's empty
        plan draws none)."""
        name = next((k for k in self.meta["noise"]["order"] if k in ("gumbel", "normal")), None)
        if name is None:
            return ()
        return (self.tensor(noise[name]) if name in noise else self.draw(name, lanes, generator),)

    def act_draws(self, noise: Dict, lanes: int, generator: torch.Generator) -> tuple:
        """The act's noise inputs: the injected or drawn (u_mix, u_inv), or
        none (the deterministic decoder)."""
        if "u_mix" not in self.meta["noise"]["order"]:
            return ()
        if "u_mix" in noise:
            return self.tensor(noise["u_mix"]), self.tensor(noise["u_inv"])
        return self.mixture_uniforms(lanes, generator)

    def draw(self, name: str, lanes: int, generator: torch.Generator) -> torch.Tensor:
        """One draw of the live policy's noise ``name`` for ``lanes`` lanes,
        as the program takes it."""
        shape = (lanes, *self.meta["noise"][name])
        if name == "normal":
            return torch.randn(shape, generator=generator, device=self.device)
        u = torch.rand(shape, generator=generator, device=self.device)
        return gumbel_of_uniform(u) if name == "gumbel" else u

    def mixture_uniforms(self, lanes: int, generator: torch.Generator):
        """The sampler's two draws (u_mix, then u_inv), mapped into (U_MIN, U_MAX)."""
        lo, span = self.meta["noise"]["uniform_map"]
        raw = [self.draw(k, lanes, generator) for k in ("u_mix", "u_inv")]
        return tuple(map_uniforms(u, lo, span) for u in raw)

    def zero_obs(self) -> Dict:
        """A zero observation matching the artifact's camera / proprio spec
        (for warm-up calls before serving traffic)."""
        cams = self.meta["cameras"]
        obs: Dict = {"robot_obs": np.zeros((15,), np.float32), "rgb_obs": {}}
        for key in ("rgb_static", "rgb_gripper"):
            if cams[key] is not None:
                obs["rgb_obs"][key] = np.zeros((cams[key], cams[key], 3), np.uint8)
        if self.norm.include_scene:
            obs["scene_obs"] = np.zeros_like(self.norm.scene_mean)
        return obs

    def frames(self, obs_batch, key: str) -> Optional[torch.Tensor]:
        """(E, 1, H, W, 3) uint8 frames of camera ``key`` on the device."""
        if self.meta["cameras"][key] is None:
            return None
        return self.tensor(np.stack([np.asarray(o["rgb_obs"][key], np.uint8) for o in obs_batch])[:, None])

    def split_obs(self, obs_batch):
        """E env obs -> (rgb_static, rgb_gripper, rob_norm, rob_raw) on the device."""
        rob_raw = np.stack([np.asarray(o["robot_obs"], np.float32).reshape(15) for o in obs_batch])[:, None]
        scene_raw = (
            np.stack([np.asarray(o["scene_obs"], np.float32) for o in obs_batch])[:, None]
            if self.norm.include_scene and "scene_obs" in obs_batch[0]
            else None
        )
        rob_norm = self.norm(rob_raw, scene_raw)
        return (self.frames(obs_batch, "rgb_static"), self.frames(obs_batch, "rgb_gripper"),
                self.tensor(rob_norm), self.tensor(rob_raw))


class ServedPolicy:
    """``HulcPolicy``-compatible ``reset()`` / ``step(obs, goal)`` from an
    artifact directory, on ``device`` (CUDA unless the caller asks for
    another)."""

    def __init__(self, artifact_dir, seed: int = 0, device="cuda"):
        self._art = _Artifact(artifact_dir, device)
        self.device = self._art.device
        self.meta = self._art.meta
        self.params = self._art.params
        self.replan_freq = self.meta["replan_freq"]
        self.lang_embeddings = self._art.lang_embeddings
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._plan = self._goal = self._carry = None
        self._step_count = 0

    def reset(self) -> None:
        """Start an episode: no plan, and the noise stream restarted from the
        seed, as ``HulcPolicy.reset()`` does, so served and live actions
        agree in every episode."""
        self._plan = None
        self._step_count = 0
        self.generator.manual_seed(self.seed)

    def warmup(self) -> None:
        """Run every program once (lang replan, vision replan, act) before
        serving traffic. Leaves the policy's state and noise stream untouched."""
        saved = (self.generator.get_state(), self._plan, self._goal, self._carry, self._step_count)
        obs = self._art.zero_obs()
        self.reset()
        self.step(obs, np.zeros((self.meta["lang_dim"],), np.float32))
        self.reset()
        self.step(obs, obs)
        rng_state, self._plan, self._goal, self._carry, self._step_count = saved
        self.generator.set_state(rng_state)

    def load_lang_embeddings(self, embeddings_path) -> None:
        embeddings = np.load(embeddings_path, allow_pickle=True).item()
        self.lang_embeddings = {v["ann"][0]: np.asarray(v["emb"]).reshape(-1) for v in embeddings.values()}

    def step(self, obs: Dict, goal, noise: Optional[Dict[str, torch.Tensor]] = None) -> np.ndarray:
        """One env step. goal: instruction str, embedding array, or goal-obs dict.

        noise: optional ``gumbel`` or ``normal`` (the plan's, as the artifact
        names it in ``meta.json``; used when the step plans) / ``u_mix`` /
        ``u_inv`` tensors, the sampler's uniforms in (U_MIN, U_MAX), in place
        of the generator's draws.
        """
        art, noise = self._art, noise or {}
        rgb_static, rgb_gripper, rob_norm, rob_raw = art.split_obs([obs])
        if self._plan is None or self._step_count % self.replan_freq == 0:
            plan_noise = art.plan_draws(noise, 1, self.generator)
            if isinstance(goal, (str, np.ndarray, torch.Tensor)):
                emb = self.lang_embeddings[goal] if isinstance(goal, str) else goal
                emb = art.tensor(np.asarray(emb, np.float32).reshape(1, -1))
                self._plan, self._goal = art.fn("replan_lang")(
                    self.params, rgb_static, rgb_gripper, rob_norm, emb, *plan_noise
                )
            else:
                g_static, g_gripper, g_norm, _ = art.split_obs([goal])

                def _cat(a, b):
                    return torch.cat([a, b], dim=1) if a is not None else None

                self._plan, self._goal = art.fn("replan_vision")(
                    self.params, _cat(rgb_static, g_static), _cat(rgb_gripper, g_gripper),
                    torch.cat([rob_norm, g_norm], dim=1), *plan_noise,
                )
            self._carry = _zero_carry(self.meta["carry"], 1, self.device)
        action, self._carry = art.fn("act")(
            self.params, self._plan, self._goal, rgb_static, rgb_gripper, rob_norm, rob_raw, self._carry,
            *art.act_draws(noise, 1, self.generator),
        )
        self._step_count += 1
        return action[0].cpu().numpy()


class ServedBatchedPolicy:
    """``BatchedHulcPolicy``-compatible lockstep stepper from an artifact
    with a ``step_batched.pt2`` (exported with lanes=E), on ``device``.
    Drop-in ``policy=`` for ``evaluation.batched_eval.evaluate_policy_batched``."""

    def __init__(self, artifact_dir, seed: int = 0, device="cuda"):
        self._art = _Artifact(artifact_dir, device)
        self.device = self._art.device
        self.meta = self._art.meta
        self.params = self._art.params
        if not self.meta.get("lanes"):
            raise ValueError(
                "artifact has no batched step — export with lanes=E "
                "(serving.export.export_policy(..., lanes=E))"
            )
        self.num_envs = self.meta["lanes"]
        self.replan_freq = self.meta["replan_freq"]
        self.lang_embeddings = self._art.lang_embeddings
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._step = self._art.fn("step_batched")

    def initial_state(self):
        e, dev = self.num_envs, self.device
        return (
            torch.zeros((e, self.meta["plan_dim"]), device=dev),
            torch.zeros((e, self.meta["latent_goal_features"]), device=dev),
            _zero_carry(self.meta["carry"], e, dev),
        )

    def warmup(self) -> None:
        """Run the lockstep step once before serving traffic; leaves the
        noise stream untouched."""
        rng_state = self.generator.get_state()
        obs = [self._art.zero_obs()] * self.num_envs
        embs = np.zeros((self.num_envs, self.meta["lang_dim"]), np.float32)
        self.step(obs, embs, self.initial_state(), np.ones((self.num_envs,), bool))
        self.generator.set_state(rng_state)

    def step(self, obs_batch, lang_embs: np.ndarray, state, replan_mask: np.ndarray,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        """obs_batch: up to E env obs dicts. Returns (actions (n, 7), state).

        noise: optional E-lane ``gumbel`` or ``normal`` (the plan's) /
        ``u_mix`` / ``u_inv`` tensors in place of the generator's draws.
        """
        # The exported step is FIXED at lanes=E: pad an under-filled batch
        # (e.g. fewer eval chains than exported lanes) with the last obs and
        # return only the real lanes' actions. Filler lanes never replan, so
        # their plan/goal/carry stay zero and cost nothing semantically.
        art, noise = self._art, noise or {}
        n, e = len(obs_batch), self.num_envs
        if n > e:
            raise ValueError(f"got {n} lanes but the artifact was exported with lanes={e}")
        if n < e:
            obs_batch = list(obs_batch) + [obs_batch[-1]] * (e - n)
            lang_embs = np.concatenate([
                np.asarray(lang_embs, np.float32),
                np.zeros((e - n, np.asarray(lang_embs).shape[-1]), np.float32),
            ])
            replan_mask = np.concatenate([np.asarray(replan_mask, bool), np.zeros((e - n,), bool)])
        rgb_static, rgb_gripper, rob_norm, rob_raw = art.split_obs(obs_batch)
        draws = art.plan_draws(noise, e, self.generator) + art.act_draws(noise, e, self.generator)
        plan, goal, carry = state
        actions, plan, goal, carry = self._step(
            self.params, rgb_static, rgb_gripper, rob_norm, rob_raw,
            art.tensor(np.asarray(lang_embs, np.float32)), plan, goal, carry,
            art.tensor(np.asarray(replan_mask, bool)), *draws,
        )
        return actions.cpu().numpy()[:n], (plan, goal, carry)
