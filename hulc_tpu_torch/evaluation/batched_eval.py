"""Batched LH-MTLC evaluation (port of hulc_tpu/evaluation/batched_eval.py).

E environments advance through ONE (E, ...) policy step. Replanning is per
lane: a new plan and goal are computed for every lane and merged in where
``replan_mask`` is set, and those lanes' decoder carries (lstm's h and c
alike; the mlp cell has none) restart from zero, so the step keeps one
shape. GCBC's plan is empty, (E, 0). ``evaluate_policy_batched`` drives E
lanes through a queue of instruction chains with that step: each lane moves
to the next instruction on success, aborts its chain on timeout, and pulls
the next chain when done.
"""

from __future__ import annotations

import collections
import pathlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.data.language import restrict_task_pool
from hulc_tpu_torch.data.statistics import DatasetStatistics
from hulc_tpu_torch.evaluation.lh_eval import CHAIN_LEN, build_results, get_sequences, save_video, write_results
from hulc_tpu_torch.evaluation.policy import StateObsNormalizer, refuse_unserved
from hulc_tpu_torch.evaluation.tasks import ALL_TASKS, SceneObsTasks
from hulc_tpu_torch.models.hulc import HulcModel
from hulc_tpu_torch.ops.image_ops import preprocess_rgb_seq, preprocess_rgb_seq_plain


def reset_carry(carry, replan_mask: torch.Tensor):
    """The decoder carry (a (L, E, H) tensor, or lstm's pair of them) with
    the lanes of ``replan_mask`` (E,) set to zero, each tensor alike (JAX's
    ``jax.tree.map`` of the reset); the mlp cell's stateless (0,) carry as
    it is."""
    def reset(t):
        if t.dim() < 2:
            return t
        return torch.where(replan_mask[None, :, None], torch.zeros_like(t), t)

    return tuple(reset(t) for t in carry) if isinstance(carry, tuple) else reset(carry)


def build_batched_step(model: HulcModel, cfg: HulcConfig):
    """The lockstep batched policy step as a function of device tensors; a
    config the JAX package's policies cannot serve (a depth or CLIP camera,
    a tactile tower) is refused (``policy.refuse_unserved``)."""
    refuse_unserved(cfg, "the batched policy")
    preprocess = preprocess_rgb_seq if model.use_kernels else preprocess_rgb_seq_plain

    @torch.no_grad()
    def step_fn(rgb_static, rgb_gripper, rob_norm, rob_raw, lang_emb, plan, latent_goal, carry,
                replan_mask, *, generator=None, gumbel=None, normal=None, u_mix=None, u_inv=None):
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
        new_plan = model.propose_plan(emb, new_goal, generator=generator, gumbel=gumbel, normal=normal)
        m = replan_mask[:, None]
        plan = torch.where(m, new_plan, plan)
        latent_goal = torch.where(m, new_goal, latent_goal)
        carry = reset_carry(carry, replan_mask)
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
            torch.zeros(e, 0 if self.cfg.model_kind == "gcbc" else self.cfg.distribution.plan_dim, device=self.device),
            torch.zeros(e, self.cfg.visual_goal.latent_goal_features, device=self.device),
            self.model.init_decoder_carry(e),
        )

    def step(self, obs_batch: List[Dict], lang_embs: np.ndarray, state, replan_mask: np.ndarray,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        """obs_batch: list of E env obs dicts. Returns (actions (E, 7), state).

        noise: optional ``gumbel`` or ``normal`` (the plan's) / ``u_mix`` /
        ``u_inv`` tensors used in place of the generator's draws (the step
        function's keywords).
        """
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
            generator=self.generator, **(noise or {}),
        )
        return actions.cpu().numpy(), (plan, goal, carry)


def evaluate_policy_batched(
    cfg: HulcConfig,
    model: Optional[HulcModel],
    env_factory: Optional[Callable[[], object]] = None,
    num_sequences: int = 1000,
    num_envs: int = 64,
    ep_len: int = 360,
    oracle: Optional[SceneObsTasks] = None,
    sequences: Optional[List[List[str]]] = None,
    lang_embeddings: Optional[Dict[str, np.ndarray]] = None,
    statistics: Optional[DatasetStatistics] = None,
    epoch: int = 0,
    output_dir=None,
    seed: int = 0,
    envs: Optional[List] = None,
    policy=None,
    results_name: str = "results.json",
    initial_states: Optional[List] = None,
    num_videos: int = 0,
    video_dir=None,
    tsne_path=None,
) -> Dict:
    """LH-MTLC protocol with E lockstep environments.

    ``model`` is the port's HulcModel, or None when ``policy`` is given; with
    both, the policy's model takes ``model``'s weights in place. ``policy``
    is anything with BatchedHulcPolicy's surface (``num_envs``,
    ``replan_freq``, ``initial_state``, ``step``); its state is opaque here
    except for the t-SNE capture, which reads the plan and latent goal as
    ``state[0]`` and ``state[1]``. Results schema identical to
    lh_eval.evaluate_policy.
    """
    oracle = oracle or SceneObsTasks()
    if sequences is None:
        pool = restrict_task_pool(lang_embeddings, ALL_TASKS)
        print(
            "[batched_eval] WARNING: no chains supplied — falling back to "
            "UNIFORM task sampling (not the official LH-MTLC protocol; use "
            "chain_sampler.get_sequences for comparable numbers)."
        )
        sequences = get_sequences(num_sequences, tasks=pool, seed=seed)
    lang_embeddings = lang_embeddings or {}
    lang_dim = (
        next(iter(lang_embeddings.values())).shape[-1] if lang_embeddings else cfg.lang_dim
    )
    # no lane should outnumber the work (an idle lane never receives an
    # observation), nor the lanes a pre-built policy was built for
    num_envs = min(num_envs, len(sequences))
    if policy is not None:
        num_envs = min(num_envs, policy.num_envs)
    if envs is None:
        envs = [env_factory() for _ in range(num_envs)]
    else:
        envs = envs[:num_envs] if len(envs) > num_envs else envs
        num_envs = len(envs)
    if policy is None:
        policy = BatchedHulcPolicy(cfg, model, num_envs, statistics, seed)
    elif model is not None and model is not policy.model:
        policy.model.load_state_dict(model.state_dict())  # reuse the policy across checkpoints
    state = policy.initial_state()

    chain_queue = collections.deque(enumerate(sequences))
    # per-lane trackers
    lane_chain = [None] * num_envs  # (chain_idx, tasks list)
    lane_pos = [0] * num_envs
    lane_steps = [0] * num_envs
    lane_start_info = [None] * num_envs
    lane_obs = [None] * num_envs
    lane_frames = [None] * num_envs  # video capture (reference rollout_lh num_videos)
    done_counts = {}
    task_attempts = collections.defaultdict(int)
    task_successes = collections.defaultdict(int)
    # latent-plan dump (reference tsne_data_<epoch>.npz schema, as in
    # lh_eval): one (plan, goal) sample per attempted subtask, captured at
    # subtask start. The samples stay on the device as copies of one lane's
    # row (a view would keep the whole step's tensor alive) and come to the
    # host in one stacked copy at the end, not one synchronising copy each.
    tsne_pending = [False] * num_envs
    tsne_rows: List = []  # (chain_idx, task, plan_row, goal_row)

    def start_lane(i) -> bool:
        if not chain_queue:
            lane_chain[i] = None
            lane_frames[i] = None
            return False  # lane_obs[i] keeps the last observation (batch filler)
        idx, chain = chain_queue.popleft()
        lane_chain[i] = (idx, chain)
        lane_pos[i] = 0
        lane_steps[i] = 0
        tsne_pending[i] = tsne_path is not None
        if initial_states is not None:
            robot_obs, scene_obs = initial_states[idx % len(initial_states)]
            lane_obs[i] = envs[i].reset(robot_obs=robot_obs, scene_obs=scene_obs)
        else:
            lane_obs[i] = envs[i].reset()
        lane_start_info[i] = envs[i].get_info()
        task_attempts[chain[0]] += 1
        if idx < num_videos and video_dir is not None:
            lane_frames[i] = [np.asarray(lane_obs[i]["rgb_obs"]["rgb_static"])]
        else:
            lane_frames[i] = None
        return True

    def finish_video(i, idx):
        if lane_frames[i]:
            save_video(lane_frames[i], pathlib.Path(video_dir) / f"chain_{idx:04d}")
        lane_frames[i] = None

    def default_emb(task):
        return lang_embeddings.get(task, np.zeros(lang_dim, np.float32))

    for i in range(num_envs):
        start_lane(i)

    replan = np.ones(num_envs, bool)
    t_start = last_print = time.time()
    lockstep_iters = 0
    while any(c is not None for c in lane_chain):
        lockstep_iters += 1
        if time.time() - last_print > 30:
            last_print = time.time()
            rate = lockstep_iters * num_envs / (last_print - t_start)
            print(
                f"[batched_eval] {len(done_counts)}/{len(sequences)} chains done, "
                f"{rate:.0f} env-steps/s ({(last_print - t_start):.0f} s elapsed)",
                flush=True,
            )
        active = [i for i in range(num_envs) if lane_chain[i] is not None]
        obs_batch = [lane_obs[i] for i in range(num_envs)]
        embs = np.stack([
            default_emb(lane_chain[i][1][lane_pos[i]])
            if lane_chain[i]
            else np.zeros(lang_dim, np.float32)
            for i in range(num_envs)
        ])
        replan_in = replan
        actions, state = policy.step(obs_batch, embs, state, replan)
        if tsne_path is not None:
            plan_d, goal_d = state[0], state[1]
            for i in active:
                if tsne_pending[i] and replan_in[i]:
                    idx_i, chain_i = lane_chain[i]
                    tsne_rows.append((idx_i, chain_i[lane_pos[i]], plan_d[i].clone(), goal_d[i].clone()))
                    tsne_pending[i] = False
        replan = np.zeros(num_envs, bool)
        for i in active:
            lane_obs[i] = envs[i].step(actions[i])
            lane_steps[i] += 1
            idx, chain = lane_chain[i]
            if lane_frames[i] is not None:
                lane_frames[i].append(np.asarray(lane_obs[i]["rgb_obs"]["rgb_static"]))
            task = chain[lane_pos[i]]
            success = task in oracle.get_task_info_for_set(
                lane_start_info[i], envs[i].get_info(), {task}
            )
            timeout = lane_steps[i] >= ep_len
            if success:
                task_successes[task] += 1
                lane_pos[i] += 1
                if lane_pos[i] >= len(chain):
                    done_counts[idx] = len(chain)
                    finish_video(i, idx)
                    replan[i] = start_lane(i)
                else:
                    task_attempts[chain[lane_pos[i]]] += 1
                    lane_steps[i] = 0
                    lane_start_info[i] = envs[i].get_info()
                    replan[i] = True
                    tsne_pending[i] = tsne_path is not None
            elif timeout:
                done_counts[idx] = lane_pos[i]
                finish_video(i, idx)
                replan[i] = start_lane(i)
            elif lane_steps[i] % policy.replan_freq == 0:
                replan[i] = True

    if tsne_path is not None and tsne_rows:
        tsne_path = pathlib.Path(tsne_path)
        tsne_path.parent.mkdir(parents=True, exist_ok=True)

        def fetch(col):
            return torch.stack([r[col] for r in tsne_rows]).cpu().numpy().astype(np.float32)

        np.savez(
            tsne_path,
            ids=np.asarray([r[0] for r in tsne_rows], np.int64),
            labels=np.asarray([r[1] for r in tsne_rows]),
            latent_goals=fetch(3),
            plans=fetch(2).reshape(len(tsne_rows), -1),
        )

    chain_successes = np.zeros(CHAIN_LEN, np.int64)
    for done in done_counts.values():
        for k in range(done):
            chain_successes[k] += 1
    results = build_results(
        epoch, list(done_counts.values()), chain_successes, len(sequences),
        task_successes, task_attempts,
    )
    write_results(results, output_dir, results_name)
    results["_policy"] = policy  # the caller may reuse the policy
    return results
