"""Training-time rollout callbacks (port of
hulc_tpu/evaluation/rollout_callback.py).

Reference: calvin_agent.rollout.rollout_long_horizon.RolloutLongHorizon
(conf/callbacks/rollout_lh/default.yaml: 128 chains every val epoch,
skip_epochs 1, ep_len 360), which logs ``eval_lh/avg_seq_len``, the metric
the best-checkpoint monitor tracks (conf/callbacks/checkpoint/lh_sr.yaml),
and calvin_agent.rollout.rollout.Rollout (conf/callbacks/rollout/default.yaml,
ep_len 120, single instructions), which logs per-task SR and
``tasks/average_sr`` (monitor conf/callbacks/checkpoint/task_sr.yaml).

Both hook into ``Trainer.fit`` as ``on_epoch_end(trainer, epoch)``. They
never drive ``trainer.model`` itself (a policy puts its model in eval mode):
each keeps one eval copy of the model on the trainer's device, built at its
first rollout, and loads ``trainer.model``'s weights into it every epoch.
In a process group every rank gathers the weights (``Trainer.params``),
rank 0 alone runs the rollouts while the others wait, and the metrics are
broadcast, so every rank's checkpoint policy sees them.
The batched policy over that copy is built once and reused, as JAX reuses
its compiled policy with a parameter swap.
"""

from __future__ import annotations

import collections
import pathlib
import warnings
from typing import Callable, Dict, Optional

import numpy as np

from hulc_tpu_torch.data.language import restrict_task_pool
from hulc_tpu_torch.evaluation import chain_sampler
from hulc_tpu_torch.evaluation.batched_eval import evaluate_policy_batched
from hulc_tpu_torch.evaluation.lh_eval import evaluate_policy, get_sequences, rollout
from hulc_tpu_torch.evaluation.policy import HulcPolicy
from hulc_tpu_torch.evaluation.tasks import ALL_TASKS, SceneObsTasks
from hulc_tpu_torch.models.hulc import make_model
from hulc_tpu_torch.parallel import mesh


class _EvalModel:
    """One eval copy of a trainer's model, refreshed from its weights."""

    def __init__(self):
        self.model = None

    def refresh(self, trainer, params):
        if self.model is None:
            self.model = make_model(trainer.cfg, trainer.device, use_kernels=trainer.use_kernels).eval()
        self.model.load_state_dict(params)
        return self.model


def _on_rank0(trainer, run):
    """``run(params)`` on rank 0 with the trainer's one-device weights, which
    every rank gathers; its result on every rank."""
    params = trainer.params()
    return mesh.broadcast_object(run(params) if mesh.rank() == 0 else None)


def _default_embeddings(lang_embeddings, cfg) -> Dict[str, np.ndarray]:
    if lang_embeddings:
        return lang_embeddings
    return {t: np.zeros(cfg.lang_dim, np.float32) for t in ALL_TASKS}


class RolloutLongHorizonCallback:
    """Per-val-epoch LH rollout, the reference's model-selection signal
    (``eval_lh/avg_seq_len``, monitored by the lh_sr checkpoint preset).

    ``mode="batched"`` (the default) drives every lane in lockstep through
    one ``BatchedHulcPolicy`` (``evaluate_policy_batched``), built at the
    first rollout and reused across epochs with the weights refreshed.
    ``mode="sequential"`` drives one env at a time, for envs that cannot be
    instantiated more than once per process.
    """

    def __init__(
        self,
        env=None,
        oracle=None,
        num_sequences: int = 128,
        ep_len: int = 360,
        rollout_freq: int = 1,
        skip_epochs: int = 1,
        instructions: Optional[Dict[str, str]] = None,
        lang_embeddings: Optional[Dict] = None,
        statistics=None,
        seed: int = 0,
        mode: str = "batched",
        env_factory: Optional[Callable[[], object]] = None,
        num_envs: int = 32,
        num_videos: int = 0,
        video_dir=None,
    ):
        if env is None and env_factory is None:
            raise ValueError("need env (sequential) or env_factory (batched)")
        self.env = env
        self.env_factory = env_factory
        self.oracle = oracle or SceneObsTasks()
        self.num_sequences = num_sequences
        self.ep_len = ep_len
        self.rollout_freq = rollout_freq
        self.skip_epochs = skip_epochs
        self.instructions = instructions
        self.lang_embeddings = lang_embeddings
        self.statistics = statistics
        self.seed = seed
        if mode == "batched" and env_factory is None:
            warnings.warn(
                "RolloutLongHorizonCallback: mode='batched' needs env_factory (a zero-arg callable building one env "
                "per lane); falling back to the SEQUENTIAL evaluator, one env step per policy call. Pass "
                "env_factory=... to keep the batched path.",
                stacklevel=2,
            )
            mode = "sequential"
        self.mode = mode
        if self.mode == "sequential" and self.env is None:
            # fail at construction, not at the first rollout epoch: sequential mode drives one env
            self.env = env_factory()
        self.num_envs = num_envs
        self.num_videos = num_videos
        self.video_dir = video_dir
        self.best_avg_seq_len = -1.0
        # kept across epochs: the eval copy of the model, the batched policy over it, the env pool
        self._eval_model = _EvalModel()
        self._batched_policy = None
        self._envs = None

    def _task_pool_and_chains(self, epoch: int, env):
        """(sequences, initial_states) for this epoch's protocol run."""
        pool = restrict_task_pool(self.lang_embeddings, ALL_TASKS)
        if set(pool) == set(ALL_TASKS):
            # feasibility-filtered protocol chains + matched scene resets
            pairs = chain_sampler.get_sequences(self.num_sequences, seed=self.seed + epoch)
            return [chain for _, chain in pairs], chain_sampler.resets_for_env(pairs, env)
        return (
            get_sequences(self.num_sequences, tasks=pool, seed=self.seed + epoch, chain_len=min(5, len(pool))),
            None,
        )

    def on_epoch_end(self, trainer, epoch: int) -> Optional[Dict[str, float]]:
        if epoch < self.skip_epochs or (epoch - self.skip_epochs) % self.rollout_freq != 0:
            return None
        return _on_rank0(trainer, lambda params: self._rollout(trainer, epoch, params))

    def _rollout(self, trainer, epoch: int, params) -> Dict[str, float]:
        model = self._eval_model.refresh(trainer, params)
        if self.mode == "batched":
            results = self._run_batched(trainer, model, epoch)
        else:
            results = self._run_sequential(trainer, model, epoch)
        r = results[str(epoch)]
        metrics = {"eval_lh/avg_seq_len": r["avg_seq_len"]}
        metrics.update({f"eval_lh/chain_sr_{k}": v for k, v in r["chain_sr"].items()})
        self.best_avg_seq_len = max(self.best_avg_seq_len, r["avg_seq_len"])
        trainer.logger.log(metrics, trainer.step, "rollout")
        print(f"[rollout] epoch {epoch}: avg_seq_len={r['avg_seq_len']:.3f}")
        return metrics

    def _epoch_video_dir(self, trainer, epoch: int):
        """Per-epoch video directory (both rollout modes); an explicit
        video_dir also gets an epoch_<e> subdirectory."""
        if not self.num_videos:
            return None
        base = pathlib.Path(self.video_dir) if self.video_dir is not None else pathlib.Path(trainer.tcfg.run_dir) / "rollout_videos"
        return base / f"epoch_{epoch}"

    def _run_batched(self, trainer, model, epoch: int):
        if self._envs is None:
            self._envs = [self.env_factory() for _ in range(min(self.num_envs, self.num_sequences))]
        sequences, initial_states = self._task_pool_and_chains(epoch, self._envs[0])
        results = evaluate_policy_batched(
            trainer.cfg,
            model,
            envs=self._envs,
            num_sequences=self.num_sequences,
            ep_len=self.ep_len,
            oracle=self.oracle,
            sequences=sequences,
            initial_states=initial_states,
            lang_embeddings=_default_embeddings(self.lang_embeddings, trainer.cfg),
            statistics=self.statistics,
            epoch=epoch,
            seed=self.seed + epoch,
            policy=self._batched_policy,  # None at the first rollout; reused after
            num_videos=self.num_videos,
            video_dir=self._epoch_video_dir(trainer, epoch),
        )
        self._batched_policy = results.pop("_policy", None)
        return results

    def _run_sequential(self, trainer, model, epoch: int):
        policy = HulcPolicy(trainer.cfg, model, statistics=self.statistics, seed=self.seed)
        policy.lang_embeddings = _default_embeddings(self.lang_embeddings, trainer.cfg)
        sequences, initial_states = self._task_pool_and_chains(epoch, self.env)
        return evaluate_policy(
            policy,
            self.env,
            epoch=epoch,
            num_sequences=self.num_sequences,
            ep_len=self.ep_len,
            oracle=self.oracle,
            instructions=self.instructions,
            sequences=sequences,
            initial_states=initial_states,
            seed=self.seed + epoch,
            num_videos=self.num_videos,
            video_dir=self._epoch_video_dir(trainer, epoch),
        )


class RolloutCallback:
    """Short-horizon single-task rollouts logging per-task SR.

    Reference: calvin_agent.rollout.rollout.Rollout wired by
    conf/callbacks/rollout/default.yaml (ep_len 120, one instruction per
    rollout). Emits ``tasks/average_sr`` (the conf/callbacks/checkpoint/
    task_sr.yaml monitor) and ``tasks/<task>_sr`` per attempted task.
    """

    def __init__(
        self,
        env,
        oracle=None,
        num_rollouts: int = 64,
        ep_len: int = 120,
        rollout_freq: int = 1,
        skip_epochs: int = 1,
        instructions: Optional[Dict[str, str]] = None,
        lang_embeddings: Optional[Dict] = None,
        statistics=None,
        seed: int = 0,
    ):
        self.env = env
        self.oracle = oracle or SceneObsTasks()
        self.num_rollouts = num_rollouts
        self.ep_len = ep_len
        self.rollout_freq = rollout_freq
        self.skip_epochs = skip_epochs
        self.instructions = instructions
        self.lang_embeddings = lang_embeddings
        self.statistics = statistics
        self.seed = seed
        self._eval_model = _EvalModel()

    def on_epoch_end(self, trainer, epoch: int) -> Optional[Dict[str, float]]:
        if epoch < self.skip_epochs or (epoch - self.skip_epochs) % self.rollout_freq != 0:
            return None
        return _on_rank0(trainer, lambda params: self._rollout(trainer, epoch, params))

    def _rollout(self, trainer, epoch: int, params) -> Dict[str, float]:
        policy = HulcPolicy(trainer.cfg, self._eval_model.refresh(trainer, params), statistics=self.statistics,
                            seed=self.seed)
        pool = list(restrict_task_pool(self.lang_embeddings, ALL_TASKS))
        policy.lang_embeddings = _default_embeddings(self.lang_embeddings, trainer.cfg)
        rng = np.random.default_rng(self.seed + epoch)
        attempts: Dict[str, int] = collections.defaultdict(int)
        successes: Dict[str, int] = collections.defaultdict(int)
        for i in range(self.num_rollouts):
            task = pool[i % len(pool)] if i < len(pool) else str(rng.choice(pool))
            self.env.reset()
            instruction = (self.instructions or {}).get(task, task)
            attempts[task] += 1
            if rollout(self.env, policy, task, instruction, self.oracle, self.ep_len):
                successes[task] += 1
        per_task = {f"tasks/{t}_sr": successes[t] / attempts[t] for t in sorted(attempts)}
        average = float(np.mean(list(per_task.values())))
        metrics = {"tasks/average_sr": average, **per_task}
        trainer.logger.log(metrics, trainer.step, "rollout")
        print(f"[rollout] epoch {epoch}: tasks/average_sr={average:.3f}")
        return metrics
