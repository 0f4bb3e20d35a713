"""Where an LH-MTLC evaluator run's wall time goes: the policy step against
the envs, the oracle and the lane bookkeeping.

    python -m hulc_tpu_torch.evaluation.eval_split [--device cuda] [--policy model|expert]

Drives ``evaluate_policy_batched`` with LANES lanes over CHAINS chains at
ep_len EP_LEN, on interactive FakeCalvinEnvs at the ``hulc`` preset's
camera sizes, with feasibility-filtered chains and their matched
resets, and a host clock around every ``policy.step``. The step ends in the
actions' copy to the host, so its device work is inside that clock; the
rest of the wall time is the envs (dynamics and both renders), the oracle
and the loop. ``--policy model`` is the port's BatchedHulcPolicy with
random weights (seed 0), and HulcPolicy through the sequential
``evaluate_policy`` (2 chains, ep_len 60); ``--policy expert`` is the scripted expert, host-side
numpy, which leaves only the env side to time (no sequential run). On
CUDA, one round of lanes (ep_len 30) then runs under torch.profiler for
the device's idle share. Prints one JSON line. ``chip_smoke.py`` runs the
same functions on the card.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Dict, List, NamedTuple

import numpy as np

from hulc_tpu_torch.config import HulcConfig, get_config
from hulc_tpu_torch.evaluation import chain_sampler
from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy, evaluate_policy_batched
from hulc_tpu_torch.evaluation.expert import ScriptedExpertPolicy, task_embeddings
from hulc_tpu_torch.evaluation.fake_env import fake_env_for
from hulc_tpu_torch.evaluation.lh_eval import evaluate_policy
from hulc_tpu_torch.evaluation.policy import HulcPolicy

# the batched run: 64 lockstep lanes over 128 feasibility-filtered chains
# at ep_len 90, three replans an instruction
LANES, CHAINS, EP_LEN = 64, 128, 90
SEQ_CHAINS, SEQ_EP_LEN = 2, 60  # the sequential run
IDLE_EP_LEN = 30  # the profiled run: one round of lanes


class Record(NamedTuple):
    """One lockstep iteration as the policy saw it."""

    obs_batch: List[Dict]
    lang_embs: np.ndarray
    state: object
    replan_mask: np.ndarray
    actions: np.ndarray
    new_state: object


class TimedBatchedPolicy:
    """A batched policy with a host clock around its step; keeps the first
    ``record`` iterations."""

    def __init__(self, inner, record: int = 0):
        self.inner = inner
        self.num_envs, self.replan_freq = inner.num_envs, inner.replan_freq
        self.record = record
        self.records: List[Record] = []
        self.calls = 0
        self.seconds = 0.0

    def initial_state(self):
        return self.inner.initial_state()

    def step(self, obs_batch, lang_embs, state, replan_mask):
        t0 = time.perf_counter()
        actions, new_state = self.inner.step(obs_batch, lang_embs, state, replan_mask)
        self.seconds += time.perf_counter() - t0
        if self.calls < self.record:
            self.records.append(Record(obs_batch, np.array(lang_embs), state, np.array(replan_mask),
                                       actions.copy(), new_state))
        self.calls += 1
        return actions, new_state


class TimedPolicy:
    """HulcPolicy's reset / step with a host clock around the step.

    ``replans`` is what the schedule implies: an instruction (the steps
    between two resets) of n steps plans ceil(n / replan_freq) times. The
    policy's state stays readable as ``_state``, so the evaluator's t-SNE
    capture sees through the wrapper.
    """

    def __init__(self, inner: HulcPolicy):
        self.inner = inner
        self.calls = 0
        self.seconds = 0.0
        self._planned = self._since_reset = 0

    @property
    def _state(self):
        return self.inner._state

    @property
    def replans(self) -> int:
        return self._planned + -(-self._since_reset // self.inner.replan_freq)

    def reset(self) -> None:
        self._planned, self._since_reset = self.replans, 0
        self.inner.reset()

    def step(self, obs, goal):
        t0 = time.perf_counter()
        action = self.inner.step(obs, goal)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self._since_reset += 1
        return action


class CountingEnv:
    """An env that counts its steps and keeps the reset vectors it was given."""

    def __init__(self, env):
        self.env = env
        self.steps = 0
        self.resets: List = []

    def reset(self, robot_obs=None, scene_obs=None):
        self.resets.append(robot_obs)
        return self.env.reset(robot_obs=robot_obs, scene_obs=scene_obs)

    def step(self, action):
        self.steps += 1
        return self.env.step(action)

    def get_info(self):
        return self.env.get_info()

    def get_obs(self):
        return self.env.get_obs()


def _started(envs: List[CountingEnv], initial_states) -> List[int]:
    """The chain index of every reset, from its reset vectors' identity."""
    chain_of = {id(robot): k for k, (robot, _) in enumerate(initial_states)}
    return [chain_of[id(robot)] for env in envs for robot in env.resets]


def _split(wall: float, policy_s: float, steps: int) -> Dict:
    return {
        "wall_s": wall, "env_steps": steps, "env_steps_per_s": steps / wall,
        "policy_s": policy_s, "env_oracle_loop_s": wall - policy_s, "policy_share": policy_s / wall,
    }


def run_batched(cfg: HulcConfig, policy, n_chains: int, ep_len: int, seed: int, output_dir,
                record: int = 0):
    """The batched protocol with ``policy.num_envs`` interactive envs over
    ``n_chains`` chains from ``chain_sampler.get_sequences(n_chains, seed)``.

    Returns (stats, the timed policy, the chain index each reset started).
    """
    pairs = chain_sampler.get_sequences(n_chains, seed=seed)
    envs = [CountingEnv(fake_env_for(cfg, interactive=True)) for _ in range(policy.num_envs)]
    initial_states = chain_sampler.resets_for_env(pairs, envs[0].env)
    timed = TimedBatchedPolicy(policy, record)
    t0 = time.perf_counter()
    results = evaluate_policy_batched(
        cfg, None, num_envs=policy.num_envs, ep_len=ep_len, sequences=[c for _, c in pairs],
        lang_embeddings=task_embeddings(cfg.lang_dim), output_dir=output_dir, envs=envs,
        policy=timed, initial_states=initial_states,
    )
    wall = time.perf_counter() - t0
    stats = {"lanes": policy.num_envs, "chains": n_chains, "ep_len": ep_len, "lockstep_iters": timed.calls,
             **_split(wall, timed.seconds, sum(e.steps for e in envs)), "results": results["0"]}
    return stats, timed, _started(envs, initial_states)


def device_idle_share(cfg: HulcConfig, policy, n_chains: int, ep_len: int, seed: int, output_dir) -> Dict:
    """A batched run (``run_batched``) under torch.profiler: the device's
    busy ms (its CUDA activity) against the run's wall ms. The profiler
    adds host time to every torch call, so the idle share it gives is, if
    anything, high."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hulc_tpu_torch.evaluation.profile_policy import device_events, device_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats, _, _ = run_batched(cfg, policy, n_chains, ep_len, seed, output_dir)
        torch.cuda.synchronize()
    busy = device_ms(device_events(prof))
    wall_ms = stats["wall_s"] * 1e3
    return {"lanes": stats["lanes"], "chains": n_chains, "ep_len": ep_len, "lockstep_iters": stats["lockstep_iters"],
            "wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "policy_share": stats["policy_share"]}


def run_sequential(cfg: HulcConfig, policy: HulcPolicy, n_chains: int, ep_len: int, seed: int, output_dir):
    """The sequential protocol (``lh_eval.evaluate_policy``) with one
    interactive env; instructions are task names, resolved through the
    policy's language embeddings.

    Returns (stats, the chain index each reset started).
    """
    pairs = chain_sampler.get_sequences(n_chains, seed=seed)
    env = CountingEnv(fake_env_for(cfg, interactive=True))
    initial_states = chain_sampler.resets_for_env(pairs, env.env)
    timed = TimedPolicy(policy)
    t0 = time.perf_counter()
    results = evaluate_policy(
        timed, env, ep_len=ep_len, sequences=[c for _, c in pairs], initial_states=initial_states,
        output_dir=output_dir,
    )
    wall = time.perf_counter() - t0
    stats = {"chains": n_chains, "ep_len": ep_len, "policy_steps": timed.calls, "replans": timed.replans,
             **_split(wall, timed.seconds, env.steps), "results": results["0"]}
    return stats, _started([env], initial_states)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--policy", choices=("model", "expert"), default="model")
    args = p.parse_args(argv)
    cfg = get_config("hulc")
    out = {"config": "hulc", "device": args.device, "policy": args.policy}
    with tempfile.TemporaryDirectory() as tmp:
        if args.policy == "expert":
            policy = ScriptedExpertPolicy(LANES, task_embeddings(cfg.lang_dim))
        else:
            import torch

            from hulc_tpu_torch.models import make_model

            torch.backends.cudnn.allow_tf32 = False  # fp32, as chip_smoke.py runs it
            torch.backends.cuda.matmul.allow_tf32 = False
            model = make_model(cfg, args.device, seed=0)
            policy = BatchedHulcPolicy(cfg, model, LANES, seed=0)
            single = HulcPolicy(cfg, model, lang_embeddings=task_embeddings(cfg.lang_dim), seed=0)
            # warm-up, untimed: the kernels' build on first launch, cuDNN's
            # algorithm choice and the allocator, at both lane counts
            run_batched(cfg, policy, LANES, 2, 0, tmp)
            run_sequential(cfg, single, 1, 2, 0, tmp)
        out["batched"], _, _ = run_batched(cfg, policy, CHAINS, EP_LEN, 0, tmp)
        if args.device == "cuda":
            out["profiled"] = device_idle_share(cfg, policy, LANES, IDLE_EP_LEN, 0, tmp)
        if args.policy == "model":
            out["sequential"], _ = run_sequential(cfg, single, SEQ_CHAINS, SEQ_EP_LEN, 0, tmp)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
