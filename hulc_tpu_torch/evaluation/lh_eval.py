"""Long-horizon multi-task language-control (LH-MTLC) evaluation.

Reference protocol (SURVEY.md §3.2, external calvin_agent.evaluation):
1000 chains of 5 language instructions; for each instruction the policy gets
``ep_len`` (360) env steps, replanning every 30; success judged by the task
oracle from env info diffs; a failed instruction aborts the chain. Results
are written as ``evaluation/results.json`` in the exact schema
``{epoch: {"avg_seq_len": f, "chain_sr": {"1".."5": f}, "task_sr": {...}}}``
consumed by the reference's create_plots.py:140-210.

The port's copy of hulc_tpu/evaluation/lh_eval.py; its t-SNE dump reads
the policy's plan and latent goal, device tensors here, through ``.cpu()``.
"""

from __future__ import annotations

import collections
import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hulc_tpu_torch.evaluation.tasks import ALL_TASKS, SceneObsTasks

DEFAULT_EP_LEN = 360
DEFAULT_NUM_SEQUENCES = 1000
CHAIN_LEN = 5


def get_sequences(
    num_sequences: int,
    tasks: Sequence[str] = tuple(ALL_TASKS),
    seed: int = 0,
    chain_len: int = CHAIN_LEN,
) -> List[List[str]]:
    """Uniform chain sampling over a restricted task pool.

    For the official protocol (full 34-task pool) use
    :mod:`hulc_tpu_torch.evaluation.chain_sampler`, which filters chains by
    scene-state feasibility and pairs each chain with its initial scene —
    evaluate.py and the LH rollout callback do so automatically."""
    rng = np.random.default_rng(seed)
    chain_len = min(chain_len, len(tasks))  # small pools -> shorter chains
    chains = []
    for _ in range(num_sequences):
        chains.append(list(rng.choice(list(tasks), size=chain_len, replace=False)))
    return chains


def rollout(
    env,
    policy,
    task: str,
    instruction,
    oracle,
    ep_len: int = DEFAULT_EP_LEN,
    frames: Optional[list] = None,
) -> bool:
    """Run one instruction to success or timeout (reference evaluate_policy
    rollout: model.reset() per subtask, oracle diff vs subtask start).
    When ``frames`` is a list, static-camera frames are appended (video
    capture, reference rollout_lh num_videos)."""
    policy.reset()
    start_info = env.get_info()
    obs = env.get_obs()
    for _ in range(ep_len):
        if frames is not None:
            frames.append(np.asarray(obs["rgb_obs"]["rgb_static"]))
        action = policy.step(obs, instruction)
        obs = env.step(action)
        done = oracle.get_task_info_for_set(start_info, env.get_info(), {task})
        if task in done:
            return True
    return False


def save_video(frames, path) -> None:
    """Write captured frames as a compressed npz (+ .gif when imageio is
    available)."""
    import pathlib as _pl

    path = _pl.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path.with_suffix(".npz"), frames=np.stack(frames))
    try:
        import imageio

        imageio.mimsave(path.with_suffix(".gif"), list(frames), fps=15)
    except ImportError:
        pass


def evaluate_policy(
    policy,
    env,
    epoch: int = 0,
    num_sequences: int = DEFAULT_NUM_SEQUENCES,
    ep_len: int = DEFAULT_EP_LEN,
    oracle: Optional[SceneObsTasks] = None,
    sequences: Optional[List[List[str]]] = None,
    instructions: Optional[Dict[str, str]] = None,
    initial_states: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
    output_dir: Optional[pathlib.Path] = None,
    seed: int = 0,
    num_videos: int = 0,
    video_dir: Optional[pathlib.Path] = None,
    results_name: str = "results.json",
    tsne_path: Optional[pathlib.Path] = None,
) -> Dict:
    """Run the LH-MTLC protocol; returns the per-epoch results dict.

    instructions: task -> natural-language instruction (or embedding) passed
    to the policy; defaults to the task name (policies with loaded lang
    embeddings resolve instruction strings).
    """
    oracle = oracle or SceneObsTasks()
    if sequences is None:
        print(
            "[lh_eval] WARNING: no chains supplied — falling back to UNIFORM "
            "task sampling, which is NOT the official LH-MTLC protocol. "
            "Numbers will not be comparable to published results; use "
            "hulc_tpu_torch.evaluation.chain_sampler.get_sequences for "
            "feasibility-filtered protocol chains (the eval CLI and rollout "
            "callback do this automatically)."
        )
        sequences = get_sequences(num_sequences, seed=seed)
    chain_successes = np.zeros(CHAIN_LEN, np.int64)
    task_attempts: Dict[str, int] = collections.defaultdict(int)
    task_successes: Dict[str, int] = collections.defaultdict(int)
    seq_lens = []
    # latent-plan dump for t-SNE figures (reference tsne_data_<epoch>.npz
    # with ids/labels/latent_goals/plans, create_plots.py:402-445)
    tsne: Dict[str, list] = {"ids": [], "labels": [], "latent_goals": [], "plans": []}

    for i, chain in enumerate(sequences):
        if initial_states is not None:
            robot_obs, scene_obs = initial_states[i % len(initial_states)]
            env.reset(robot_obs=robot_obs, scene_obs=scene_obs)
        else:
            env.reset()
        done_count = 0
        frames = [] if (i < num_videos and video_dir is not None) else None
        for task in chain:
            instruction = (instructions or {}).get(task, task)
            task_attempts[task] += 1
            ok = rollout(env, policy, task, instruction, oracle, ep_len, frames=frames)
            state = getattr(policy, "_state", None)
            if tsne_path is not None and state is not None:
                tsne["ids"].append(i)
                tsne["labels"].append(task)
                tsne["latent_goals"].append(state.latent_goal[0].cpu().numpy().astype(np.float32))
                tsne["plans"].append(state.plan[0].cpu().numpy().astype(np.float32).reshape(-1))
            if ok:
                task_successes[task] += 1
                done_count += 1
            else:
                break
        if frames:
            save_video(frames, pathlib.Path(video_dir) / f"chain_{i:04d}")
        for k in range(done_count):
            chain_successes[k] += 1
        seq_lens.append(done_count)

    if tsne_path is not None and tsne["ids"]:
        tsne_path = pathlib.Path(tsne_path)
        tsne_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(
            tsne_path,
            ids=np.asarray(tsne["ids"], np.int64),
            labels=np.asarray(tsne["labels"]),
            latent_goals=np.stack(tsne["latent_goals"]),
            plans=np.stack(tsne["plans"]),
        )

    results = build_results(epoch, seq_lens, chain_successes, len(sequences), task_successes, task_attempts)
    write_results(results, output_dir, results_name)
    return results


def build_results(epoch, seq_lens, chain_successes, n_sequences, task_successes, task_attempts) -> Dict:
    """Assemble the results.json schema (shared with the batched evaluator)."""
    return {
        str(epoch): {
            "avg_seq_len": float(np.mean(seq_lens)),
            "chain_sr": {
                str(k + 1): float(chain_successes[k] / n_sequences) for k in range(CHAIN_LEN)
            },
            "task_sr": {
                t: float(task_successes[t] / task_attempts[t]) for t in sorted(task_attempts)
            },
            # success/total counts (reference results schema field consumed by
            # create_plots.py:255-260 for count-filtered task bars)
            "task_info": {
                t: {"success": int(task_successes[t]), "total": int(task_attempts[t])}
                for t in sorted(task_attempts)
            },
        }
    }


def write_results(results: Dict, output_dir, results_name: str = "results.json") -> None:
    """Merge-update <output_dir>/<results_name> (no-op when output_dir is None).

    NOTE: the merge is read-modify-write without locking; concurrent writers
    must use distinct results_name files (run_parallel does) and merge after.
    """
    if output_dir is None:
        return
    output_dir = pathlib.Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    path = output_dir / results_name
    existing = json.loads(path.read_text()) if path.exists() else {}
    existing.update(results)
    path.write_text(json.dumps(existing, indent=2))
