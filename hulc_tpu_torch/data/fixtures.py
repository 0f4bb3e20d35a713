"""Synthetic CALVIN-shaped dataset fixtures (a copy of
hulc_tpu/data/fixtures.py: the same seed writes the same bytes).

Writes datasets with the on-disk schema of the CALVIN download: per-frame
``episode_{idx:07d}.npz`` files, ``ep_start_end_ids.npy``,
``statistics.yaml``, ``lang_paraphrase-MiniLM-L3-v2/auto_lang_ann.npy`` and
(validation only) ``embeddings.npy``. ``small=True`` writes 64 / 48 px
cameras (tests), ``small=False`` the 200 / 84 px of the ``hulc`` preset.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Sequence

import numpy as np

LANG_FOLDER = "lang_paraphrase-MiniLM-L3-v2"
EP_FMT = "episode_{:07d}.npz"

FIXTURE_TASKS = [
    "rotate_red_block_right",
    "move_slider_left",
    "open_drawer",
    "turn_on_lightbulb",
    "push_pink_block_left",
]
FIXTURE_ANNOTATIONS = {
    "rotate_red_block_right": "rotate the red block to the right",
    "move_slider_left": "move the door to the left",
    "open_drawer": "pull the drawer open",
    "turn_on_lightbulb": "turn on the light bulb",
    "push_pink_block_left": "push the pink block to the left",
}


def _frame(rng: np.random.Generator, small: bool = False):
    h = 64 if small else 200
    g = 48 if small else 84
    return {
        "rgb_static": rng.integers(0, 255, (h, h, 3), dtype=np.uint8),
        "rgb_gripper": rng.integers(0, 255, (g, g, 3), dtype=np.uint8),
        "depth_static": rng.uniform(0.1, 5.0, (h, h)).astype(np.float32),
        "depth_gripper": rng.uniform(0.01, 2.0, (g, g)).astype(np.float32),
        "actions": np.concatenate(
            [rng.uniform(-1, 1, 6), [rng.choice([-1.0, 1.0])]]
        ).astype(np.float32),
        "rel_actions": np.concatenate(
            [rng.uniform(-1, 1, 6), [rng.choice([-1.0, 1.0])]]
        ).astype(np.float32),
        "robot_obs": np.concatenate(
            [
                rng.uniform(-0.5, 0.5, 3),  # tcp pos
                rng.uniform(-1.4, 1.4, 3),  # tcp orn (canonical euler range)
                rng.uniform(0.0, 0.08, 1),  # gripper width
                rng.uniform(-2.0, 2.0, 7),  # joints
                [rng.choice([-1.0, 1.0])],  # gripper action
            ]
        ).astype(np.float32),
        "scene_obs": rng.uniform(-1, 1, 24).astype(np.float32),
    }


def _render(pos3, h: int) -> np.ndarray:
    """Deterministic image of a 3-vector in [-1, 1]^3: an 8x8 bright marker
    at the (x, y)-proportional pixel location, brightness from z — exactly
    the kind of signal SpatialSoftmax keypoint pooling extracts."""
    img = np.full((h, h, 3), 30, np.uint8)
    u = int((np.clip(pos3[0], -1, 1) + 1) / 2 * (h - 9))
    v = int((np.clip(pos3[1], -1, 1) + 1) / 2 * (h - 9))
    val = np.uint8(120 + (np.clip(pos3[2], -1, 1) + 1) / 2 * 120)
    img[v : v + 8, u : u + 8] = val
    return img


def _learnable_episode(rng: np.random.Generator, episode_len: int, small: bool):
    """Episode whose rel_actions are a smooth, observable function of state:
    the TCP follows per-axis sinusoids, images render the state, and
    rel_actions are the CALVIN-convention deltas (pos*50, orn*20) toward the
    next frame — genuinely learnable behavior cloning (unlike the i.i.d.
    noise frames of the default fixture, which can only be memorized)."""
    t = np.arange(episode_len + 1, dtype=np.float64)[:, None]
    periods = rng.uniform(30, 80, 3)
    phases = rng.uniform(0, 2 * np.pi, 3)
    pos = 0.35 * np.sin(2 * np.pi * t / periods + phases)  # (T+1, 3)
    periods_o = rng.uniform(40, 90, 3)
    phases_o = rng.uniform(0, 2 * np.pi, 3)
    orn = 1.0 * np.sin(2 * np.pi * t / periods_o + phases_o)
    grip = np.sign(np.sin(2 * np.pi * t[:, 0] / rng.uniform(30, 50) + rng.uniform(0, 2 * np.pi)))
    grip[grip == 0] = 1.0
    frames = []
    for i in range(episode_len):
        rel = np.concatenate([
            np.clip((pos[i + 1] - pos[i]) * 50.0, -1, 1),
            np.clip((orn[i + 1] - orn[i]) * 20.0, -1, 1),
            [grip[i + 1]],
        ]).astype(np.float32)
        robot_obs = np.concatenate(
            [pos[i], orn[i], [0.04 + 0.03 * grip[i]], np.zeros(7), [grip[i]]]
        ).astype(np.float32)
        h = 64 if small else 200
        g = 48 if small else 84
        frames.append({
            "rgb_static": _render(pos[i] / 0.35, h),
            "rgb_gripper": _render(orn[i], g),
            "depth_static": np.full((h, h), 1.0 + pos[i, 2], np.float32),
            "depth_gripper": np.full((g, g), 0.5, np.float32),
            "actions": rel.copy(),
            "rel_actions": rel,
            "robot_obs": robot_obs,
            "scene_obs": np.tile(pos[i], 8).astype(np.float32),
        })
    return frames


def write_split(
    split_dir: pathlib.Path,
    num_episodes: int = 2,
    episode_len: int = 64,
    seed: int = 0,
    small: bool = True,
    with_lang: bool = True,
    is_validation: bool = False,
    ann_len: int = 48,
    learnable: bool = False,
    lang_dim: int = 384,
) -> None:
    """Write one split (training/ or validation/) of a synthetic dataset,
    its language embeddings ``lang_dim`` wide (384, as the JAX package's
    fixture writes them always; 1024 for ``hulc_clip_lang``)."""
    split_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    ranges = []
    frame_idx = 0
    for _ in range(num_episodes):
        start = frame_idx
        ep_frames = _learnable_episode(rng, episode_len, small) if learnable else None
        for j in range(episode_len):
            frame = ep_frames[j] if ep_frames is not None else _frame(rng, small)
            np.savez(split_dir / EP_FMT.format(frame_idx), **frame)
            frame_idx += 1
        ranges.append([start, frame_idx - 1])  # inclusive, like CALVIN
    np.save(split_dir / "ep_start_end_ids.npy", np.asarray(ranges, np.int64))

    # statistics.yaml in the real CALVIN layout (transform-targets format)
    rob_mean = [0.0] * 15
    rob_std = [1.0] * 15
    stats = (
        "robot_obs:\n"
        "  - _target_: calvin_agent.utils.transforms.NormalizeVector\n"
        f"    mean: {rob_mean}\n"
        f"    std: {rob_std}\n"
        "scene_obs:\n"
        "  - _target_: calvin_agent.utils.transforms.NormalizeVector\n"
        f"    mean: {[0.0] * 24}\n"
        f"    std: {[1.0] * 24}\n"
        f"act_min_bound: {[-1.0] * 6 + [-1.0]}\n"
        f"act_max_bound: {[1.0] * 6 + [1.0]}\n"
    )
    (split_dir / "statistics.yaml").write_text(stats)

    if with_lang:
        lang_dir = split_dir / LANG_FOLDER
        lang_dir.mkdir(exist_ok=True)
        anns, tasks, embs, indxs = [], [], [], []
        for i, (start, end) in enumerate(ranges):
            # two annotated sub-sequences per episode
            for k in range(2):
                task = FIXTURE_TASKS[(2 * i + k) % len(FIXTURE_TASKS)]
                a_start = start + k * (episode_len // 2)
                a_end = min(a_start + ann_len, end)
                anns.append(FIXTURE_ANNOTATIONS[task])
                tasks.append(task)
                embs.append(rng.normal(size=(1, lang_dim)).astype(np.float32))
                indxs.append((a_start, a_end))
        data = {
            "language": {"ann": anns, "task": tasks, "emb": np.stack(embs)},
            "info": {"indx": indxs},
        }
        np.save(lang_dir / "auto_lang_ann.npy", data, allow_pickle=True)

        if is_validation:
            embeddings = {
                task: {
                    "ann": [FIXTURE_ANNOTATIONS[task]],
                    "emb": rng.normal(size=(1, lang_dim)).astype(np.float32),
                }
                for task in FIXTURE_TASKS
            }
            np.save(lang_dir / "embeddings.npy", embeddings, allow_pickle=True)


def make_fixture_dataset(
    root: pathlib.Path,
    num_episodes: int = 2,
    episode_len: int = 64,
    small: bool = True,
    seed: int = 0,
    learnable: bool = False,
    lang_dim: int = 384,
) -> pathlib.Path:
    """Create training/ + validation/ splits under root; returns root.
    ``lang_dim`` is the language embeddings' width (the JAX package's
    fixture writes 384 always, so its CLI cannot train ``hulc_clip_lang``
    on it).

    learnable=True writes smooth-trajectory episodes whose actions are an
    observable function of the rendered state (convergence-evidence runs);
    the default writes i.i.d. noise frames (schema/shape tests)."""
    root = pathlib.Path(root)
    write_split(root / "training", num_episodes, episode_len, seed, small, True, False,
                learnable=learnable, lang_dim=lang_dim)
    write_split(root / "validation", max(1, num_episodes // 2), episode_len, seed + 1,
                small, True, True, learnable=learnable, lang_dim=lang_dim)
    return root
