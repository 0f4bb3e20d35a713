"""CALVIN play-data store and windowed sequence sampling (port of
hulc_tpu/data/dataset.py, numpy, with the JAX package's RNG streams, so one
seed gives the same windows in both packages).

  * :class:`EpisodeStore`: per-frame npz reader with a ``ram`` cache
    (every key preloaded into contiguous arrays), a ``shm`` cache (a POSIX
    shared-memory arena, ``data.shm_store``) or ``none`` (npz per window).
  * :class:`VisionWindowSampler`: uniform windows of length
    [min_window, max_window] over play episodes.
  * :class:`LangWindowSampler`: windows drawn from the annotated ranges of
    ``auto_lang_ann.npy`` with the ``use_for_aux_lang_loss`` mask.

Padding (pad=True, as calvin_agent): observations repeat the last frame
out to max_window; *relative* actions pad with zero motion while keeping
the last gripper command; absolute actions repeat.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hulc_tpu_torch.data.statistics import DatasetStatistics

OBS_KEYS = ("rgb_static", "rgb_gripper", "depth_static", "depth_gripper")
STATE_KEYS = ("actions", "rel_actions", "robot_obs", "scene_obs")


class EpisodeStore:
    """Frame-indexed access to a CALVIN split directory.

    cache="ram" preloads every key into contiguous arrays (window reads are
    pure slices — the ShmDataset equivalent); cache="none" reads npz files
    per window (DiskDataset equivalent).
    """

    def __init__(
        self,
        split_dir,
        keys: Sequence[str] = ("rgb_static", "rgb_gripper", "actions", "rel_actions", "robot_obs", "scene_obs"),
        cache: str = "ram",
    ):
        self.split_dir = pathlib.Path(split_dir)
        self.keys = tuple(keys)
        ep_ids = np.load(self.split_dir / "ep_start_end_ids.npy")
        self.episode_ranges: List[Tuple[int, int]] = [(int(a), int(b)) for a, b in ep_ids]
        self.statistics = DatasetStatistics.load(self.split_dir)
        # CALVIN frame files are named by absolute frame index; frame numbers
        # need not start at 0 (validation split of D starts mid-range).
        self._min_frame = min(a for a, _ in self.episode_ranges)
        self._max_frame = max(b for _, b in self.episode_ranges)
        self._fmt = self._detect_format()
        self._cache: Optional[Dict[str, np.ndarray]] = None
        self._cache_offset = self._min_frame
        self.shm = None
        if cache == "ram":
            self._build_cache()
        elif cache == "shm":
            self._attach_or_populate_shm()

    def _detect_format(self) -> str:
        for fmt in ("episode_{:07d}.npz", "episode_{:06d}.npz"):
            if (self.split_dir / fmt.format(self._min_frame)).exists():
                return fmt
        raise FileNotFoundError(
            f"no episode files found in {self.split_dir} (frame {self._min_frame})"
        )

    def _build_cache(self) -> None:
        n = self._max_frame - self._min_frame + 1
        self._cache = self.load_frames(self._min_frame, n)

    def load_frames(
        self, start: int, count: int, workers: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        """Decode frames [start, start+count) into per-key stacked arrays,
        npz files decoded across a thread pool (zlib inflate and file reads
        release the GIL; each worker writes a disjoint row of the
        preallocated output). This is the warm-up path; it scales with
        cores. workers=None picks min(16, cpu_count); 1 skips the pool
        entirely.

        Serves both cache builders: the RAM cache and
        ShmEpisodeCache.populate_from_store.
        """
        if self._cache is not None:
            return {k: v.copy() for k, v in self.get_window(start, count).items()}
        first = self._load_frame(start)
        out = {
            k: np.empty((count,) + first[k].shape, first[k].dtype) for k in self.keys
        }
        for k in self.keys:
            out[k][0] = first[k]
        if workers is None:
            workers = min(16, os.cpu_count() or 1)

        def load_into(i: int) -> None:
            frame = self._load_frame(start + i)
            for k in self.keys:
                out[k][i] = frame[k]

        if workers <= 1 or count <= 2:
            for i in range(1, count):
                load_into(i)
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(workers) as ex:
                # consume the iterator so worker exceptions propagate
                list(ex.map(load_into, range(1, count)))
        return out

    def _attach_or_populate_shm(self) -> None:
        """Shared-memory cache (native ShmDataset equivalent): attach an
        existing ready arena or populate one from disk (the 'warm-up')."""
        import hashlib

        from hulc_tpu_torch.data.shm_store import ShmEpisodeCache

        digest = hashlib.sha1(
            (str(self.split_dir.resolve()) + "|" + ",".join(self.keys)).encode()
        ).hexdigest()[:16]
        name = f"/hulc_tpu_torch_{digest}"
        first = self._load_frame(self._min_frame)
        key_meta = {k: (first[k].shape, first[k].dtype) for k in self.keys}
        try:
            shm = ShmEpisodeCache.attach(name, key_meta)
            try:
                # bounded wait: a writer killed mid-populate leaves a
                # never-ready arena — reclaim and repopulate
                shm.wait_ready(timeout_s=1800.0)
            except TimeoutError:
                shm.close()
                ShmEpisodeCache.unlink(name)
                shm = ShmEpisodeCache.populate_from_store(name, self)
        except FileNotFoundError:
            shm = ShmEpisodeCache.populate_from_store(name, self)
        self.shm = shm
        self._cache = {k: shm.key_array(k) for k in self.keys}

    def _load_frame(self, frame_idx: int) -> Dict[str, np.ndarray]:
        with np.load(self.split_dir / self._fmt.format(frame_idx)) as f:
            return {k: f[k] for k in self.keys}

    def get_window(self, start: int, length: int) -> Dict[str, np.ndarray]:
        """Frames [start, start+length) stacked per key."""
        if self._cache is not None:
            o = start - self._cache_offset
            return {k: self._cache[k][o : o + length] for k in self.keys}
        frames = [self._load_frame(start + i) for i in range(length)]
        return {k: np.stack([f[k] for f in frames]) for k in self.keys}

    def gather_padded(
        self,
        key: str,
        starts: Sequence[int],
        lengths: Sequence[int],
        max_window: int,
        n_threads: int = 1,
    ) -> np.ndarray:
        """Batched padded windows; C++ memcpy fast path when shm-cached.

        Pads by repeating the last frame (rel_actions tail-zeroing is the
        caller's responsibility, see loader._assemble). n_threads only
        affects the shm path (C++ std::thread batch split).
        """
        rel = np.asarray(starts, np.int64) - self._cache_offset
        if self.shm is not None:
            return self.shm.gather_windows(
                key, rel, np.asarray(lengths, np.int64), max_window, n_threads
            )
        out = None
        for i, (start, length) in enumerate(zip(starts, lengths)):
            w = self.get_window(int(start), int(length))[key]
            if out is None:
                out = np.empty((len(rel), max_window) + w.shape[1:], w.dtype)
            take = min(length, max_window)
            out[i, :take] = w[:take]
            out[i, take:] = w[take - 1]
        return out

    @property
    def num_frames(self) -> int:
        return sum(b - a + 1 for a, b in self.episode_ranges)


def pad_window(window: Dict[str, np.ndarray], max_window: int) -> Dict[str, np.ndarray]:
    """Pad a sampled window to max_window (calvin_agent pad=True semantics)."""
    out = {}
    for k, v in window.items():
        n = v.shape[0]
        if n >= max_window:
            out[k] = v[:max_window]
            continue
        reps = max_window - n
        if k == "rel_actions":
            # zero motion, keep last gripper command
            pad = np.zeros((reps,) + v.shape[1:], v.dtype)
            pad[:, -1] = v[-1, -1]
        else:
            pad = np.repeat(v[-1:], reps, axis=0)
        out[k] = np.concatenate([v, pad], axis=0)
    return out


@dataclasses.dataclass
class WindowSample:
    start: int
    length: int  # actual (pre-padding) length
    use_for_aux_lang_loss: bool = False
    lang_idx: int = -1  # annotation index (lang sampler only)


class VisionWindowSampler:
    """Uniform window sampling over play episodes (DiskDataset "vis")."""

    def __init__(
        self,
        episode_ranges: Sequence[Tuple[int, int]],
        min_window: int = 20,
        max_window: int = 32,
        seed: int = 0,
    ):
        self.min_window = min_window
        self.max_window = max_window
        self.rng = np.random.default_rng(seed)
        # Valid start indices: every frame with >= min_window frames left in
        # its episode (mirrors calvin_agent episode_lookup construction).
        starts = []
        for a, b in episode_ranges:
            last_start = b + 1 - min_window  # b inclusive
            if last_start >= a:
                starts.append(np.arange(a, last_start + 1))
        self.starts = np.concatenate(starts) if starts else np.zeros(0, np.int64)
        self.ep_end = {int(a): int(b) for a, b in episode_ranges}
        self._ends = np.zeros_like(self.starts)
        i = 0
        for a, b in episode_ranges:
            last_start = b + 1 - min_window
            if last_start >= a:
                n = last_start - a + 1
                self._ends[i : i + n] = b
                i += n

    def __len__(self) -> int:
        return len(self.starts)

    def sample(self) -> WindowSample:
        i = int(self.rng.integers(len(self.starts)))
        return self.sample_at(i)

    def sample_at(self, i: int, deterministic: bool = False) -> WindowSample:
        start = int(self.starts[i])
        remaining = int(self._ends[i]) + 1 - start
        max_len = min(self.max_window, remaining)
        if deterministic:
            length = max_len  # reproducible validation windows
        else:
            length = int(self.rng.integers(self.min_window, max_len + 1))
        return WindowSample(start=start, length=length)


class LangWindowSampler:
    """Windows from language-annotated ranges (DiskDataset "lang").

    auto_lang_ann info/indx gives (start, end) per annotation; valid window
    starts lie inside [start, end - min_window + 1] with stride skip_frames.
    ``use_for_aux_lang_loss`` is True when the sampled window reaches into
    the final ``aux_lang_loss_window`` frames of the annotated range.
    """

    def __init__(
        self,
        split_dir,
        lang_folder: str = "lang_paraphrase-MiniLM-L3-v2",
        min_window: int = 20,
        max_window: int = 32,
        skip_frames: int = 1,
        aux_lang_loss_window: int = 8,
        seed: int = 0,
    ):
        self.min_window = min_window
        self.max_window = max_window
        self.aux_lang_loss_window = aux_lang_loss_window
        self.rng = np.random.default_rng(seed)
        path = pathlib.Path(split_dir) / lang_folder / "auto_lang_ann.npy"
        data = np.load(path, allow_pickle=True).item()
        self.annotations: List[str] = list(data["language"]["ann"])
        self.tasks: List[str] = list(data["language"]["task"])
        emb = np.asarray(data["language"]["emb"], np.float32)
        self.embeddings = emb.reshape(emb.shape[0], -1)  # (N, 384)
        self.ranges: List[Tuple[int, int]] = [(int(a), int(b)) for a, b in data["info"]["indx"]]

        starts, ann_idx, ends = [], [], []
        for j, (a, b) in enumerate(self.ranges):
            last_start = b + 1 - min_window
            if last_start < a:
                continue
            s = np.arange(a, last_start + 1, skip_frames)
            starts.append(s)
            ann_idx.append(np.full(len(s), j))
            ends.append(np.full(len(s), b))
        self.starts = np.concatenate(starts) if starts else np.zeros(0, np.int64)
        self.ann_idx = np.concatenate(ann_idx) if ann_idx else np.zeros(0, np.int64)
        self._ends = np.concatenate(ends) if ends else np.zeros(0, np.int64)

    def __len__(self) -> int:
        return len(self.starts)

    def sample(self) -> WindowSample:
        return self.sample_at(int(self.rng.integers(len(self.starts))))

    def sample_at(self, i: int, deterministic: bool = False) -> WindowSample:
        start = int(self.starts[i])
        end = int(self._ends[i])
        remaining = end + 1 - start
        max_len = min(self.max_window, remaining)
        if deterministic:
            length = max_len  # reproducible validation windows
        else:
            length = int(self.rng.integers(self.min_window, max_len + 1))
        use_aux = (end + 1 - (start + length)) < self.aux_lang_loss_window
        return WindowSample(
            start=start, length=length, use_for_aux_lang_loss=use_aux, lang_idx=int(self.ann_idx[i])
        )
