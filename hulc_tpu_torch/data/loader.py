"""Batch assembly on the host and the upload to the device (port of
hulc_tpu/data/loader.py).

One loader per modality ("vis" from play windows, "lang" from annotated
windows), combined into ``{"vis": ..., "lang": ...}`` training batches, or,
with ``fuse``, one ``{"fused": 2B}`` batch with the [vis; lang] rows
stacked on the host. A bounded background thread assembles the next batch
while the device computes. Batches leave the host as numpy, images as
uint8; scaling, normalization and augmentation run on the device
(``training.preprocess``).

``DeviceLoader`` uploads them through a ``StagingPool``: each host batch is
copied into one of two pinned staging slots, then to the device by a
non-blocking copy on a side CUDA stream; the consumer's stream waits on the
copy's event, never the host. Batch n+1 is staged and its copy enqueued
when the consumer asks for it, right after it enqueued step n, so the copy
runs under step n.
"""

from __future__ import annotations

import pathlib
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

import torch

from hulc_tpu_torch.config import TACTILE_REFUSAL, HulcConfig
from hulc_tpu_torch.data.dataset import (
    EpisodeStore,
    LangWindowSampler,
    VisionWindowSampler,
)
from hulc_tpu_torch.models.hulc import ModalityBatch
from hulc_tpu_torch.parallel.mesh import rows_of
from hulc_tpu_torch.training.preprocess import batch_to_device


PREFETCH = 2  # host batches assembled ahead of the consumer


def _keep_indices_slice(robot_obs: np.ndarray, keep_indices) -> np.ndarray:
    parts = [robot_obs[..., a:b] for a, b in keep_indices]
    return np.concatenate(parts, axis=-1)


class ModalityLoader:
    """Assembles ModalityBatch structs for one modality ("vis" or "lang").

    ``batch_size`` is the global batch. Rank ``rank`` of ``world`` draws the
    global batch's samples from the shared seed, as one process does, and
    assembles only its rows (``rows_of``): stacked by rank, the ranks'
    batches are the one-process batch."""

    def __init__(
        self,
        store: EpisodeStore,
        sampler,
        cfg: HulcConfig,
        batch_size: int = 32,
        modality: str = "vis",
        seed: int = 0,
        gather_threads: int = 1,
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world:
            raise ValueError(f"a batch of {batch_size} per modality does not split over {world} ranks")
        self.store = store
        self.sampler = sampler
        self.cfg = cfg
        self.batch_size = batch_size
        self.modality = modality
        self.max_window = sampler.max_window
        self.rng = np.random.default_rng(seed)
        self.gather_threads = gather_threads
        self.rank, self.world = rank, world

    def __len__(self) -> int:
        return max(1, len(self.sampler) // self.batch_size)

    def _assemble(self, samples) -> ModalityBatch:
        cfg = self.cfg
        starts = [s.start for s in samples]
        lengths = [s.length for s in samples]

        def stack(key):
            out = self.store.gather_padded(
                key, starts, lengths, self.max_window, n_threads=self.gather_threads
            )
            if key == "rel_actions":
                # pad semantics for relative actions: zero motion, keep the
                # repeated gripper command (pad_window equivalence)
                for i, ln in enumerate(lengths):
                    if ln < self.max_window:
                        out[i, ln:, :6] = 0.0
            return out

        raw_robot = stack("robot_obs")  # (B, S, 15) unnormalized
        stats = self.store.statistics
        norm_robot = (raw_robot - stats.robot_obs_mean) / np.maximum(stats.robot_obs_std, 1e-6)
        proprio_cfg = cfg.perceptual_encoder.proprio
        if proprio_cfg is not None:
            raw_state, norm_state = raw_robot, norm_robot
            if proprio_cfg.include_scene:
                # robot_scene proprioception: [robot_obs; scene_obs], each
                # normalized with its own statistics.yaml entry
                raw_scene = stack("scene_obs")
                norm_scene = (raw_scene - stats.scene_obs_mean) / np.maximum(
                    stats.scene_obs_std, 1e-6
                )
                raw_state = np.concatenate([raw_robot, raw_scene], axis=-1)
                norm_state = np.concatenate([norm_robot, norm_scene], axis=-1)
            robot_obs = _keep_indices_slice(
                norm_state if proprio_cfg.normalize else raw_state, proprio_cfg.keep_indices
            ).astype(np.float32)
        else:
            # reference default (robot_no_joints): 8 dims fed even when the
            # proprio encoder is disabled (batch schema keeps the key)
            robot_obs = _keep_indices_slice(norm_robot, ((0, 7), (14, 15))).astype(np.float32)

        lang = None
        aux_mask = None
        idx = np.asarray([s.start for s in samples], np.int64)
        if self.modality == "lang":
            lang = np.stack([self.sampler.embeddings[s.lang_idx] for s in samples])
            aux_mask = np.asarray([s.use_for_aux_lang_loss for s in samples])
            idx = np.asarray([s.lang_idx for s in samples], np.int64)

        return ModalityBatch(
            # (B, S, H, W, 3) uint8; None for state_only (no cameras loaded)
            rgb_static=stack("rgb_static") if "rgb_static" in self.store.keys else None,
            rgb_gripper=stack("rgb_gripper") if "rgb_gripper" in self.store.keys else None,
            robot_obs=robot_obs,
            actions=stack("rel_actions").astype(np.float32),
            state_info_robot_obs=raw_robot.astype(np.float32),
            lang=lang,
            use_for_aux_lang_loss=aux_mask,
            idx=idx,
            depth_static=stack("depth_static") if "depth_static" in self.store.keys else None,
            depth_gripper=stack("depth_gripper") if "depth_gripper" in self.store.keys else None,
        )

    def draw(self) -> list:
        """Draw one batch worth of window samples (cheap; NOT thread-safe —
        callers with multiple assembly workers serialize draws with a lock)."""
        return [self.sampler.sample() for _ in range(self.batch_size)]

    def mine(self, samples: list) -> list:
        """This rank's share of a global batch's samples."""
        return rows_of(samples, 1, self.world, self.rank)

    def next_batch(self) -> ModalityBatch:
        return self._assemble(self.mine(self.draw()))

    def deterministic_batch(self, step: int, whole: bool = False) -> ModalityBatch:
        """Sequential (wrap-around) batch for validation: this rank's rows, or
        with ``whole`` every rank's."""
        n = len(self.sampler)
        idxs = [(step * self.batch_size + i) % n for i in range(self.batch_size)]
        return self._assemble([self.sampler.sample_at(i, deterministic=True)
                               for i in (idxs if whole else self.mine(idxs))])


class CombinedLoader:
    """Yields {"vis": ModalityBatch, "lang": ModalityBatch} with prefetch.

    Epoch length = max over modality loaders (reference num_training_steps,
    hulc.py:198-200). deterministic=True iterates samples sequentially
    (validation; reference shuffle_val=False).
    """

    def __init__(
        self,
        loaders: Dict[str, ModalityLoader],
        deterministic: bool = False,
        num_workers: int = 1,
        fuse: bool = False,
    ):
        self.loaders = loaders
        self.deterministic = deterministic
        # parallel batch-assembly workers (reference multi-worker dataloaders,
        # conf/datamodule/datasets/vision_dataset/vision.yaml num_workers).
        # Sampling stays serialized under a lock (np rngs aren't thread-safe);
        # the heavy gather/normalize work runs GIL-released in numpy/C++.
        # Deterministic (validation) iteration always uses one worker so the
        # batch order is reproducible.
        self.num_workers = max(1, num_workers)
        # loader-side modality fusion: emit {"fused": 2B-batch} with the
        # [vis; lang] rows already stacked on the host, so the train step's
        # fused pass needs no concat on the device. The lang embedding and
        # aux mask ride on the fused struct (second half).
        if fuse and set(loaders) != {"vis", "lang"}:
            raise ValueError("fuse=True needs exactly the vis+lang modalities")
        self.fuse = fuse
        self._step = 0

    def __len__(self) -> int:
        return max(len(l) for l in self.loaders.values())

    @staticmethod
    def fuse_batch(batch: Dict[str, ModalityBatch]) -> Dict[str, ModalityBatch]:
        """Host-side [vis; lang] row stacking -> {"fused": 2B ModalityBatch}.

        The per-frame/lang-only field split lives on the schema
        (ModalityBatch.LANG_ONLY_FIELDS) so this and the in-graph fusion in
        models/hulc.py can never diverge when a field is added.
        """
        vis, lang = batch["vis"], batch["lang"]

        def cat(f):
            a, c = getattr(vis, f), getattr(lang, f)
            return np.concatenate([a, c], axis=0) if a is not None and c is not None else None

        fields = {
            f: getattr(lang, f) if f in ModalityBatch.LANG_ONLY_FIELDS else cat(f)
            for f in ModalityBatch._fields
        }
        return {"fused": ModalityBatch(**fields)}

    def _make(self) -> Dict[str, ModalityBatch]:
        if self.deterministic:
            out = {k: l.deterministic_batch(self._step) for k, l in self.loaders.items()}
            self._step += 1
            return out
        out = {k: l.next_batch() for k, l in self.loaders.items()}
        return self.fuse_batch(out) if self.fuse else out

    def __iter__(self) -> Iterator[Dict[str, ModalityBatch]]:
        if self.deterministic:
            self._step = 0  # every epoch evaluates the same slice
        n_workers = 1 if self.deterministic else self.num_workers
        q: "queue.Queue" = queue.Queue(maxsize=max(PREFETCH, n_workers))
        stop = threading.Event()
        steps = len(self)
        draw_lock = threading.Lock()
        remaining = [steps]

        def put_bounded(item) -> bool:
            # bounded put so an early-terminated consumer (validate()
            # breaking at max_batches) doesn't leave us blocked forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def draw_all():
            # serialize claiming a step + rng sampling; assembly runs outside
            with draw_lock:
                if remaining[0] <= 0:
                    return None
                remaining[0] -= 1
                if self.deterministic:
                    out = ("det", self._step)
                    self._step += 1
                    return out
                return ("samples", {k: l.draw() for k, l in self.loaders.items()})

        def worker():
            try:
                while not stop.is_set():
                    drawn = draw_all()
                    if drawn is None:
                        return
                    kind, payload = drawn
                    if kind == "det":
                        batch = {
                            k: l.deterministic_batch(payload) for k, l in self.loaders.items()
                        }
                    else:
                        batch = {
                            k: self.loaders[k]._assemble(self.loaders[k].mine(s)) for k, s in payload.items()
                        }
                        if self.fuse:
                            batch = self.fuse_batch(batch)
                    if not put_bounded(batch):
                        return
            except BaseException as exc:  # surface I/O errors to the consumer
                put_bounded(exc)

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(n_workers)]
        for t in threads:
            t.start()
        try:
            for _ in range(steps):
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)


def make_loaders(
    cfg: HulcConfig,
    root_data_dir,
    split: str = "training",
    batch_size: int = 32,
    min_window: int = 20,
    max_window: int = 32,
    lang_folder: str = "lang_paraphrase-MiniLM-L3-v2",
    aux_lang_loss_window: int = 8,
    cache: str = "ram",
    seed: int = 0,
    deterministic: bool = False,
    modalities: Tuple[str, ...] = ("vis", "lang"),
    num_workers: int = 1,
    gather_threads: int = 1,
    fuse: bool = False,
    rank: int = 0,
    world: int = 1,
) -> CombinedLoader:
    """Build the (possibly single-) modality loader for one split.

    modalities: ("vis", "lang") default; ("vis",) / ("lang",) mirror the
    reference's vision_only / lang_only dataset configs. num_workers
    parallelizes whole-batch assembly across Python threads (heavy work is
    GIL-released numpy/C++); gather_threads additionally splits each shm
    C++ gather across std::threads. ``batch_size`` is the global
    per-modality batch; rank ``rank`` of ``world`` gets its rows of each
    (``ModalityLoader``), fused as ``[vis_r; lang_r]``.
    """

    if cfg.perceptual_encoder.tactile is not None:
        raise ValueError(f"make_loaders refuses a config with a tactile tower: {TACTILE_REFUSAL}")
    split_dir = pathlib.Path(root_data_dir) / split
    keys = ["actions", "rel_actions", "robot_obs", "scene_obs"]
    if cfg.perceptual_encoder.rgb_static is not None:
        keys.insert(0, "rgb_static")
    if cfg.perceptual_encoder.rgb_gripper is not None:
        keys.insert(1, "rgb_gripper")
    if cfg.perceptual_encoder.depth_static is not None:
        keys.append("depth_static")
    if cfg.perceptual_encoder.depth_gripper is not None:
        keys.append("depth_gripper")
    store = EpisodeStore(split_dir, keys=keys, cache=cache)

    loaders = {}
    if "vis" in modalities:
        vis_sampler = VisionWindowSampler(store.episode_ranges, min_window, max_window, seed=seed)
        loaders["vis"] = ModalityLoader(
            store, vis_sampler, cfg, batch_size, "vis", seed + 2,
            gather_threads=gather_threads, rank=rank, world=world,
        )
    if "lang" in modalities:
        lang_sampler = LangWindowSampler(
            split_dir,
            lang_folder=lang_folder,
            min_window=min_window,
            max_window=max_window,
            aux_lang_loss_window=aux_lang_loss_window,
            seed=seed + 1,
        )
        loaders["lang"] = ModalityLoader(
            store, lang_sampler, cfg, batch_size, "lang", seed + 3,
            gather_threads=gather_threads, rank=rank, world=world,
        )
    if not loaders:
        raise ValueError(f"no modalities selected from {modalities!r}")
    # val stays per-modality (val_metrics); single-modality runs (vis_only /
    # lang_only configs) have nothing to fuse
    fuse = fuse and not deterministic and set(loaders) == {"vis", "lang"}
    return CombinedLoader(
        loaders, deterministic=deterministic, num_workers=num_workers, fuse=fuse
    )


class StagingPool:
    """Two pinned staging slots, used in turn, and the side stream that
    copies out of them to ``device``.

    ``upload`` copies a host batch into the next slot (one pinned buffer
    per (scope, field, shape, dtype), allocated at first use; a failed
    pinning raises), after that slot's last copy has left it, then copies it
    to fresh device memory by non-blocking copies on the side stream. The
    consumer's current stream waits on the copy's event, never the host. A
    batch handed out stays valid while the consumer holds it. One pool
    serves every loader of a ``Trainer``, so its pinned memory is bounded by
    the batch shapes it has seen, not by the loaders."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._buffers = ({}, {})  # slot -> {(scope, field, shape, dtype): pinned tensor}
        self._copied = [None, None]  # slot -> event after the last copy out of it
        self._slot = 0

    def _pinned(self, slot: int, key, src: torch.Tensor) -> torch.Tensor:
        key = (*key, tuple(src.shape), src.dtype)
        buf = self._buffers[slot].get(key)
        if buf is None:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            if not buf.is_pinned():
                raise RuntimeError(f"the staging buffer of {key} is not in pinned memory")
            self._buffers[slot][key] = buf
        return buf

    def stage(self, batch: Dict[str, ModalityBatch]):
        """Copy a host batch into the next slot: (slot, {scope: pinned fields})."""
        slot, self._slot = self._slot, self._slot ^ 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # the slot's last copy has left its buffers
        staged = {}
        for scope, mod in batch.items():
            fields = []
            for name, x in zip(mod._fields, mod):
                if x is None:
                    fields.append(None)
                    continue
                src = torch.from_numpy(np.ascontiguousarray(x))
                buf = self._pinned(slot, (scope, name), src)
                buf.copy_(src)
                fields.append(buf)
            staged[scope] = fields
        return slot, staged

    def copy(self, staged) -> Dict[str, ModalityBatch]:
        """Enqueue a staged batch's copy on the side stream; the current
        stream waits on it."""
        slot, fields = staged
        consumer = torch.cuda.current_stream(self.device)
        done = torch.cuda.Event()
        out = {}
        with torch.cuda.stream(self.stream):
            for scope, bufs in fields.items():
                out[scope] = ModalityBatch(*(None if b is None else b.to(self.device, non_blocking=True) for b in bufs))
            done.record(self.stream)
        self._copied[slot] = done
        consumer.wait_event(done)
        for mod in out.values():
            for t in mod:
                if t is not None:
                    t.record_stream(consumer)  # freed memory waits for the consumer's work
        return out

    def upload(self, batch: Dict[str, ModalityBatch]) -> Dict[str, ModalityBatch]:
        """One host batch on the device, the current stream waiting on its copy."""
        return self.copy(self.stage(batch))


class DeviceLoader:
    """The batches of ``loader`` (host numpy) on ``device``: on a CUDA
    device through ``pool`` (a ``StagingPool``; a new one when None), so
    batch n+1 is staged and its copy enqueued when the consumer asks for
    it, right after it enqueued step n, and the copy runs under step n. On
    the CPU the batches are ``batch_to_device``'s."""

    def __init__(self, loader, device, pool: Optional[StagingPool] = None):
        self.loader = loader
        self.device = torch.device(device)
        self.pool = None if self.device.type != "cuda" else (pool or StagingPool(self.device))

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Dict[str, ModalityBatch]]:
        for batch in self.loader:
            yield batch_to_device(batch, self.device) if self.pool is None else self.pool.upload(batch)
