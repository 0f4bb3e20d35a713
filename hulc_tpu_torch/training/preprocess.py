"""On-device batch preprocessing (port of hulc_tpu/training/preprocess.py:21-122).

uint8 (B, S, H, W, C) camera frames become normalized (B, S, C, H, W) in
the model's compute dtype (fp32, or bf16: the fp32 normalize rounded once,
as JAX's ``_prep_one(..., dtype)``), by the camera's encoder (JAX's
``_prep_one``):

* a CNN camera at its encoder's size: ``(v / 255 - 0.5) / 0.5``, with the
  random shift when training (``ops.image_ops``, B.1 / B.1');
* a frame whose H is not its encoder's ``input_size`` is resized to it
  (``jax.image.resize``'s bilinear, antialiased), as JAX's size check does;
* the CLIP branch: the resize (200 -> 224 for the dataset's frames), in
  training with a shift the rounding to bf16 and the shift (pad
  ``shift_pad``), then CLIP's normalize (``v / 255``, then per channel
  ``(x - mean) / std``);
* the tactile branch: a resize to ``input_size + 6``, in training the bf16
  rounding and a shift with pad 3, the crop [3:-3], then ``(v * (1 / 255)
  - 0.5) / 0.5``. A 160 x 120 frame is resized twice, to 64 and then to 70,
  as JAX's size check and the branch do.

Every resized camera is one launch of B.15 (``ops.image_ops.resize_preprocess``;
the tactile double resize too: its fp32 64 px intermediate stays in the
launch's shared memory, ``FramePrep.pre``). fp32
(B, S, H, W) depth frames pass through when evaluating and take their noise
when training (``ops.depth_noise``: the gamma mode on the static camera,
the gaussian one with std 0.01 on the gripper camera); depth is never
shifted. Per modality the draws come from the caller's ``torch.Generator``
in a fixed order, the static camera's shifts, the gripper camera's, the
tactile camera's, then the static depth's noise and the gripper depth's,
unless the caller passes them (``shifts[scope][camera]``, (B*S, 2) each;
``depth_noise[scope][camera]``, the raw standard-normal draw of the
frames' shape), as the tests pass what JAX drew. On CUDA frames the depth
noise is drawn inside B.10's launch from the CUDA generator's seed and
offset (``ops.depth_noise.draw_depth_noise``; a generator on another
device is refused); on CPU frames it is a ``torch.randn`` tensor, which
then takes the noised frames. The raw batch is never written. With
several ranks each draw is the global batch's, and a rank keeps its rows
(``parallel.mesh.draw_rows``; B.10 computes only its rows of the global
draw, ``mesh.row_placement``), so every generator moves as the
one-device step's does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hulc_tpu_torch.config import HulcConfig, VisionEncoderConfig
from hulc_tpu_torch.models.hulc import ModalityBatch
from hulc_tpu_torch.ops.depth_noise import draw_depth_noise, prep_depth, prep_depth_plain
from hulc_tpu_torch.ops.image_ops import (
    TACTILE_PAD,
    clip_prep,
    draw_shifts,
    preprocess_rgb_seq,
    preprocess_rgb_seq_plain,
    preprocess_rgb_seq_shift,
    preprocess_rgb_seq_shift_plain,
    resize_preprocess,
    resize_preprocess_plain,
    rgb_prep,
    tactile_prep,
)
from hulc_tpu_torch.parallel import mesh

# each camera's field of the batch and its encoder's field of the config
CAMERAS = (("rgb_static", "rgb_static"), ("rgb_gripper", "rgb_gripper"), ("rgb_tactile", "tactile"))
# each depth camera's training noise (JAX: _prep_depth's gamma_noise / gaussian_std)
DEPTH_CAMERAS = (("depth_static", "gamma", 0.0), ("depth_gripper", "gaussian", 0.01))


def batch_to_device(batch: Dict[str, ModalityBatch], device) -> Dict[str, ModalityBatch]:
    """Every field as a tensor on ``device``: numpy arrays and tensors
    elsewhere are copied; a tensor already there (``"cuda"`` meaning the
    current CUDA device) is passed as it is, so an uploaded batch is not
    copied again."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def move(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor) and x.device == device:
            return x
        return (torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x).to(device)

    return {scope: ModalityBatch(*(move(x) for x in mod)) for scope, mod in batch.items()}


def train_shift_pad(enc: VisionEncoderConfig) -> int:
    """The pad of the shift a camera of ``enc`` takes in training: the
    tactile branch's own (3), else the encoder's ``shift_pad``."""
    return TACTILE_PAD if enc.kind == "tactile" else enc.shift_pad


def prep_camera(enc: VisionEncoderConfig, imgs: torch.Tensor, train: bool, dtype: torch.dtype,
                draw_shifts_for=None, use_kernels: bool = True) -> torch.Tensor:
    """One camera's (B, S, H, W, C) uint8 frames -> (B, S, C, h, w) ``dtype``
    (JAX's ``_prep_one``). ``draw_shifts_for(n, pad)`` gives the (n, 2)
    shifts where the branch shifts."""
    b, s, h, w, c = imgs.shape
    if enc.kind in ("spatial_softmax", "nature_cnn") and h == enc.input_size:
        if train and enc.shift_pad > 0:
            fn = preprocess_rgb_seq_shift if use_kernels else preprocess_rgb_seq_shift_plain
            return fn(imgs, draw_shifts_for(b * s, enc.shift_pad), enc.shift_pad, out_dtype=dtype)
        return (preprocess_rgb_seq if use_kernels else preprocess_rgb_seq_plain)(imgs, out_dtype=dtype)
    frames = imgs.reshape(b * s, h, w, c)
    size = enc.input_size
    if enc.kind == "tactile":  # JAX's size check, then the branch's own resize, in one launch
        prep = tactile_prep(size, c, train, (h, w))
    elif enc.kind == "clip":
        prep = clip_prep(size, (h, w), enc.shift_pad, train)
    else:
        prep = rgb_prep(size, (h, w), c, enc.shift_pad, train)
    shifts = draw_shifts_for(b * s, prep.pad) if prep.pad else None
    out = (resize_preprocess if use_kernels else resize_preprocess_plain)(frames, prep, shifts, dtype)
    return out.reshape((b, s) + out.shape[1:])


def preprocess_modality(
    cfg: HulcConfig,
    batch: ModalityBatch,
    train: bool,
    *,
    generator: Optional[torch.Generator] = None,
    shifts: Optional[Dict[str, torch.Tensor]] = None,
    depth_noise: Optional[Dict[str, torch.Tensor]] = None,
    use_kernels: bool = True,
) -> ModalityBatch:
    pe = cfg.perceptual_encoder
    updates = {}
    for cam, field in CAMERAS:
        imgs, enc = getattr(batch, cam), getattr(pe, field)
        if imgs is None or enc is None:
            continue

        def camera_shifts(n, pad, cam=cam, device=imgs.device):
            if shifts is not None:
                return mesh.local_rows(shifts[cam])
            return mesh.draw_rows(lambda shape: draw_shifts(shape[0], pad, generator, device), (n, 2))

        updates[cam] = prep_camera(enc, imgs, train, cfg.dtype, camera_shifts, use_kernels)
    for cam, mode, std in DEPTH_CAMERAS:
        frames = getattr(batch, cam)
        if frames is None or getattr(pe, cam) is None:
            continue
        if not train:
            updates[cam] = frames.to(torch.float32)
        elif depth_noise is not None:
            fn = prep_depth if use_kernels else prep_depth_plain
            updates[cam] = fn(frames, mesh.local_rows(depth_noise[cam]), mode, std)
        elif frames.device.type == "cuda":
            updates[cam] = draw_depth_noise(frames, mode, std, generator, mesh.row_placement(), use_kernels)
        else:
            z = mesh.draw_rows(
                lambda shape: torch.randn(shape, generator=generator, device=frames.device, dtype=torch.float32),
                frames.shape,
            )
            updates[cam] = prep_depth(frames, z, mode, std, out=z) if use_kernels else prep_depth_plain(
                frames, z, mode, std)
    return batch._replace(**updates)


def preprocess_batch(
    cfg: HulcConfig,
    batch: Dict[str, ModalityBatch],
    train: bool = True,
    *,
    generator: Optional[torch.Generator] = None,
    shifts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    depth_noise: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    use_kernels: bool = True,
) -> Dict[str, ModalityBatch]:
    """Each modality of ``batch`` preprocessed; ``shifts`` and
    ``depth_noise`` by scope. Under ``parallel.mesh.sharded_rows`` the draws
    are the global batch's and the injected tensors global, each cut to this
    rank's rows (of both halves of a ``"fused"`` batch)."""
    out = {}
    for scope, mod in batch.items():
        with mesh.row_blocks(2 if scope == "fused" else 1):
            out[scope] = preprocess_modality(
                cfg, mod, train, generator=generator,
                shifts=None if shifts is None else shifts[scope],
                depth_noise=None if depth_noise is None else depth_noise[scope], use_kernels=use_kernels,
            )
    return out
