"""On-device batch preprocessing (port of hulc_tpu/training/preprocess.py:23-122).

uint8 (B, S, H, W, 3) camera frames become normalized (B, S, 3, H, W) in
the model's compute dtype (fp32, or bf16: the fp32 normalize rounded once,
as JAX's ``_prep_one(..., dtype)``), with the random shift when training
(``ops.image_ops``). fp32 (B, S, H, W)
depth frames pass through when evaluating and take their noise when
training (``ops.depth_noise``: the gamma mode on the static camera, the
gaussian one with std 0.01 on the gripper camera); depth is never shifted.
Per modality the draws come from the caller's ``torch.Generator`` in a
fixed order, the static camera's shifts, the gripper camera's, then the
static depth's noise and the gripper depth's, unless the caller passes
them (``shifts[scope][camera]``, (B*S, 2) each; ``depth_noise[scope]
[camera]``, the raw standard-normal draw of the frames' shape), as the
tests pass what JAX drew. A drawn noise tensor takes the noised frames;
the raw batch is never written. With several ranks each draw is the
global batch's, and a rank keeps its rows (``parallel.mesh.draw_rows``):
the depth noise of a ``hulc_depth`` step is drawn whole on every rank. Tactile and CLIP cameras, and resizing a
frame to the encoder's input size, are not ported yet: a batch or config
that needs them is refused.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.models.hulc import ModalityBatch
from hulc_tpu_torch.ops.depth_noise import prep_depth, prep_depth_plain
from hulc_tpu_torch.ops.image_ops import (
    draw_shifts,
    preprocess_rgb_seq,
    preprocess_rgb_seq_plain,
    preprocess_rgb_seq_shift,
    preprocess_rgb_seq_shift_plain,
)
from hulc_tpu_torch.parallel import mesh

CAMERAS = ("rgb_static", "rgb_gripper")
# each depth camera's training noise (JAX: _prep_depth's gamma_noise / gaussian_std)
DEPTH_CAMERAS = (("depth_static", "gamma", 0.0), ("depth_gripper", "gaussian", 0.01))
NOT_PORTED = (("rgb_tactile", "tactile"),)


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
    for field, enc in NOT_PORTED:
        if getattr(batch, field) is not None and getattr(pe, enc) is not None:
            raise NotImplementedError(f"preprocessing {field!r} is not ported yet")
    updates = {}
    for cam in CAMERAS:
        imgs, enc = getattr(batch, cam), getattr(pe, cam)
        if imgs is None or enc is None:
            continue
        if enc.kind not in ("spatial_softmax", "nature_cnn"):
            raise NotImplementedError(f"preprocessing for the {enc.kind!r} encoder is not ported yet")
        if imgs.shape[2] != enc.input_size:
            raise NotImplementedError(
                f"resizing {cam} from {imgs.shape[2]} px to {enc.input_size} px is not ported yet"
            )
        if train and enc.shift_pad > 0:
            s = mesh.local_rows(shifts[cam]) if shifts is not None else mesh.draw_rows(
                lambda shape: draw_shifts(shape[0], enc.shift_pad, generator, imgs.device),
                (imgs.shape[0] * imgs.shape[1], 2),
            )
            fn = preprocess_rgb_seq_shift if use_kernels else preprocess_rgb_seq_shift_plain
            updates[cam] = fn(imgs, s, enc.shift_pad, out_dtype=cfg.dtype)
        else:
            updates[cam] = (preprocess_rgb_seq if use_kernels else preprocess_rgb_seq_plain)(imgs, out_dtype=cfg.dtype)
    for cam, mode, std in DEPTH_CAMERAS:
        frames = getattr(batch, cam)
        if frames is None or getattr(pe, cam) is None:
            continue
        if not train:
            updates[cam] = frames.to(torch.float32)
        elif depth_noise is not None:
            fn = prep_depth if use_kernels else prep_depth_plain
            updates[cam] = fn(frames, mesh.local_rows(depth_noise[cam]), mode, std)
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
