"""On-device batch preprocessing (port of hulc_tpu/training/preprocess.py:23-122).

uint8 (B, S, H, W, 3) camera frames become normalized fp32 (B, S, 3, H, W),
with the random shift when training (``ops.image_ops``). Per modality the
shifts are drawn static camera first, then gripper camera, from the
caller's ``torch.Generator``, unless the caller passes them
(``shifts[scope][camera]``, (B*S, 2) each), as the tests pass the shifts
JAX drew. Depth, tactile and CLIP cameras, and resizing a frame to the
encoder's input size, are not ported yet: a batch or config that needs
them is refused.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hulc_tpu_torch.config import HulcConfig
from hulc_tpu_torch.models.hulc import ModalityBatch
from hulc_tpu_torch.ops.image_ops import (
    draw_shifts,
    preprocess_rgb_seq,
    preprocess_rgb_seq_plain,
    preprocess_rgb_seq_shift,
    preprocess_rgb_seq_shift_plain,
)

CAMERAS = ("rgb_static", "rgb_gripper")
NOT_PORTED = (("depth_static", "depth_static"), ("depth_gripper", "depth_gripper"), ("rgb_tactile", "tactile"))


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
            s = shifts[cam] if shifts is not None else draw_shifts(
                imgs.shape[0] * imgs.shape[1], enc.shift_pad, generator, imgs.device
            )
            fn = preprocess_rgb_seq_shift if use_kernels else preprocess_rgb_seq_shift_plain
            updates[cam] = fn(imgs, s, enc.shift_pad)
        else:
            updates[cam] = (preprocess_rgb_seq if use_kernels else preprocess_rgb_seq_plain)(imgs)
    return batch._replace(**updates)


def preprocess_batch(
    cfg: HulcConfig,
    batch: Dict[str, ModalityBatch],
    train: bool = True,
    *,
    generator: Optional[torch.Generator] = None,
    shifts: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    use_kernels: bool = True,
) -> Dict[str, ModalityBatch]:
    """Each modality of ``batch`` preprocessed; ``shifts`` by scope."""
    return {
        scope: preprocess_modality(
            cfg, mod, train, generator=generator,
            shifts=None if shifts is None else shifts[scope], use_kernels=use_kernels,
        )
        for scope, mod in batch.items()
    }
