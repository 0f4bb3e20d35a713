"""Camera-frame preprocessing (port of hulc_tpu/ops/image_ops.py:27-160).

``preprocess_rgb_seq`` turns a (B, S, H, W, C) uint8 batch into normalized
``(v / 255 - mean) / std`` in the layout ``nn.Conv2d`` reads,
(B, S, C, H, W): fp32, or bf16 for a bf16 model's training and validation
(``out_dtype``; JAX's ``out_dtype`` off the TPU: the fp32 normalize
rounded once). ``preprocess_rgb_seq_shift`` is the training branch: each
frame is first shifted by the DrQ-v2 random shift (an integer crop of the
replicate-padded frame, one (row, column) shift per frame in
``[0, 2 * pad]``), which is a clamped gather and exact on uint8. The shifts
are an input: ``draw_shifts`` draws them from a ``torch.Generator`` as the
JAX package draws them (``randint((B*S, 2), 0, 2*pad + 1)``), and tests
pass the shifts JAX drew. On a CUDA tensor each function launches its
hand-written kernel in ``csrc/preprocess.cu`` (which fuses the NHWC -> NCHW
transpose into the same pass); on a CPU tensor it runs the plain version.
The eval branch does so as the ``hulc::preprocess_rgb`` op
(``ops.library``), which ``torch.export`` keeps as one node.
Both kernels normalize through ``normalize_table``, the plain version's own
result for each of the 256 byte values in the output's type, so they are
bit-equal to it; each has an fp32 and a bf16 instance (B.14). The
``hulc::preprocess_rgb`` op is fp32 only: serving preprocesses to fp32, as
JAX's policies do.

``resize_bilinear`` is ``jax.image.resize(method="bilinear")``
(antialiased; ``resize_weights``, H contracted before W, fp32), and
``resize_preprocess`` a resized camera's whole preprocess as one launch of
B.15 (``csrc/resize_preprocess.cu``): the resize (after a first one, the
tactile 160 x 120 frame's to 64 px, ``FramePrep.pre``, kept in the
launch's shared memory), in training the bf16 rounding and the shift, the
crop and the normalize, in the operation sequence of each branch of JAX's
``_prep_one`` (``FramePrep``: ``clip_prep``, ``tactile_prep``,
``rgb_prep``), written NCHW in fp32 or bf16. Its plain version,
``resize_preprocess_plain``, is those operations in JAX's order (the two
resizes one after the other); ``resize_bilinear``'s raw mode on a CUDA
tensor is a launch of B.15 too. ``resize_plan`` picks each launch's band of
output rows a block.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from hulc_tpu_torch import kernels
from hulc_tpu_torch.ops.spatial_softmax import _aligned


def _normalize_plain(imgs: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    x = imgs.to(torch.float32) * (1.0 / 255.0)
    return (x - mean) / std


def preprocess_rgb_seq_plain(
    imgs: torch.Tensor, mean: float = 0.5, std: float = 0.5, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain PyTorch version: the JAX order of operations, one cast to
    ``out_dtype``, then NCHW."""
    return _normalize_plain(imgs, mean, std).to(out_dtype).permute(0, 1, 4, 2, 3).contiguous()


# the kernels of each output type: (eval, train)
_KERNELS = {
    torch.float32: (kernels.PREPROCESS_RGB, kernels.PREPROCESS_RGB_SHIFT),
    torch.bfloat16: (kernels.PREPROCESS_RGB_BF16, kernels.PREPROCESS_RGB_SHIFT_BF16),
}


def _kernels_for(out_dtype: torch.dtype):
    if out_dtype not in _KERNELS:
        raise TypeError(f"the preprocess kernels write float32 or bfloat16, not {out_dtype}")
    return _KERNELS[out_dtype]


@functools.cache
def normalize_table(mean: float, std: float, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(256,) ``dtype`` on ``device``: the plain normalize of every byte
    value, computed on the CPU, where the divide by ``std`` is a true divide
    (on CUDA a divide by a Python scalar runs as a multiply by its
    reciprocal), then rounded once to ``dtype``."""
    return _normalize_plain(torch.arange(256, dtype=torch.uint8), mean, std).to(dtype).to(device)


def preprocess_rgb_seq(
    imgs: torch.Tensor, mean: float = 0.5, std: float = 0.5, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, S, H, W, C) uint8 -> (B, S, C, H, W) ``out_dtype`` in [-1, 1]:
    fp32 through the ``hulc::preprocess_rgb`` op; bf16 through the bf16
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if out_dtype == torch.float32:
        return torch.ops.hulc.preprocess_rgb(imgs, float(mean), float(std))
    if imgs.device.type == "cpu":
        return preprocess_rgb_seq_plain(imgs, mean, std, out_dtype)
    return preprocess_rgb_seq_kernel(imgs, mean, std, out_dtype)


def preprocess_rgb_seq_kernel(
    imgs: torch.Tensor, mean: float, std: float, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The eval preprocess kernel (its ``out_dtype`` instance) on a CUDA tensor."""
    kernel = _kernels_for(out_dtype)[0]
    kernels.require_cuda_tensor("imgs", imgs, torch.uint8, 5)
    b, s, h, w, c = imgs.shape
    if c != 3:
        raise ValueError(f"the eval preprocess kernel takes RGB frames (C = 3), got C = {c}")
    table = normalize_table(float(mean), float(std), imgs.device, out_dtype)
    out = torch.empty((b, s, c, h, w), dtype=out_dtype, device=imgs.device)
    kernel(imgs.device, imgs.data_ptr(), table.data_ptr(), out.data_ptr(), b * s, h, w, c)
    return out


def draw_shifts(n: int, pad: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """(n, 2) int32 (row, column) shifts in [0, 2 * pad], one per frame."""
    return torch.randint(0, 2 * pad + 1, (n, 2), generator=generator, device=device, dtype=torch.int32)


def random_shift_plain(imgs: torch.Tensor, shifts: torch.Tensor, pad: int) -> torch.Tensor:
    """(N, H, W, C) frames cropped at ``shifts`` from their replicate-padded
    copy: out[n, y, x] = imgs[n, clip(s_r + y - pad), clip(s_c + x - pad)]."""
    n, h, w, _ = imgs.shape
    shifts = shifts.to(device=imgs.device, dtype=torch.long)
    rows = (shifts[:, :1] + torch.arange(h, device=imgs.device) - pad).clamp(0, h - 1)
    cols = (shifts[:, 1:] + torch.arange(w, device=imgs.device) - pad).clamp(0, w - 1)
    batch = torch.arange(n, device=imgs.device)[:, None, None]
    return imgs[batch, rows[:, :, None], cols[:, None, :]]


def preprocess_rgb_seq_shift_plain(
    imgs: torch.Tensor, shifts: torch.Tensor, pad: int, mean: float = 0.5, std: float = 0.5,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the training branch: shift, then normalize."""
    b, s = imgs.shape[:2]
    shifted = random_shift_plain(imgs.reshape((b * s,) + imgs.shape[2:]), shifts, pad)
    return preprocess_rgb_seq_plain(shifted.reshape(imgs.shape), mean, std, out_dtype)


def preprocess_rgb_seq_shift(
    imgs: torch.Tensor, shifts: torch.Tensor, pad: int, mean: float = 0.5, std: float = 0.5,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """(B, S, H, W, C) uint8 and (B*S, 2) shifts -> (B, S, C, H, W) ``out_dtype``."""
    b, s, h, w, c = imgs.shape
    if shifts.shape != (b * s, 2):
        raise ValueError(f"shifts has shape {tuple(shifts.shape)}, expected {(b * s, 2)}")
    if h != w:
        raise ValueError(f"random_shift requires square frames (got {h}x{w})")
    if imgs.device.type == "cpu":
        return preprocess_rgb_seq_shift_plain(imgs, shifts, pad, mean, std, out_dtype)
    kernel = _kernels_for(out_dtype)[1]
    kernels.require_cuda_tensor("imgs", imgs, torch.uint8, 5)
    shifts = shifts.to(device=imgs.device, dtype=torch.int32).contiguous()
    table = normalize_table(float(mean), float(std), imgs.device, out_dtype)
    out = torch.empty((b, s, c, h, w), dtype=out_dtype, device=imgs.device)
    kernel(
        imgs.device, imgs.data_ptr(), shifts.data_ptr(), table.data_ptr(), out.data_ptr(), b * s, h, w, c,
        int(pad),
    )
    return out


# --------------------------------------------------------------------------
# the resize and the resized cameras' preprocess (B.15)
# --------------------------------------------------------------------------

# CLIP's image normalization (hulc_tpu/models/clip.py:269-271)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@functools.cache
def resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(in_size, out_size) fp32 on the CPU: ``jax.image.resize``'s bilinear
    weight matrix (``jax/_src/image/scale.py`` ``compute_weight_mat``, no
    translation, antialiased): half-pixel centres, the triangle kernel
    widened by the scale when downsampling, each output's column normalized
    over the inputs it reaches, zero where the sample falls outside, with
    the roundings of XLA's CPU build of those lines, so that the resized
    frames agree with ``jax.image.resize``'s to a few fp32 ulp at the
    presets' shapes (200 -> 224, 160 x 120 -> 64, 64 -> 70)."""
    f32, f64 = torch.float32, torch.float64
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32)  # JAX: Python floats, then fp32
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    # XLA's CPU code for these fp32 lines: 1 - x as a fused multiply-add (an
    # fp64 product, rounded once) with x / kernel_scale a product with its
    # fp32 reciprocal, and the sample position a fused multiply-add where
    # the output size is a multiple of 8 (its vectorized loop), else a
    # product and a difference, each rounded
    centres = torch.arange(out_size, dtype=f32) + 0.5
    if out_size % 8 == 0:
        sample_f = (centres.to(f64) * inv_scale.to(f64) - 0.5).to(f32)
    else:
        sample_f = centres * inv_scale - 0.5
    dist = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs()
    recip = (1.0 / kernel_scale.to(f64)).to(f32)
    weights = torch.clamp((1.0 - dist.to(f64) * recip.to(f64)).to(f32), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(torch.finfo(f32).eps),
                          weights / torch.where(total != 0, total, torch.ones((), dtype=f32)),
                          torch.zeros((), dtype=f32))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros((), dtype=f32))


def resize_bilinear_plain(imgs: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., height, width, C) fp32, as ``jax.image.resize(
    imgs.astype(float32), ..., "bilinear")``: a side whose size does not
    change is left as it is; H is contracted first, then W, each with its
    weight matrix in fp32."""
    x = imgs.to(torch.float32)
    h, w = x.shape[-3], x.shape[-2]
    if h != height:
        x = torch.einsum("...hwc,hy->...ywc", x, resize_weights(h, height).to(x.device))
    if w != width:
        x = torch.einsum("...ywc,wx->...yxc", x, resize_weights(w, width).to(x.device))
    return x.contiguous()


@dataclasses.dataclass(frozen=True)
class FramePrep:
    """What B.15 makes of a frame (port of the branches of
    hulc_tpu/training/preprocess.py:21-55): resize it to ``size`` (h, w),
    round it to bf16 (``round_bf16``, the CLIP and tactile branches in
    training), shift it with replicate padding ``pad`` (0: no shift), cut
    ``crop`` rows and columns off each side, then normalize: ``v / 255``
    (``divide``, CLIP's ``clip_preprocess``) or ``v * (1 / 255)``, then
    ``(x - mean) / std`` per channel. ``pre`` (h, w): a first resize, its
    fp32 frame unrounded (the tactile 160 x 120 frame's, to 64 px by JAX's
    size check), in the same launch."""

    size: Tuple[int, int]
    pad: int
    crop: int
    round_bf16: bool
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    divide: bool
    pre: Optional[Tuple[int, int]] = None

    @property
    def out_size(self) -> Tuple[int, int]:
        return self.size[0] - 2 * self.crop, self.size[1] - 2 * self.crop


def clip_prep(input_size: int, frame: Tuple[int, int], shift_pad: int, train: bool) -> FramePrep:
    """The CLIP branch (preprocess.py:27-35): frames whose H is not
    ``input_size`` resized to it, then in training with a shift the bf16
    rounding and the shift, then ``clip_preprocess``."""
    shift = train and shift_pad > 0
    size = frame if frame[0] == input_size else (input_size, input_size)
    return FramePrep(size, shift_pad if shift else 0, 0, shift, CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, True)


TACTILE_PAD = 3  # the tactile branch's crop, and the pad of its shift in training


def tactile_prep(input_size: int, channels: int, train: bool, frame: Optional[Tuple[int, int]] = None) -> FramePrep:
    """The tactile branch (preprocess.py:36-52): a ``frame`` (h, w) whose h
    is not ``input_size`` first resized to it (JAX's size check; None: the
    frame is at ``input_size``), then the resize to ``input_size + 6``, in
    training the bf16 rounding and a shift with pad 3, the crop [3:-3], the
    normalize with mean and std 0.5."""
    half, p = (0.5,) * channels, TACTILE_PAD
    pre = (input_size, input_size) if frame is not None and frame[0] != input_size else None
    return FramePrep((input_size + 2 * p, input_size + 2 * p), p if train else 0, p, train, half, half, False, pre)


def rgb_prep(input_size: int, frame: Tuple[int, int], channels: int, shift_pad: int, train: bool) -> FramePrep:
    """A camera of another kind whose frames are resized (preprocess.py:25-26,
    53-55): the resized fp32 frame shifted in training, then normalized with
    mean and std 0.5, unrounded."""
    size = frame if frame[0] == input_size else (input_size, input_size)
    half = (0.5,) * channels
    return FramePrep(size, shift_pad if train else 0, 0, False, half, half, False)


def resize_preprocess_plain(frames: torch.Tensor, prep: FramePrep, shifts: Optional[torch.Tensor],
                            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of B.15: (N, H, W, C) uint8 or fp32 and (N, 2)
    shifts (None without a shift) -> (N, C, h, w) ``out_dtype``, the JAX
    package's operations in its order."""
    x = frames if prep.pre is None else resize_bilinear_plain(frames, *prep.pre)
    x = resize_bilinear_plain(x, *prep.size)
    if prep.round_bf16:
        x = x.to(torch.bfloat16)
    if prep.pad:
        x = random_shift_plain(x, shifts, prep.pad)
    if prep.crop:
        c = prep.crop
        x = x[:, c:-c, c:-c]
    x = x.to(torch.float32)
    # a true divide on either device (CUDA divides by a CPU scalar as a multiply by its reciprocal)
    x = x / torch.tensor(255.0, device=x.device) if prep.divide else x * (1.0 / 255.0)
    mean = torch.tensor(prep.mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(prep.std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(out_dtype).permute(0, 3, 1, 2).contiguous()


@functools.cache
def resize_taps(in_size: int, out_size: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``resize_weights`` as B.15 reads it, on ``device``: each output's first
    input (int32, (out,)), its ``taps`` weights from there (fp32, (out,
    taps), zero past the inputs it reaches), and ``taps``, the most inputs
    any output reaches. A side that keeps its size is one tap of weight 1."""
    if in_size == out_size:
        start, weights, taps = torch.arange(out_size, dtype=torch.int32), torch.ones((out_size, 1)), 1
    else:
        w = resize_weights(in_size, out_size).T  # (out, in)
        nonzero = w != 0
        first = torch.where(nonzero.any(1), nonzero.int().argmax(1), torch.zeros((), dtype=torch.long))
        last = in_size - 1 - nonzero.flip(1).int().argmax(1)
        taps = int((last - first).max()) + 1
        start = torch.clamp(first, max=in_size - taps)
        cols = start[:, None] + torch.arange(taps)
        weights = torch.gather(w, 1, cols)
        start = start.to(torch.int32)
    return start.to(device), weights.to(torch.float32).contiguous().to(device), taps


@functools.cache
def _norm_consts(mean: Tuple[float, ...], std: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """(2C + 1,) fp32: the means, the stds and 1 / 255, as the plain version rounds them."""
    return torch.tensor([*mean, *std, 1.0 / 255.0], dtype=torch.float32).to(device)


# B.15's output kinds (csrc/resize_preprocess.cu): normalized NCHW fp32 or bf16, the raw resize in NHWC fp32
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}
_RAW = 2

# B.15's plan: a block's shared memory at most this, so that three blocks of
# 256 threads fit on an H100 SM (228 KB, 1 KB of it the runtime's a block).
# Measured (evaluation/resize_variants.py --budgets): CLIP's bf16 output at
# 16 rows a band (63.8 KB) beats 8 rows by 9%; fp32's 16 rows (85 KB) and
# every mode at half the bands lose
B15_SMEM_BUDGET = 64 * 1024
B15_BANDS = (32, 16, 8, 4, 2, 1)  # output rows a block, the tallest that fits
B15_MAX_TAPS = 8  # the most taps of a row or a column the kernel takes (kMaxTaps)


@dataclasses.dataclass(frozen=True)
class ResizePlan:
    """A launch of B.15: ``band`` output rows a block, the most source rows
    (``src_rows``) and first-resize rows (``inter_rows``, 0 without one) a
    band reaches, and the block's shared memory (``smem_bytes``, the
    kernel's layout)."""

    band: int
    src_rows: int
    inter_rows: int
    smem_bytes: int


def _window_rows(start: torch.Tensor, taps: int, rows: int) -> int:
    """The most input rows that ``rows`` consecutive outputs of a tap table
    (each output's first input ``start``, ``taps`` from there) reach."""
    rows = min(rows, len(start))
    s = start.long()
    return int((s[rows - 1:] - s[:len(s) - rows + 1]).max()) + taps


def _entry_words(taps: int) -> int:
    return 4 if taps <= 3 else (taps + 4) // 4 * 4


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.cache
def resize_plan(h: int, w: int, c: int, in_bytes: int, size: Tuple[int, int], out_size: Tuple[int, int],
                pre: Optional[Tuple[int, int]], out_kind: int) -> ResizePlan:
    """The band height of a B.15 launch from (h, w, c) frames of
    ``in_bytes``-byte elements (through the first resize ``pre``, if any)
    resized to ``size`` and cut to ``out_size``: the tallest of
    ``B15_BANDS`` whose shared memory (``csrc/resize_preprocess.cu``'s
    layout) stays within ``B15_SMEM_BUDGET``. Raises where none does, or
    where a row or a column takes more than ``B15_MAX_TAPS`` taps."""
    cpu = torch.device("cpu")
    ph, pw = pre if pre is not None else (h, w)
    rows, cols = resize_taps(ph, size[0], cpu), resize_taps(pw, size[1], cpu)
    pre_rows = pre_cols = None
    if pre is not None:
        pre_rows, pre_cols = resize_taps(h, ph, cpu), resize_taps(w, pw, cpu)
    taps = (rows[2], cols[2]) + ((pre_rows[2], pre_cols[2]) if pre is not None else ())
    if max(taps) > B15_MAX_TAPS:
        raise ValueError(f"B.15 takes at most {B15_MAX_TAPS} taps a row or column, not {max(taps)}")
    oh, ow = out_size
    out_bytes = 2 if out_kind == 1 else 4
    wc = w * c
    for band in B15_BANDS:
        band = min(band, oh)
        if pre is None:
            inter, src = 0, _window_rows(rows[0], rows[2], band)
            s_bytes, t_bytes = src * wc * in_bytes + 32, 4 * c * band * w
        else:
            inter = _window_rows(rows[0], rows[2], band)
            src = _window_rows(pre_rows[0], pre_rows[2], inter)
            s_bytes = max(src * wc * in_bytes + 32, 4 * c * inter * pw)
            t_bytes = 4 * c * max(inter * w, band * pw)
        s_bytes = max(s_bytes, out_bytes * c * band * ow)  # the output tile, over the staged rows
        tables = 4 * size[1] * _entry_words(cols[2]) + 4 * band * _entry_words(rows[2])
        if pre is not None:
            tables += 4 * pw * _entry_words(pre_cols[2]) + 4 * inter * _entry_words(pre_rows[2])
        smem = _round16(s_bytes) + _round16(t_bytes) + tables + _round16(4 * (2 * c + 1))
        if smem <= B15_SMEM_BUDGET:
            return ResizePlan(band, src, inter, smem)
    raise ValueError(f"B.15 cannot stage ({h}, {w}, {c}) frames resized to {size}: a one-row band needs {smem} B "
                     f"of shared memory (at most {B15_SMEM_BUDGET})")


def _launch_resize(frames: torch.Tensor, size: Tuple[int, int], out: torch.Tensor, out_kind: int,
                   prep: Optional[FramePrep], shifts: Optional[torch.Tensor], launch=None) -> torch.Tensor:
    """B.15's launch into ``out``; ``launch`` (device, *args) calls the entry
    point, ``kernels.RESIZE_PREPROCESS`` unless a variant's is given
    (``evaluation/resize_variants.py``)."""
    if frames.device.type != "cuda":
        raise ValueError(f"frames must be a CUDA tensor, got {frames.device}")
    if frames.dtype not in (torch.uint8, torch.float32) or frames.dim() != 4 or not frames.is_contiguous():
        raise ValueError(f"B.15 takes contiguous (N, H, W, C) uint8 or float32 frames, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    n, h, w, c = frames.shape
    pre = None if prep is None else prep.pre
    if pre is not None and frames.dtype != torch.uint8:
        raise ValueError("B.15's first resize takes uint8 frames")
    frames = _aligned(frames)  # the kernel's 16-byte copies
    ph, pw = pre if pre is not None else (h, w)
    rows, cols = resize_taps(ph, size[0], frames.device), resize_taps(pw, size[1], frames.device)
    pre_ptrs, pre_taps = (None,) * 4, (0, 0)
    if pre is not None:
        pre_rows, pre_cols = resize_taps(h, ph, frames.device), resize_taps(w, pw, frames.device)
        pre_ptrs = (pre_rows[0].data_ptr(), pre_rows[1].data_ptr(), pre_cols[0].data_ptr(), pre_cols[1].data_ptr())
        pre_taps = (pre_rows[2], pre_cols[2])
    pad = crop = 0
    flags = int(frames.dtype == torch.float32)
    consts = shift_ptr = None
    if prep is not None:
        if len(prep.mean) != c or len(prep.std) != c:
            raise ValueError(f"{c} channels, but {len(prep.mean)} means and {len(prep.std)} stds")
        pad, crop = prep.pad, prep.crop
        flags |= 2 * prep.round_bf16 | 4 * prep.divide
        consts = _norm_consts(tuple(prep.mean), tuple(prep.std), frames.device)
        if pad:
            if shifts is None or tuple(shifts.shape) != (n, 2):
                raise ValueError(f"a shift with pad {pad} needs (N, 2) = {(n, 2)} shifts")
            shifts = shifts.to(device=frames.device, dtype=torch.int32).contiguous()
            shift_ptr = shifts.data_ptr()
    oh, ow = out.shape[-2:] if out_kind != _RAW else out.shape[1:3]
    plan = resize_plan(h, w, c, frames.element_size(), tuple(size), (oh, ow), pre, out_kind)
    (launch or kernels.RESIZE_PREPROCESS)(
        frames.device, frames.data_ptr(), out.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(),
        cols[0].data_ptr(), cols[1].data_ptr(), *pre_ptrs, shift_ptr, None if consts is None else consts.data_ptr(),
        n, h, w, c, ph, pw, *pre_taps, size[0], size[1], oh, ow, rows[2], cols[2], pad, crop, out_kind, flags,
        plan.band, plan.src_rows, plan.inter_rows,
    )
    return out


def resize_preprocess(frames: torch.Tensor, prep: FramePrep, shifts: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N, H, W, C) uint8 or fp32 frames -> (N, C, h, w) ``out_dtype``: one
    launch of B.15 on a CUDA tensor, the plain version on a CPU tensor."""
    if frames.device.type == "cpu":
        return resize_preprocess_plain(frames, prep, shifts, out_dtype)
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"B.15 writes float32 or bfloat16, not {out_dtype}")
    n, _, _, c = frames.shape
    out = torch.empty((n, c, *prep.out_size), dtype=out_dtype, device=frames.device)
    return _launch_resize(frames, prep.size, out, _OUT_KIND[out_dtype], prep, shifts)


def resize_bilinear(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, H, W, C) uint8 or fp32 -> (N, height, width, C) fp32, the resize
    alone: B.15's raw mode on a CUDA tensor (the tactile branch's first of
    two resizes), the plain version on a CPU tensor."""
    if frames.device.type == "cpu":
        return resize_bilinear_plain(frames, height, width)
    n, _, _, c = frames.shape
    out = torch.empty((n, height, width, c), dtype=torch.float32, device=frames.device)
    return _launch_resize(frames, (height, width), out, _RAW, None, None)
