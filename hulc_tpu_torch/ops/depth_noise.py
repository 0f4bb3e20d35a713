"""Training noise on depth frames (port of hulc_tpu/training/preprocess.py:58-80).

The reference augments depth only while training: ``AddDepthNoise(1000,
1000)`` on the static camera, a multiplicative Gamma(1000) / 1000 draw per
pixel, and ``AddGaussianNoise(0.01)`` on the gripper camera. The JAX
package replaces the Gamma draw by its Wilson-Hilferty form on one
standard-normal draw ``z``,

    gamma:    y = x * (1 - c + z * sqrt(c)) ** 3,  c = 1 / 9000
    gaussian: y = x + std * z

and ``prep_depth`` computes exactly that from the raw draw ``z``, which
the caller draws (``torch.randn``) or passes, as the tests pass the
draw JAX made. The constants round as JAX rounds them: ``c`` from a
Python double to fp32, ``sqrt(c)`` an fp32 square root of that fp32 ``c``,
``1 - c`` a double rounded to fp32; the cube is ``m * (m * m)``, as
``lax.integer_pow`` expands it. On a CUDA tensor ``prep_depth`` launches
the hand-written kernel in ``csrc/depth_noise.cu`` (one elementwise pass,
each product and sum rounded on its own, so it is bit-equal to the plain
version); on a CPU tensor it runs ``prep_depth_plain``. Depth is an input:
nothing takes a gradient through the noise.

``prep_depth_draw`` is the draw mode: the same kernel draws ``z`` itself,
so the step no longer writes a ``torch.randn`` tensor and reads it back.
Each group of four elements of the global (one-device) draw is one
Philox4x32-10 block, counter (the group's index, the generator's offset),
key (the generator's seed, its high word xor ``DRAW_DOMAIN``), and
Box-Muller makes its four normals (``csrc/depth_noise.cu``). A rank of a
data-parallel step draws only its rows of the global draw (``DrawLayout``,
from ``parallel.mesh.row_placement``). Its plain version,
``prep_depth_draw_plain``, computes the same words with a numpy Philox
(integer arithmetic: exact on any host) and the Box-Muller in PyTorch.
``draw_depth_noise`` is what the train step calls on CUDA frames: it reads
the CUDA generator's seed and offset, launches, and moves the offset on by
``DRAW_OFFSET_STEP``, so a restored generator draws the same noise again
and the next step draws afresh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hulc_tpu_torch import kernels
from hulc_tpu_torch.ops.spatial_softmax import _aligned

GAMMA_K = 1000.0  # reference AddDepthNoise(shape=1000, rate=1000)
_C = np.float32(1.0 / (9.0 * GAMMA_K))
GAMMA_SCALE = float(np.sqrt(_C))  # fp32 sqrt of the fp32 c
GAMMA_SHIFT = float(np.float32(1.0 - 1.0 / (9.0 * GAMMA_K)))  # the double 1 - c, rounded once
MODES = {"gamma": 0, "gaussian": 1}


def _mode_constant(mode: str, std: float) -> float:
    if mode not in MODES:
        raise ValueError(f"depth noise mode {mode!r}: expected one of {sorted(MODES)}")
    if mode == "gaussian" and not std > 0.0:
        raise ValueError(f"the gaussian depth noise needs a positive std, got {std}")
    return float(np.float32(std))


def prep_depth_plain(x: torch.Tensor, z: torch.Tensor, mode: str, std: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version, one eager op per rounding of the JAX form."""
    std32 = _mode_constant(mode, std)
    x = x.to(torch.float32)
    if mode == "gaussian":
        return x + z * std32
    m = z * GAMMA_SCALE + GAMMA_SHIFT
    return x * (m * (m * m))


def prep_depth(
    x: torch.Tensor, z: torch.Tensor, mode: str, std: float = 0.0, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(B, S, H, W) depth frames and the raw draw ``z`` of their shape ->
    the noised fp32 frames. ``mode`` is ``"gamma"`` (static camera) or
    ``"gaussian"`` with ``std`` (gripper camera). ``out`` may be ``z`` itself
    (a fresh draw, read once per element before it is written), never ``x``."""
    std32 = _mode_constant(mode, std)
    if z.requires_grad:
        raise ValueError("the depth noise takes no gradient: pass a draw that does not require one")
    if z.shape != x.shape:
        raise ValueError(f"the draw has shape {tuple(z.shape)}, the frames {tuple(x.shape)}")
    if out is not None and out.data_ptr() == x.data_ptr():
        raise ValueError("the depth noise must not write over the frames it reads")
    if x.device.type == "cpu":
        y = prep_depth_plain(x, z, mode, std)
        return y if out is None else out.copy_(y)
    x = _aligned(x.to(torch.float32).contiguous())  # the kernel's float4 accesses
    kernels.require_cuda_tensor("z", z, torch.float32)
    if out is None or out.data_ptr() != z.data_ptr():
        z = _aligned(z.contiguous())
    if out is None:
        out = torch.empty_like(x)
    kernels.require_cuda_tensor("out", out, torch.float32)
    if out.shape != x.shape or out.data_ptr() % 16 != 0 or z.data_ptr() % 16 != 0:
        raise ValueError("out must be an aligned contiguous fp32 tensor of the frames' shape")
    a, b = (GAMMA_SHIFT, GAMMA_SCALE) if mode == "gamma" else (0.0, std32)
    n = x.numel()
    kernels.DEPTH_NOISE(x.device, x.data_ptr(), z.data_ptr(), out.data_ptr(), n, MODES[mode], a, b, 1, n, 0, 0, 0,
                        None, None)
    return out


# ---------------------------------------------------------------------------
# the draw mode
# ---------------------------------------------------------------------------

PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # Philox4x32's multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # its key bumps (the golden ratio, sqrt(3) - 1)
DRAW_DOMAIN = 0x48554C43  # xor'd into the key's high word: torch's own Philox on the generator keys on the seed
DRAW_OFFSET_STEP = 4  # each group of four elements takes one Philox block (four values) at the offset
_MASK32 = np.uint64(0xFFFFFFFF)


def philox4x32_10(counter, key: Tuple[int, int]) -> np.ndarray:
    """Philox4x32-10 (Salmon et al., SC 2011) in numpy: ``counter`` four
    arrays (or ints) of 32-bit words, ``key`` two; returns the (4, ...)
    uint32 output blocks. Integer arithmetic in uint64, exact on any host."""
    c0, c1, c2, c3 = np.broadcast_arrays(*(np.asarray(c, dtype=np.uint64) for c in counter))
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    m0, m1 = np.uint64(PHILOX_M[0]), np.uint64(PHILOX_M[1])
    for _ in range(10):
        p0, p1 = c0 * m0, c2 * m1
        c0, c1, c2, c3 = (p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & _MASK32, (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & _MASK32
        k0, k1 = (k0 + np.uint64(PHILOX_W[0])) & _MASK32, (k1 + np.uint64(PHILOX_W[1])) & _MASK32
    return np.stack([c0, c1, c2, c3]).astype(np.uint32)


def draw_key(seed: int) -> Tuple[int, int]:
    """The draw's Philox key for a generator seeded ``seed``."""
    return seed & 0xFFFFFFFF, ((seed >> 32) & 0xFFFFFFFF) ^ DRAW_DOMAIN


class DrawLayout(NamedTuple):
    """Where the local frames lie in the global draw: ``blocks`` blocks of
    ``block_n`` elements (the local tensor's leading rows split evenly),
    block k's first element global element ``k * block_stride + base``."""

    blocks: int
    block_n: int
    block_stride: int
    base: int

    @property
    def groups(self) -> np.ndarray:
        """The global group (of four elements) of each local group, in order."""
        starts = np.arange(self.blocks, dtype=np.uint64) * np.uint64(self.block_stride // 4) + np.uint64(self.base // 4)
        return (starts[:, None] + np.arange(self.block_n // 4, dtype=np.uint64)[None, :]).ravel()


def draw_layout(shape, rows: Tuple[int, int, int] = (1, 1, 0)) -> DrawLayout:
    """The layout of local frames of ``shape`` whose leading rows are rank
    ``rank``'s share of each of ``blocks`` equal blocks of a global batch
    over ``ranks`` ranks (``rows`` = (blocks, ranks, rank), as
    ``parallel.mesh.row_placement`` gives it). The draw takes whole groups
    of four: each block must hold a multiple of 4 elements, so that it
    starts at a multiple of 4 in the global draw."""
    blocks, ranks, rank = rows
    lead = shape[0]
    if lead % blocks:
        raise ValueError(f"{lead} rows do not split into {blocks} blocks")
    row_n = int(np.prod(shape[1:], dtype=np.int64))
    block_n = lead // blocks * row_n
    if block_n % 4:
        raise ValueError(f"a misaligned base: a block of {block_n} elements (rank {rank} of {ranks}) does not start "
                         f"every block at a multiple of 4 in the global draw, which takes whole groups of four")
    return DrawLayout(blocks, block_n, ranks * block_n, rank * block_n)


def draw_words(layout: DrawLayout, seed: int, offset: int) -> np.ndarray:
    """The raw Philox words of each local element (uint32, in order): the
    plain version of the kernel's draw."""
    g = layout.groups
    off = np.uint64(offset)
    words = philox4x32_10((g & _MASK32, g >> np.uint64(32), off & _MASK32, off >> np.uint64(32)), draw_key(seed))
    return np.ascontiguousarray(words.T).ravel()


def box_muller_plain(words: torch.Tensor) -> torch.Tensor:
    """The kernel's Box-Muller on (4k,) words (int64 holding uint32 values):
    u = w * 2^-32 + 2^-33 in fp32 (one rounding, as the kernel's fmaf),
    r = sqrt(-2 log u) of each pair's first word, (r cos, r sin)(2 pi u) of
    its second. The transcendentals are PyTorch's, so a kernel's z agrees
    with this to a few fp32 ulp, not bit for bit."""
    u = words.to(torch.float32) * 2.0**-32 + 2.0**-33
    u0, u1 = u[0::2], u[1::2]
    r = torch.sqrt(-2.0 * torch.log(u0))
    angle = (2.0 * u1).to(torch.float64) * np.pi
    return torch.stack([r * torch.cos(angle).to(torch.float32), r * torch.sin(angle).to(torch.float32)], 1).reshape(-1)


def prep_depth_draw_plain(x: torch.Tensor, mode: str, std: float, seed: int, offset: int,
                          rows: Tuple[int, int, int] = (1, 1, 0)):
    """Plain version of the draw mode: (y, z, words) for frames ``x`` whose
    rows lie in the global draw as ``rows`` says, drawn with a generator
    seeded ``seed`` at offset ``offset`` (numpy's Philox on the host)."""
    words = torch.from_numpy(draw_words(draw_layout(x.shape, rows), seed, offset).astype(np.int64)).to(x.device)
    z = box_muller_plain(words).reshape(x.shape)
    return prep_depth_plain(x, z, mode, std), z, words.reshape(x.shape)


def prep_depth_draw(x: torch.Tensor, mode: str, std: float, seed: int, offset: int,
                    rows: Tuple[int, int, int] = (1, 1, 0), out: Optional[torch.Tensor] = None, debug: bool = False):
    """(B, S, H, W) depth frames -> the noised fp32 frames, the draw made
    in the launch (see the module's note) from a generator seeded ``seed``
    at offset ``offset``; ``rows`` places the frames' rows in the global
    draw. ``out`` (never ``x``) takes the result. With ``debug`` returns
    (y, z, words): the kernel also writes its normals and raw words. The
    plain version on a CPU tensor."""
    std32 = _mode_constant(mode, std)
    layout = draw_layout(x.shape, rows)
    if out is not None and out.data_ptr() == x.data_ptr():
        raise ValueError("the depth noise must not write over the frames it reads")
    if x.device.type == "cpu":
        y, z, words = prep_depth_draw_plain(x, mode, std, seed, offset, rows)
        y = y if out is None else out.copy_(y)
        return (y, z, words) if debug else y
    x = _aligned(x.to(torch.float32).contiguous())
    if out is None:
        out = torch.empty_like(x)
    kernels.require_cuda_tensor("out", out, torch.float32)
    if out.shape != x.shape or out.data_ptr() % 16 != 0:
        raise ValueError("a misaligned base: out must be a 16-byte aligned contiguous fp32 tensor of the frames' shape")
    z = words = None
    if debug:
        z, words = torch.empty_like(x), torch.empty(x.shape, dtype=torch.int32, device=x.device)
    a, b = (GAMMA_SHIFT, GAMMA_SCALE) if mode == "gamma" else (0.0, std32)
    kernels.DEPTH_NOISE(x.device, x.data_ptr(), None, out.data_ptr(), x.numel(), MODES[mode], a, b, layout.blocks,
                        layout.block_stride, layout.base, seed, offset, None if z is None else z.data_ptr(),
                        None if words is None else words.data_ptr())
    if debug:
        return out, z, words.to(torch.int64) & 0xFFFFFFFF
    return out


def draw_depth_noise(frames: torch.Tensor, mode: str, std: float, generator: Optional[torch.Generator],
                     rows: Tuple[int, int, int] = (1, 1, 0), use_kernels: bool = True) -> torch.Tensor:
    """The train step's depth noise on CUDA frames: the draw mode on
    ``generator`` (a CUDA generator on the frames' device; None: that
    device's default), which then moves on by ``DRAW_OFFSET_STEP``, the
    same on every rank. The plain version when ``use_kernels`` is False. A
    generator elsewhere is refused."""
    if frames.device.type != "cuda":
        raise ValueError(f"the draw mode takes CUDA frames, got {frames.device} (a CPU step draws with torch.randn)")
    if generator is None:
        generator = torch.cuda.default_generators[frames.device.index or 0]
    if generator.device.type != "cuda" or (generator.device.index or 0) != (frames.device.index or 0):
        raise ValueError(f"the depth noise's draw needs a generator on the frames' device {frames.device}, got one "
                         f"on {generator.device}")
    seed, offset = generator.initial_seed(), generator.get_offset()
    if use_kernels:
        y = prep_depth_draw(frames, mode, std, seed, offset, rows)
    else:
        y = prep_depth_draw_plain(frames.to(torch.float32), mode, std, seed, offset, rows)[0]
    generator.set_offset(offset + DRAW_OFFSET_STEP)
    return y
