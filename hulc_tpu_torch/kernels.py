"""Build and bind the hand-written CUDA kernels in ``csrc/*.cu``.

At first use every source is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library under ``build/`` at the repository root, named by a
hash of the sources and flags so a changed source is rebuilt. The library
has a plain C interface and is loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :class:`Kernel` raises on a non-zero code and
counts successful launches in ``Kernel.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import torch

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_U64 = ctypes.c_ulonglong
_I32 = ctypes.c_int
_F32 = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _run(cmd: Sequence[str]) -> str:
    proc = subprocess.run(list(cmd), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` into ``build/libhulc_kernels-<hash>.so`` (a no-op
    when that file exists) and return its path. The compiler's register and
    spill report is kept beside it as ``.log``."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"libhulc_kernels-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}-{tag}.{os.getpid()}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(sources, objs)]
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        logs = list(pool.map(_run, cmds))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    logs.append(_run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                      *map(str, objs), "-o", str(tmp)]))
    for obj in objs:
        obj.unlink()
    lib.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp, lib)  # atomic: another process never loads a partial file
    return lib


_TEMPLATE_ARG = {"Lb0E": "false", "Lb1E": "true"}
# builtin types as template arguments (the Itanium ABI's codes)
_BUILTIN_TYPES = {"f": "float", "d": "double", "i": "int", "j": "unsigned int", "t": "unsigned short",
                  "h": "unsigned char", "b": "bool"}


def _template_args(mangled: str, pos: int):
    """The template arguments of the ``I...E`` list at ``pos``, readable (a
    bool or int literal, a builtin type, a named type such as
    ``__nv_bfloat16``), or None where there is no such list."""
    if not mangled.startswith("I", pos):
        return None
    out, pos = [], pos + 1
    while pos < len(mangled) and mangled[pos] != "E":
        if mangled[pos] == "L":
            end = mangled.index("E", pos) + 1
            lit = mangled[pos:end]
            out.append(_TEMPLATE_ARG.get(lit, lit[2:-1] if lit.startswith("Li") else lit))
            pos = end
        elif mangled[pos] in _BUILTIN_TYPES:
            out.append(_BUILTIN_TYPES[mangled[pos]])
            pos += 1
        else:
            length = re.match(r"\d+", mangled[pos:])
            if length is None:
                return None
            start = pos + length.end()
            out.append(mangled[start:start + int(length.group())])
            pos = start + int(length.group())
    return out if out and pos < len(mangled) else None


def _entry_name(mangled: str) -> str:
    """``preprocess_rgb_shift_kernel`` out of its mangled name: the last
    length-prefixed identifier, read from the start of the name (the
    anonymous namespace's identifier holds hex hashes, whose digits must
    not be read as a length); an instance of a kernel template gets its
    arguments, as ``plan_st_kl_fwd_kernel<true>`` (a bool, an int literal)
    or ``spatial_softmax_kernel<__nv_bfloat16>`` (a type)."""
    head = re.match(r"_Z(N?)", mangled)
    if head is None:
        return mangled
    pos, name = head.end(), None
    while (length := re.match(r"\d+", mangled[pos:])) is not None:
        start = pos + length.end()
        name, pos = mangled[start:start + int(length.group())], start + int(length.group())
        if not head.group(1):  # not a nested name: one identifier
            break
    if name is None:
        return mangled
    args = _template_args(mangled, pos)
    return name if args is None else f"{name}<{', '.join(args)}>"


def ptxas_report(log: str) -> dict:
    """Per ``__global__`` function of the build log (``-Xptxas -v``):
    registers, static shared memory, stack frame and spill bytes."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = _entry_name(entry.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if frame:
            out[name].update(zip(("stack_bytes", "spill_store_bytes", "spill_load_bytes"), map(int, frame.groups())))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(regs.group(1)), static_smem_bytes=int(smem.group(1)) if smem else 0)
    return out


# C signature of each entry point, without the trailing stream argument.
_SIGNATURES = {
    "hulc_preprocess_rgb": (_P, _P, _P, _I64, _I32, _I32, _I32),
    "hulc_preprocess_rgb_shift": (_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32),
    "hulc_spatial_softmax": (_P, _P, _I64, _I32, _I32, _I32, _P, _F32),
    "hulc_spatial_softmax_bwd": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P, _F32),
    # the bf16 instances (B.14): bf16 out of the preprocess, a bf16 map (and dx) in SpatialSoftmax
    "hulc_preprocess_rgb_bf16": (_P, _P, _P, _I64, _I32, _I32, _I32),
    "hulc_preprocess_rgb_shift_bf16": (_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32),
    "hulc_spatial_softmax_bf16": (_P, _P, _I64, _I32, _I32, _I32, _P, _F32),
    "hulc_spatial_softmax_bwd_bf16": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P, _F32),
    "hulc_logistic_mixture_sample": (_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _F32, _F32, _F32, _F32),
    "hulc_mixture_nll_fwd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _F32, _F32,
    ),
    "hulc_mixture_nll_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32),
    "hulc_plan_st_kl_fwd": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _F32, _F32),
    "hulc_plan_st_kl_bwd": (_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _F32, _F32),
    "hulc_adam_lowp": (_P, _I32, _I32, _I32, _I64, _I64, _I64, _P, _P, _F32, _F32, _F32, _F32, _F32, _F32, _F32, _F32),
    # B.5', the other instances of B.5's template: fp32 moments; adamw adds the
    # weight decay; sgd takes the momentum and the negated learning rate
    "hulc_adam_fp32": (_P, _I32, _I32, _I32, _I64, _I64, _I64, _P, _P, _F32, _F32, _F32, _F32, _F32, _F32, _F32, _F32),
    "hulc_adamw": (_P, _I32, _I32, _I32, _I64, _I64, _I64, _P, _P, *(_F32,) * 9),
    "hulc_sgd": (_P, _I32, _I32, _I32, _I64, _I64, _I64, _P, _P, _F32, _F32),
    "hulc_grad_norm_finish": (_P, _I64, _P),
    # the sizes, then ops.recurrence.RecurrencePlan's five fields
    "hulc_rnn_relu_fwd": (_P, _P, _P, _P, _P, _P, *(_I32,) * 8),
    "hulc_rnn_relu_bwd": (_P, _P, _P, _P, _P, _P, *(_I32,) * 8),
    # the sizes, the chain's layout (reverse, y's row width, its column offset), the plan
    "hulc_rnn_tanh_fwd": (_P, _P, _P, _P, _P, _P, *(_I32,) * 11),
    "hulc_rnn_tanh_bwd": (_P, _P, _P, _P, _P, _P, *(_I32,) * 11),
    # B.13's relu chain: the tanh chain's parameters
    "hulc_rnn_relu_chain_fwd": (_P, _P, _P, _P, _P, _P, *(_I32,) * 11),
    "hulc_rnn_relu_chain_bwd": (_P, _P, _P, _P, _P, _P, *(_I32,) * 11),
    # the pointers (the dh chains' with a scratch for W^T), the sizes, then ops.recurrence.GatedPlan's six fields
    "hulc_rnn_gru_fwd": (*(_P,) * 7, *(_I32,) * 9),
    "hulc_rnn_gru_bwd": (*(_P,) * 10, *(_I32,) * 9),
    "hulc_rnn_lstm_fwd": (*(_P,) * 9, *(_I32,) * 9),
    "hulc_rnn_lstm_bwd": (*(_P,) * 10, *(_I32,) * 9),
    # B.13's gru chain: B.11's pointers, the sizes, the chain's layout (reverse, y's row width, its column
    # offset), the plan
    "hulc_rnn_gru_chain_fwd": (*(_P,) * 7, *(_I32,) * 12),
    "hulc_rnn_gru_chain_bwd": (*(_P,) * 10, *(_I32,) * 12),
    # x, z, y, n, mode (0 gamma, 1 gaussian), the mode's two fp32 constants; then the draw mode's (z null):
    # the blocks of rows, a block's stride and the first one's base in the global draw, the generator's seed and
    # offset, and the debug outputs z and words (or null)
    "hulc_depth_noise": (_P, _P, _P, _I64, _I32, _F32, _F32, _I32, _I64, _I64, _U64, _U64, _P, _P),
    # B.15: src, dst, the row and column tap tables, the first resize's (or null), shifts, the normalize's
    # constants, then n, the source's h, w, c, the first resize's ph, pw and its taps of a row and of a column,
    # the resized rh, rw, the output's oh, ow, the taps of a row and of a column, pad, crop, the output's kind
    # (0 fp32, 1 bf16, 2 the raw resize), the flags (1 fp32 source, 2 bf16 rounding, 4 v / 255), and
    # image_ops.ResizePlan's band, source rows and intermediate rows
    "hulc_resize_preprocess": (*(_P,) * 12, _I64, *(_I32,) * 20),
    "hulc_empty_launch": (),
}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [*args, _P]
        fn.restype = ctypes.c_int
    lib.hulc_error_string.argtypes = [ctypes.c_int]
    lib.hulc_error_string.restype = ctypes.c_char_p
    lib.hulc_device_limits.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.hulc_device_limits.restype = ctypes.c_int
    lib.hulc_rnn_cluster_limit.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.hulc_rnn_cluster_limit.restype = ctypes.c_int
    lib.hulc_rnn_check.argtypes = [ctypes.c_int] * 10
    lib.hulc_rnn_check.restype = ctypes.c_int
    lib.hulc_rnn_gated_check.argtypes = [ctypes.c_int] * 13
    lib.hulc_rnn_gated_check.restype = ctypes.c_int
    return lib


def _raise_if(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({library().hulc_error_string(err).decode()})")


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(SM count, shared memory a block may opt in to, bytes) of CUDA device
    ``index``, as the runtime reports them."""
    lib = library()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    _raise_if(lib.hulc_device_limits(index, ctypes.byref(sms), ctypes.byref(smem)), "hulc_device_limits")
    return sms.value, smem.value


@functools.cache
def cluster_limits(index: int, sizes: tuple[int, ...]) -> dict[int, int]:
    """{cluster size: clusters CUDA device ``index`` holds at once at one
    block per SM}, for each of ``sizes``, as the runtime reports them."""
    lib = library()
    out = {}
    with torch.cuda.device(index):
        for size in sizes:
            n = ctypes.c_int()
            _raise_if(lib.hulc_rnn_cluster_limit(size, ctypes.byref(n)), "hulc_rnn_cluster_limit")
            out[size] = n.value
    return out


# csrc/rnn.cu's sequence kernels, by the cell name the launch plan is made for
RNN_CELLS = {"rnn": 0, "rnn_tanh": 1, "rnn_chain": 2}


def check_rnn_plan(index: int, cell: str, backward: bool, batch: int, seq: int, hidden: int,
                   plan: tuple[int, ...]) -> None:
    """``hulc_rnn_check`` of a launch plan (``RecurrencePlan.c_args()``) on
    CUDA device ``index`` for a kernel of ``RNN_CELLS``: the decoder's relu
    chain (``rnn``), the tanh chain, or the relu chain with a layout
    (``rnn_chain``, B.13). Raises if it refuses the plan. A sequence kernel
    launches only after this."""
    with torch.cuda.device(index):
        err = library().hulc_rnn_check(RNN_CELLS[cell], int(backward), batch, seq, hidden, *plan)
    _raise_if(err, f"hulc_rnn_check of the {cell} plan {plan} at {(batch, seq, hidden)}")


def check_gated_plan(index: int, lstm: bool, laid: bool, backward: bool, saves: bool, batch: int, seq: int,
                     hidden: int, plan: tuple[int, ...]) -> None:
    """``hulc_rnn_gated_check`` of a launch plan (``GatedPlan.c_args()``) of
    the gru or the lstm cell (``laid``: the gru chain with a layout, B.13)
    on CUDA device ``index``: raises if it refuses the plan. A sequence
    kernel launches only after this."""
    with torch.cuda.device(index):
        err = library().hulc_rnn_gated_check(int(lstm), int(laid), int(backward), int(saves), batch, seq, hidden,
                                             *plan)
    what = "lstm" if lstm else "gru chain" if laid else "gru"
    _raise_if(err, f"hulc_rnn_gated_check of the {what} plan {plan} at {(batch, seq, hidden)}")


class Kernel:
    """One C entry point of the library and the count of its launches."""

    def __init__(self, symbol: str):
        if symbol not in _SIGNATURES:
            raise KeyError(symbol)
        self.symbol = symbol
        self.launches = 0

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise if the launch failed."""
        lib = library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, self.symbol)(*args, stream)
        if err != 0:
            msg = lib.hulc_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {err} ({msg})")
        self.launches += 1


class Composite:
    """The launch count of a wrapper whose launches are another entry
    point's: B.9's bidirectional layer, one launch of B.8's kernel a
    direction. It counts its own calls, and each launch counts under the
    entry point too. ``symbol`` names it in the launch counts; it is no C
    entry point."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0


PREPROCESS_RGB = Kernel("hulc_preprocess_rgb")
PREPROCESS_RGB_SHIFT = Kernel("hulc_preprocess_rgb_shift")
SPATIAL_SOFTMAX = Kernel("hulc_spatial_softmax")
SPATIAL_SOFTMAX_BWD = Kernel("hulc_spatial_softmax_bwd")
LOGISTIC_MIXTURE_SAMPLE = Kernel("hulc_logistic_mixture_sample")
MIXTURE_NLL_FWD = Kernel("hulc_mixture_nll_fwd")
MIXTURE_NLL_BWD = Kernel("hulc_mixture_nll_bwd")
PLAN_ST_KL_FWD = Kernel("hulc_plan_st_kl_fwd")
PLAN_ST_KL_BWD = Kernel("hulc_plan_st_kl_bwd")
ADAM_LOWP = Kernel("hulc_adam_lowp")
GRAD_NORM_FINISH = Kernel("hulc_grad_norm_finish")
ADAM_FP32 = Kernel("hulc_adam_fp32")
ADAMW = Kernel("hulc_adamw")
SGD = Kernel("hulc_sgd")
RNN_RELU_FWD = Kernel("hulc_rnn_relu_fwd")
RNN_RELU_BWD = Kernel("hulc_rnn_relu_bwd")
RNN_TANH_FWD = Kernel("hulc_rnn_tanh_fwd")
RNN_TANH_BWD = Kernel("hulc_rnn_tanh_bwd")
RNN_RELU_CHAIN_FWD = Kernel("hulc_rnn_relu_chain_fwd")
RNN_RELU_CHAIN_BWD = Kernel("hulc_rnn_relu_chain_bwd")
BIRNN_TANH_FWD = Composite("hulc_birnn_tanh_fwd")
BIRNN_TANH_BWD = Composite("hulc_birnn_tanh_bwd")
DEPTH_NOISE = Kernel("hulc_depth_noise")
RNN_GRU_FWD = Kernel("hulc_rnn_gru_fwd")
RNN_GRU_BWD = Kernel("hulc_rnn_gru_bwd")
RNN_LSTM_FWD = Kernel("hulc_rnn_lstm_fwd")
RNN_LSTM_BWD = Kernel("hulc_rnn_lstm_bwd")
RNN_GRU_CHAIN_FWD = Kernel("hulc_rnn_gru_chain_fwd")
RNN_GRU_CHAIN_BWD = Kernel("hulc_rnn_gru_chain_bwd")
PREPROCESS_RGB_BF16 = Kernel("hulc_preprocess_rgb_bf16")
PREPROCESS_RGB_SHIFT_BF16 = Kernel("hulc_preprocess_rgb_shift_bf16")
SPATIAL_SOFTMAX_BF16 = Kernel("hulc_spatial_softmax_bf16")
SPATIAL_SOFTMAX_BWD_BF16 = Kernel("hulc_spatial_softmax_bwd_bf16")
RESIZE_PREPROCESS = Kernel("hulc_resize_preprocess")
# no work: its device time is the floor under every kernel's (measured, never on a path)
EMPTY_LAUNCH = Kernel("hulc_empty_launch")
ALL_KERNELS = (
    PREPROCESS_RGB, PREPROCESS_RGB_SHIFT, SPATIAL_SOFTMAX, SPATIAL_SOFTMAX_BWD,
    LOGISTIC_MIXTURE_SAMPLE, MIXTURE_NLL_FWD, MIXTURE_NLL_BWD, PLAN_ST_KL_FWD, PLAN_ST_KL_BWD,
    ADAM_LOWP, GRAD_NORM_FINISH, RNN_RELU_FWD, RNN_RELU_BWD, RNN_TANH_FWD, RNN_TANH_BWD,
    BIRNN_TANH_FWD, BIRNN_TANH_BWD, DEPTH_NOISE, RNN_GRU_FWD, RNN_GRU_BWD, RNN_LSTM_FWD, RNN_LSTM_BWD,
    PREPROCESS_RGB_BF16, PREPROCESS_RGB_SHIFT_BF16, SPATIAL_SOFTMAX_BF16, SPATIAL_SOFTMAX_BWD_BF16,
    ADAM_FP32, ADAMW, SGD, RNN_RELU_CHAIN_FWD, RNN_RELU_CHAIN_BWD, RNN_GRU_CHAIN_FWD, RNN_GRU_CHAIN_BWD,
    RESIZE_PREPROCESS,
)


def reset_launch_counts() -> None:
    for kernel in ALL_KERNELS:
        kernel.launches = 0


def require_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int | None = None) -> None:
    """Validate what a kernel is handed before its pointer is passed."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
