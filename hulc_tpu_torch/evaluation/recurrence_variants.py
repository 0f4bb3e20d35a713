"""Where a time step of the recurrence kernels goes, by taking parts out.

    python3 hulc_tpu_torch/evaluation/recurrence_variants.py [VARIANT ...]

Builds ``csrc/rnn_relu.cu`` as it is and in variants made by patching its
text (each its own ``nvcc``, all started together, into ``build/variants``),
then times each variant's forward and backward entry point with CUDA
events at the train step's (64, 32, 2048) and at (64, 1, 2048) and
(1, 1, 2048), W_hh at torch's init. A variant that leaves out part of the
work computes wrong values and is timed only; the others are held to the
plain versions (relative L2). Prints one line per variant and shape, with
the card's name and power limit first. Needs a CUDA device; run from the
repository root.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from hulc_tpu_torch import kernels  # noqa: E402
from hulc_tpu_torch.ops.recurrence import dh_chain_plain, rnn_relu_fwd_plain  # noqa: E402

_STAGE = ("      stage_chunk(stage + ((c + 1) & 1) * kRows * kHStride, src, stride, rows, (c + 1) * kChunk, "
          "hidden, vec);\n")
_FMA = "      if (k0 + kk < hidden) {\n"
_NO_STAGE = (_STAGE, "")  # only chunk 0 is staged: the others compute on stale data
_NO_FMA = (_FMA, "      if (k0 + kk < hidden && hidden < 0) {\n")

# name: (patches, whether the variant still computes the recurrence)
VARIANTS = {
    "as_built": ([], True),
    "no_staging": ([_NO_STAGE], False),  # FMAs, barriers, epilogue
    "no_fma": ([_NO_FMA], False),  # staging, barriers, epilogue
    "barriers_only": ([_NO_STAGE, _NO_FMA], False),  # the weight slice's load, barriers, epilogue
    "no_grid_barrier": ([("    if (t > 0) grid.sync();", "    if (t > 0) __syncthreads();"),
                         ("    grid.sync();  // dpre", "    __syncthreads();  // dpre")], False),
    "tile_8x4": ([("constexpr int kTileCols = 8;", "constexpr int kTileCols = 4;")], True),  # the first design
}
SHAPES = ((64, 32), (64, 1), (1, 1))
HIDDEN = 2048


def build(names):
    """{name: loaded library} for the variants that compiled."""
    source = (kernels.CSRC_DIR / "rnn_relu.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", str(src), "-o", str(out_dir / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: build failed\n{log}")
            continue
        regs = {k: v.get("registers") for k, v in kernels.ptxas_report(log).items()}
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn in ("hulc_rnn_relu_fwd", "hulc_rnn_relu_bwd"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        print(f"{name}: registers {regs}")
    return libs


def event_ms(fn, iters: int = 30, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean ms per call of ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variants", nargs="*", help=f"any of {', '.join(VARIANTS)} (default: all)")
    args = p.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        p.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("recurrence_variants needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = build(args.variants or list(VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = (2.0 * torch.rand(HIDDEN, HIDDEN, generator=gen, device="cuda") - 1.0) / HIDDEN**0.5
    bias = (2.0 * torch.rand(HIDDEN, generator=gen, device="cuda") - 1.0) / HIDDEN**0.5
    stream = torch.cuda.current_stream().cuda_stream
    for b, s in SHAPES:
        xp = torch.randn((b, s, HIDDEN), generator=gen, device="cuda")
        dy = torch.randn((b, s, HIDDEN), generator=gen, device="cuda")
        h0 = torch.zeros((b, HIDDEN), device="cuda")
        y, h_last, dpre, dh0 = (torch.empty_like(t) for t in (xp, h0, xp, h0))
        want_y = rnn_relu_fwd_plain(xp, h0, w, bias)
        want_dpre, _ = dh_chain_plain(dy, want_y, None, w)
        for name, lib in libs.items():
            def fwd():
                err = lib.hulc_rnn_relu_fwd(xp.data_ptr(), h0.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                            y.data_ptr(), h_last.data_ptr(), b, s, HIDDEN, stream)
                if err:
                    raise RuntimeError(f"{name} forward: CUDA error {err}")

            def bwd():
                err = lib.hulc_rnn_relu_bwd(dy.data_ptr(), want_y.data_ptr(), None, w.data_ptr(),
                                            dpre.data_ptr(), dh0.data_ptr(), b, s, HIDDEN, stream)
                if err:
                    raise RuntimeError(f"{name} backward: CUDA error {err}")

            fwd_ms, bwd_ms = event_ms(fwd), event_ms(bwd)
            check = ""
            if VARIANTS[name][1]:
                check = f", relative L2 y {rel_l2(y, want_y):.3g}, dpre {rel_l2(dpre, want_dpre):.3g}"
            print(f"{name} at {(b, s, HIDDEN)}: forward {fwd_ms:.6f} ms, backward {bwd_ms:.6f} ms{check} ({card})",
                  flush=True)


if __name__ == "__main__":
    main()
