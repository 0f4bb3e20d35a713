"""Where B.15's time goes, by taking parts out and by changing its band.

    python3 hulc_tpu_torch/evaluation/resize_variants.py [VARIANT ...] [--budgets BYTES,...]

Builds ``csrc/resize_preprocess.cu`` as it is and in variants made by
patching its text (each its own ``nvcc``, all started together, into
``build/variants``), then times each variant by CUDA events at the train
step's modes (``MODES``: CLIP's 2048 frames of 200 px to 224 in fp32 and
bf16, the tactile 160 x 120 x 6 frame in one launch, the 64 px tactile
frame), each on uint8 frames and shifts from seed 0 through
``image_ops._launch_resize`` with the variant's entry point. A variant that
leaves out part of the work computes wrong values and is timed only; the
others (as built, with nvcc's division, the H pass a byte a load) are held
to the plain version (bit-equal). With
``--budgets`` the as-built kernel is also timed with ``resize_plan``'s
shared-memory budget at each value (its band changes with it). A patch
whose text the source no longer has raises. Prints one line per variant
and mode, with the card's name and power limit first. Needs a CUDA device;
run from the repository root.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from hulc_tpu_torch import kernels  # noqa: E402
from hulc_tpu_torch.evaluation.kernel_times import card, event_ms  # noqa: E402
from hulc_tpu_torch.ops import image_ops  # noqa: E402

_EPILOGUE = "put(plane + r * ow + x, epilogue(v, mean, std, d255, inv255, flags));"
_W_CALL = ("      contract_cols(T, width, band, rb, c, ow, dx, p.rw, col_e, p.col_es, p.col_taps, [&](int ch) {")
_H_CALL = "      contract_rows(T, S, 1, wc, c, row_e, p.row_es, p.row_taps, c, rb, p.band, p.w);"
_PRE = "      contract_rows(T, S, 1, wc, c, prow_e, p.prow_es, p.pre_row_taps, c, ni, cap, p.w);"
_STAGE = "k < a1; k += 16LL * kThreads) cp_async16"
_STORE = "    for (int k = 0; k < runs; ++k) {"
_DIVIDE = "  return fmaf(d.y, fmaf(q, -d.b, a), q);"
_PACKED = "    if (in_ch == 1 && in_col == c && in_row % 4 == 0"
_NO = "      if (p.n < 0) "

# name: (patches, each (text, replacement); whether the variant computes the right values)
VARIANTS = {
    "as_built": ([], True),
    "nvcc_division": ([(_DIVIDE, "  return __fdiv_rn(a, d.b);")], True),  # __fdiv_rn per element
    "bytes_one_by_one": ([(_PACKED, "    if (in_row < 0")], True),  # the H pass a byte a load
    "no_epilogue": ([(_EPILOGUE, "put(plane + r * ow + x, v);")], False),  # the W sums stored as they are
    "no_w": ([(_W_CALL, _NO + _W_CALL.lstrip())], False),  # no W contraction, no epilogue
    "no_h": ([(_H_CALL, _NO + _H_CALL.lstrip())], False),  # no H contraction (one resize)
    "no_first_resize": ([(_PRE, _NO + _PRE.lstrip())], False),  # the tactile frame's first H pass skipped
    "no_staging": ([(_STAGE, "k < a1 && total < 0; k += 16LL * kThreads) cp_async16")], False),
    "no_store": ([(_STORE, "    for (int k = 0; k < runs * 0; ++k) {")], False),
    "memory_only": ([(_EPILOGUE, "put(plane + r * ow + x, v);"), (_W_CALL, _NO + _W_CALL.lstrip()),
                     (_H_CALL, _NO + _H_CALL.lstrip())], False),
    "threads_512": ([("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")], True),
    "threads_128": ([("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")], True),
}
MODES = {
    "clip_train_fp32": ((2048, 200, 200, 3), image_ops.clip_prep(224, (200, 200), 10, True), torch.float32),
    "clip_train_bf16": ((2048, 200, 200, 3), image_ops.clip_prep(224, (200, 200), 10, True), torch.bfloat16),
    "tactile_160x120_train_fp32": ((2048, 160, 120, 6), image_ops.tactile_prep(64, 6, True, (160, 120)),
                                   torch.float32),
    "tactile_64_train_fp32": ((2048, 64, 64, 6), image_ops.tactile_prep(64, 6, True), torch.float32),
}
OUT = pathlib.Path("build/variants")


def patched(name: str) -> str:
    src = (kernels.CSRC_DIR / "resize_preprocess.cu").read_text()
    for text, replacement in VARIANTS[name][0]:
        if text not in src:
            raise ValueError(f"variant {name}: the source no longer has {text!r}")
        src = src.replace(text, replacement)
    return src


def build(names) -> dict:
    """{name: loaded library} of each variant, compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels._nvcc(), {}
    for name in names:
        cu = OUT / f"resize_{name}.cu"
        cu.write_text(patched(name))
        procs[name] = subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-shared", str(cu), "-o", str(cu.with_suffix(".so"))],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"resize_{name}.so"))
        fn = lib.hulc_resize_preprocess
        fn.argtypes = [*kernels._SIGNATURES["hulc_resize_preprocess"], ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def launcher(fn):
    def launch(device, *args):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"hulc_resize_preprocess failed to launch: CUDA error {err}")
    return launch


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variants", nargs="*", default=list(VARIANTS))
    p.add_argument("--budgets", default="", help="shared-memory budgets (bytes) to time the as-built kernel at")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("resize_variants needs a CUDA device")
    print(card(), flush=True)
    fns = build(args.variants)
    gen = torch.Generator(device="cuda").manual_seed(0)
    budgets = [int(b) for b in args.budgets.split(",") if b]
    for mode, (shape, prep, dtype) in MODES.items():
        frames = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
        shifts = torch.randint(0, 2 * prep.pad + 1, (shape[0], 2), generator=gen, device="cuda", dtype=torch.int32)
        out = torch.empty((shape[0], shape[3], *prep.out_size), dtype=dtype, device="cuda")
        kind = image_ops._OUT_KIND[dtype]

        def call(fn):
            return image_ops._launch_resize(frames, prep.size, out, kind, prep, shifts, launch=launcher(fn))

        for name, fn in fns.items():
            ms = event_ms(lambda: call(fn))
            note = ""
            if VARIANTS[name][1]:
                call(fn)
                equal = torch.equal(out, image_ops.resize_preprocess_plain(frames, prep, shifts, dtype))
                note = f", bit-equal to the plain version: {equal}"
            plan = image_ops.resize_plan(*shape[1:], 1, prep.size, prep.out_size, prep.pre, kind)
            print(f"{mode} {name}: {ms:.6f} ms (band {plan.band}, {plan.smem_bytes} B shared memory){note}", flush=True)
        for budget in budgets:
            saved = image_ops.B15_SMEM_BUDGET
            image_ops.B15_SMEM_BUDGET = budget
            image_ops.resize_plan.cache_clear()
            try:
                plan = image_ops.resize_plan(*shape[1:], 1, prep.size, prep.out_size, prep.pre, kind)
                ms = event_ms(lambda: call(fns["as_built"]))
                print(f"{mode} as_built at a {budget} B budget: {ms:.6f} ms (band {plan.band}, {plan.smem_bytes} B)",
                      flush=True)
            except ValueError as err:
                print(f"{mode} at a {budget} B budget: {err}")
            finally:
                image_ops.B15_SMEM_BUDGET = saved
                image_ops.resize_plan.cache_clear()
        del frames, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
