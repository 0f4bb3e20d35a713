"""Where a time step of the recurrence kernels goes, by taking parts out.

    python3 hulc_tpu_torch/evaluation/recurrence_variants.py [VARIANT ...]

Builds ``csrc/rnn.cu`` as it is and in variants made by patching its
text (each its own ``nvcc``, all started together, into ``build/variants``),
then times each variant's relu forward and backward entry point with CUDA
events at the train step's (64, 32, 2048) and at (64, 1, 2048) and
(1, 1, 2048), W_hh at torch's init, with the plan ``ops.recurrence`` makes
for the card. A variant that leaves out part of the
work computes wrong values and is timed only; the others are held to the
plain versions (relative L2). A patch whose text the source no longer has
raises. Prints one line per variant and shape, with the card's name and
power limit first. Needs a CUDA device; run from the repository root.
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
from hulc_tpu_torch.evaluation.kernel_times import event_ms  # noqa: E402
from hulc_tpu_torch.ops.recurrence import device_plan  # noqa: E402
from hulc_tpu_torch.ops.recurrence import dh_chain_plain, rnn_relu_fwd_plain  # noqa: E402

_STAGE = ("      stage_chunk(stage + ((c + 1) & 1) * kRows * kHStride, src, stride, rows, (c + 1) * kChunk, "
          "g, vec);\n")
_FMA = "    for (int i = 0; i < kPartQuads; ++i) {\n"  # preceded by its unroll pragma
_NO_STAGE = (_STAGE, "")  # only chunk 0 of a step is staged: the others compute on stale data
_NO_FMA = (_FMA, "    for (int i = 0; i < kPartQuads && g.k_valid < 0; ++i) {\n")
_H_LOAD = "h[r] = *reinterpret_cast<const float4*>(hs + (rg + 8 * r) * kHStride + kk);"
_W_LOAD = "const float4 wv = *reinterpret_cast<const float4*>(wc + (col0 + kColGroups * q) * wst + kk);"
_CHAIN = """        for (int r = 0; r < kTileRows; ++r) {
          float a = acc[r][q];
          a = fmaf(h[r].x, wv.x, a);
          a = fmaf(h[r].y, wv.y, a);
          a = fmaf(h[r].z, wv.z, a);
          acc[r][q] = fmaf(h[r].w, wv.w, a);
        }
"""
_K_OUTER = """        for (int r = 0; r < kTileRows; ++r) acc[r][q] = fmaf(h[r].x, wv.x, acc[r][q]);
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) acc[r][q] = fmaf(h[r].y, wv.y, acc[r][q]);
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) acc[r][q] = fmaf(h[r].z, wv.z, acc[r][q]);
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) acc[r][q] = fmaf(h[r].w, wv.w, acc[r][q]);
"""

# name: (patches, whether the variant still computes the recurrence)
VARIANTS = {
    "as_built": ([], True),
    "no_staging": ([_NO_STAGE], False),  # FMAs, DSMEM reduction, barriers, epilogue
    "no_fma": ([_NO_FMA], False),  # staging, DSMEM reduction, barriers, epilogue
    "barriers_only": ([_NO_STAGE, _NO_FMA], False),  # the W slice's load, reduction, barriers, epilogue
    # each block sums its own partial cluster-size times: shared memory, not DSMEM
    "no_dsmem_reduction": ([("cluster.map_shared_rank(part, r)[row * kPartStride + col]",
                             "part[row * kPartStride + col]")], False),
    "no_grid_barrier": ([("    if (t > 0) cg::this_grid().sync();", "    if (t > 0) __syncthreads();"),
                         ("    cg::this_grid().sync();  // dpre", "    __syncthreads();  // dpre")], False),
    # the FMAs of one k value for all 8 x 9 outputs, then the next (no chain
    # of four dependent FMAs per output)
    "k_outer": ([(_CHAIN, _K_OUTER)], True),
    "no_unroll": ([("#pragma unroll\n" + _FMA, _FMA)], True),  # the k loop of a chunk not unrolled
    # every lane reads one row of the state (or one column of W): what the
    # shared-memory loads of the other cost
    "h_broadcast": ([(_H_LOAD, _H_LOAD.replace("(rg + 8 * r) * kHStride + kk", "kk"))], False),
    "w_broadcast": ([(_W_LOAD, _W_LOAD.replace("(col0 + kColGroups * q) * wst + kk", "kk"))], False),
    # the DSMEM loads of one output in flight at a time, not of five
    "reduce_batch_1": ([("constexpr int kReduceBatch = 5;", "constexpr int kReduceBatch = 1;")], True),
    # no cluster barrier between the partials' writes and their reads
    "no_cluster_sync": ([("      cluster.sync();  // every partial of the cluster is written\n", ""),
                         ("      cluster.sync();\n      reduce_partials", "      reduce_partials")], False),
    # the one-step GEMV with all of a lane's loads of W in flight at H = 2048
    "step_unroll_16": ([("#pragma unroll 4\n    for (int q = lane; q < quads; q += 32) {",
                         "#pragma unroll 16\n    for (int q = lane; q < quads; q += 32) {")], True),
}
SHAPES = ((64, 32), (64, 1), (1, 1))
HIDDEN = 2048


def patched_source(name: str) -> str:
    """``csrc/rnn.cu`` with ``name``'s patches; raises when a patch's text
    is not in the source."""
    text = (kernels.CSRC_DIR / "rnn.cu").read_text()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def build(names):
    """{name: loaded library} for the variants that compiled."""
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out_dir / f"{name}.cu"
        src.write_text(patched_source(name))
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
            getattr(lib, fn).argtypes = [*kernels._SIGNATURES[fn], ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        lib.hulc_rnn_check.argtypes = [ctypes.c_int] * 10
        libs[name] = lib
        print(f"{name}: registers {regs}")
    return libs


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
    index = torch.cuda.current_device()

    def plan(lib, b, s, backward):
        # the variant's own check: it also lets its sequence kernel take the shared memory
        args = device_plan(HIDDEN, b, s, index, backward).c_args()
        err = lib.hulc_rnn_check(0, int(backward), b, s, HIDDEN, *args)
        if err:
            raise RuntimeError(f"hulc_rnn_check refused {args} at {(b, s, HIDDEN)}: CUDA error {err}")
        return args

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
            fwd_plan, bwd_plan = plan(lib, b, s, False), plan(lib, b, s, True)

            def fwd():
                err = lib.hulc_rnn_relu_fwd(xp.data_ptr(), h0.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                            y.data_ptr(), h_last.data_ptr(), b, s, HIDDEN, *fwd_plan, stream)
                if err:
                    raise RuntimeError(f"{name} forward: CUDA error {err}")

            def bwd():
                err = lib.hulc_rnn_relu_bwd(dy.data_ptr(), want_y.data_ptr(), None, w.data_ptr(),
                                            dpre.data_ptr(), dh0.data_ptr(), b, s, HIDDEN, *bwd_plan, stream)
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
