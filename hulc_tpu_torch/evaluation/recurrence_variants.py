"""Where a time step of the recurrence kernels goes, by taking parts out.

    python3 hulc_tpu_torch/evaluation/recurrence_variants.py [VARIANT ...]
    python3 hulc_tpu_torch/evaluation/recurrence_variants.py --gated [VARIANT ...]

Builds ``csrc/rnn.cu`` as it is and in variants made by patching its
text (each its own ``nvcc``, all started together, into ``build/variants``),
then times each variant's relu forward and backward entry point with CUDA
events at the train step's (64, 32, 2048) and at (64, 1, 2048) and
(1, 1, 2048), W_hh at torch's init, with the plan ``ops.recurrence`` makes
for the card. With ``--gated`` the same for ``csrc/rnn_gates.cu`` (its own
variants, ``GATED_VARIANTS``): the gru (B.11) and lstm (B.12) forward and dh
chain at (64, 32, 2048) and (64, 1, 2048). A variant that leaves out part of the
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
from typing import Tuple

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from hulc_tpu_torch import kernels  # noqa: E402
from hulc_tpu_torch.evaluation.kernel_times import event_ms  # noqa: E402
from hulc_tpu_torch.ops.recurrence import GATES, _gated_loop, device_plan, gated_device_plan  # noqa: E402
from hulc_tpu_torch.ops.recurrence import dh_chain_gru_plain, dh_chain_lstm_plain  # noqa: E402
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

# csrc/rnn_gates.cu's variants: the same name in the forward and the dh chain. A box left
# out of a chunk is still announced (as 0 bytes), so the ring's barriers complete.
_G_W = (("        mbar_arrive_tx(&bars.w[p % NS], sizeof(float) * C::kGateCols * C::kFwdStride);\n"
         "        for (int g = 0; g < G; ++g)\n",
         "        mbar_arrive_tx(&bars.w[p % NS], 0);\n        for (int g = 0; g < 0; ++g)\n"),
        ("        mbar_arrive_tx(&bars.w[p % NS], sizeof(float) * kCols * kBwdStride);\n"
         "        tma_2d(ws, maps.w, geo.k0 + kc, geo.c0, &bars.w[p % NS]);\n",
         "        mbar_arrive_tx(&bars.w[p % NS], 0);\n"))
_G_STATE = (("        mbar_arrive_tx(&bars.state[p % NS], sizeof(float) * kRows * C::kFwdStride);\n"
             "        if (t == 0) {",
             "        mbar_arrive_tx(&bars.state[p % NS], 0);\n        if (t < 0) {"),
            ("          tma_3d(hs, maps.state, geo.k0 + kc, time_of<kLaid>(a, t - 1), r0, &bars.state[p % NS]);", ""),
            ("        mbar_arrive_tx(&bars.state[p % NS], sizeof(float) * kBwdDhpFloats);\n        if (S == 1) {",
             "        mbar_arrive_tx(&bars.state[p % NS], 0);\n        if (S < 0) {"),
            ("          tma_3d(ds, maps.state, geo.k0 + kc, t, r0, &bars.state[p % NS]);", ""))
_G_FMA = ("  for (int i = 0; i < kQuads; ++i) {\n",)  # chunk_fma, forward and dh chain
_G_EPILOGUE = ("      for (int i0 = threadIdx.x; i0 < n_items; i0 += kBatch * NT) {\n",)


def _never(line: str) -> Tuple[str, str]:
    """A patch that keeps a loop's header but runs its body never."""
    return line, line.replace("; ++i) {", " && blockDim.x == 0; ++i) {").replace(
        "; i0 += ", " && blockDim.x == 0; i0 += ")


# name: (patches, whether the variant still computes the recurrence)
GATED_VARIANTS = {
    "as_built": ([], True),
    # each chunk computes on whatever state its stage held: W streamed, FMAs, reduction, barriers, epilogue
    "no_state_staging": (list(_G_STATE), False),
    # each chunk computes on whatever W its stage held: the state staged, FMAs, reduction, barriers, epilogue
    "no_w_stream": (list(_G_W), False),
    "no_fma": ([_never(line) for line in _G_FMA], False),  # the ring, reduction, barriers, epilogue
    # no copies: the FMAs on stale stages, the ring's barriers, reduction, grid barrier, epilogue
    "fma_only": (list(_G_STATE + _G_W), False),
    "no_epilogue": ([_never(line) for line in _G_EPILOGUE], False),  # no reduction, no cell, no stores
    # the ring's barriers, the reduction, the grid barrier, the epilogue; no copies, no FMAs
    "barriers_only": (list(_G_STATE + _G_W) + [_never(line) for line in _G_FMA], False),
    # the epilogue without its global loads (xp, b_hh, the carried states, dy, the saved gates)
    "epilogue_no_loads": ([
        ("            x[m][g] = n > 0 ? load4(a.xp + bt * gh + g * H + j, n, a.vec) : zero;",
         "            x[m][g] = zero;"),
        ("                                    load4(a.bias + g * H + j, n, a.vec))",
         "                                    zero)"),
        ("          h_prev[m] = n > 0 ? load4(t == 0 ? a.h0 + bj : a.y + (static_cast<long long>(b) * S + tq) * YW + j, "
         "n, a.vec)\n                            : zero;",
         "          h_prev[m] = zero;"),
        ("          c_prev[m] = kLstm && n > 0 ? load4(t == 0 ? a.c0 + bj : a.c_last + bj, n, a.vec) : zero;",
         "          c_prev[m] = zero;"),
        ("  for (int k = 0; k < C::kSaved; ++k) s[k] = load4(sv + k * H, n, vec);",
         "  for (int k = 0; k < C::kSaved; ++k) s[k] = make_float4(0.5f, 0.5f, 0.5f, 0.5f);"),
        ("          if (!kLstm && n > 0) dh[m] = add4(dh[m], load4(a.dh0 + bj, n, a.vec));", ""),
        ("          dy[m] = n > 0 && t > 0 ? load4(a.dy + (static_cast<long long>(b) * S + tq) * YW + j, n, a.vec)"
         " : zero;",
         "          dy[m] = zero;"),
        ("          dc[m] = kLstm && n > 0 && t > 0 ? load4(a.dc0 + bj, n, a.vec) : zero;", "          dc[m] = zero;"),
    ], False),
    # each block sums its own partial cluster-size times: shared memory, not DSMEM
    "no_dsmem_reduction": ([("    for (int q = 0; q < kMaxCluster; ++q)"
                             " rank[q] = q < n ? cluster.map_shared_rank(part, q) : part;",
                             "    for (int q = 0; q < kMaxCluster; ++q) rank[q] = part;")], False),
    # no proxy fence between the state's plain stores and the next step's boxes
    "no_proxy_fence": ([("      if (a.tma && threadIdx.x == 0) fence_proxy_global();\n", ""),
                        ("    if (a.tma && threadIdx.x == 0) fence_proxy_global();\n", "")], True),
    "no_grid_barrier": ([("      cg::this_grid().sync();  // y[:, t - 1]", "      __syncthreads();  // y[:, t - 1]"),
                         ("    cg::this_grid().sync();  // dhp", "    __syncthreads();  // dhp")], False),
}
GATED_SHAPES = ((64, 32), (64, 1))


def patched_source(name: str, gated: bool = False) -> str:
    """``csrc/rnn.cu`` (``csrc/rnn_gates.cu`` when ``gated``) with
    ``name``'s patches; raises when a patch's text is not in the source."""
    text = (kernels.CSRC_DIR / ("rnn_gates.cu" if gated else "rnn.cu")).read_text()
    for old, new in (GATED_VARIANTS if gated else VARIANTS)[name][0]:
        if old not in text:
            raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def build(names, gated: bool = False):
    """{name: loaded library} for the variants that compiled."""
    out_dir = kernels.BUILD_DIR / ("variants_gated" if gated else "variants")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out_dir / f"{name}.cu"
        src.write_text(patched_source(name, gated))
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
        fns = GATED_SYMBOLS if gated else ("hulc_rnn_relu_fwd", "hulc_rnn_relu_bwd")
        for fn in fns:
            getattr(lib, fn).argtypes = [*kernels._SIGNATURES[fn], ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        if gated:
            lib.hulc_rnn_gated_check.argtypes = [ctypes.c_int] * 13
        else:
            lib.hulc_rnn_check.argtypes = [ctypes.c_int] * 10
        libs[name] = lib
        print(f"{name}: registers {regs}")
    return libs


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


GATED_SYMBOLS = ("hulc_rnn_gru_fwd", "hulc_rnn_gru_bwd", "hulc_rnn_lstm_fwd", "hulc_rnn_lstm_bwd")


def time_gated(libs, card: str) -> None:
    """Each variant's gru and lstm forward (inference) and dh chain at
    GATED_SHAPES: W_hh and b_hh at torch's U(-1/sqrt(H), 1/sqrt(H)), xp, dy
    and the carries ~ N(0, 1), the saved gates from the plain loop."""
    index = torch.cuda.current_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    h = HIDDEN
    for cell in GATES:
        lstm, g = cell == "lstm", GATES[cell]
        w = (2.0 * torch.rand(g * h, h, generator=gen, device="cuda") - 1.0) / h**0.5
        bias = (2.0 * torch.rand(g * h, generator=gen, device="cuda") - 1.0) / h**0.5
        for b, s in GATED_SHAPES:
            xp = torch.randn((b, s, g * h), generator=gen, device="cuda")
            h0, c0, dh_last, dc_last = (torch.randn((b, h), generator=gen, device="cuda") for _ in range(4))
            dy = torch.randn((b, s, h), generator=gen, device="cuda")
            want_y, _, saved = _gated_loop(cell, xp, h0, c0 if lstm else None, w, bias, True)
            if lstm:
                want = dh_chain_lstm_plain(dy, dh_last, dc_last, saved, c0, w)[0]
            else:
                want = dh_chain_gru_plain(dy, dh_last, want_y, h0, saved, w)[0]
            y, h_last, c_last = torch.empty_like(want_y), torch.empty_like(h0), torch.empty_like(h0)
            dxp, dhp, dh0, dc0 = torch.empty_like(xp), torch.empty_like(xp), torch.empty_like(h0), torch.empty_like(h0)
            w_t = torch.empty((h, g * h), device="cuda")
            fwd_plan = gated_device_plan(cell, h, b, s, index, False, False).c_args()
            bwd_plan = gated_device_plan(cell, h, b, s, index, True, False).c_args()
            for name, lib in libs.items():
                for backward, plan in ((False, fwd_plan), (True, bwd_plan)):
                    # the variant's own check: it also lets its sequence kernel take the shared memory
                    err = lib.hulc_rnn_gated_check(int(lstm), 0, int(backward), 0, b, s, h, *plan)
                    if err:
                        raise RuntimeError(f"{name}: hulc_rnn_gated_check refused {plan} at {(b, s, h)}: error {err}")
                if lstm:
                    fwd_args = (xp, h0, c0, w, bias, y, h_last, c_last, None)
                    bwd_args = (dy, dh_last, dc_last, saved, c0, w, w_t, dxp, dh0, dc0)
                else:
                    fwd_args = (xp, h0, w, bias, y, h_last, None)
                    bwd_args = (dy, dh_last, want_y, h0, saved, w, w_t, dxp, dhp, dh0)
                fwd_ptrs = [None if a is None else a.data_ptr() for a in fwd_args]
                bwd_ptrs = [None if a is None else a.data_ptr() for a in bwd_args]

                def fwd(lib=lib, name=name):
                    err = getattr(lib, f"hulc_rnn_{cell}_fwd")(*fwd_ptrs, b, s, h, *fwd_plan, stream)
                    if err:
                        raise RuntimeError(f"{name} {cell} forward: CUDA error {err}")

                def bwd(lib=lib, name=name):
                    err = getattr(lib, f"hulc_rnn_{cell}_bwd")(*bwd_ptrs, b, s, h, *bwd_plan, stream)
                    if err:
                        raise RuntimeError(f"{name} {cell} dh chain: CUDA error {err}")

                fwd_ms, bwd_ms = event_ms(fwd), event_ms(bwd)
                check = ""
                if GATED_VARIANTS[name][1]:
                    check = f", relative L2 y {rel_l2(y, want_y):.3g}, dxp {rel_l2(dxp, want):.3g}"
                print(f"{name} {cell} at {(b, s, h)}: forward {fwd_ms:.6f} ms, dh chain {bwd_ms:.6f} ms{check} "
                      f"({card})", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variants", nargs="*", help=f"any of {', '.join(VARIANTS)} (default: all); with --gated any of "
                                               f"{', '.join(GATED_VARIANTS)}")
    p.add_argument("--gated", action="store_true", help="the variants of csrc/rnn_gates.cu (B.11, B.12)")
    args = p.parse_args(argv)
    table = GATED_VARIANTS if args.gated else VARIANTS
    unknown = set(args.variants) - set(table)
    if unknown:
        p.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("recurrence_variants needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = build(args.variants or list(table), args.gated)
    if args.gated:
        time_gated(libs, card)
        return
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
