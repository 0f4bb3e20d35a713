"""bf16 compute (``compute_dtype="bfloat16"``) in the port against the JAX
package on the CPU, at ``hulc_debug`` (an 84 px gripper camera, the size
``torch_convert.convert_state_dict`` maps; the recognition network's
dropout 0, since the two frameworks cannot draw the same masks; replan
every 3 steps): the bf16 plain versions of the preprocess (B.1, B.1')
bit-equal to JAX's, the SpatialSoftmax (B.2, B.2') on a bf16 map against
JAX's and ``jax.grad`` through its convert; the train losses and every
gradient; the four bf16 kernel entry points' bindings
(tests/test_torch_bf16_modules.py holds each module of the bf16 path on
the same inputs as JAX's; tests/test_torch_bf16_steps.py ``mcil_debug``'s
train step and the validation step; tests/test_torch_bf16_policy.py the
policies and the export). Weights go from JAX to the port through
``params_from_jax`` and stay fp32 in both.

With ``d_port`` = relL2(port bf16, JAX bf16) and ``d_ref`` = relL2(JAX
bf16, JAX fp32), both JAX runs on the same inputs and weights:

* module by module, on the same inputs, every output is held to
  ``d_port <= min(1e-2, 0.5 * d_ref)``: the port rounds where JAX rounds
  (an fp32 port would sit at about ``d_ref``), and each module's input
  gradient to ``d_port <= 1.5 * d_ref``;
* end to end (losses, every parameter's gradient, validation metrics,
  actions), to ``d_port <= 1.5 * d_ref`` (a gradient also to twice its
  sensitivity: relu units at zero switch; where bf16 moves an output by
  less than the fp32 tests allow the port against JAX, their tolerance:
  1e-5 for a loss or metric, 1e-4 for a gradient), forward outputs also to
  ``d_port <= 1e-2``; and the median of d(port bf16, JAX fp32) / ``d_ref``
  over a case's outputs is at least 0.5 (the port computes in bf16).

Why not 0.5 end to end: a bf16 rounding flips wherever two fp32 values
straddle a rounding point, so fp32 sums taken in another order (the
SpatialSoftmax's, a LayerNorm's) flip some roundings, and every flip
changes the next layers' inputs by a bf16 ulp: downstream of a flip two
bf16 evaluations are as far apart as two independent roundings, about
sqrt(2) * ``d_ref``. Backward, XLA keeps some products unrounded where
autograd rounds them (an input's gradient at its cast to bf16). The
measured ratios are in CHANGES.md. An output bf16 does not move in JAX
(``d_ref`` 0: a plan, a gripper success rate) must be equal.

The reference is the JAX package as it is. Its SpatialSoftmax grid is
``jnp.linspace``'s, the port's ``torch.linspace``'s (which its kernels
compute); they differ by an ulp in some entries, and in bf16 an ulp of a
keypoint flips roundings downstream. ``hulc_debug``'s train step is also
held to JAX on the port's grid (``jax_grid_of_the_port``) by the same
rule, and prints that definition's own effect on JAX's gradients
(``pytest -s``); each case prints its ratios."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.models.vision import SpatialSoftmax as JaxSpatialSoftmax
from hulc_tpu.ops.image_ops import preprocess_rgb_seq as jax_preprocess_rgb_seq

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch import kernels
from hulc_tpu_torch.evaluation.profile_policy import kind_of
from hulc_tpu_torch.models import make_model
from hulc_tpu_torch.models.hulc import HulcModel, ModalityBatch
from hulc_tpu_torch.ops.image_ops import (
    normalize_table,
    preprocess_rgb_seq,
    preprocess_rgb_seq_plain,
    preprocess_rgb_seq_shift,
    preprocess_rgb_seq_shift_plain,
)
from hulc_tpu_torch.ops.spatial_softmax import spatial_softmax, spatial_softmax_bwd, spatial_softmax_plain
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from hulc_tpu_torch.training.profile_train import bf16_device_ms
from tests.torch_bf16_common import B, KL_BETA, S, bf16_setup, check_train, jax_train, rel_l2
from tests.torch_port_common import jax_gumbel, to_torch

torch.set_num_threads(1)
# JAX's programs are compiled with XLA's default passes (jax.jit), not
# torch_port_common.QUICK_COMPILE: which bf16 roundings XLA keeps depends
# on its fusions (at optimization level 0 a gradient moved 4x d_ref)

SS_RTOL = 1e-5  # SpatialSoftmax keypoints: fp32 on the same bf16 map, sums in another order
BF16_ULP = 2.0**-7  # bf16's spacing relative to a value's power of two
CSRC = kernels.CSRC_DIR


# ---------------------------------------------------------------------------
# the configuration, the weights
# ---------------------------------------------------------------------------

def test_bf16_config_builds_with_fp32_parameters_under_the_same_keys():
    """``get_config(..., compute_dtype=)`` and ``apply_overrides`` give the
    same bf16 model; its parameters are fp32 under the fp32 model's keys
    and shapes; another compute dtype is refused."""
    fp32 = make_model(port_config.get_config("hulc_debug"), "cpu")
    for cfg in (port_config.get_config("hulc_debug", compute_dtype="bfloat16"),
                port_config.apply_overrides(port_config.get_config("hulc_debug"), ["compute_dtype=bfloat16"])):
        assert cfg.dtype == torch.bfloat16
        model = make_model(cfg, "cpu")
        assert {k: (v.shape, v.dtype) for k, v in model.state_dict().items()} == {
            k: (v.shape, v.dtype) for k, v in fp32.state_dict().items()}
    with pytest.raises(ValueError, match="compute_dtype"):
        HulcModel(port_config.get_config("hulc_debug", compute_dtype="float16"))


# ---------------------------------------------------------------------------
# the kernels' plain versions: B.1, B.1', B.2, B.2'
# ---------------------------------------------------------------------------

def _nchw(x) -> np.ndarray:
    """JAX's (B, S, H, W, C) in the port's (B, S, C, H, W) layout, bf16 as fp32."""
    return np.asarray(jnp.asarray(x, jnp.float32)).transpose(0, 1, 4, 2, 3)


@pytest.mark.parametrize("shape", [(2, 3, 84, 84, 3), (1, 2, 37, 37, 3)])
def test_plain_preprocess_bf16_is_jax_bit_for_bit(shape):
    """The eval (B.1) and the shift (B.1', on JAX's shifts) plain versions'
    bf16 outputs equal JAX's ``preprocess_rgb_seq(..., out_dtype=bfloat16)``
    bit for bit, and the bf16 normalize table (what both kernels read) is
    the plain version of every byte value."""
    imgs = np.random.default_rng(80).integers(0, 256, shape, dtype=np.uint8)
    t = torch.from_numpy(imgs)
    got = preprocess_rgb_seq(t, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, preprocess_rgb_seq_plain(t, out_dtype=torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), _nchw(jax_preprocess_rgb_seq(imgs, out_dtype=jnp.bfloat16)))
    pad, key = 4, jax.random.key(81)
    b, s = shape[:2]
    shifts = to_torch(jax.random.randint(key, (b * s, 2), 0, 2 * pad + 1))
    got = preprocess_rgb_seq_shift(t, shifts, pad, out_dtype=torch.bfloat16)
    assert torch.equal(got, preprocess_rgb_seq_shift_plain(t, shifts, pad, out_dtype=torch.bfloat16))
    want = jax_preprocess_rgb_seq(imgs, key, pad, out_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), _nchw(want))
    table = normalize_table(0.5, 0.5, torch.device("cpu"), torch.bfloat16)
    assert table.dtype == torch.bfloat16
    assert torch.equal(table, preprocess_rgb_seq_plain(torch.arange(256, dtype=torch.uint8).reshape(1, 1, 1, 256, 1),
                                                       out_dtype=torch.bfloat16).flatten())


@pytest.mark.parametrize("learnable", [False, True], ids=["fixed_t", "learnable_t"])
@pytest.mark.parametrize("shape", [(6, 64, 4, 4), (5, 3, 7, 7)])
def test_plain_spatial_softmax_on_a_bf16_map_matches_jax(shape, learnable):
    """SpatialSoftmax of a bf16 map: fp32 keypoints within rtol 1e-5 of
    JAX's; the bf16 ``dx`` within one bf16 ulp of ``jax.grad`` through the
    convert, element by element (both round an fp32 value once), and within
    1e-3 relative L2; dT (learnable T = 0.7) within 1e-5 of its terms'
    magnitudes, as the fp32 tests hold it."""
    rng = np.random.default_rng(82)
    x = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    g = rng.normal(size=(shape[0], 2 * shape[1])).astype(np.float32)
    temp = 0.7
    jax_ss = JaxSpatialSoftmax(temperature=None if learnable else temp)
    params = {"params": {"temperature": jnp.full((1,), temp, jnp.float32)}} if learnable else {}
    x_nhwc = x.transpose(0, 2, 3, 1)

    def f(p, xx):
        return jnp.sum(jax_ss.apply(p, xx) * g)

    want = jax_ss.apply(params, x_nhwc)
    dparams, dx_want = jax.grad(f, argnums=(0, 1))(params, x_nhwc)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    t = torch.full((1,), temp) if learnable else temp
    got = spatial_softmax_plain(xt, t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SS_RTOL, atol=1e-6)
    dx, dt = spatial_softmax_bwd(xt, torch.from_numpy(g), t)
    assert dx.dtype == torch.bfloat16
    dx, dx_want = dx.float().numpy(), np.asarray(dx_want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    assert np.all(np.abs(dx - dx_want) <= BF16_ULP * np.maximum(np.abs(dx), np.abs(dx_want)))
    assert rel_l2(dx, dx_want) <= 1e-3
    if learnable:
        terms = np.sum(np.abs(xt.float().numpy() * dx)) / temp
        np.testing.assert_allclose(dt.numpy(), np.asarray(dparams["params"]["temperature"]), atol=1e-5 * terms)
    # the op path and its autograd Function give the same on the CPU
    xg = xt.clone().requires_grad_()
    out = spatial_softmax(xg, t)
    assert torch.equal(out, got)
    out.backward(torch.from_numpy(g))
    assert xg.grad.dtype == torch.bfloat16 and np.array_equal(xg.grad.float().numpy(), dx)


def test_spatial_softmax_op_takes_a_bf16_map():
    """``hulc::spatial_softmax`` passes ``torch.library.opcheck`` on a bf16
    map; its output is fp32 (N, 2C), the fake implementation's too."""
    x = torch.randn(3, 5, 6, 6).to(torch.bfloat16)
    torch.library.opcheck(torch.ops.hulc.spatial_softmax.default, (x, None, 0.7))
    assert torch.ops.hulc.spatial_softmax(x, None, 0.7).dtype == torch.float32


# ---------------------------------------------------------------------------
# hulc_debug and mcil_debug in bf16 against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hulc_setup():
    return bf16_setup("hulc_debug", seed=84)


def test_hulc_train_losses_and_grads_match_jax(hulc_setup):
    """The loader-fused batch with the random shift (JAX's shifts, bf16
    frames) and JAX's plan noise: every loss and every parameter's gradient
    by the parity rule, against the JAX package and against JAX on the
    port's grid."""
    setup = hulc_setup
    jc = setup["jax_cfgs"]["float32"]
    fused = CombinedLoader.fuse_batch(setup["raw"])
    key, k_aug = jax.random.key(87), jax.random.key(88)
    want = jax_train(setup, key, k_aug, fused, train=True, port_grid=True)
    # preprocess_batch's key chain: a split per scope, then five per modality
    k_static, k_gripper = jax.random.split(jax.random.split(k_aug)[1], 5)[:2]
    pe = jc.perceptual_encoder
    shifts = {"fused": {cam: to_torch(jax.random.randint(k, (2 * B * S, 2), 0, 2 * enc.shift_pad + 1))
                        for cam, k, enc in (("rgb_static", k_static, pe.rgb_static),
                                            ("rgb_gripper", k_gripper, pe.rgb_gripper))}}
    model = setup["model"]
    model.zero_grad(set_to_none=True)
    batch = preprocess_batch(setup["cfg"], batch_to_device({k: ModalityBatch(*m) for k, m in fused.items()}, "cpu"),
                             shifts=shifts)
    assert batch["fused"].rgb_static.dtype == torch.bfloat16
    got = model.train().train_losses(batch, KL_BETA, gumbel=jax_gumbel(jax.random.split(key)[1], 2 * B, jc))
    got["total_loss"].backward()
    model.eval()
    assert float(want["bfloat16"][0]["lang_clip_loss"]) != 0.0
    assert check_train("hulc_debug train", setup, got, model, want) == len(jax.tree.leaves(setup["params"]))


# ---------------------------------------------------------------------------
# the four bf16 entry points, the profiler's kinds
# ---------------------------------------------------------------------------

BF16_ENTRY_POINTS = {
    "hulc_preprocess_rgb_bf16": "hulc_preprocess_rgb",
    "hulc_preprocess_rgb_shift_bf16": "hulc_preprocess_rgb_shift",
    "hulc_spatial_softmax_bf16": "hulc_spatial_softmax",
    "hulc_spatial_softmax_bwd_bf16": "hulc_spatial_softmax_bwd",
}


def test_bf16_entry_points_are_bound_like_their_fp32_twins():
    """Each bf16 entry point is an ``extern "C"`` launcher of its fp32
    twin's source with the twin's parameters, bound with the twin's ctypes
    signature, and counted in ``ALL_KERNELS``; on a CPU tensor no wrapper
    launches one."""
    params = {}
    for src in ("preprocess.cu", "spatial_softmax.cu"):
        for name, args in re.findall(r'extern "C" int (hulc_\w+)\(([^)]*)\)', (CSRC / src).read_text()):
            params[name] = re.sub(r"\s+", " ", args).strip()
    symbols = {k.symbol for k in kernels.ALL_KERNELS}
    for bf16, fp32 in BF16_ENTRY_POINTS.items():
        assert params[bf16] == params[fp32], bf16
        assert kernels._SIGNATURES[bf16] == kernels._SIGNATURES[fp32], bf16
        assert bf16 in symbols
    kernels.reset_launch_counts()
    imgs = torch.randint(0, 256, (1, 2, 8, 8, 3), dtype=torch.uint8)
    preprocess_rgb_seq(imgs, out_dtype=torch.bfloat16)
    preprocess_rgb_seq_shift(imgs, torch.zeros(2, 2, dtype=torch.int32), 2, out_dtype=torch.bfloat16)
    x = torch.randn(2, 3, 5, 5).to(torch.bfloat16).requires_grad_()
    spatial_softmax(x, 1.0).sum().backward()
    assert all(k.launches == 0 for k in kernels.ALL_KERNELS)


def test_ptxas_report_names_each_element_type_instance():
    """A kernel template on the element type keeps a line of the build
    report per instance, named by the type."""
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122spatial_softmax_kernelI{arg}EEvPKT_P6float2"
        f"iiiPKff' for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, 1 barriers, 76 bytes cmem[0]\n"
        for arg, regs in (("f", 30), ("13__nv_bfloat16", 32))
    )
    report = kernels.ptxas_report(log)
    assert set(report) == {"spatial_softmax_kernel<float>", "spatial_softmax_kernel<__nv_bfloat16>"}
    assert report["spatial_softmax_kernel<__nv_bfloat16>"]["registers"] == 32


BF16_OP, FP32_OP = ["c10::BFloat16", "c10::BFloat16", ""], ["float", "float", "Scalar"]


@pytest.mark.parametrize("name,kind,launch,types,outer,bf16", [
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_128x128_64x3_nhwc_align8>",
     "convolutions", "cuda_runtime", BF16_OP, None, True),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x64", "convolutions",
     "cuda_runtime", BF16_OP, None, True),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1", "matmuls", "cuda_driver",
     BF16_OP, None, True),
    ("nvjet_tst_128x64_64x8_1x2_h_bz_TNT", "matmuls", "cuda_driver", BF16_OP, None, True),
    ("nvjet_tst_128x64_64x8_1x2_h_bz_TNT", "matmuls", "cuda_driver", FP32_OP, None, False),  # its name says no type
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma", "matmuls", "cuda_runtime",
     FP32_OP, BF16_OP, False),  # the innermost op decides
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, false>", "other",
     "cuda_runtime", BF16_OP, None, True),
    ("void (anonymous namespace)::spatial_softmax_kernel<__nv_bfloat16>(__nv_bfloat16 const*, float2*, int)",
     "hand kernels", "cuda_runtime", None, None, True),
    ("void (anonymous namespace)::spatial_softmax_kernel<float>(float const*, float2*, int)", "hand kernels",
     "cuda_runtime", None, BF16_OP, False),  # a hand kernel: its instance's type decides
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize256x64x8", "convolutions",
     "cuda_runtime", None, None, False),  # launched inside no op
])
def test_profiles_split_bf16_kernels_by_kind(name, kind, launch, types, outer, bf16):
    """profile_train's kinds (bf16 convolutions and matmuls as such, the
    layout transposes as other) on kernel names a bf16 step's profile shows,
    and its bf16 split (``bf16_device_ms``) on a Chrome trace of one launch:
    by the input types of the innermost CPU op around the launching runtime
    or driver call, a hand kernel by its instance's type."""
    events = [
        {"cat": "kernel", "name": name, "ts": 50, "dur": 4.0, "tid": 7, "args": {"correlation": 9}},
        {"cat": launch, "name": "cudaLaunchKernel", "ts": 20, "dur": 2, "tid": 1, "args": {"correlation": 9}},
        {"cat": "cpu_op", "name": "aten::sum", "ts": 12, "dur": 3, "tid": 1, "args": {"Input type": BF16_OP}},
    ]
    if types is not None:
        events.append({"cat": "cpu_op", "name": "aten::op", "ts": 15, "dur": 10, "tid": 1, "args": {"Input type": types}})
    if outer is not None:
        events.append({"cat": "cpu_op", "name": "aten::outer", "ts": 10, "dur": 40, "tid": 1, "args": {"Input type": outer}})
    assert kind_of(name) == kind
    assert bf16_device_ms(events, 2) == ({kind: 0.002} if bf16 else {})
