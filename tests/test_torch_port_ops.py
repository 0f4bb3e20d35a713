"""Port ops (hulc_tpu_torch.ops, SpatialSoftmax) against the JAX package on
the CPU, where each kernel wrapper runs its plain PyTorch version. Inputs
and noise come from numpy seeds or from the keys JAX draws with, so both
packages see the same numbers."""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulc_tpu.models.vision import SpatialSoftmax as JaxSpatialSoftmax
from hulc_tpu.ops import frame_transforms as jft
from hulc_tpu.ops import rotations as jrot
from hulc_tpu.ops.image_ops import preprocess_rgb_seq as jax_preprocess
from hulc_tpu.ops.logistic_mixture import logistic_mixture_sample as jax_mixture_sample
from hulc_tpu.ops.plan_distributions import DiscretePlanState as JaxPlanState
from hulc_tpu.ops.plan_distributions import PlanDistribution as JaxPlanDistribution

from hulc_tpu_torch import kernels
from hulc_tpu_torch.models.vision import spatial_softmax, spatial_softmax_plain
from hulc_tpu_torch.ops import frame_transforms, rotations
from hulc_tpu_torch.ops.image_ops import normalize_table, preprocess_rgb_seq, preprocess_rgb_seq_plain
from hulc_tpu_torch.ops.logistic_mixture import U_MAX, U_MIN, draw_raw_uniforms, map_uniforms, sample_action
from hulc_tpu_torch.ops.plan_distributions import DiscretePlanState, PlanDistribution

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "hulc_tpu_torch"


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def jax_mixture_uniforms(rng, shape):
    """The uniforms logistic_mixture_sample draws from ``rng``."""
    k_mix, k_inv = jax.random.split(rng)
    u_mix = jax.random.uniform(k_mix, shape, jnp.float32, minval=U_MIN, maxval=U_MAX)
    u_inv = jax.random.uniform(k_inv, shape[:-1], jnp.float32, minval=U_MIN, maxval=U_MAX)
    return u_mix, u_inv


# Tolerance: XLA on the CPU and plain torch already differ by up to 1.19e-7
# on the same uint8 frames (one ulp near 1.0); 2.4e-7 is two ulp.
@pytest.mark.parametrize("shape", [(2, 1, 64, 64, 3), (3, 1, 84, 84, 3), (1, 2, 200, 200, 3)])
def test_preprocess_matches_jax(shape):
    imgs = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    want = np.asarray(jax_preprocess(jnp.asarray(imgs))).transpose(0, 1, 4, 2, 3)
    got = preprocess_rgb_seq(_t(imgs))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2.4e-7, rtol=0)


# The eval preprocess kernel normalizes through the 256-entry table: that
# formulation must be the plain version bit for bit, for any (mean, std),
# and agree with JAX as the plain version does (2.4e-7, two ulp near 1.0).
@pytest.mark.parametrize("shape", [(1, 1, 37, 37, 3), (2, 1, 84, 84, 3)])
@pytest.mark.parametrize("mean,std", [(0.5, 0.5), (0.45, 0.27)])
def test_eval_preprocess_through_the_normalize_table_is_bit_equal(shape, mean, std):
    imgs = np.random.default_rng(9).integers(0, 256, shape, np.uint8)
    table = normalize_table(mean, std, torch.device("cpu"))
    got = table[_t(imgs).long()].permute(0, 1, 4, 2, 3)
    assert torch.equal(got, preprocess_rgb_seq_plain(_t(imgs), mean, std))
    want = np.asarray(jax_preprocess(jnp.asarray(imgs), mean=mean, std=std)).transpose(0, 1, 4, 2, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2.4e-7, rtol=0)


@pytest.mark.parametrize("shape", [(3, 21, 21, 64), (3, 4, 4, 64), (2, 7, 7, 5)])  # full, hulc_debug, odd
@pytest.mark.parametrize("temperature", [1.0, 0.5, None])
def test_spatial_softmax_matches_jax(temperature, shape):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=shape)).astype(np.float32)
    mod = JaxSpatialSoftmax(temperature=temperature)
    params = mod.init(jax.random.key(0), jnp.asarray(x))
    temp = 1.0 if temperature is None else temperature
    if temperature is None:  # learnable: move it off its init value
        temp = 1.3
        params = {"params": {"temperature": jnp.full((1,), temp, jnp.float32)}}
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    temp_arg = torch.tensor([temp]) if temperature is None else temp
    got = spatial_softmax(_t(x.transpose(0, 3, 1, 2)), temp_arg)
    assert got.shape == (shape[0], 2 * shape[3])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("lanes", [1, 64])
def test_logistic_mixture_sample_matches_jax(lanes):
    rng = np.random.default_rng(2)
    shape = (lanes, 1, 6, 10)
    logits, means = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    log_scales = np.maximum(rng.normal(size=shape) - 2.0, -7.0).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jax_mixture_sample(key, jnp.asarray(logits), jnp.asarray(log_scales), jnp.asarray(means)))
    u_mix, u_inv = jax_mixture_uniforms(key, shape)
    got = sample_action(_t(logits), _t(log_scales), _t(means), _t(u_mix), _t(u_inv), uniform_map=(0.0, 1.0))
    assert got.shape == (lanes, 1, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_draw_uniforms_is_seeded_and_in_range():
    shape = (4, 1, 6, 10)
    cpu = torch.device("cpu")
    first, again = ([map_uniforms(u) for u in draw_raw_uniforms(shape, torch.Generator().manual_seed(5), cpu)]
                    for _ in range(2))
    for u, v, want_shape in zip(first, again, (shape, shape[:-1])):
        assert u.shape == want_shape and torch.equal(u, v)
        assert bool((u >= U_MIN).all()) and bool((u <= U_MAX).all())


def _canonical_orn(rng, n):
    """Euler angles with the middle angle inside +-pi/2 (away from gimbal lock)."""
    return np.stack(
        [rng.uniform(-np.pi, np.pi, n), rng.uniform(-1.3, 1.3, n), rng.uniform(-np.pi, np.pi, n)], -1
    ).astype(np.float32)


def test_rotations_match_jax():
    angles = _canonical_orn(np.random.default_rng(4), 256)
    want_m = np.asarray(jrot.euler_angles_to_matrix(jnp.asarray(angles), "XYZ"))
    got_m = rotations.euler_angles_to_matrix(_t(angles), "XYZ")
    np.testing.assert_allclose(got_m.numpy(), want_m, atol=1e-6, rtol=0)
    want_a = np.asarray(jrot.matrix_to_euler_angles(jnp.asarray(want_m), "XYZ"))
    got_a = rotations.matrix_to_euler_angles(_t(want_m), "XYZ")
    np.testing.assert_allclose(got_a.numpy(), want_a, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_a.numpy(), angles, atol=1e-4, rtol=0)


# Tolerance 5e-4: the frame transforms scale rotation deltas by 0.01 before
# composing and by 100 after, amplifying float noise a hundredfold.
@pytest.mark.parametrize("name", ["tcp_to_world_frame", "world_to_tcp_frame"])
def test_frame_transforms_match_jax(name):
    rng = np.random.default_rng(5)
    n = 128
    action = np.concatenate(
        [rng.normal(size=(n, 6)), rng.choice([-1.0, 1.0], size=(n, 1))], -1
    ).astype(np.float32)
    robot_obs = rng.normal(size=(n, 15)).astype(np.float32)
    robot_obs[:, 3:6] = _canonical_orn(rng, n)
    want = np.asarray(getattr(jft, name)(jnp.asarray(action), jnp.asarray(robot_obs)))
    got = getattr(frame_transforms, name)(_t(action), _t(robot_obs))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


@pytest.mark.parametrize("grid", [(4, 4), (32, 32)])
def test_plan_sample_matches_jax_exactly(grid):
    cat, cls = grid
    logits = np.random.default_rng(6).normal(size=(5, cat * cls)).astype(np.float32)
    key = jax.random.key(7)
    jdist = JaxPlanDistribution(kind="discrete", category_size=cat, class_size=cls)
    want = np.asarray(jdist.sample(key, JaxPlanState(jnp.asarray(logits))))
    gumbel = jax.random.gumbel(key, (5, cat, cls))
    dist = PlanDistribution(category_size=cat, class_size=cls)
    got = dist.sample(DiscretePlanState(_t(logits)), gumbel=_t(gumbel))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        dist.mode(DiscretePlanState(_t(logits))).numpy(),
        np.asarray(jdist.mode(JaxPlanState(jnp.asarray(logits)))),
    )


def test_cpu_wrappers_run_plain_versions_and_launch_nothing():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(8)
    imgs = _t(rng.integers(0, 256, (2, 1, 32, 32, 3), np.uint8))
    assert torch.equal(preprocess_rgb_seq(imgs), preprocess_rgb_seq_plain(imgs))
    x = _t(rng.normal(size=(2, 8, 5, 5)).astype(np.float32))
    assert torch.equal(spatial_softmax(x, 1.0), spatial_softmax_plain(x, 1.0))
    assert all(k.launches == 0 for k in kernels.ALL_KERNELS)
    with pytest.raises(ValueError):
        spatial_softmax(torch.zeros(1, 2, 4, 5), 1.0)


@pytest.mark.parametrize("mangled,name", [
    # the anonymous namespace's hash ends in "45" and its identifier is 45
    # characters long: a scan for any length that reaches "_kernel" reads
    # "cb_12_adam_lowp_cu_5bc449f816adam_lowp_kernel"
    ("_ZN45_GLOBAL__N__0f1e45cb_12_adam_lowp_cu_5bc449f816adam_lowp_kernelEPKfiiif", "adam_lowp_kernel"),
    ("_ZN46_GLOBAL__N__16c0ffee_13_preprocess_cu_4f95cdf927preprocess_rgb_shift_kernelEPKhi",
     "preprocess_rgb_shift_kernel"),
    ("_ZN43_GLOBAL__N__21abcdef_10_plan_kl_cu_0123456721plan_st_kl_fwd_kernelILb0EEEvPKf",
     "plan_st_kl_fwd_kernel<false>"),
    ("_Z12empty_kernelv", "empty_kernel"),
], ids=["hash_digits_look_like_a_length", "hash_starts_with_a_length", "template", "global"])
def test_ptxas_report_reads_the_mangled_name_from_its_start(mangled, name):
    """Whatever digits the namespace's hashes hold (they change with the
    checkout's path), the report is keyed by the kernel's own name."""
    log = (
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 88 registers, used 1 barriers, 64 bytes smem, 400 bytes cmem[0]\n"
    )
    assert kernels.ptxas_report(log) == {name: {"stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
                                                "registers": 88, "static_smem_bytes": 64}}


def test_ptxas_report_reads_registers_shared_memory_and_spills():
    """The build log's per-kernel resources, keyed by the kernel's own name
    (a hex hash in the mangled name ends in digits too)."""
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN46_GLOBAL__N__fc65a1cc_13_preprocess_cu_4f95cdf927preprocess_rgb_shift_kernelEPKhPKiPKfPfiiiii' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN46_GLOBAL__N__fc65a1cc_13_preprocess_cu_4f95cdf9\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 42 registers, used 1 barriers, 128 bytes smem, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122spatial_softmax_kernelEPKf' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 31 registers, used 0 barriers\n"
    )
    assert kernels.ptxas_report(log) == {
        "preprocess_rgb_shift_kernel": {"stack_bytes": 0, "spill_store_bytes": 8, "spill_load_bytes": 4,
                                        "registers": 42, "static_smem_bytes": 128},
        "spatial_softmax_kernel": {"stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
                                   "registers": 31, "static_smem_bytes": 0},
    }


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax_and_no_hulc_tpu():
    """Static check over every module of the port and chip_smoke.py."""
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in ("jax", "hulc_tpu")]
    assert not bad


def test_importing_port_loads_no_jax_and_no_hulc_tpu():
    """Import every module of the port (``parallel`` among them) in a fresh
    interpreter and list the forbidden modules that appeared."""
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import hulc_tpu_torch\n"
        "for m in pkgutil.walk_packages(hulc_tpu_torch.__path__, 'hulc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "assert {'hulc_tpu_torch.parallel.mesh', 'hulc_tpu_torch.parallel.dryrun'} <= new\n"
        "print(sorted(m for m in new if m.split('.')[0] in ('jax', 'hulc_tpu')))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_running_the_clis_loads_no_jax_and_no_hulc_tpu(tmp_path):
    """Run ``python -m hulc_tpu_torch.training.train`` (a one-step fixture
    run on the CPU) and then ``python -m hulc_tpu_torch.evaluation.evaluate``
    on its checkpoint in a fresh interpreter, as ``-m`` runs them, and list
    the forbidden modules that appeared: the CLIs import most of their
    modules inside ``main``, which importing the package does not reach."""
    run = tmp_path / "run"
    code = (
        "import runpy, sys\n"
        "before = set(sys.modules)\n"
        f"for argv in ({_cli_argv('hulc_tpu_torch.training.train', run)!r}, "
        f"{_cli_argv('hulc_tpu_torch.evaluation.evaluate', run)!r}):\n"
        "    sys.argv = list(argv)\n"
        "    runpy.run_module(argv[0], run_name='__main__', alter_sys=True)\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m.split('.')[0] in ('jax', 'hulc_tpu')))\n"
    )
    env = dict(os.environ, TMPDIR=str(tmp_path),
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert (run / "evaluation" / "results.json").is_file()
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cli_argv(module, run):
    if module.endswith(".train"):
        return [module, "--config", "hulc_debug", "--fixture", "--steps", "1", "--batch-size", "2", "--cache",
                "none", "--device", "cpu", "--run-dir", str(run), "--val-max-batches", "1"]
    return [module, "--run-dir", str(run), "--config", "hulc_debug", "--device", "cpu", "--batched", "--num-envs",
            "1", "--num-sequences", "1", "--ep-len", "4"]
