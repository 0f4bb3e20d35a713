"""The port's two samplers on the CPU, where each kernel wrapper runs its
plain PyTorch version: the plan's straight-through sample and balanced KL
(``rsample_balanced_kl``) from uniform noise, whose Gumbel transform the
forward kernel does itself, and the action sampler (``sample_action``),
which maps the raw uniform draws and picks the gripper column in the same
launch. Each against the JAX package on the noise JAX draws from its keys,
and against the port's earlier composition of the same steps bit for bit.
Tolerances: picks and the gripper column exact; the straight-through
value, the KL and the gradients rtol 1e-5 (torch's and XLA's softmax differ
in the last bits); mixture samples atol 1e-5, as the sampler's other
tests."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.models.decoders import DecoderOutputs as JaxDecoderOutputs
from hulc_tpu.models.decoders import LogisticPolicyDecoder as JaxDecoder
from hulc_tpu.ops.plan_distributions import DiscretePlanState as JaxPlanState
from hulc_tpu.ops.plan_distributions import PlanDistribution as JaxPlanDistribution

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch import kernels
from hulc_tpu_torch.models.decoders import DecoderOutputs, LogisticPolicyDecoder
from hulc_tpu_torch.ops.logistic_mixture import (
    U_MAX,
    U_MIN,
    U_SPAN,
    draw_raw_uniforms,
    logistic_mixture_sample_plain,
    map_uniforms,
    sample_action,
    sample_action_plain,
)
from hulc_tpu_torch.ops.plan_distributions import (
    DiscretePlanState,
    PlanDistribution,
    gumbel_noise,
    gumbel_of_uniform,
)

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parent.parent / "hulc_tpu_torch" / "csrc"
TINY = float(np.finfo(np.float32).tiny)


def _t(x, requires_grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(requires_grad)


def _np(x):
    return x.detach().numpy()


# ---------------------------------------------------------------------------
# B.4: the plan sample and the balanced KL from uniform noise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [(4, 4), (32, 32), (5, 7)])
def test_uniform_entry_gives_jax_categorical_picks_and_jax_values(grid):
    """The uniforms low-mode jax.random.gumbel draws for a key, through the
    uniform entry: jax.random.categorical's picks exactly, and JAX's
    rsample / balanced_kl values and gradients."""
    cat, cls = grid
    b = 6
    rng = np.random.default_rng(31)
    post = (2 * rng.normal(size=(b, cat * cls))).astype(np.float32)
    prior = (2 * rng.normal(size=(b, cat * cls))).astype(np.float32)
    w_st = rng.normal(size=(b, cat * cls)).astype(np.float32)
    w_kl = rng.normal(size=(b,)).astype(np.float32)
    key = jax.random.key(32)
    jdist = JaxPlanDistribution(kind="discrete", category_size=cat, class_size=cls)

    def jax_obj(p, q):
        st = jdist.rsample(key, JaxPlanState(p))
        kl = jdist.balanced_kl(JaxPlanState(p), JaxPlanState(q), 0.8, per_sample=True)
        return jnp.sum(st * w_st) + jnp.sum(kl * w_kl), (st, kl)

    (_, (want_st, want_kl)), (g_post, g_prior) = jax.value_and_grad(jax_obj, argnums=(0, 1), has_aux=True)(
        post, prior
    )
    want_picks = np.asarray(jax.random.categorical(key, jnp.asarray(post).reshape(b, cat, cls), axis=-1))
    uniform = _t(jax.random.uniform(key, (b, cat, cls), jnp.float32, minval=TINY, maxval=1.0))
    dist = PlanDistribution(category_size=cat, class_size=cls)
    p, q = _t(post, True), _t(prior, True)
    st, kl = dist.rsample_balanced_kl(DiscretePlanState(p), DiscretePlanState(q), 0.8, uniform=uniform)
    ((st * _t(w_st)).sum() + (kl * _t(w_kl)).sum()).backward()
    np.testing.assert_array_equal(_np(st).reshape(b, cat, cls).argmax(-1), want_picks)
    np.testing.assert_allclose(_np(st), np.asarray(want_st), rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(kl), np.asarray(want_kl), rtol=1e-5)
    for got, want in ((p.grad, g_post), (q.grad, g_prior)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_gumbel_of_uniform_is_gumbel_noise_bit_for_bit():
    """One generator state: ``gumbel_noise`` equals the plain transform of
    the same ``torch.rand`` draw, bit for bit, and the three noise entries
    of rsample_balanced_kl (generator, uniform, gumbel) give the same
    sample and KL."""
    shape = (7, 32, 32)
    want = gumbel_noise(shape, torch.Generator().manual_seed(41), torch.device("cpu"))
    u = torch.rand(shape, generator=torch.Generator().manual_seed(41))
    assert torch.equal(gumbel_of_uniform(u), want)
    # u = 0 clamps at the smallest normal float, as jax.random.gumbel's draw does
    edge = gumbel_of_uniform(torch.tensor([0.0, TINY]))
    assert torch.equal(edge[0], edge[1]) and bool(torch.isfinite(edge).all())

    dist = PlanDistribution()
    post, prior = (DiscretePlanState(torch.randn(7, 1024, generator=torch.Generator().manual_seed(s)))
                   for s in (42, 43))
    runs = [
        dist.rsample_balanced_kl(post, prior, 0.8, generator=torch.Generator().manual_seed(41)),
        dist.rsample_balanced_kl(post, prior, 0.8, uniform=u),
        dist.rsample_balanced_kl(post, prior, 0.8, gumbel=want),
    ]
    for st, kl in runs[1:]:
        assert torch.equal(st, runs[0][0]) and torch.equal(kl, runs[0][1])
    with pytest.raises(ValueError, match="not both"):
        dist.rsample_balanced_kl(post, prior, 0.8, gumbel=want, uniform=u)


# ---------------------------------------------------------------------------
# B.3: the action sampler from raw draws, with the gripper column
# ---------------------------------------------------------------------------


def _mixture(rng, lead, a, k, tie_every=3):
    """Decoder-shaped mixture parameters and gripper logits, with a tie in
    every ``tie_every``-th frame's gripper logits."""
    shape = (*lead, a, k)
    logits, means = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    log_scales = np.maximum(rng.normal(size=shape) - 2.0, -7.0).astype(np.float32)
    grip = rng.normal(size=(*lead, 2)).astype(np.float32)
    flat = grip.reshape(-1, 2)
    flat[::tie_every, 1] = flat[::tie_every, 0]
    return logits, log_scales, means, grip


def _todays_action(logits, log_scales, means, grip, generator, bounds):
    """The action as the decoder composed it before the fused sampler: the
    two draws each mapped by a multiply and an add, the plain sample,
    argmax == 1, where, cat."""
    u_mix = torch.rand(logits.shape, generator=generator)
    u_inv = torch.rand(logits.shape[:-1], generator=generator)
    u_mix, u_inv = U_MIN + (U_MAX - U_MIN) * u_mix, U_MIN + (U_MAX - U_MIN) * u_inv
    actions = logistic_mixture_sample_plain(logits, log_scales, means, u_mix, u_inv)
    gripper = torch.where(torch.argmax(grip, dim=-1) == 1, bounds[1], bounds[0])
    return torch.cat([actions, gripper[..., None].to(actions.dtype)], dim=-1)


@pytest.mark.parametrize("lead,k", [((1, 1), 10), ((64, 1), 10), ((5, 3), 17)])
def test_sample_action_plain_on_raw_draws_equals_todays_composition(lead, k):
    logits, log_scales, means, grip = map(_t, _mixture(np.random.default_rng(51), lead, 6, k))
    bounds = (-1.0, 1.0)
    want = _todays_action(logits, log_scales, means, grip, torch.Generator().manual_seed(52), bounds)
    u_mix, u_inv = draw_raw_uniforms(tuple(logits.shape), torch.Generator().manual_seed(52), torch.device("cpu"))
    got = sample_action_plain(logits, log_scales, means, u_mix, u_inv, grip, bounds, (U_MIN, U_SPAN))
    assert got.shape == (*lead, 7) and torch.equal(got, want)
    assert torch.equal(sample_action(logits, log_scales, means, u_mix, u_inv, grip, bounds), want)
    # the map: a multiply, then an add; the identity map hands the tensor back
    assert torch.equal(map_uniforms(u_mix), U_MIN + (U_MAX - U_MIN) * u_mix)
    assert map_uniforms(u_mix, 0.0, 1.0) is u_mix


@pytest.mark.parametrize("lanes", [1, 64])
def test_sample_action_matches_jax_decoder_sample(lanes):
    """With the identity map on the uniforms JAX draws from the key, the
    (..., 7) action equals JAX's decoder ``_sample_from_outputs``, gripper
    logit ties included (argmax's first index: the closed bound)."""
    ad = jax_config.get_config("hulc_debug").action_decoder
    a, k = ad.out_features - 1, ad.n_mixtures
    logits, log_scales, means, grip = _mixture(np.random.default_rng(53), (lanes, 1), a, k, tie_every=2)
    key = jax.random.key(54)
    out = JaxDecoderOutputs(*(jnp.asarray(x) for x in (logits, log_scales, means, grip)), None)
    want = np.asarray(JaxDecoder(cfg=ad)._sample_from_outputs(key, out))
    k_mix, k_inv = jax.random.split(key)
    u_mix = jax.random.uniform(k_mix, logits.shape, jnp.float32, minval=U_MIN, maxval=U_MAX)
    u_inv = jax.random.uniform(k_inv, logits.shape[:-1], jnp.float32, minval=U_MIN, maxval=U_MAX)
    bounds = (ad.act_min_bound[-1], ad.act_max_bound[-1])
    got = sample_action(*map(_t, (logits, log_scales, means, u_mix, u_inv, grip)), bounds, (0.0, 1.0))
    assert got.shape == (lanes, 1, a + 1)
    np.testing.assert_array_equal(got[..., a].numpy(), want[..., a])
    np.testing.assert_allclose(got[..., :a].numpy(), want[..., :a], atol=1e-5, rtol=0)
    assert (got[..., a].numpy().reshape(-1)[::2] == bounds[0]).all()  # the tied frames


@pytest.mark.parametrize("injected", [True, False])
def test_decoder_sample_kernel_path_equals_plain_path(injected):
    """``_sample_from_outputs`` of the port's decoder, use_kernels True
    (the fused sampler's entry) and False (the plain composition), from one
    generator state or on injected uniforms: the same action bit for bit."""
    cfg = port_config.get_config("hulc_debug").action_decoder
    a, k = cfg.out_features - 1, cfg.n_mixtures
    logits, log_scales, means, grip = map(_t, _mixture(np.random.default_rng(55), (3, 2), a, k))
    out = DecoderOutputs(logits, log_scales, means, grip, None)
    raw = draw_raw_uniforms(tuple(logits.shape), torch.Generator().manual_seed(56), torch.device("cpu"))
    noise = [map_uniforms(u) for u in raw]
    actions = []
    for use_kernels in (True, False):
        decoder = LogisticPolicyDecoder(cfg, use_kernels=use_kernels)
        u_mix, u_inv = noise if injected else (None, None)
        actions.append(decoder._sample_from_outputs(out, torch.Generator().manual_seed(57), u_mix, u_inv))
    assert actions[0].shape == (3, 2, a + 1) and torch.equal(actions[0], actions[1])


def test_cpu_sampler_wrappers_launch_nothing():
    kernels.reset_launch_counts()
    logits, log_scales, means, grip = map(_t, _mixture(np.random.default_rng(58), (2, 1), 6, 10))
    u_mix, u_inv = draw_raw_uniforms(tuple(logits.shape), torch.Generator().manual_seed(59), torch.device("cpu"))
    sample_action(logits, log_scales, means, u_mix, u_inv, grip)
    dist = PlanDistribution(category_size=4, class_size=4)
    post, prior = DiscretePlanState(torch.randn(2, 16)), DiscretePlanState(torch.randn(2, 16))
    dist.rsample_balanced_kl(post, prior, 0.8, uniform=torch.rand(2, 4, 4))
    assert all(k.launches == 0 for k in kernels.ALL_KERNELS)


# ---------------------------------------------------------------------------
# the ctypes bindings against the C entry points
# ---------------------------------------------------------------------------

_C_TYPES = {"long long": kernels._I64, "unsigned long long": kernels._U64, "int": kernels._I32, "float": kernels._F32}


def test_every_binding_matches_its_c_entry_point():
    """Each ``extern "C"`` launcher in csrc/ is bound with its parameters'
    types, in order, then the stream; every bound symbol exists there."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (hulc_\w+)\(([^)]*)\)', src.read_text()):
            types = [re.sub(r"\s+", " ", p.strip()).rsplit(" ", 1)[0].replace(" *", "*") for p in params.split(",")]
            found[name] = types
    for name, args in kernels._SIGNATURES.items():
        assert name in found, f"{name} is not a C entry point of csrc/"
        *types, stream = found[name]
        assert stream == "void*", name
        assert [kernels._P if t.endswith("*") else _C_TYPES[t] for t in types] == list(args), name
    # the redesigned samplers: the noise kind, the uniform map and the gripper
    assert found["hulc_plan_st_kl_fwd"][8] == "int"
    assert found["hulc_logistic_mixture_sample"][5:11] == ["const void*", "void*", "long long", "int", "int", "float"]


def test_ptxas_report_names_kernel_template_instances():
    """Each instance of a kernel template (the plan kernels' one-chunk and
    chunked rows) keeps its own line of the build report."""
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121plan_st_kl_fwd_kernelILb{b}EEEvPKfS2_S2_PfS3_"
        f"iibbff' for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers, 128 bytes smem, 400 bytes cmem[0]\n"
        for b, regs in ((1, 39), (0, 40))
    )
    row = {"stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0, "static_smem_bytes": 128}
    assert kernels.ptxas_report(log) == {"plan_st_kl_fwd_kernel<true>": {**row, "registers": 39},
                                         "plan_st_kl_fwd_kernel<false>": {**row, "registers": 40}}
