"""The training slice's ops and modules (random shift, mixture NLL, plan
KL, SpatialSoftmax backward, AdamLowp, schedules, transformer, recognition
net, CLIP loss) against the JAX package on the CPU, where each kernel
wrapper runs its plain PyTorch version. Inputs come from numpy seeds, and
noise from the keys JAX draws with, so both packages see the same numbers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.models.decoders import _cross_entropy_gripper as jax_gripper_ce
from hulc_tpu.models.hulc import masked_clip_loss as jax_masked_clip_loss
from hulc_tpu.models.layers import TransformerEncoder as JaxTransformerEncoder
from hulc_tpu.models.vision import SpatialSoftmax as JaxSpatialSoftmax
from hulc_tpu.ops.image_ops import preprocess_rgb_seq as jax_preprocess
from hulc_tpu.ops.image_ops import random_shift as jax_random_shift
from hulc_tpu.ops.logistic_mixture import logistic_mixture_log_prob as jax_log_prob
from hulc_tpu.ops.logistic_mixture import logistic_mixture_loss as jax_mixture_loss
from hulc_tpu.ops.plan_distributions import DiscretePlanState as JaxPlanState
from hulc_tpu.ops.plan_distributions import PlanDistribution as JaxPlanDistribution
from hulc_tpu.training import schedules as jax_schedules
from hulc_tpu.training.optimizers import scale_by_adam_lowp

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch import kernels
from hulc_tpu_torch.models.decoders import _cross_entropy_gripper
from hulc_tpu_torch.models.hulc import init_weights_, masked_clip_loss
from hulc_tpu_torch.models.layers import Dropout, TransformerEncoder, set_dropout_generator
from hulc_tpu_torch.models.plan_nets import PlanRecognitionTransformer, make_plan_distribution
from hulc_tpu_torch.models.vision import SpatialSoftmax, spatial_softmax, spatial_softmax_bwd_plain, spatial_softmax_plain
from hulc_tpu_torch.ops.image_ops import (
    draw_shifts,
    normalize_table,
    preprocess_rgb_seq_shift,
    preprocess_rgb_seq_shift_plain,
    random_shift_plain,
)
from hulc_tpu_torch.ops.logistic_mixture import (
    action_bounds,
    logistic_mixture_log_prob,
    logistic_mixture_loss,
    mixture_nll,
    mixture_nll_grad_plain,
    mixture_nll_plain,
)
from hulc_tpu_torch.ops.plan_distributions import DiscretePlanState, PlanDistribution
from hulc_tpu_torch.training import schedules
from hulc_tpu_torch.training.optimizers import ELEMS_PER_BLOCK, AdamLowp, pointer_table_rows
from tests.torch_port_common import jax_random_params, port_model_from_jax

torch.set_num_threads(1)


def _t(x, requires_grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(requires_grad)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def assert_grad_close(got, want, rtol=1e-5, err_msg=""):
    """Elementwise rtol, plus the same share of the tensor's largest entry:
    a gradient entry sums terms of both signs, so its rounding error scales
    with the terms, not with what is left of them."""
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=rtol * float(np.abs(want).max()), err_msg=err_msg)


def assert_sum_close(got, want, terms_abs_sum, rtol=1e-5, err_msg=""):
    """assert_grad_close's rule for a gradient that is one sum, such as a
    temperature's: its rounding error scales with the sum of its terms'
    magnitudes, not with what is left of them (with random incoming
    gradients the terms cancel by a factor of up to a few thousand)."""
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, atol=rtol * terms_abs_sum, err_msg=err_msg)


# ---------------------------------------------------------------------------
# random shift and the train-time preprocess
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,pad", [((6, 64, 64, 3), 3), ((5, 84, 84, 3), 4), ((2, 200, 200, 3), 10)])
def test_random_shift_is_exact_against_jax_slice(shape, pad):
    imgs = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    key = jax.random.key(1)
    want = np.asarray(jax_random_shift(key, jnp.asarray(imgs), pad, method="slice"))
    shifts = jax.random.randint(key, (shape[0], 2), 0, 2 * pad + 1)
    got = random_shift_plain(_t(imgs), _t(shifts), pad)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# Tolerance 2.4e-7: the eval preprocess's, two ulp near 1.0 (XLA on the CPU
# and plain torch round the normalize differently by up to one ulp).
@pytest.mark.parametrize("shape,pad", [((2, 3, 64, 64, 3), 3), ((2, 2, 84, 84, 3), 4)])
def test_train_preprocess_matches_jax(shape, pad):
    imgs = np.random.default_rng(1).integers(0, 256, shape, np.uint8)
    key = jax.random.key(2)
    want = np.asarray(jax_preprocess(jnp.asarray(imgs), key, pad)).transpose(0, 1, 4, 2, 3)
    shifts = jax.random.randint(key, (shape[0] * shape[1], 2), 0, 2 * pad + 1)
    got = preprocess_rgb_seq_shift(_t(imgs), _t(shifts), pad)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2.4e-7, rtol=0)


@pytest.mark.parametrize("mean,std", [(0.5, 0.5), (0.45, 0.27)])
def test_normalize_table_is_bit_equal_to_the_plain_preprocess(mean, std):
    """The shift kernel's 256-entry table, gathered at the shifted bytes, is
    the plain train preprocess bit for bit, for every byte value."""
    rng = np.random.default_rng(24)
    imgs = rng.permutation(np.tile(np.arange(256, dtype=np.uint8), 6)).reshape(1, 2, 16, 16, 3)
    shifts = torch.tensor([[0, 5], [3, 1]], dtype=torch.int32)
    table = normalize_table(mean, std, torch.device("cpu"))
    assert table.shape == (256,) and table.dtype == torch.float32
    shifted = random_shift_plain(_t(imgs).reshape(2, 16, 16, 3), shifts, 2).reshape(imgs.shape)
    got = table[shifted.long()].permute(0, 1, 4, 2, 3)
    want = preprocess_rgb_seq_shift_plain(_t(imgs), shifts, 2, mean, std)
    assert torch.equal(got, want)


def test_draw_shifts_is_seeded_and_in_range():
    a = draw_shifts(64, 4, torch.Generator().manual_seed(3), "cpu")
    b = draw_shifts(64, 4, torch.Generator().manual_seed(3), "cpu")
    assert a.shape == (64, 2) and a.dtype == torch.int32 and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) <= 8


# ---------------------------------------------------------------------------
# mixture NLL + gripper CE
# ---------------------------------------------------------------------------

A, K = 6, 10
AMIN, AMAX = (-1.0,) * A, (1.0,) * A


def _mixture_inputs(seed, b=4, s=5, k=K):
    """Mixture parameters and TCP-frame actions; the actions go through all
    three branches: the edge bins (+-1), interior bins, and, where the
    means sit far from the action at a small scale, cdf_delta < 1e-5."""
    rng = np.random.default_rng(seed)
    shape = (b, s, A, k)
    logits = rng.normal(size=shape).astype(np.float32)
    log_scales = (rng.normal(size=shape) - 2.0).astype(np.float32)
    means = rng.uniform(-1, 1, shape).astype(np.float32)
    actions = rng.uniform(-0.95, 0.95, (b, s, A + 1)).astype(np.float32)
    actions[:, 0, 0] = -1.0
    actions[:, 1, 1] = 1.0
    actions[:, 2, 2] = 0.3
    means[:, 2, 2] = 3.0
    log_scales[:, 2, 2] = -3.0
    log_scales[..., 0] = -7.5  # below log_scale_min: the clamp is active
    actions[..., A] = rng.choice([-1.0, 1.0], size=(b, s))
    gripper = rng.normal(size=(b, s, 2)).astype(np.float32)
    return logits, log_scales, means, actions, gripper


def test_mixture_inputs_cover_all_branches():
    logits, log_scales, means, actions, _ = _mixture_inputs(4)
    x = actions[..., :A, None]
    inv = np.exp(-np.maximum(log_scales, -7.0))
    half = 1.0 / 9.0
    with np.errstate(over="ignore"):
        cdf = 1.0 / (1.0 + np.exp(-inv * (x - means + half))) - 1.0 / (1.0 + np.exp(-inv * (x - means - half)))
    interior = (x > -1 + 1e-3) & (x < 1 - 1e-3)
    assert (x < -1 + 1e-3).any() and (x > 1 - 1e-3).any()
    assert (interior & (cdf > 1e-5)).any() and (interior & (cdf <= 1e-5)).any()


def test_mixture_log_prob_and_grad_match_jax():
    logits, log_scales, means, actions, _ = _mixture_inputs(5)
    w = np.random.default_rng(6).normal(size=actions[..., :A].shape).astype(np.float32)

    def jax_obj(lp, ls, mu):
        out = jax_log_prob(lp, ls, mu, actions[..., :A], jnp.asarray(AMIN), jnp.asarray(AMAX), 10, -7.0)
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.value_and_grad(jax_obj, argnums=(0, 1, 2), has_aux=True)(logits, log_scales, means)
    params = [_t(x, True) for x in (logits, log_scales, means)]
    got = logistic_mixture_log_prob(*params, _t(actions[..., :A]), AMIN, AMAX, 10, -7.0)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    for name, p, g in zip(("logit_probs", "log_scales", "means"), params, jgrads):
        assert_grad_close(p.grad, g, err_msg=name)


def test_mixture_loss_per_sample_matches_jax():
    logits, log_scales, means, actions, _ = _mixture_inputs(7)
    args = (actions[..., :A], AMIN, AMAX, 10, -7.0)
    for per_sample in (False, True):
        want = jax_mixture_loss(logits, log_scales, means, *args[:1], jnp.asarray(AMIN), jnp.asarray(AMAX),
                                10, -7.0, per_sample=per_sample)
        got = logistic_mixture_loss(_t(logits), _t(log_scales), _t(means), _t(args[0]), *args[1:],
                                    per_sample=per_sample)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)


def test_mixture_nll_with_gripper_and_grads_match_jax():
    """The kernel's function (per-frame NLL + gripper_alpha x CE), meaned
    over time, against the JAX decoder's loss terms and their jax.grad."""
    logits, log_scales, means, actions, gripper = _mixture_inputs(8)
    alpha = 0.7
    w = np.random.default_rng(9).normal(size=(actions.shape[0],)).astype(np.float32)

    def jax_obj(lp, ls, mu, gl):
        nll = jax_mixture_loss(lp, ls, mu, actions[..., :A], jnp.asarray(AMIN), jnp.asarray(AMAX), 10, -7.0,
                               per_sample=True)
        out = nll + alpha * jax_gripper_ce(gl, actions[..., A], per_sample=True)
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.value_and_grad(jax_obj, argnums=(0, 1, 2, 3), has_aux=True)(
        logits, log_scales, means, gripper
    )
    params = [_t(x, True) for x in (logits, log_scales, means, gripper)]
    per_frame = mixture_nll(*params[:3], _t(actions), params[3], AMIN, AMAX, 10, -7.0, alpha)
    assert per_frame.shape == actions.shape[:2]
    got = per_frame.mean(dim=1)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    for name, p, g in zip(("logit_probs", "log_scales", "means", "gripper_logits"), params, jgrads):
        assert_grad_close(p.grad, g, err_msg=name)
    assert float(params[1].grad[..., 0].abs().max()) == 0.0  # clamped log scales get no gradient


@pytest.mark.parametrize("k", [7, 10, 33])
@pytest.mark.parametrize("with_gripper", [True, False])
def test_mixture_nll_grad_plain_matches_jax_and_autograd(with_gripper, k):
    """The closed-form gradients the kernels compute, on 15 frames (not a
    multiple of 8), against jax.grad of the JAX decoder's loss terms and
    against autograd through the plain forward."""
    logits, log_scales, means, actions, gripper = _mixture_inputs(30, b=3, s=5, k=k)
    if not with_gripper:
        actions, gripper = actions[..., :A], None
    alpha = 0.7
    b, s = actions.shape[:2]
    w = np.random.default_rng(31).normal(size=(b,)).astype(np.float32)

    def jax_obj(lp, ls, mu, gl):
        out = jax_mixture_loss(lp, ls, mu, actions[..., :A], jnp.asarray(AMIN), jnp.asarray(AMAX), 10, -7.0,
                               per_sample=True)
        if with_gripper:
            out = out + alpha * jax_gripper_ce(gl, actions[..., A], per_sample=True)
        return jnp.sum(out * w)

    jgrads = jax.grad(jax_obj, argnums=(0, 1, 2, 3))(logits, log_scales, means, gripper if with_gripper else 0.0)
    inputs = [_t(logits), _t(log_scales), _t(means), _t(actions), None if gripper is None else _t(gripper)]
    consts = (AMIN, AMAX, 10, -7.0, alpha)
    frame_grad = torch.from_numpy(np.repeat(w[:, None] / s, s, axis=1))  # d mean-over-time / d frame
    got = mixture_nll_grad_plain(*inputs, *consts, frame_grad)
    names = ("logit_probs", "log_scales", "means", "gripper_logits")
    assert (got[3] is None) == (not with_gripper)
    for name, g, want in zip(names, got, jgrads[:4] if with_gripper else jgrads[:3]):
        assert g.shape == np.shape(want)
        assert_grad_close(g, want, err_msg=f"{name} vs jax")
    assert float(got[1][..., 0].abs().max()) == 0.0  # clamped log scales get no gradient

    leaves = [x.clone().requires_grad_() for x in inputs if x is not None and x.dim() == 4]
    if with_gripper:
        leaves.append(inputs[4].clone().requires_grad_())
    out = mixture_nll_plain(*leaves[:3], inputs[3], leaves[3] if with_gripper else None, *consts)
    upstream = torch.from_numpy(np.random.default_rng(32).normal(size=(b, s)).astype(np.float32))
    want = torch.autograd.grad(out, leaves, upstream)
    got = mixture_nll_grad_plain(*inputs, *consts, upstream)
    for name, g, wnt in zip(names, got, want):
        assert_grad_close(g, wnt.numpy(), err_msg=f"{name} vs autograd")


def test_action_bounds_cache_hands_back_the_same_tensors():
    cpu = torch.device("cpu")
    lo, hi = action_bounds(AMIN, AMAX, cpu)
    again = action_bounds(tuple(AMIN), tuple(AMAX), cpu)
    assert again[0] is lo and again[1] is hi
    assert lo.dtype == torch.float32 and lo.tolist() == list(AMIN) and hi.tolist() == list(AMAX)
    other = action_bounds(AMIN[:-1] + (-0.5,), AMAX, cpu)
    assert other[0] is not lo and other[0].tolist()[-1] == -0.5


def test_gripper_cross_entropy_matches_jax():
    _, _, _, actions, gripper = _mixture_inputs(10)
    for per_sample in (False, True):
        want = jax_gripper_ce(gripper, actions[..., A], per_sample=per_sample)
        got = _cross_entropy_gripper(_t(gripper), _t(actions[..., A]), per_sample=per_sample)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# straight-through plan sample and the balanced KL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [(4, 4), (32, 32)])
def test_rsample_and_balanced_kl_with_grads_match_jax(grid):
    cat, cls = grid
    rng = np.random.default_rng(11)
    post = (2 * rng.normal(size=(6, cat * cls))).astype(np.float32)
    prior = (2 * rng.normal(size=(6, cat * cls))).astype(np.float32)
    w_st = rng.normal(size=(6, cat * cls)).astype(np.float32)
    w_kl = rng.normal(size=(6,)).astype(np.float32)
    key = jax.random.key(12)
    jdist = JaxPlanDistribution(kind="discrete", category_size=cat, class_size=cls)

    def jax_obj(p, q):
        st = jdist.rsample(key, JaxPlanState(p))
        kl = jdist.balanced_kl(JaxPlanState(p), JaxPlanState(q), 0.8, per_sample=True)
        return jnp.sum(st * w_st) + jnp.sum(kl * w_kl), (st, kl)

    (_, (want_st, want_kl)), (g_post, g_prior) = jax.value_and_grad(jax_obj, argnums=(0, 1), has_aux=True)(
        post, prior
    )
    dist = PlanDistribution(category_size=cat, class_size=cls)
    p, q = _t(post, True), _t(prior, True)
    gumbel = _t(jax.random.gumbel(key, (6, cat, cls)))
    st, kl = dist.rsample_balanced_kl(DiscretePlanState(p), DiscretePlanState(q), 0.8, gumbel=gumbel)
    ((st * _t(w_st)).sum() + (kl * _t(w_kl)).sum()).backward()
    # the picks are identical; the picked entry, (1 + p) - p, rounds at 1's
    # ulp, and torch's and XLA's softmax differ in p's last bits
    grid = (6, cat, cls)
    np.testing.assert_array_equal(_np(st).reshape(grid).argmax(-1), np.asarray(want_st).reshape(grid).argmax(-1))
    np.testing.assert_allclose(_np(st), np.asarray(want_st), rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(kl), np.asarray(want_kl), rtol=1e-5)
    assert_grad_close(p.grad, g_post)
    assert_grad_close(q.grad, g_prior)
    want_mean = jdist.balanced_kl(JaxPlanState(post), JaxPlanState(prior), 0.8)
    got_mean = dist.balanced_kl(DiscretePlanState(_t(post)), DiscretePlanState(_t(prior)), 0.8)
    np.testing.assert_allclose(_np(got_mean), np.asarray(want_mean), rtol=1e-5)


# ---------------------------------------------------------------------------
# SpatialSoftmax backward
# ---------------------------------------------------------------------------


def test_spatial_softmax_grad_matches_jax():
    rng = np.random.default_rng(13)
    x = (3.0 * rng.normal(size=(3, 21, 21, 64))).astype(np.float32)
    g = rng.normal(size=(3, 128)).astype(np.float32)
    mod = JaxSpatialSoftmax(temperature=1.0)
    params = mod.init(jax.random.key(0), jnp.asarray(x))
    want = jax.grad(lambda v: jnp.sum(mod.apply(params, v) * g))(jnp.asarray(x))
    xt = _t(x.transpose(0, 3, 1, 2), True)
    (spatial_softmax(xt, 1.0) * _t(g)).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), np.asarray(want).transpose(0, 3, 1, 2), atol=1e-6, rtol=0)


def _jax_spatial_softmax_grads(x_nhwc, g, temp):
    """jax.grad of the learnable-temperature JaxSpatialSoftmax at T = temp,
    with respect to x (returned NCHW) and params["temperature"]."""
    mod = JaxSpatialSoftmax(temperature=None)
    params = {"params": {"temperature": jnp.full((1,), temp, jnp.float32)}}

    def obj(p, v):
        return jnp.sum(mod.apply(p, v) * g)

    dp, dx = jax.grad(obj, argnums=(0, 1))(params, jnp.asarray(x_nhwc))
    return np.asarray(dx).transpose(0, 3, 1, 2), np.asarray(dp["params"]["temperature"])


@pytest.mark.parametrize("shape", [(3, 21, 21, 64), (3, 4, 4, 64), (2, 7, 7, 5)])  # full, hulc_debug, odd
@pytest.mark.parametrize("temp", [1.0, 0.7])
def test_spatial_softmax_bwd_plain_matches_jax_and_autograd(shape, temp):
    """The closed form the backward kernel computes: dx and dT against
    jax.grad of the JAX module and against autograd through the plain forward."""
    rng = np.random.default_rng(25)
    x = (3.0 * rng.normal(size=shape)).astype(np.float32)
    g = rng.normal(size=(shape[0], 2 * shape[3])).astype(np.float32)
    want_dx, want_dt = _jax_spatial_softmax_grads(x, g, temp)
    xt = _t(x.transpose(0, 3, 1, 2))
    dx, dt = spatial_softmax_bwd_plain(xt, _t(g), torch.tensor([temp]))
    assert dx.shape == xt.shape and dt.shape == (1,)
    terms = float((xt * dx).abs().sum()) / temp  # dT = -(1/T) * sum(x * dx)
    assert_grad_close(dx, want_dx, err_msg="dx vs jax")
    assert_sum_close(dt, want_dt, terms, err_msg="dT vs jax")
    xa, ta = xt.clone().requires_grad_(), torch.tensor([temp], requires_grad=True)
    auto_dx, auto_dt = torch.autograd.grad(spatial_softmax_plain(xa, ta), (xa, ta), _t(g))
    assert_grad_close(dx, auto_dx.numpy(), err_msg="dx vs autograd")
    assert_sum_close(dt, auto_dt.numpy(), terms, err_msg="dT vs autograd")
    fixed_dx, _ = spatial_softmax_bwd_plain(xt, _t(g), temp)  # a float temperature: the same dx
    assert_grad_close(fixed_dx, want_dx, err_msg="dx, float T, vs jax")


def test_spatial_softmax_learnable_temperature_grad_matches_jax():
    """The port's CPU path (SpatialSoftmax with temperature=None, autograd
    through the plain version) gives the gradients JAX gives."""
    rng = np.random.default_rng(26)
    x = (3.0 * rng.normal(size=(3, 21, 21, 64))).astype(np.float32)
    g = rng.normal(size=(3, 128)).astype(np.float32)
    want_dx, want_dt = _jax_spatial_softmax_grads(x, g, 0.7)
    mod = SpatialSoftmax(temperature=None)
    with torch.no_grad():
        mod.temperature.fill_(0.7)
    xt = _t(x.transpose(0, 3, 1, 2), True)
    (mod(xt) * _t(g)).sum().backward()
    assert_grad_close(xt.grad, want_dx, err_msg="dx")
    terms = float((xt.detach() * xt.grad).abs().sum()) / 0.7
    assert_sum_close(mod.temperature.grad, want_dt, terms, err_msg="dT")


# ---------------------------------------------------------------------------
# AdamLowp and the schedules
# ---------------------------------------------------------------------------


def test_adam_lowp_matches_optax_for_three_steps():
    """The same gradients through both: bf16 moments bit-equal, params 1e-7."""
    rng = np.random.default_rng(14)
    shapes = {"a": (33, 7), "b": (5,), "c": (2, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-6, 0, s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lr = 3e-3
    tx = optax.chain(scale_by_adam_lowp(), optax.scale_by_learning_rate(optax.constant_schedule(lr)))
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = AdamLowp(t_params.values(), lr=lambda count: lr)
    for g in grads:
        updates, j_state = tx.update(jax.tree.map(jnp.asarray, g), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = _t(g[k])
        opt.step()
    adam = j_state[0]
    for k, p in t_params.items():
        st = opt.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16
        np.testing.assert_array_equal(st["exp_avg"].float().numpy(), np.asarray(adam.mu[k], np.float32))
        np.testing.assert_array_equal(st["exp_avg_sq"].float().numpy(), np.asarray(adam.nu[k], np.float32))
        np.testing.assert_allclose(_np(p), np.asarray(j_params[k]), atol=1e-7, rtol=0)


def test_adam_pointer_table_rows():
    """One row per tensor: the p, m and v addresses (the gradient's goes to
    each launch by value), numel, the head of scalar
    elements before the 4-wide groups (from p's address), and the index of
    the tensor's first block over the blocks of the tensors before it (one
    per ELEMS_PER_BLOCK elements of groups after the head, at least one);
    and the number of blocks in all. Fresh storages start aligned (head 0);
    a view of all four arrays one element in takes a head of 3."""
    sizes = (3, ELEMS_PER_BLOCK, ELEMS_PER_BLOCK + 1, 1, 2 * ELEMS_PER_BLOCK + 6, 5)
    ts = [[torch.zeros(n, dtype=torch.bfloat16 if k >= 1 else torch.float32) for n in sizes] for k in range(3)]
    for k in range(3):
        ts[k].append(torch.zeros(ELEMS_PER_BLOCK + 9, dtype=ts[k][0].dtype)[1:])
    # ptrs are 64-byte aligned at least, so the views sit one element past a 16 (8) byte boundary
    assert all(t[-1].data_ptr() % 16 == 4 if t[0].dtype == torch.float32 else t[-1].data_ptr() % 8 == 2 for t in ts)
    rows, n_blocks = pointer_table_rows(*ts)
    numel = (*sizes, ELEMS_PER_BLOCK + 8)
    heads = [0] * len(sizes) + [3]
    first = (0, 1, 2, 3, 4, 7, 8)
    assert rows == [
        [ts[0][i].data_ptr(), ts[1][i].data_ptr(), ts[2][i].data_ptr(), n, h, f]
        for i, (n, h, f) in enumerate(zip(numel, heads, first))
    ]
    assert n_blocks == 10


@pytest.mark.parametrize("kind", ["constant", "cosine_with_warmup", "linear_with_warmup"])
def test_lr_schedules_match_optax(kind):
    want = jax_schedules.make_lr_schedule(kind, 3e-4, 100, 0.1)
    got = schedules.make_lr_schedule(kind, 3e-4, 100, 0.1)
    for count in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        # optax computes in fp32: near zero its values round at 1e-6 of the peak
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-6 * 3e-4, err_msg=str(count))


@pytest.mark.parametrize("kind", ["constant", "linear", "sigmoid"])
def test_kl_schedule_matches_jax(kind):
    want = jax_schedules.KLSchedule(kind=kind)
    got = schedules.KLSchedule(kind=kind)
    for epoch in (0, 9, 10, 30, 50, 51):
        assert got(epoch, 0.01) == want(epoch, 0.01)


# ---------------------------------------------------------------------------
# transformer, recognition net, CLIP loss, dropout
# ---------------------------------------------------------------------------


def _attention_from_flax(p, d, heads):
    hd = d // heads
    w = np.concatenate([np.asarray(p[n]["kernel"]).reshape(d, d).T for n in ("query", "key", "value")])
    b = np.concatenate([np.asarray(p[n]["bias"]).reshape(d) for n in ("query", "key", "value")])
    return {
        "self_attn.in_proj_weight": w, "self_attn.in_proj_bias": b,
        "self_attn.out_proj.weight": np.asarray(p["out"]["kernel"]).reshape(heads * hd, d).T,
        "self_attn.out_proj.bias": np.asarray(p["out"]["bias"]),
    }


def test_transformer_encoder_matches_jax():
    d, heads, ff = 32, 4, 48
    x = np.random.default_rng(15).normal(size=(3, 6, d)).astype(np.float32)
    jmod = JaxTransformerEncoder(num_layers=2, num_heads=heads, dim_feedforward=ff)
    params = jmod.init(jax.random.key(16), jnp.asarray(x))["params"]
    want = jmod.apply({"params": params}, jnp.asarray(x))
    model = TransformerEncoder(2, d, heads, ff).eval()
    sd = {}
    for i in range(2):
        p = params[f"layer_{i}"]
        sd.update({f"layers.{i}.{k}": v for k, v in _attention_from_flax(p["self_attn"], d, heads).items()})
        for n in ("linear1", "linear2"):
            sd[f"layers.{i}.{n}.weight"] = np.asarray(p[n]["kernel"]).T
            sd[f"layers.{i}.{n}.bias"] = np.asarray(p[n]["bias"])
        for n in ("norm1", "norm2"):
            sd[f"layers.{i}.{n}.weight"] = np.asarray(p[n]["scale"])
            sd[f"layers.{i}.{n}.bias"] = np.asarray(p[n]["bias"])
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = model(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads", [4, 3])  # 3 heads: 32 features are padded to 33
def test_recognition_transformer_matches_jax(heads):
    """Weights carried by params_from_jax, incl. pad-to-heads."""

    def cfg_of(m):
        cfg = m.get_config("hulc_debug")
        pr = dataclasses.replace(cfg.plan_recognition, num_heads=heads)
        return dataclasses.replace(cfg, plan_recognition=pr).resolve()

    jax_model, params = jax_random_params(cfg_of(jax_config), seed=17)
    model, unused = port_model_from_jax(params, cfg_of(port_config))
    assert unused == []
    x = np.random.default_rng(18).normal(size=(3, 5, 32)).astype(np.float32)
    want_state, want_feat = jax_model.apply(
        {"params": params}, jnp.asarray(x), method=lambda m, v: m.plan_recognition(v)
    )
    with torch.no_grad():
        state, feat = model.plan_recognition(_t(x))
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), atol=1e-5, rtol=0)
    np.testing.assert_allclose(state.logit.numpy(), np.asarray(want_state.logit), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1], [1, 0, 1, 1, 0], [0, 0, 0, 0, 0]])
def test_masked_clip_loss_matches_jax(mask):
    rng = np.random.default_rng(19)
    img, txt = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(2))
    m = np.asarray(mask, bool)
    scale = np.float32(1 / 0.07)
    want = jax_masked_clip_loss(jnp.asarray(img), jnp.asarray(txt), scale, jnp.asarray(m))
    got = masked_clip_loss(_t(img), _t(txt), torch.tensor(scale), _t(m))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)
    if not m.any():
        assert float(got) == 0.0


def test_dropout_keeps_its_share_and_switches_off_in_eval():
    gen = torch.Generator().manual_seed(20)
    drop = Dropout(0.1)
    set_dropout_generator(drop, gen)
    x = torch.ones(200, 100)
    y = drop.train()(x)
    kept = y != 0
    assert 0.88 < float(kept.float().mean()) < 0.92
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(drop.eval()(x), x)
    shared = Dropout(0.5, broadcast_dims=(0, 1))
    set_dropout_generator(shared, gen)
    z = shared.train()(torch.ones(3, 4, 6, 6))
    assert all(torch.equal(z[i, j], z[0, 0]) for i in range(3) for j in range(4))
    with pytest.raises(RuntimeError):
        Dropout(0.1).train()(x)  # no generator set


def test_recognition_dropout_sites_and_eval_switch():
    """Input dropout, then per layer: attention weights, both residuals and
    the feed-forward hidden; all off in eval mode."""
    cfg = port_config.get_config("hulc_debug")
    model = PlanRecognitionTransformer(cfg.plan_recognition, make_plan_distribution(cfg.distribution))
    init_weights_(model, torch.Generator().manual_seed(21))
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    assert len(drops) == 1 + 4 * cfg.plan_recognition.num_layers
    assert all(d.p == cfg.plan_recognition.dropout for d in drops)
    set_dropout_generator(model, torch.Generator().manual_seed(21))
    x = torch.randn(2, 5, cfg.plan_recognition.in_features)
    with torch.no_grad():
        a, b = model.train()(x)[1], model(x)[1]
        c, d = model.eval()(x)[1], model(x)[1]
    assert not torch.equal(a, b) and torch.equal(c, d)


def test_cpu_training_wrappers_launch_nothing():
    kernels.reset_launch_counts()
    imgs = _t(np.random.default_rng(22).integers(0, 256, (1, 2, 16, 16, 3), np.uint8))
    shifts = torch.tensor([[0, 3], [2, 1]], dtype=torch.int32)
    assert torch.equal(preprocess_rgb_seq_shift(imgs, shifts, 2), preprocess_rgb_seq_shift_plain(imgs, shifts, 2))
    x = torch.randn(2, 4, 5, 5, requires_grad=True)
    spatial_softmax(x, 1.0).sum().backward()
    logits, log_scales, means, actions, gripper = _mixture_inputs(23, 1, 3)
    mixture_nll(_t(logits), _t(log_scales), _t(means), _t(actions), _t(gripper), AMIN, AMAX, 10).sum()
    dist = make_plan_distribution(port_config.get_config("hulc_debug").distribution)
    dist.rsample_balanced_kl(DiscretePlanState(torch.randn(2, 16)), DiscretePlanState(torch.randn(2, 16)), 0.8,
                             generator=torch.Generator().manual_seed(0))
    p = torch.nn.Parameter(torch.randn(3))
    p.grad = torch.randn(3)
    AdamLowp([p]).step()
    assert all(k.launches == 0 for k in kernels.ALL_KERNELS)
