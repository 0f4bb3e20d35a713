"""Helpers shared by the tests/test_torch_port_*.py files: weights made by
the JAX package and carried into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hulc_tpu.models import example_batch, init_params
from hulc_tpu.models import make_model as jax_make_model

from hulc_tpu_torch.convert import params_from_jax
from hulc_tpu_torch.models import make_model
from hulc_tpu_torch.ops.logistic_mixture import U_MAX, U_MIN


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def with_depth(cfg, batch, seed=1):
    """``batch`` with the (B, S, H, W) fp32 depth frames of each depth
    camera ``cfg`` names. JAX's ``example_batch`` makes none, and a model
    initialized on a batch without them builds no depth towers."""
    pe = cfg.perceptual_encoder
    b, s = batch.actions.shape[:2]
    rng = np.random.default_rng(seed)

    def depth(enc):
        return None if enc is None else rng.uniform(0.1, 5.0, (b, s, enc.input_size, enc.input_size)).astype(np.float32)

    return batch._replace(depth_static=depth(pe.depth_static), depth_gripper=depth(pe.depth_gripper))


def _example_batch(cfg):
    return {"vis": with_depth(cfg, example_batch(cfg, 1, 2)), "lang": with_depth(cfg, example_batch(cfg, 1, 2, lang=True))}


def jax_init(cfg):
    """(JAX model, numpy params) from ``hulc_tpu.models.init_params``."""
    model = jax_make_model(cfg)
    batch = _example_batch(cfg)
    params = jax.jit(lambda k: init_params(model, k, batch))(jax.random.key(0))
    return model, jax.tree.map(np.asarray, params)


def jax_random_params(cfg, seed):
    """(JAX model, numpy params) with the tree of ``init_params`` but values
    drawn by numpy at torch's default scales; no JAX compile, so it is
    cheap at full width."""
    model = jax_make_model(cfg)
    batch = _example_batch(cfg)
    shapes = jax.eval_shape(lambda: init_params(model, jax.random.key(0), batch))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return np.ones(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else int(np.prod(leaf.shape))
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def port_model_from_jax(params, port_cfg):
    """(port model on the CPU holding the JAX weights, unused JAX paths)."""
    state_dict, unused = params_from_jax(params, port_cfg)
    model = make_model(port_cfg, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model, unused


def jax_mixture_uniforms(key, lanes, cfg):
    """The uniforms the JAX decoder's act() draws from ``key`` (the gripper
    dimension is not sampled where the gripper head is discrete)."""
    ad = cfg.action_decoder
    shape = (lanes, 1, ad.out_features - 1 if ad.discrete_gripper else ad.out_features, ad.n_mixtures)
    k_mix, k_inv = jax.random.split(key)
    u_mix = jax.random.uniform(k_mix, shape, jnp.float32, minval=U_MIN, maxval=U_MAX)
    u_inv = jax.random.uniform(k_inv, shape[:-1], jnp.float32, minval=U_MIN, maxval=U_MAX)
    return to_torch(u_mix), to_torch(u_inv)


def jax_gumbel(key, lanes, cfg):
    """The Gumbel noise the JAX plan sample draws from ``key``."""
    d = cfg.distribution
    return to_torch(jax.random.gumbel(key, (lanes, d.category_size, d.class_size)))


def jax_plan_noise(key, lanes, cfg):
    """The noise the JAX plan sample draws from ``key``, under the port's
    name for it: a discrete plan's Gumbel noise, a continuous plan's
    standard-normal draw."""
    d = cfg.distribution
    if d.kind == "discrete":
        return {"gumbel": jax_gumbel(key, lanes, cfg)}
    return {"normal": to_torch(jax.random.normal(key, (lanes, d.plan_features), jnp.float32))}


def jax_batched_step_noise(key, lanes, cfg):
    """The noise of one JAX lockstep step (``build_batched_step``) from its
    key, as the port's ``BatchedHulcPolicy.step`` takes it."""
    k_plan, k_act = jax.random.split(key)
    u_mix, u_inv = jax_mixture_uniforms(k_act, lanes, cfg)
    return {**jax_plan_noise(k_plan, lanes, cfg), "u_mix": u_mix, "u_inv": u_inv}
