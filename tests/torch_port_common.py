"""Helpers shared by the tests/test_torch_port_*.py files: weights made by
the JAX package and carried into the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _make_raw_batch

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


GATED_B, GATED_S = 3, 5  # the gated decoder tests' windows
# XLA's CPU backend at its lowest optimization level: the reference's
# programs compile in about half the time (numbers within a few ulp of the
# optimized build's); for tests that compile a whole model once
QUICK_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_call(fn, *args):
    """``fn(*args)`` through ``jax.jit``, compiled with QUICK_COMPILE, on the host."""
    return jax.device_get(jax.jit(fn).lower(*args).compile(QUICK_COMPILE)(*args))


def gated_cfg(m, cell):
    """``hulc_debug`` of config module ``m`` (either package's) with the
    decoder cell set by ``apply_overrides``: replan every 3 steps, an 84 px
    gripper camera (the size ``torch_convert.convert_state_dict`` maps) and
    the recognition network's dropout 0 (the two frameworks cannot draw the
    same masks)."""
    cfg = m.get_config("hulc_debug", replan_freq=3)
    pe = cfg.perceptual_encoder
    pe = dataclasses.replace(pe, rgb_gripper=dataclasses.replace(pe.rgb_gripper, input_size=84))
    pr = dataclasses.replace(cfg.plan_recognition, dropout=0.0)
    cfg = dataclasses.replace(cfg, perceptual_encoder=pe, plan_recognition=pr)
    return m.apply_overrides(cfg, [f"action_decoder.rnn_cell={cell}"])


def gated_setup(cell, jax_config, port_config):
    """JAX's random weights for ``gated_cfg`` of the cell, a raw {"vis",
    "lang"} batch of GATED_B windows of GATED_S frames (gripper commands of
    +-1, Euler angles in the canonical range), the port's model holding the
    weights, and a language embedding for one task."""
    jax_cfg, port_cfg = gated_cfg(jax_config, cell), gated_cfg(port_config, cell)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    jax_model, params = jax_random_params(jax_cfg, seed=70)
    raw = _make_raw_batch(jax_cfg, GATED_B, GATED_S, seed=71)
    rng = np.random.default_rng(72)
    for scope, mod in raw.items():
        actions = mod.actions.copy()
        actions[..., -1] = rng.choice([-1.0, 1.0], actions.shape[:-1])  # the dataset's gripper commands
        state = mod.state_info_robot_obs.copy()
        state[..., 3:6] = rng.uniform(-1.2, 1.2, state[..., 3:6].shape)  # canonical Euler range
        raw[scope] = mod._replace(actions=actions, state_info_robot_obs=state)
    raw["lang"] = raw["lang"]._replace(use_for_aux_lang_loss=np.array([True, False, True]))
    model, unused = port_model_from_jax(params, port_cfg)
    assert unused == []
    lang = rng.normal(size=port_cfg.lang_dim).astype(np.float32)
    return {"cell": cell, "jax_cfg": jax_cfg, "cfg": port_cfg, "jax_model": jax_model, "params": params, "raw": raw,
            "model": model, "lang": lang}
