"""The port's closed-loop policy against the JAX package on the CPU:
``replan_lang``, ``replan_vision`` and ``act`` from ``build_policy_fns``
and one lockstep ``build_batched_step`` with a mixed replan mask, given
the same weights (carried by ``params_from_jax``), the same frames and the
noise JAX draws from its keys. Tolerance 1e-4 on plan, latent goal, carry
and action (fp32 sums in another order, and the x100 of the TCP-frame
rotation)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.evaluation.batched_eval import build_batched_step as jax_build_batched_step
from hulc_tpu.data.dataset import DatasetStatistics as JaxStatistics
from hulc_tpu.evaluation.policy import StateObsNormalizer as JaxNormalizer
from hulc_tpu.evaluation.policy import build_policy_fns as jax_build_policy_fns

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy, build_batched_step
from hulc_tpu_torch.data.statistics import DatasetStatistics
from hulc_tpu_torch.evaluation.policy import HulcPolicy, StateObsNormalizer, build_policy_fns
from tests.torch_port_common import jax_gumbel as _gumbel
from tests.torch_port_common import jax_init, jax_random_params, port_model_from_jax, to_torch as _t
from tests.torch_port_common import jax_mixture_uniforms as _mixture_uniforms

torch.set_num_threads(1)

ATOL = 1e-4
JAX_CFG = jax_config.get_config("hulc_debug")
PORT_CFG = port_config.get_config("hulc_debug")


def _inputs(rng, cfg, lanes, seq=1):
    pe = cfg.perceptual_encoder
    s, g = pe.rgb_static.input_size, pe.rgb_gripper.input_size
    rob_raw = rng.normal(size=(lanes, seq, 15)).astype(np.float32)
    rob_raw[..., 3:6] = rng.uniform(-1.0, 1.0, (lanes, seq, 3))
    return {
        "rgb_static": rng.integers(0, 256, (lanes, seq, s, s, 3), np.uint8),
        "rgb_gripper": rng.integers(0, 256, (lanes, seq, g, g, 3), np.uint8),
        "rob_norm": rng.normal(size=(lanes, seq, 8)).astype(np.float32),
        "rob_raw": rob_raw,
    }


def _plan_goal_carry(rng, cfg, lanes):
    d, ad = cfg.distribution, cfg.action_decoder
    plan = np.eye(d.class_size, dtype=np.float32)[
        rng.integers(0, d.class_size, (lanes, d.category_size))
    ].reshape(lanes, -1)
    goal = rng.normal(size=(lanes, ad.latent_goal_features)).astype(np.float32)
    carry = np.abs(rng.normal(size=(ad.num_layers, lanes, ad.hidden_size))).astype(np.float32)
    return plan, goal, carry


@pytest.fixture(scope="module")
def debug_pair():
    jax_model, params = jax_init(JAX_CFG)
    return jax_model, params, port_model_from_jax(params, PORT_CFG)[0]


@pytest.fixture(scope="module")
def fns(debug_pair):
    jax_model, params, port_model = debug_pair
    jax_fns = [jax.jit(f) for f in jax_build_policy_fns(jax_model, JAX_CFG)]
    return params, jax_fns, build_policy_fns(port_model, PORT_CFG)


def test_replan_lang_matches_jax(fns):
    params, (j_replan, _, _), (t_replan, _, _) = fns
    rng = np.random.default_rng(0)
    x = _inputs(rng, JAX_CFG, 3)
    lang = rng.normal(size=(3, 384)).astype(np.float32)
    key = jax.random.key(1)
    want_plan, want_goal = j_replan(params, key, x["rgb_static"], x["rgb_gripper"], x["rob_norm"], lang)
    plan, goal = t_replan(
        _t(x["rgb_static"]), _t(x["rgb_gripper"]), _t(x["rob_norm"]), _t(lang),
        gumbel=_gumbel(key, 3, JAX_CFG),
    )
    np.testing.assert_allclose(plan.numpy(), np.asarray(want_plan), atol=ATOL, rtol=0)
    np.testing.assert_allclose(goal.numpy(), np.asarray(want_goal), atol=ATOL, rtol=0)


def test_replan_vision_matches_jax(fns):
    params, (_, j_replan, _), (_, t_replan, _) = fns
    x = _inputs(np.random.default_rng(2), JAX_CFG, 2, seq=2)  # current + goal frame
    key = jax.random.key(3)
    want_plan, want_goal = j_replan(params, key, x["rgb_static"], x["rgb_gripper"], x["rob_norm"])
    plan, goal = t_replan(
        _t(x["rgb_static"]), _t(x["rgb_gripper"]), _t(x["rob_norm"]), gumbel=_gumbel(key, 2, JAX_CFG)
    )
    np.testing.assert_allclose(plan.numpy(), np.asarray(want_plan), atol=ATOL, rtol=0)
    np.testing.assert_allclose(goal.numpy(), np.asarray(want_goal), atol=ATOL, rtol=0)


def test_act_sequence_with_carry_matches_jax(fns):
    """Three act() steps threading the decoder carry."""
    params, (_, _, j_act), (_, _, t_act) = fns
    rng = np.random.default_rng(4)
    plan, goal, carry = _plan_goal_carry(rng, JAX_CFG, 2)
    j_carry, t_carry = jnp.asarray(carry), _t(carry)
    for step in range(3):
        x = _inputs(rng, JAX_CFG, 2)
        key = jax.random.key(10 + step)
        want, j_carry = j_act(
            params, key, plan, goal, x["rgb_static"], x["rgb_gripper"], x["rob_norm"], x["rob_raw"], j_carry
        )
        u_mix, u_inv = _mixture_uniforms(key, 2, JAX_CFG)
        got, t_carry = t_act(
            _t(plan), _t(goal), _t(x["rgb_static"]), _t(x["rgb_gripper"]), _t(x["rob_norm"]),
            _t(x["rob_raw"]), t_carry, u_mix=u_mix, u_inv=u_inv,
        )
        assert got.shape == (2, 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0, err_msg=f"step {step}")
        np.testing.assert_allclose(t_carry.numpy(), np.asarray(j_carry), atol=ATOL, rtol=0)


def test_batched_step_with_mixed_replan_mask_matches_jax(debug_pair):
    jax_model, params, port_model = debug_pair
    lanes = 4
    rng = np.random.default_rng(5)
    x = _inputs(rng, JAX_CFG, lanes)
    lang = rng.normal(size=(lanes, 384)).astype(np.float32)
    plan, goal, carry = _plan_goal_carry(rng, JAX_CFG, lanes)
    mask = np.array([True, False, True, False])
    key = jax.random.key(6)
    want = jax.jit(jax_build_batched_step(jax_model, JAX_CFG))(
        params, key, x["rgb_static"], x["rgb_gripper"], x["rob_norm"], x["rob_raw"],
        lang, plan, goal, carry, mask,
    )
    k_plan, k_act = jax.random.split(key)
    u_mix, u_inv = _mixture_uniforms(k_act, lanes, JAX_CFG)
    got = build_batched_step(port_model, PORT_CFG)(
        _t(x["rgb_static"]), _t(x["rgb_gripper"]), _t(x["rob_norm"]), _t(x["rob_raw"]), _t(lang),
        _t(plan), _t(goal), _t(carry), _t(mask),
        gumbel=_gumbel(k_plan, lanes, JAX_CFG), u_mix=u_mix, u_inv=u_inv,
    )
    for name, g, w in zip(("action", "plan", "latent_goal", "carry"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0, err_msg=name)
    # lanes that did not replan kept their plan and carry-driven state
    np.testing.assert_array_equal(got[1][~mask].numpy(), plan[~mask])


@pytest.mark.parametrize("proprio", ["default", "robot_scene"])
def test_state_obs_normalizer_matches_jax(proprio):
    rng = np.random.default_rng(10)
    stats = [rng.normal(size=15), rng.uniform(0.5, 2.0, 15), -np.ones(7), np.ones(7),
             rng.normal(size=24), rng.uniform(0.5, 2.0, 24)]
    stats = [s.astype(np.float32) for s in stats]
    rob = rng.normal(size=(3, 1, 15)).astype(np.float32)
    scene = rng.normal(size=(3, 1, 24)).astype(np.float32)
    outs = []
    for m, norm_cls, stats_cls in ((jax_config, JaxNormalizer, JaxStatistics),
                                   (port_config, StateObsNormalizer, DatasetStatistics)):
        cfg = m.get_config("hulc_debug")
        if proprio == "robot_scene":
            keep = ((0, 3), (6, 7), (14, 18), (21, 24))
            p = m.ProprioConfig(n_state_obs=11, keep_indices=keep, include_scene=True)
            pe = dataclasses.replace(cfg.perceptual_encoder, proprio=p)
            cfg = dataclasses.replace(cfg, perceptual_encoder=pe).resolve()
        outs.append(norm_cls(cfg, stats_cls(*stats))(rob, scene))
    assert outs[1].shape == outs[0].shape and outs[1].dtype == np.float32
    np.testing.assert_array_equal(outs[1], outs[0])


def _obs(rng, cfg):
    pe = cfg.perceptual_encoder
    s, g = pe.rgb_static.input_size, pe.rgb_gripper.input_size
    return {
        "rgb_obs": {
            "rgb_static": rng.integers(0, 256, (s, s, 3), np.uint8),
            "rgb_gripper": rng.integers(0, 256, (g, g, 3), np.uint8),
        },
        "robot_obs": rng.normal(size=15).astype(np.float32),
    }


def test_hulc_policy_steps_across_a_replan(debug_pair):
    """reset()/step() for 35 steps crosses the replan at replan_freq=30;
    the same seed gives the same actions."""
    _, _, port_model = debug_pair
    runs = []
    for _ in range(2):
        rng = np.random.default_rng(7)
        policy = HulcPolicy(PORT_CFG, port_model, seed=3)
        policy.reset()
        lang = rng.normal(size=384).astype(np.float32)
        actions = [policy.step(_obs(rng, PORT_CFG), lang) for _ in range(35)]
        assert policy._state.step_count == 35
        runs.append(np.stack(actions))
    acts = runs[0]
    assert acts.shape == (35, 7) and np.isfinite(acts).all()
    assert set(np.unique(acts[:, 6])) <= {-1.0, 1.0}
    np.testing.assert_array_equal(runs[0], runs[1])
    goal_obs = _obs(np.random.default_rng(8), PORT_CFG)
    policy.reset()
    assert np.isfinite(policy.step(_obs(rng, PORT_CFG), goal_obs)).all()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_reset_restarts_the_noise_stream_as_jax_does(debug_pair, package):
    """Two episodes from the same observations and embedding give the same
    actions: ``reset()`` restarts the noise stream from the seed (JAX: from
    its base key), across a replan (replan_freq 3)."""
    _, params, port_model = debug_pair
    if package == "jax":
        from hulc_tpu.evaluation.policy import HulcPolicy as JaxHulcPolicy

        policy = JaxHulcPolicy(jax_config.get_config("hulc_debug", replan_freq=3), params, seed=3)
    else:
        policy = HulcPolicy(port_config.get_config("hulc_debug", replan_freq=3), port_model, seed=3)
    rng = np.random.default_rng(13)
    lang = rng.normal(size=384).astype(np.float32)
    obs = [_obs(rng, PORT_CFG) for _ in range(5)]
    episodes = []
    for _ in range(2):
        policy.reset()
        episodes.append(np.stack([policy.step(o, lang) for o in obs]))
    np.testing.assert_array_equal(episodes[1], episodes[0])


def test_batched_policy_steps_with_staggered_replans(debug_pair):
    _, _, port_model = debug_pair
    lanes = 3
    policy = BatchedHulcPolicy(PORT_CFG, port_model, lanes, seed=0)
    state = policy.initial_state()
    rng = np.random.default_rng(9)
    lang = rng.normal(size=(lanes, 384)).astype(np.float32)
    for t in range(6):
        mask = np.array([t == 0 or (t + i) % 4 == 0 for i in range(lanes)])
        actions, state = policy.step([_obs(rng, PORT_CFG) for _ in range(lanes)], lang, state, mask)
        assert actions.shape == (lanes, 7) and np.isfinite(actions).all()
        assert set(np.unique(actions[:, 6])) <= {-1.0, 1.0}


def test_full_width_hulc_act_matches_jax():
    """The one full-width test: a single act() step of the flagship hulc
    preset (200 px / 84 px cameras, 2x2048 RNN, 1024-d plan) at one lane."""
    jax_cfg, port_cfg = jax_config.get_config("hulc"), port_config.get_config("hulc")
    jax_model, params = jax_random_params(jax_cfg, seed=11)
    port_model, _ = port_model_from_jax(params, port_cfg)
    rng = np.random.default_rng(12)
    x = _inputs(rng, jax_cfg, 1)
    plan, goal, _ = _plan_goal_carry(rng, jax_cfg, 1)
    carry = np.zeros((2, 1, 2048), np.float32)
    key = jax.random.key(13)
    j_act = jax_build_policy_fns(jax_model, jax_cfg)[2]
    want, want_carry = jax.jit(j_act)(
        params, key, plan, goal, x["rgb_static"], x["rgb_gripper"], x["rob_norm"], x["rob_raw"], carry
    )
    u_mix, u_inv = _mixture_uniforms(key, 1, jax_cfg)
    got, got_carry = build_policy_fns(port_model, port_cfg)[2](
        _t(plan), _t(goal), _t(x["rgb_static"]), _t(x["rgb_gripper"]), _t(x["rob_norm"]),
        _t(x["rob_raw"]), _t(carry), u_mix=u_mix, u_inv=u_inv,
    )
    assert got.shape == (1, 7) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_carry.numpy(), np.asarray(want_carry), atol=ATOL, rtol=0)
