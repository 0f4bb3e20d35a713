"""Port modules (hulc_tpu_torch.models, config, convert) against the JAX
package on the CPU, with the JAX weights of ``hulc_debug`` carried into the
port by ``params_from_jax``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.models.decoders import decoder_carry as jax_decoder_carry
from hulc_tpu.models.hulc import ModalityBatch
from hulc_tpu.training.torch_convert import convert_state_dict

from hulc_tpu_torch import config as port_config
from tests.torch_port_common import jax_init, jax_random_params, port_model_from_jax, to_torch as _t

torch.set_num_threads(1)

CFG_NAME = "hulc_debug"
JAX_CFG = jax_config.get_config(CFG_NAME)
PORT_CFG = port_config.get_config(CFG_NAME)


@pytest.fixture(scope="module")
def jax_side():
    return jax_init(JAX_CFG)


@pytest.fixture(scope="module")
def port_model(jax_side):
    return port_model_from_jax(jax_side[1], PORT_CFG)


def _apply(jax_side, *args, method):
    model, params = jax_side
    return model.apply({"params": params}, *args, method=getattr(model, method))


# Variants of hulc_debug, built the same way from either package's config
# module (the two define their own dataclasses).


def _with_proprio(m):
    cfg = m.get_config(CFG_NAME)
    pe = dataclasses.replace(cfg.perceptual_encoder, proprio=m.ProprioConfig())
    return dataclasses.replace(cfg, perceptual_encoder=pe).resolve()


def _with_mlp_language_head(m):
    head = m.GoalEncoderConfig(kind="mlp", hidden_size=32, latent_goal_features=8)
    return dataclasses.replace(m.get_config(CFG_NAME), language_goal=head).resolve()


def _with_84px_gripper(m):
    cfg = m.get_config(CFG_NAME)
    pe = cfg.perceptual_encoder
    pe = dataclasses.replace(pe, rgb_gripper=dataclasses.replace(pe.rgb_gripper, input_size=84))
    return dataclasses.replace(cfg, perceptual_encoder=pe).resolve()


@pytest.mark.parametrize("name", ["hulc", "hulc_debug"])
def test_config_presets_match_jax_field_by_field(name):
    want = dataclasses.asdict(jax_config.get_config(name))
    got = dataclasses.asdict(port_config.get_config(name))
    assert got == want


def test_params_from_jax_leaves_only_training_subtrees_unused(port_model):
    """The port now holds the training-only subtrees too (the recognition
    transformer, the CLIP heads, logit_scale), so nothing is left unused."""
    _, unused = port_model
    assert unused == []


def _frames(rng, e, s):
    pe = JAX_CFG.perceptual_encoder
    static = rng.normal(size=(e, s, pe.rgb_static.input_size, pe.rgb_static.input_size, 3))
    gripper = rng.normal(size=(e, s, pe.rgb_gripper.input_size, pe.rgb_gripper.input_size, 3))
    return static.astype(np.float32), gripper.astype(np.float32)


def _check_encode(jax_side, model, seed):
    static, gripper = _frames(np.random.default_rng(seed), 3, 2)
    robot_obs = np.random.default_rng(seed + 1).normal(size=(3, 2, 8)).astype(np.float32)
    batch = ModalityBatch(
        rgb_static=jnp.asarray(static), rgb_gripper=jnp.asarray(gripper),
        robot_obs=jnp.asarray(robot_obs), actions=jnp.zeros((3, 2, 7)),
        state_info_robot_obs=jnp.zeros((3, 2, 15)),
    )
    want, _ = _apply(jax_side, batch, method="encode")
    with torch.no_grad():
        got, _ = model.encode({
            "rgb_static": _t(static.transpose(0, 1, 4, 2, 3)),
            "rgb_gripper": _t(gripper.transpose(0, 1, 4, 2, 3)),
        }, _t(robot_obs))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_perceptual_encoder_matches_jax(jax_side, port_model):
    """Both cameras through ConcatEncoders, incl. SpatialSoftmax and the
    nature-CNN flatten (NHWC in JAX, NCHW in the port)."""
    _check_encode(jax_side, port_model[0], seed=0)


def test_perceptual_encoder_with_proprio_matches_jax():
    jax_side = jax_random_params(_with_proprio(jax_config), seed=6)
    model, unused = port_model_from_jax(jax_side[1], _with_proprio(port_config))
    assert unused == []
    _check_encode(jax_side, model, seed=7)


@pytest.mark.parametrize("which", ["visual", "language"])
def test_goal_encoders_match_jax(jax_side, port_model, which):
    width = 384 if which == "language" else JAX_CFG.perceptual_encoder.latent_size
    x = np.random.default_rng(1).normal(size=(4, width)).astype(np.float32)
    want = _apply(jax_side, jnp.asarray(x), method=f"encode_{which}_goal")
    model, _ = port_model
    with torch.no_grad():
        got = getattr(model, f"encode_{which}_goal")(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_mlp_language_head_matches_jax():
    """The plain three-Linear language head (GoalEncoderConfig kind="mlp")."""
    jax_side = jax_random_params(_with_mlp_language_head(jax_config), seed=8)
    model, unused = port_model_from_jax(jax_side[1], _with_mlp_language_head(port_config))
    assert unused == []
    x = np.random.default_rng(9).normal(size=(4, 384)).astype(np.float32)
    want = _apply(jax_side, jnp.asarray(x), method="encode_language_goal")
    with torch.no_grad():
        got = model.encode_language_goal(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_plan_proposal_matches_jax(jax_side, port_model):
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(4, 1, JAX_CFG.perceptual_encoder.latent_size)).astype(np.float32)
    goal = rng.normal(size=(4, JAX_CFG.plan_proposal.latent_goal_features)).astype(np.float32)
    key = jax.random.key(3)
    want = _apply(jax_side, key, jnp.asarray(emb), jnp.asarray(goal), method="propose_plan")
    d = JAX_CFG.distribution
    model, _ = port_model
    with torch.no_grad():
        state = model.plan_proposal(_t(emb[:, 0]), _t(goal))
        got = model.propose_plan(
            _t(emb), _t(goal), gumbel=_t(jax.random.gumbel(key, (4, d.category_size, d.class_size)))
        )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert state.logit.shape == (4, d.plan_dim)


def test_decoder_forward_with_carry_matches_jax(jax_side, port_model):
    """Three sequential single-frame decoder passes threading the carry."""
    from hulc_tpu.models.decoders import LogisticPolicyDecoder

    ad = JAX_CFG.action_decoder
    rng = np.random.default_rng(4)
    plan = rng.normal(size=(2, ad.plan_features)).astype(np.float32)
    goal = rng.normal(size=(2, ad.latent_goal_features)).astype(np.float32)
    jax_mod = LogisticPolicyDecoder(ad)
    jax_params = {"params": jax_side[1]["action_decoder"]}
    model, _ = port_model
    j_carry = jax_decoder_carry(ad, 2)
    t_carry = model.init_decoder_carry(2)
    for step in range(3):
        emb = rng.normal(size=(2, 1, ad.perceptual_features)).astype(np.float32)
        want = jax_mod.apply(jax_params, jnp.asarray(plan), jnp.asarray(emb), jnp.asarray(goal), j_carry)
        with torch.no_grad():
            got = model.action_decoder(_t(plan), _t(emb), _t(goal), t_carry)
        for name in ("logit_probs", "log_scales", "means", "gripper_logits", "carry"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-5, rtol=0,
                err_msg=f"{name} at step {step}",
            )
        j_carry, t_carry = want.carry, got.carry


def test_state_dict_round_trips_through_jax_converter():
    """convert_state_dict(port.state_dict()) gives back the whole JAX tree,
    leaf for leaf, with no unused keys. The gripper camera is 84 px here
    because torch_convert's flatten-size table maps the debug preset's
    48 px to a 3x3 map, while its conv tower gives 2x2."""
    jax_cfg = _with_84px_gripper(jax_config)
    _, params = jax_random_params(jax_cfg, seed=5)
    model, unused = port_model_from_jax(params, _with_84px_gripper(port_config))
    assert unused == []
    back, unused = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, jax_cfg)
    assert unused == []
    expected = params
    got_leaves = jax.tree_util.tree_flatten_with_path(back)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(expected)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
