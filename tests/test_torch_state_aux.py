"""The state-only family and hulc's auxiliary losses in the port against the
JAX package on the CPU, at debug width (``state_only_debug``,
``fetch_state_debug``, ``fetch_vision`` with its widths cut and its 84 px
static camera kept, and ``hulc_debug`` with ``state_recons``, BC-Z and MIA
on by ``apply_overrides`` (``torch_port_common.AUX_OVERRIDES``); replan
every 3 steps, the recognition network's dropout 0).

* Per variant: the weights' conversion, the train losses and gradients
  (fused and per modality), the validation metrics, ``HulcPolicy`` and
  ``BatchedHulcPolicy`` on JAX's noise (``torch_port_common.check_variant_*``,
  tolerances stated there).
* The BC-Z and MIA losses with the mask ``None``, all false and partial,
  and the state reconstruction, each against JAX's loss and its gradients
  (inputs and heads) within rtol 1e-5 / 1e-5 relative L2.
* The state-only batches: ``make_loaders`` byte-equal to JAX's (no frame
  read; ``fetch_state``'s ``[robot_obs; scene_obs]`` sliced by
  ``keep_indices``), and the static camera alone preprocessed with JAX's
  shifts (pad 4 at 84 px) within 2.4e-7 of JAX's.

The two-rank BC-Z and MIA losses (MIA's roll crossing ranks) run in
tests/test_torch_parallel.py's spawn."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.data.loader import make_loaders as jax_make_loaders
from hulc_tpu.models.hulc import masked_bc_z_loss as jax_masked_bc_z_loss
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.data import fixtures
from hulc_tpu_torch.data.loader import make_loaders
from hulc_tpu_torch.models.hulc import ModalityBatch, masked_bc_z_loss
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from tests.torch_port_common import (
    check_variant_policies,
    check_variant_train_step,
    check_variant_val,
    check_variant_weights,
    grads_in_port_layout,
    quick_jit,
    to_torch,
    variant_setup,
)

torch.set_num_threads(1)

NAMES = ("state_only", "fetch_state", "fetch_vision", "aux")
LOSS_RTOL, GRAD_REL = 1e-5, 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_weights_convert_one_to_one(name):
    check_variant_weights(name)


@pytest.mark.parametrize("schema", ["fused", "split"])
@pytest.mark.parametrize("name", NAMES)
def test_train_losses_and_grads_match_jax(name, schema):
    got, want = check_variant_train_step(name, schema)
    if name == "aux":
        for k in ("proprio_loss", "lang_pred_loss", "lang_contrastive_loss"):
            assert float(want[k]) > 0.0, k


@pytest.mark.parametrize("name", NAMES)
def test_val_metrics_match_jax(name):
    check_variant_val(name)


@pytest.mark.parametrize("name", NAMES)
def test_policies_match_jax(name):
    check_variant_policies(name)


# ---------------------------------------------------------------------------
# the auxiliary losses alone
# ---------------------------------------------------------------------------

MASKS = {"none": None, "all_false": np.zeros(4, bool), "partial": np.array([True, False, True, True])}


def _aux_inputs(cfg, seed=94):
    rng = np.random.default_rng(seed)
    seq_feat = rng.normal(size=(4, cfg.plan_recognition.fc_hidden_size)).astype(np.float32)
    goal = rng.normal(size=(4, cfg.visual_goal.latent_goal_features)).astype(np.float32)
    lang = rng.normal(size=(4, cfg.lang_dim)).astype(np.float32)
    return seq_feat, goal, lang


TIE = 1e-5  # a relu pre-activation this close to 0 may switch between the frameworks' roundings


def _relu_margin(model, seq_feat, goal):
    """The smallest |pre-activation| of every relu the aux heads apply to
    these inputs: a unit within TIE of 0 makes the two frameworks'
    gradients different functions (one side of the kink each)."""
    x, g = to_torch(seq_feat), to_torch(goal)
    with torch.no_grad():
        im, tx = model.proj_vis_lang(x, g)
        pre = [model.proj_vis_lang.mlp_im[0](x), model.proj_vis_lang.mlp_lang[0](g), model.bc_z_lang_decoder.fc0(x)]
        for other in (tx, torch.roll(tx, 1, 0)):
            pre.append(model.mia_lang_discriminator.fc0(torch.cat([im, other], -1)))
    return min(float(t.abs().min()) for t in pre)


def _check_grad(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    assert np.linalg.norm(got - want) <= GRAD_REL * max(np.linalg.norm(want), 1e-30), name


@functools.lru_cache(maxsize=None)
def _jax_aux_loss(loss):
    """JAX's ``bc_z_loss`` / ``mia_loss`` of the aux variant and its
    gradients (params, seq_feat, the other input) under each mask of MASKS,
    from one compiled program: {mask: (loss, grads)}."""
    v = variant_setup("aux")
    jax_model = v["jax_model"]
    seq_feat, goal, lang = _aux_inputs(v["cfg"])
    method = getattr(jax_model, f"{loss}_loss")

    def every_mask(p, x, y):
        out = {}
        for name, m in MASKS.items():
            def one(p, x, y, m=m):
                return jax_model.apply({"params": p}, x, y, None if m is None else jnp.asarray(m), method=method)

            out[name] = jax.value_and_grad(one, argnums=(0, 1, 2))(p, x, y)
        return out

    return jax.device_get(quick_jit(every_mask)(v["params"], seq_feat, lang if loss == "bc_z" else goal))


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("loss", ["bc_z", "mia"])
def test_aux_loss_and_grads_match_jax(loss, mask):
    """``bc_z_loss`` / ``mia_loss`` of the aux variant's heads: the loss and
    its gradients with respect to ``seq_feat``, the latent goal (MIA) or the
    language embedding (BC-Z), and each head parameter. An all-false mask
    gives 0 and no gradient."""
    v = variant_setup("aux")
    cfg = v["cfg"]
    seq_feat, goal, lang = _aux_inputs(cfg)
    assert _relu_margin(v["model"], seq_feat, goal) > TIE  # no relu at its kink: one function on both sides
    m = MASKS[mask]
    other = lang if loss == "bc_z" else goal
    want, (gp, gx, gy) = _jax_aux_loss(loss)[mask]
    model = v["model"]
    model.zero_grad(set_to_none=True)
    x, y = to_torch(seq_feat).requires_grad_(), to_torch(other).requires_grad_()
    got = getattr(model, f"{loss}_loss")(x, y, None if m is None else torch.from_numpy(m))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL, atol=1e-7)
    if mask == "all_false":
        assert float(want) == 0.0 == float(got.detach())
    _check_grad(x.grad, gx, "seq_feat")
    _check_grad(y.grad, gy, "other")
    heads = ("bc_z_lang_decoder",) if loss == "bc_z" else ("proj_vis_lang", "mia_lang_discriminator")
    want_grads = grads_in_port_layout(gp, cfg)
    for k, p in model.named_parameters():
        if k.split(".")[0] in heads:
            _check_grad(torch.zeros_like(p) if p.grad is None else p.grad, want_grads[k], k)
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_masked_bc_z_loss_matches_jax(mask):
    rng = np.random.default_rng(91)
    pred, gt = rng.normal(size=(4, 6)).astype(np.float32), rng.normal(size=(4, 6)).astype(np.float32)
    m = MASKS[mask]
    want = jax_masked_bc_z_loss(pred, gt, None if m is None else jnp.asarray(m))
    got = masked_bc_z_loss(to_torch(pred), to_torch(gt), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=1e-7)


def test_state_reconstruction_matches_jax():
    """The state decoder's MSE on the visual features, its value and its
    gradients (visual features and head)."""
    v = variant_setup("aux")
    cfg, jax_model, params, model = v["cfg"], v["jax_model"], v["params"], v["model"]
    rng = np.random.default_rng(92)
    visual = rng.normal(size=(3, 5, 32)).astype(np.float32)
    robot = rng.normal(size=(3, 5, cfg.perceptual_encoder.proprio.n_state_obs)).astype(np.float32)

    def jax_loss(p, x):
        return jax_model.apply({"params": p}, x, robot,
                               method=lambda mdl, a, b: mdl.perceptual_encoder.state_reconstruction_loss(a, b))

    want, (gp, gx) = jax.device_get(quick_jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(params, visual))
    model.zero_grad(set_to_none=True)
    x = to_torch(visual).requires_grad_()
    got = model.perceptual_encoder.state_reconstruction_loss(x, to_torch(robot))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    _check_grad(x.grad, gx, "visual_emb")
    want_grads = grads_in_port_layout(gp, cfg)
    for k, p in model.named_parameters():
        if k.startswith("perceptual_encoder.state_decoder"):
            _check_grad(p.grad, want_grads[k], k)
    model.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# the state-only batches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return fixtures.make_fixture_dataset(tmp_path_factory.mktemp("state_data"), num_episodes=2, episode_len=24)


@pytest.mark.parametrize("preset", ["state_only_debug", "fetch_state_debug"])
def test_state_only_loader_matches_jax(root, preset):
    """Fused batches over three draws byte-equal to JAX's: no frame field,
    the proprio of the preset's width (fetch_state: ``[robot_obs;
    scene_obs]`` each normalized, sliced by ``keep_indices``)."""
    kwargs = dict(batch_size=3, seed=7, min_window=6, max_window=8, fuse=True, cache="none")
    got_loader = make_loaders(port_config.get_config(preset), root, **kwargs)
    want_loader = jax_make_loaders(jax_config.get_config(preset), root, **kwargs)
    n_state = port_config.get_config(preset).perceptual_encoder.proprio.n_state_obs
    for draw, (got, want) in enumerate(zip(got_loader, want_loader)):
        g, w = got["fused"], want["fused"]
        assert g.rgb_static is None and g.rgb_gripper is None and g.robot_obs.shape[-1] == n_state
        for name, a, b in zip(g._fields, g, w):
            assert (a is None) == (b is None), name
            if a is not None:
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), name
        if draw == 2:
            break
    assert "rgb_static" not in next(iter(got_loader.loaders.values())).store.keys


@pytest.mark.parametrize("preset", ["state_only_debug", "fetch_state_debug"])
def test_state_only_fit_trains_and_validates(root, tmp_path, preset):
    """``Trainer.fit`` on the fixture without a camera: 2 steps, validation
    and a checkpoint, every logged loss finite."""
    from hulc_tpu_torch.training import checkpoint as ckpt
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg = port_config.get_config(preset)
    trainer = Trainer(cfg, TrainerConfig(run_dir=str(tmp_path / "run"), seed=3, log_every=1), "cpu")
    kwargs = dict(batch_size=2, min_window=6, max_window=8, cache="none")
    train = make_loaders(cfg, root, **kwargs)
    val = make_loaders(cfg, root, split="validation", deterministic=True, **kwargs)
    assert trainer.fit(train, val, max_epochs=1, max_steps=2) == 2
    assert ckpt.latest_checkpoint(tmp_path / "run") is not None
    metrics = trainer.validate(val, max_batches=1)
    assert np.isfinite(metrics["action_loss_pp"]) and metrics["vis_kl_loss"] >= 0.0


def test_static_camera_alone_preprocess_matches_jax():
    """``fetch_vision``'s static camera alone (84 px, pad 4), train
    preprocessing on JAX's shifts; the proprio passes through."""
    v = variant_setup("fetch_vision")
    jax_cfg, cfg = v["jax_cfg"], v["cfg"]
    fused = CombinedLoader.fuse_batch(v["raw"])
    key = jax.random.key(93)
    want = jax_preprocess_batch(jax_cfg, {"fused": fused["fused"]}, rng=key, train=True)["fused"]
    _, k_scope = jax.random.split(key)
    k_static = jax.random.split(k_scope, 5)[0]
    pad = cfg.perceptual_encoder.rgb_static.shift_pad
    n = fused["fused"].actions.shape[0] * fused["fused"].actions.shape[1]
    shifts = {"fused": {"rgb_static": to_torch(jax.random.randint(k_static, (n, 2), 0, 2 * pad + 1))}}
    batch = batch_to_device({"fused": ModalityBatch(*fused["fused"])}, "cpu")
    got = preprocess_batch(cfg, batch, train=True, shifts=shifts)["fused"]
    assert got.rgb_gripper is None and want.rgb_gripper is None
    np.testing.assert_allclose(got.rgb_static.numpy(), np.asarray(want.rgb_static).transpose(0, 1, 4, 2, 3),
                               atol=2.4e-7, rtol=0)
    np.testing.assert_array_equal(got.robot_obs.numpy(), np.asarray(want.robot_obs))
