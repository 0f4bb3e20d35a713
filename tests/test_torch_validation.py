"""The port's validation pass against the JAX package's on the CPU, at
``hulc_debug``: the weights are JAX's (``params_from_jax``) and the port is
fed the noise JAX drew from each key (the plans' Gumbel noise, the decoded
windows' mixture uniforms).

* The decoder's ``loss_and_act``, ``lmp_val``, ``val_metrics`` over a
  ``{"vis", "lang"}`` batch key by key, and the val step from the raw uint8
  batch against the body of JAX's ``Trainer.make_val_step``: losses within
  rtol 1e-5, MAEs within atol 1e-4 (``tcp_to_world_frame`` amplifies fp
  noise), the gripper success rates and the sampled plans exact.
* ``clip_groundtruth_metrics`` against JAX's.
* ``Trainer.validate`` leaves the model in train mode (or a later train
  step would lose the recognition transformer's dropout), and
  ``val_metrics`` refuses to run in train mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_raw_batch
from hulc_tpu import config as jax_config
from hulc_tpu.evaluation.metrics import clip_groundtruth_metrics as jax_clip_groundtruth_metrics
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch
from hulc_tpu.training.trainer import Trainer as JaxTrainer
from hulc_tpu.training.trainer import TrainerConfig as JaxTrainerConfig

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.convert import params_from_jax
from hulc_tpu_torch.data.fixtures import make_fixture_dataset
from hulc_tpu_torch.data.loader import make_loaders
from hulc_tpu_torch.evaluation.metrics import clip_groundtruth_metrics
from hulc_tpu_torch.models.hulc import ModalityBatch
from hulc_tpu_torch.ops.logistic_mixture import U_MAX, U_MIN
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig
from tests.torch_port_common import jax_gumbel, jax_random_params, port_model_from_jax, to_torch

torch.set_num_threads(1)

B, S, KL_BETA = 3, 6, 0.02
LOSS_RTOL, MAE_ATOL = 1e-5, 1e-4
JAX_CFG = jax_config.get_config("hulc_debug")
PORT_CFG = port_config.get_config("hulc_debug")


def _port_batch(batch):
    return {scope: ModalityBatch(*mod) for scope, mod in batch.items()}


def _window_uniforms(key, b, s, cfg):
    """The uniforms JAX's logistic_mixture_sample draws from ``key`` for a
    (b, s) window."""
    ad = cfg.action_decoder
    shape = (b, s, ad.out_features - 1, ad.n_mixtures)
    k_mix, k_inv = jax.random.split(key)
    u_mix = jax.random.uniform(k_mix, shape, jnp.float32, minval=U_MIN, maxval=U_MAX)
    u_inv = jax.random.uniform(k_inv, shape[:-1], jnp.float32, minval=U_MIN, maxval=U_MAX)
    return to_torch(u_mix), to_torch(u_inv)


def _lmp_val_noise(key, b, s, cfg):
    """The noise JAX's lmp_val draws from its key (its four-way split)."""
    k_pp, k_pr, k_act_pp, k_act_pr = jax.random.split(key, 4)
    u_mix_pp, u_inv_pp = _window_uniforms(k_act_pp, b, s, cfg)
    u_mix_pr, u_inv_pr = _window_uniforms(k_act_pr, b, s, cfg)
    return {
        "gumbel_pp": jax_gumbel(k_pp, b, cfg), "u_mix_pp": u_mix_pp, "u_inv_pp": u_inv_pp,
        "gumbel_pr": jax_gumbel(k_pr, b, cfg), "u_mix_pr": u_mix_pr, "u_inv_pr": u_inv_pr,
    }


def _val_metrics_noise(key, scopes, b, s, cfg):
    """The noise JAX's val_metrics draws, by scope: a key split per scope, in
    the order its jitted batch holds them (a dict flattens in key order)."""
    out = {}
    for scope in sorted(scopes):
        key, k = jax.random.split(key)
        out[scope] = _lmp_val_noise(k, b, s, cfg)
    return out


@pytest.fixture(scope="module")
def setup():
    jax_model, params = jax_random_params(JAX_CFG, seed=40)
    raw = _make_raw_batch(JAX_CFG, B, S, seed=41)
    rng = np.random.default_rng(42)
    for scope, mod in raw.items():
        actions = mod.actions.copy()
        actions[..., -1] = rng.choice([-1.0, 1.0], actions.shape[:-1])  # the dataset's gripper commands
        state = mod.state_info_robot_obs.copy()
        state[..., 3:6] = rng.uniform(-1.2, 1.2, state[..., 3:6].shape)  # canonical Euler range
        raw[scope] = mod._replace(actions=actions, state_info_robot_obs=state)
    raw["lang"] = raw["lang"]._replace(use_for_aux_lang_loss=np.array([True, False, True]))
    model, unused = port_model_from_jax(params, PORT_CFG)
    assert unused == []
    return jax_model, params, raw, model.eval()


def _check(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    for k in keys:
        g, w = np.asarray(got[k].detach()), np.asarray(want[k])
        assert g.shape == w.shape, k
        if "sampled_plan" in k or "gripper_sr" in k:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif "mae" in k:
            np.testing.assert_allclose(g, w, atol=MAE_ATOL, rtol=0, err_msg=k)
        elif k == "seq_feat":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def test_loss_and_act_matches_jax(setup):
    jax_model, params, raw, model = setup
    cfg = JAX_CFG
    rng = np.random.default_rng(43)
    ad = cfg.action_decoder
    plan = np.eye(cfg.distribution.class_size, dtype=np.float32)[
        rng.integers(0, cfg.distribution.class_size, (B, cfg.distribution.category_size))
    ].reshape(B, -1)
    emb = rng.normal(size=(B, S, ad.perceptual_features)).astype(np.float32)
    goal = rng.normal(size=(B, ad.latent_goal_features)).astype(np.float32)
    mod = raw["vis"]
    key = jax.random.key(44)
    loss, act = jax.jit(lambda p, *a: jax_model.apply(
        {"params": p}, *a, method=lambda m, *x: m.action_decoder.loss_and_act(*x)
    ))(params, key, plan, emb, goal, mod.actions, mod.state_info_robot_obs)
    u_mix, u_inv = _window_uniforms(key, B, S, cfg)
    with torch.no_grad():
        got_loss, got_act = model.action_decoder.loss_and_act(
            *map(torch.from_numpy, (plan, emb, goal, mod.actions, mod.state_info_robot_obs)), u_mix=u_mix, u_inv=u_inv
        )
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=LOSS_RTOL)
    assert got_act.shape == (B, S, 7)
    np.testing.assert_allclose(got_act.numpy(), np.asarray(act), atol=MAE_ATOL, rtol=0)
    np.testing.assert_array_equal(got_act[..., -1].numpy(), np.asarray(act)[..., -1])


def test_lmp_val_matches_jax(setup):
    jax_model, params, raw, model = setup
    prep = jax_preprocess_batch(JAX_CFG, {"lang": raw["lang"]}, rng=None, train=False)["lang"]
    key = jax.random.key(45)

    def jax_lmp_val(p, k, batch):
        def f(m):
            emb, _ = m.encode(batch, deterministic=True)
            goal = m.encode_language_goal(batch.lang)
            return m.lmp_val(k, emb, goal, batch.actions, batch.state_info_robot_obs, KL_BETA)
        return jax_model.apply({"params": p}, method=f)

    want = jax.device_get(jax.jit(jax_lmp_val)(params, key, prep))
    batch = preprocess_batch(PORT_CFG, batch_to_device(_port_batch({"lang": raw["lang"]}), "cpu"), train=False)["lang"]
    with torch.no_grad():
        emb, _ = model.encode(batch.rgb_obs(), batch.robot_obs)
        goal = model.encode_language_goal(batch.lang)
        got = model.lmp_val(
            emb, goal, batch.actions, batch.state_info_robot_obs, KL_BETA, noise=_lmp_val_noise(key, B, S, JAX_CFG)
        )
    assert set(got) == set(want)
    _check(got, want)
    assert float(np.asarray(want["kl_loss"])) > 0.0


@pytest.fixture(scope="module")
def jax_val_metrics(setup):
    jax_model, params, raw, _ = setup
    prep = jax_preprocess_batch(JAX_CFG, raw, rng=None, train=False)
    key = jax.random.key(46)
    out = jax.jit(lambda p, k, b: jax_model.apply({"params": p}, k, b, KL_BETA, method=jax_model.val_metrics))(
        params, key, prep
    )
    return key, jax.device_get(out)


def test_val_metrics_match_jax(setup, jax_val_metrics):
    _, _, raw, model = setup
    key, want = jax_val_metrics
    batch = preprocess_batch(PORT_CFG, batch_to_device(_port_batch(raw), "cpu"), train=False)
    with torch.no_grad():
        got = model.val_metrics(batch, KL_BETA, noise=_val_metrics_noise(key, raw, B, S, JAX_CFG))
    assert set(got) == set(want)
    _check(got, want)
    assert float(want["val_pred_clip_loss"]) != 0.0
    assert 0.0 < float(want["vis_gripper_sr_pp"]) < 1.0  # the comparison is not vacuous


def test_val_step_from_raw_uint8_matches_jax(setup, tmp_path):
    """Trainer.val_step on the raw uint8 batch against the body of JAX's
    make_val_step (eval preprocess, val_metrics, the scalars)."""
    _, params, raw, _ = setup
    jax_trainer = JaxTrainer(JAX_CFG, JaxTrainerConfig(run_dir=str(tmp_path / "jax"), num_devices=1))
    key = jax.random.key(47)
    want = jax.device_get(jax_trainer.make_val_step()(
        jax.tree.map(jnp.asarray, params), raw, key, jnp.asarray(KL_BETA, jnp.float32)
    ))
    trainer = Trainer(PORT_CFG, TrainerConfig(run_dir=str(tmp_path / "port")), device="cpu")
    state_dict, _ = params_from_jax(params, PORT_CFG)
    trainer.model.load_state_dict(state_dict, strict=True)
    trainer.model.eval()
    with torch.no_grad():
        got = trainer.val_step(_port_batch(raw), KL_BETA, noise=_val_metrics_noise(key, raw, B, S, JAX_CFG))
    assert set(got) == set(want) and all(v.dim() == 0 for v in got.values())
    _check(got, want)


def test_clip_groundtruth_metrics_match_jax(setup):
    jax_model, params, _, model = setup
    rng = np.random.default_rng(48)
    n_bank, n_tasks = 9, 4
    seq_feat = rng.normal(size=(5, JAX_CFG.plan_recognition.fc_hidden_size)).astype(np.float32)
    bank = rng.normal(size=(n_bank, 384)).astype(np.float32)
    bank_ids = rng.integers(0, n_tasks, n_bank)
    gt = rng.integers(0, n_tasks, 5)
    mask = np.array([True, True, False, True, True])
    want = jax_clip_groundtruth_metrics(jax_model, jax.tree.map(jnp.asarray, params), jnp.asarray(seq_feat), gt,
                                        bank, bank_ids, mask)
    got = clip_groundtruth_metrics(model, torch.from_numpy(seq_feat), gt, bank, bank_ids, mask)
    assert set(got) == set(want) == {"lang_gt_score", "lang_gt_sr"}
    np.testing.assert_allclose(got["lang_gt_score"], want["lang_gt_score"], rtol=1e-5)
    assert got["lang_gt_sr"] == want["lang_gt_sr"]
    assert clip_groundtruth_metrics(model, torch.from_numpy(seq_feat), gt, bank, bank_ids, np.zeros(5, bool)) == {}


def test_validate_leaves_the_model_in_train_mode(tmp_path):
    """validate runs in eval mode (val_metrics refuses train mode) and gives
    train mode back, so the recognition transformer's dropout stays on for
    the steps that follow; two validations give the same means (the noise
    generator is seeded at every call)."""
    root = make_fixture_dataset(tmp_path / "data", num_episodes=2, episode_len=20)
    val = make_loaders(PORT_CFG, root, split="validation", batch_size=2, min_window=6, max_window=8,
                       deterministic=True)
    trainer = Trainer(PORT_CFG, TrainerConfig(run_dir=str(tmp_path / "run"), val_max_batches=2), device="cpu")
    assert PORT_CFG.plan_recognition.dropout > 0.0
    seen = []
    original = trainer.model.val_metrics

    def spy(*args, **kwargs):
        seen.append([m.training for m in trainer.model.modules()])
        return original(*args, **kwargs)

    trainer.model.val_metrics = spy
    first = trainer.validate(val)
    assert len(seen) == 2 and not any(any(flags) for flags in seen)
    assert all(m.training for m in trainer.model.modules())
    assert trainer.validate(val) == first
    assert all(np.isfinite(v) for v in first.values())
    batch = preprocess_batch(PORT_CFG, batch_to_device(next(iter(val)), "cpu"), train=False)
    with pytest.raises(RuntimeError, match="eval mode"):
        original(batch)


def test_clip_groundtruth_callback_logs_lang_gt(tmp_path):
    """The callback ranks the validation language windows against the
    sampler's instruction bank in eval mode, logs ``lang_gt`` and gives
    train mode back."""
    from hulc_tpu_torch.evaluation.metrics import ClipGroundtruthCallback

    root = make_fixture_dataset(tmp_path / "data", num_episodes=2, episode_len=20)
    val = make_loaders(PORT_CFG, root, split="validation", batch_size=3, min_window=6, max_window=8,
                       deterministic=True)
    trainer = Trainer(PORT_CFG, TrainerConfig(run_dir=str(tmp_path / "run")), device="cpu")
    out = ClipGroundtruthCallback(val, max_batches=2).on_epoch_end(trainer, 0)
    assert set(out) == {"lang_gt_score", "lang_gt_sr"} and 0.0 <= out["lang_gt_sr"] <= 1.0
    assert np.isfinite(out["lang_gt_score"])
    assert all(m.training for m in trainer.model.modules())
    (line,) = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert '"prefix": "lang_gt"' in line
