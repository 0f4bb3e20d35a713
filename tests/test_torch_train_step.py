"""The port's training losses, gradients and one Trainer step against the
JAX package on the CPU, at ``hulc_debug`` with an 84 px gripper camera (the
size ``torch_convert.convert_state_dict`` maps, which carries the port's
gradients back to the JAX layout). Weights go from JAX to the port through
``params_from_jax``; the port gets the random shifts and the plan noise
JAX drew. The recognition network's dropout is 0 on both sides, since the
two frameworks cannot draw the same masks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training import train_state as flax_train_state

from __graft_entry__ import _make_raw_batch
from hulc_tpu import config as jax_config
from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch
from hulc_tpu.training.torch_convert import convert_state_dict
from hulc_tpu.training.trainer import Trainer as JaxTrainer
from hulc_tpu.training.trainer import TrainerConfig as JaxTrainerConfig

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.convert import params_from_jax
from hulc_tpu_torch.models.hulc import LOSS_KEYS, ModalityBatch
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig
from tests.torch_port_common import jax_random_params, port_model_from_jax

torch.set_num_threads(1)

B, S, KL_BETA, LR = 3, 4, 0.01, 2e-4
GRAD_RTOL = 1e-4  # per leaf, relative L2: fp32 sums in another order
ZERO_GRAD = 1e-7  # share of the whole gradient's norm below which a leaf's is rounding noise


def _cfg(m):
    cfg = m.get_config("hulc_debug")
    pe = cfg.perceptual_encoder
    pe = dataclasses.replace(pe, rgb_gripper=dataclasses.replace(pe.rgb_gripper, input_size=84))
    pr = dataclasses.replace(cfg.plan_recognition, dropout=0.0)
    return dataclasses.replace(cfg, perceptual_encoder=pe, plan_recognition=pr).resolve()


JAX_CFG, PORT_CFG = _cfg(jax_config), _cfg(port_config)


def _port_batch(batch):
    return {scope: ModalityBatch(*mod) for scope, mod in batch.items()}


def _plan_gumbel(key, n):
    d = JAX_CFG.distribution
    return jax.random.gumbel(key, (n, d.category_size, d.class_size))


@pytest.fixture(scope="module")
def setup():
    jax_model, params = jax_random_params(JAX_CFG, seed=30)
    split = _make_raw_batch(JAX_CFG, B, S, seed=31)
    mask = np.array([True, False, True])
    split["lang"] = split["lang"]._replace(use_for_aux_lang_loss=mask)
    return jax_model, params, split, CombinedLoader.fuse_batch(split)


@pytest.fixture(scope="module")
def jax_trainer_step(setup, tmp_path_factory):
    """One JAX train step, the noise it drew, and the grads it took."""
    jax_model, params, _, fused = setup
    tcfg = JaxTrainerConfig(run_dir=str(tmp_path_factory.mktemp("jax_run")), num_devices=1, donate_state=False, lr=LR)
    trainer = JaxTrainer(JAX_CFG, tcfg)
    state = flax_train_state.TrainState.create(
        apply_fn=jax_model.apply, params=jax.tree.map(jnp.asarray, params), tx=trainer.build_optimizer(1)
    )
    rng = jax.random.key(32)
    new_state, losses = trainer.make_train_step()(state, fused, rng, jnp.asarray(KL_BETA, jnp.float32))

    # the key chain of make_train_step, preprocess_batch and _fused_train_losses
    k_aug, k_loss, _ = jax.random.split(jax.random.fold_in(rng, 0), 3)
    _, k_scope = jax.random.split(k_aug)
    k_static, k_gripper = jax.random.split(k_scope, 5)[:2]
    pe = JAX_CFG.perceptual_encoder
    shifts = {"fused": {
        cam: torch.from_numpy(np.array(jax.random.randint(k, (2 * B * S, 2), 0, 2 * enc.shift_pad + 1)))
        for cam, k, enc in (("rgb_static", k_static, pe.rgb_static), ("rgb_gripper", k_gripper, pe.rgb_gripper))
    }}
    gumbel = _plan_gumbel(jax.random.split(k_loss)[1], 2 * B)

    prep = jax_preprocess_batch(JAX_CFG, fused, rng=k_aug, train=True)

    def loss_fn(p):
        out = jax_model.apply({"params": p}, k_loss, prep, KL_BETA, method=jax_model.train_losses)
        return out["total_loss"], out

    grads, want = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    return {
        "losses": jax.device_get(losses), "params": jax.device_get(new_state.params),
        "grads": jax.device_get(grads), "grad_losses": jax.device_get(want),
        "shifts": shifts, "gumbel": torch.from_numpy(np.array(gumbel)),
    }


def _check_losses(got, want):
    got = {k: v.detach() for k, v in got.items()}
    keys = set(LOSS_KEYS) | {f"{k}_{s}" for k in ("action_loss", "kl_loss_scaled", "total_loss") for s in ("vis", "lang")}
    assert keys <= set(got) and keys <= set(want)
    for k in sorted(keys):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(want["lang_clip_loss"]) != 0.0


def _check_grads(model, want):
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    got, unused = convert_state_dict(grads, JAX_CFG)
    assert unused == []
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    total = np.sqrt(sum(np.sum(np.square(np.asarray(w))) for _, w in want_leaves))
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        g, w, name = np.asarray(g), np.asarray(w), jax.tree_util.keystr(path)
        if np.linalg.norm(w) <= ZERO_GRAD * total:
            # zero in exact arithmetic (the attention's key bias: a constant
            # added to every key of a query cancels in its softmax); both
            # sides hold rounding noise there
            assert np.linalg.norm(g) <= ZERO_GRAD * total, name
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, f"{name}: relative L2 error {err}"


def test_fused_train_losses_and_grads_match_jax(setup, jax_trainer_step):
    """The loader-fused {"fused": 2B} schema, the train step's own batch."""
    _, params, _, fused = setup
    model, _ = port_model_from_jax(params, PORT_CFG)
    batch = preprocess_batch(PORT_CFG, batch_to_device(_port_batch(fused), "cpu"),
                             shifts=jax_trainer_step["shifts"])
    losses = model.train().train_losses(batch, KL_BETA, gumbel=jax_trainer_step["gumbel"])
    losses["total_loss"].backward()
    _check_losses(losses, jax_trainer_step["grad_losses"])
    _check_grads(model, jax_trainer_step["grads"])


def test_split_train_losses_and_grads_match_jax(setup):
    """The {"vis": B, "lang": B} schema: a pass per modality, each with its
    own plan noise (eval preprocessing: no shifts)."""
    jax_model, params, split, _ = setup
    key = jax.random.key(33)
    prep = jax_preprocess_batch(JAX_CFG, split, rng=None, train=False)

    def loss_fn(p):
        out = jax_model.apply({"params": p}, key, prep, KL_BETA, method=jax_model.train_losses)
        return out["total_loss"], out

    grads, want = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    k_vis, k_lang = (jax.random.split(k)[1] for k in (key, jax.random.split(key)[0]))
    gumbel = {"vis": _plan_gumbel(k_vis, B), "lang": _plan_gumbel(k_lang, B)}
    model, _ = port_model_from_jax(params, PORT_CFG)
    batch = preprocess_batch(PORT_CFG, batch_to_device(_port_batch(split), "cpu"), train=False)
    losses = model.train().train_losses(
        batch, KL_BETA, gumbel={k: torch.from_numpy(np.array(v)) for k, v in gumbel.items()}
    )
    losses["total_loss"].backward()
    _check_losses(losses, jax.device_get(want))
    _check_grads(model, jax.device_get(grads))


def test_trainer_step_matches_jax(setup, jax_trainer_step):
    """Losses, grad_norm and the updated params of one step (Adam with bf16
    moments). The first Adam step moves each param by about lr * sign(g),
    so where |g| is at rounding noise the two can step apart: params are
    held to 1e-6 where |g_jax| > 1e-6 and to 2 * lr elsewhere."""
    _, params, _, fused = setup
    trainer = Trainer(PORT_CFG, TrainerConfig(lr=LR), device="cpu")
    state_dict, unused = params_from_jax(params, PORT_CFG)
    assert unused == []
    trainer.model.load_state_dict(state_dict, strict=True)
    trainer.init_state(1)
    losses = trainer.train_step(
        _port_batch(fused), KL_BETA, shifts=jax_trainer_step["shifts"], gumbel=jax_trainer_step["gumbel"]
    )
    want = jax_trainer_step["losses"]
    _check_losses(losses, want)
    np.testing.assert_allclose(float(losses["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
    got_params, _ = convert_state_dict({k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}, JAX_CFG)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for (path, g), (_, w), (_, grad) in zip(flat(got_params), flat(jax_trainer_step["params"]),
                                            flat(jax_trainer_step["grads"])):
        g, w, big = np.asarray(g), np.asarray(w), np.abs(np.asarray(grad)) > 1e-6
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(g[big], w[big], atol=1e-6, rtol=0, err_msg=name)
        assert np.all(np.abs(g - w)[~big] <= 2 * LR), name


def test_trainer_draws_its_own_noise_and_steps():
    """Without injected noise: shifts, plan noise and dropout masks come
    from the trainer's generator; two trainers of one seed agree."""
    cfg = port_config.get_config("hulc_debug")
    raw = _port_batch(CombinedLoader.fuse_batch(_make_raw_batch(jax_config.get_config("hulc_debug"), 2, 3, seed=34)))
    runs = []
    for _ in range(2):
        trainer = Trainer(cfg, TrainerConfig(seed=5), device="cpu")
        trainer.init_state(10)
        runs.append(trainer.train_steps(2, [raw], KL_BETA))
    assert all(np.isfinite(float(v)) for v in runs[0][-1].values())
    assert trainer.step == 2 and trainer.model.training
    for a, b in zip(runs[0], runs[1]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(runs[0][0]["total_loss"], runs[0][1]["total_loss"])


def test_exact_zero_gradients_match_jax(setup, jax_trainer_step):
    """The gradients that are exactly zero (the rows and columns of units no
    window of the batch activates: the Adam kernel's cheap case) are zero in
    the JAX step too, element by element, outside the leaves whose whole
    gradient is rounding noise (``_check_grads``)."""
    _, params, _, fused = setup
    model, _ = port_model_from_jax(params, PORT_CFG)
    batch = preprocess_batch(PORT_CFG, batch_to_device(_port_batch(fused), "cpu"),
                             shifts=jax_trainer_step["shifts"])
    model.train().train_losses(batch, KL_BETA, gumbel=jax_trainer_step["gumbel"])["total_loss"].backward()
    got, _ = convert_state_dict({k: p.grad.numpy() for k, p in model.named_parameters()}, JAX_CFG)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    want_leaves = flat(jax_trainer_step["grads"])
    total = np.sqrt(sum(np.sum(np.square(np.asarray(w))) for _, w in want_leaves))
    with_zeros = 0
    for (path, g), (_, w) in zip(flat(got), want_leaves):
        g, w, name = np.asarray(g), np.asarray(w), jax.tree_util.keystr(path)
        if np.linalg.norm(w) <= ZERO_GRAD * total:
            continue
        np.testing.assert_array_equal(g == 0, w == 0, err_msg=name)
        with_zeros += bool(np.any(w == 0))
    assert with_zeros >= 10  # the comparison is not vacuous
