"""The ``mcil`` model in the port against the JAX package on the CPU, at
``mcil_debug`` with an 84 px gripper camera (the size
``torch_convert.convert_state_dict`` maps, which carries the port's
gradients back to the JAX layout): the presets, the weights' conversion,
the continuous (Normal) plan, the train losses and their gradients, the
validation metrics, the live and served policies, and a short ``fit``.
Weights go from JAX to the port through ``params_from_jax``; the port gets
the noise JAX drew from each key. MCIL has no dropout (the BiRNN's is 0),
so its train mode draws nothing but the plan noise."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_raw_batch
from hulc_tpu import config as jax_config
from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.evaluation.batched_eval import BatchedHulcPolicy as JaxBatchedHulcPolicy
from hulc_tpu.evaluation.policy import HulcPolicy as JaxHulcPolicy
from hulc_tpu.models import example_batch, init_params
from hulc_tpu.models import make_model as jax_make_model
from hulc_tpu.ops.plan_distributions import PlanDistribution as JaxPlanDistribution
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch
from hulc_tpu.training.torch_convert import convert_state_dict

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.data.fixtures import make_fixture_dataset
from hulc_tpu_torch.data.loader import make_loaders
from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
from hulc_tpu_torch.evaluation.fake_env import fake_env_for
from hulc_tpu_torch.evaluation.policy import HulcPolicy
from hulc_tpu_torch.models.hulc import LOSS_KEYS, HulcModel, ModalityBatch
from hulc_tpu_torch.models.layers import ScanBiRNN
from hulc_tpu_torch.ops.plan_distributions import ContinuousPlanState, PlanDistribution
from hulc_tpu_torch.serving import ServedBatchedPolicy, ServedPolicy, export_policy
from hulc_tpu_torch.training import checkpoint as ckpt
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig
from tests.torch_port_common import (
    jax_batched_step_noise,
    jax_mixture_uniforms,
    jax_plan_noise,
    jax_random_params,
    port_model_from_jax,
    to_torch,
)

torch.set_num_threads(1)

B, S, KL_BETA = 3, 5, 0.01
LOSS_RTOL = 1e-5  # fp32 sums in another order
GRAD_RTOL = 1e-4  # per leaf, relative L2
ATOL = 1e-4  # plans, MAEs and actions
LANES = 3
TASK = "push_red_block_right"


def _cfg(m):
    cfg = m.get_config("mcil_debug", replan_freq=3)
    pe = cfg.perceptual_encoder
    pe = dataclasses.replace(pe, rgb_gripper=dataclasses.replace(pe.rgb_gripper, input_size=84))
    return dataclasses.replace(cfg, perceptual_encoder=pe).resolve()


JAX_CFG, PORT_CFG = _cfg(jax_config), _cfg(port_config)


def _port_batch(batch):
    return {scope: ModalityBatch(*mod) for scope, mod in batch.items()}


@pytest.fixture(scope="module")
def setup():
    jax_model, params = jax_random_params(JAX_CFG, seed=60)
    raw = _make_raw_batch(JAX_CFG, B, S, seed=61)
    raw["lang"] = raw["lang"]._replace(use_for_aux_lang_loss=np.array([True, False, True]))
    model, unused = port_model_from_jax(params, PORT_CFG)
    assert unused == []
    return jax_model, params, raw, model


# ---------------------------------------------------------------------------
# presets, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mcil", "mcil_debug"])
def test_preset_matches_jax_field_by_field(name):
    want, got = dataclasses.asdict(jax_config.get_config(name)), dataclasses.asdict(port_config.get_config(name))
    assert got == want
    cfg = port_config.get_config(name)
    assert cfg.plan_recognition.kind == "birnn" and cfg.plan_recognition.birnn_cell == "rnn_tanh"
    assert cfg.distribution.kind == "continuous" and not cfg.use_clip_auxiliary_loss
    assert not cfg.action_decoder.discrete_gripper and not cfg.action_decoder.gripper_control


def test_mcil_builds_at_full_width():
    """The full-width model (on the meta device: no memory, no compute)
    holds JAX's parameters, as many as JAX's tree, with the BiRNN at H =
    2048 (layer 0 from the 128-d latent, layer 1 from 4096) and the plan's
    512-d state (a 256-d Normal)."""
    cfg = port_config.get_config("mcil")
    with torch.device("meta"):
        model = HulcModel(cfg)
    jcfg = jax_config.get_config("mcil")
    batch = {"vis": example_batch(jcfg, 1, 2), "lang": example_batch(jcfg, 1, 2, lang=True)}
    shapes = jax.eval_shape(lambda: init_params(jax_make_model(jcfg), jax.random.key(0), batch))
    assert sum(p.numel() for p in model.parameters()) == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    birnn = model.plan_recognition.birnn_model
    assert isinstance(birnn, ScanBiRNN) and birnn.hidden_size == 2048
    assert birnn.weight_ih_l0.shape == birnn.weight_ih_l0_reverse.shape == (2048, 128)
    assert birnn.weight_ih_l1.shape == (2048, 4096) and birnn.weight_hh_l1_reverse.shape == (2048, 2048)
    assert model.plan_recognition.fc_state[0].weight.shape == (512, 4096)
    assert model.plan_proposal.fc_state[0].weight.shape == (512, 2048)
    assert not hasattr(model, "proj_vis_lang") and not hasattr(model.action_decoder, "gripper_fc")


def test_params_from_jax_round_trip(setup):
    """JAX's tree -> the port's state_dict -> JAX's tree, bit for bit, no
    key unused either way (the BiRNN's fwd_k / bwd_k as nn.RNN's layer k
    and its ``_reverse`` twin)."""
    _, params, _, model = setup
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    assert "plan_recognition.birnn_model.weight_hh_l1_reverse" in state
    back, unused = convert_state_dict(state, JAX_CFG)
    assert unused == []
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(params)]
    for (path, a), (_, b) in zip(flat(back), flat(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the continuous plan
# ---------------------------------------------------------------------------

FEATURES = 6


def _dist_inputs():
    rng = np.random.default_rng(62)
    post, prior = (rng.normal(size=(4, 2 * FEATURES)).astype(np.float32) for _ in range(2))
    post[0, FEATURES:] = -30.0  # softplus far below 1: std at min_std
    return post, prior


def _jax_dist_out(method, post, prior, key):
    jd = JaxPlanDistribution(kind="continuous", plan_features=FEATURES)

    def f(p, q):
        sp, sq = jd.make_state(p), jd.make_state(q)
        return {
            "make_state": lambda: jnp.concatenate([sp.mean, sp.std], -1),
            "sample": lambda: jd.sample(key, sp),
            "rsample": lambda: jd.rsample(key, sp),
            "mode": lambda: jd.mode(sp),
            "kl": lambda: jd.kl(sp, sq),
            "balanced_kl": lambda: jd.balanced_kl(sp, sq, 0.8, per_sample=True),
        }[method]()

    out = f(post, prior)
    # the gradient of <out, ones> for each input: a fixed cotangent
    grads = jax.grad(lambda p, q: jnp.sum(f(p, q) * jnp.linspace(0.5, 1.5, out.size).reshape(out.shape)),
                     argnums=(0, 1))(post, prior)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("method", ["make_state", "sample", "rsample", "mode", "kl", "balanced_kl"])
def test_continuous_distribution_matches_jax(method):
    """Each of the six methods on JAX's standard-normal draw, and the
    gradients through it (the sample none: JAX's stop_gradient), rtol
    1e-5."""
    post, prior = _dist_inputs()
    key = jax.random.key(63)
    want, want_grads = _jax_dist_out(method, post, prior, key)
    dist = PlanDistribution(kind="continuous", plan_features=FEATURES)
    assert (dist.plan_dim, dist.state_dim, dist.noise_name) == (FEATURES, 2 * FEATURES, "normal")
    normal = to_torch(jax.random.normal(key, (4, FEATURES), jnp.float32))
    p, q = to_torch(post).requires_grad_(), to_torch(prior).requires_grad_()
    sp, sq = dist.make_state(p), dist.make_state(q)
    got = {
        "make_state": lambda: torch.cat([sp.mean, sp.std], -1),
        "sample": lambda: dist.sample(sp, normal=normal),
        "rsample": lambda: dist.rsample(sp, normal=normal),
        "mode": lambda: dist.mode(sp),
        "kl": lambda: dist.kl(sp, sq),
        "balanced_kl": lambda: dist.balanced_kl(sp, sq, 0.8, per_sample=True),
    }[method]()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL, atol=1e-6)
    cot = torch.linspace(0.5, 1.5, got.numel()).reshape(got.shape)
    if got.requires_grad:
        got_grads = torch.autograd.grad((got * cot).sum(), (p, q), allow_unused=True)
    else:
        got_grads = (None, None)
    for g, w in zip(got_grads, want_grads):
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=1e-6)
    assert float(sp.std[0].detach().max()) == pytest.approx(1e-4, rel=1e-3)


def test_continuous_plan_refuses_discrete_noise_and_draws_from_the_generator():
    dist = PlanDistribution(kind="continuous", plan_features=FEATURES)
    state = ContinuousPlanState(torch.zeros(2, FEATURES), torch.ones(2, FEATURES))
    with pytest.raises(ValueError, match="normal="):
        dist.sample(state, gumbel=torch.zeros(2, FEATURES))
    with pytest.raises(ValueError, match="normal="):
        dist.rsample_balanced_kl(state, state, 0.8, uniform=torch.zeros(2, FEATURES))
    a = dist.sample(state, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, torch.randn(2, FEATURES, generator=torch.Generator().manual_seed(3)))
    sample, kl = dist.rsample_balanced_kl(state, state, 0.8, normal=a)
    assert torch.equal(sample, a) and torch.equal(kl, torch.zeros(2))


# ---------------------------------------------------------------------------
# training losses and gradients
# ---------------------------------------------------------------------------

def _check_losses(got, want):
    keys = set(LOSS_KEYS) | {f"{k}_{s}" for k in ("action_loss", "kl_loss_scaled", "total_loss") for s in ("vis", "lang")}
    assert keys <= set(got) and keys <= set(want)
    for k in sorted(keys):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert float(want["lang_clip_loss"]) == 0.0 and float(want["kl_loss"]) > 0.0


def _check_grads(model, want):
    got, unused = convert_state_dict({k: p.grad.numpy() for k, p in model.named_parameters()}, JAX_CFG)
    assert unused == []
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [p for p, _ in flat(got)] == [p for p, _ in flat(want)]
    birnn, zero = 0, []
    for (path, g), (_, w) in zip(flat(got), flat(want)):
        name, g, w = jax.tree_util.keystr(path), np.asarray(g), np.asarray(w)
        birnn += "birnn" in name
        if not np.any(w):
            # the last layer's reverse W_hh: seq_feat reads that chain's
            # first step only, whose state was the zero h0
            np.testing.assert_array_equal(g, w, err_msg=name)
            zero.append(name)
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, f"{name}: relative L2 error {err}"
    assert birnn == 16  # 2 layers x 2 directions x (W_ih, b_ih, W_hh, b_hh)
    assert zero == ["['plan_recognition']['birnn']['bwd_1']['hh_0']"]


@pytest.mark.parametrize("schema", ["fused", "split"])
def test_train_losses_and_grads_match_jax(setup, schema):
    """``train_losses`` on the loader-fused {"fused": 2B} batch (one pass)
    and on {"vis", "lang"} (a pass per modality, each with its own plan
    noise), eval preprocessing: every loss key within rtol 1e-5, every
    parameter's gradient within 1e-4 relative L2."""
    jax_model, params, raw, _ = setup
    batch = CombinedLoader.fuse_batch(raw) if schema == "fused" else raw
    key = jax.random.key(64)
    prep = jax_preprocess_batch(JAX_CFG, batch, rng=None, train=False)

    def loss_fn(p):
        out = jax_model.apply({"params": p}, key, prep, KL_BETA, method=jax_model.train_losses)
        return out["total_loss"], out

    grads, want = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    if schema == "fused":
        normal = jax_plan_noise(jax.random.split(key)[1], 2 * B, JAX_CFG)["normal"]
    else:
        k_vis, k_lang = (jax.random.split(k)[1] for k in (key, jax.random.split(key)[0]))
        normal = {"vis": jax_plan_noise(k_vis, B, JAX_CFG)["normal"],
                  "lang": jax_plan_noise(k_lang, B, JAX_CFG)["normal"]}
    model, _ = port_model_from_jax(params, PORT_CFG)
    got = model.train().train_losses(
        preprocess_batch(PORT_CFG, batch_to_device(_port_batch(batch), "cpu"), train=False), KL_BETA, normal=normal
    )
    got["total_loss"].backward()
    _check_losses(got, jax.device_get(want))
    _check_grads(model, jax.device_get(grads))


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _window_uniforms(key, b, s, cfg):
    """The uniforms JAX's logistic_mixture_sample draws for a (b, s) window
    of all seven continuous dimensions."""
    u_mix, u_inv = jax_mixture_uniforms(key, b * s, cfg)
    a = cfg.action_decoder.out_features
    return u_mix.reshape(b, s, a, -1), u_inv.reshape(b, s, a)


def _val_noise(key, scopes, b, s, cfg):
    """The noise JAX's val_metrics draws, by scope (a key split per scope in
    key order, then lmp_val's four-way split)."""
    out = {}
    for scope in sorted(scopes):
        key, k = jax.random.split(key)
        k_pp, k_pr, k_act_pp, k_act_pr = jax.random.split(k, 4)
        noise = {}
        for tag, k_plan, k_act in (("pp", k_pp, k_act_pp), ("pr", k_pr, k_act_pr)):
            noise[f"normal_{tag}"] = jax_plan_noise(k_plan, b, cfg)["normal"]
            noise[f"u_mix_{tag}"], noise[f"u_inv_{tag}"] = _window_uniforms(k_act, b, s, cfg)
        out[scope] = noise
    return out


def test_val_metrics_match_jax(setup):
    jax_model, params, raw, model = setup
    prep = jax_preprocess_batch(JAX_CFG, raw, rng=None, train=False)
    key = jax.random.key(65)
    want = jax.device_get(jax.jit(
        lambda p, k, b: jax_model.apply({"params": p}, k, b, KL_BETA, method=jax_model.val_metrics)
    )(params, key, prep))
    batch = preprocess_batch(PORT_CFG, batch_to_device(_port_batch(raw), "cpu"), train=False)
    with torch.no_grad():
        got = model.eval().val_metrics(batch, KL_BETA, noise=_val_noise(key, raw, B, S, JAX_CFG))
    assert set(got) == set(want) and "val_pred_clip_loss" not in got
    for k in sorted(want):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if "gripper_sr" in k:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif "mae" in k or "sampled_plan" in k:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert float(want["vis_kl_loss"]) > 0.0


# ---------------------------------------------------------------------------
# policies, live and served
# ---------------------------------------------------------------------------

class _JaxPolicyNoise:
    """The noise JAX's ``HulcPolicy`` draws from its key schedule, as the
    port's ``HulcPolicy.step(noise=)`` takes it."""

    def __init__(self, seed):
        self.base = self.rng = jax.random.key(seed)

    def reset(self):
        self.rng = self.base

    def step(self, plans: bool):
        noise = {}
        if plans:
            self.rng, k = jax.random.split(self.rng)
            noise.update(jax_plan_noise(k, 1, JAX_CFG))
        self.rng, k_act = jax.random.split(self.rng)
        noise["u_mix"], noise["u_inv"] = jax_mixture_uniforms(k_act, 1, JAX_CFG)
        return noise


@pytest.fixture(scope="module")
def lang():
    return {TASK: np.random.default_rng(66).normal(size=PORT_CFG.lang_dim).astype(np.float32)}


def test_policy_matches_jax_across_a_replan_and_reset(setup, lang):
    """``HulcPolicy`` on JAX's noise: a language-goal episode of 7 steps
    (replans at 0, 3, 6), ``reset()``, then a visual-goal episode of 4."""
    _, params, _, model = setup
    jax_policy = JaxHulcPolicy(JAX_CFG, jax.tree.map(jnp.asarray, params), lang_embeddings=lang, seed=5)
    policy = HulcPolicy(PORT_CFG, model, lang_embeddings=lang, seed=5)
    noise = _JaxPolicyNoise(5)
    env = fake_env_for(PORT_CFG)
    goal_obs = None
    for episode, steps in enumerate((7, 4)):
        obs = env.reset()
        for p in (jax_policy, policy, noise):
            p.reset()
        goal = TASK if episode == 0 else goal_obs
        for t in range(steps):
            want = jax_policy.step(obs, goal)
            got = policy.step(obs, goal, noise=noise.step(t % JAX_CFG.replan_freq == 0))
            assert got.shape == (7,)
            np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, err_msg=f"episode {episode} step {t}")
            obs = env.step(got)
        goal_obs = obs


def test_batched_policy_matches_jax(setup, lang):
    """``BatchedHulcPolicy`` at 3 lanes on JAX's per-step noise, with mixed
    per-lane replans."""
    _, params, _, model = setup
    jax_policy = JaxBatchedHulcPolicy(JAX_CFG, jax.tree.map(jnp.asarray, params), LANES, seed=9)
    policy = BatchedHulcPolicy(PORT_CFG, model, LANES, seed=9)
    rng = jax.random.key(9)
    envs = [fake_env_for(PORT_CFG) for _ in range(LANES)]
    obs_batch = [e.reset() for e in envs]
    embs = np.stack([lang[TASK]] * LANES)
    s_jax, s_port = jax_policy.initial_state(), policy.initial_state()
    replan = np.ones(LANES, bool)
    for t in range(5):
        want, s_jax = jax_policy.step(obs_batch, embs, s_jax, replan)
        rng, k = jax.random.split(rng)
        got, s_port = policy.step(obs_batch, embs, s_port, replan, noise=jax_batched_step_noise(k, LANES, JAX_CFG))
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, err_msg=f"step {t}")
        np.testing.assert_allclose(s_port[0].numpy(), np.asarray(s_jax[0]), atol=ATOL, rtol=0)
        obs_batch = [e.step(a) for e, a in zip(envs, got)]
        replan = np.array([t % 2 == 0, False, t == 1])


def test_served_artifact_is_bit_equal_to_the_live_policy(setup, lang, tmp_path):
    """An ``mcil_debug`` artifact exported on the CPU: its noise is the
    Normal plan's draw, and ``ServedPolicy`` (across replans and a
    ``reset()``) and ``ServedBatchedPolicy`` (mixed replans) give the live
    policies' actions bit for bit."""
    _, _, _, model = setup
    export_policy(PORT_CFG, model.state_dict(), tmp_path, lang_embeddings=lang, lanes=LANES, device="cpu")
    meta = json.loads((tmp_path / "meta.json").read_text())
    ad = PORT_CFG.action_decoder
    assert meta["noise"]["order"] == ["normal", "u_mix", "u_inv"] and "gumbel" not in meta["noise"]
    assert meta["noise"]["normal"] == [PORT_CFG.distribution.plan_features]
    assert meta["noise"]["u_mix"] == [1, ad.out_features, ad.n_mixtures] and meta["plan_dim"] == 8

    live, served = HulcPolicy(PORT_CFG, model, lang_embeddings=lang, seed=7), ServedPolicy(tmp_path, seed=7, device="cpu")
    env = fake_env_for(PORT_CFG)
    for steps in (7, 4):
        obs = env.reset()
        live.reset()
        served.reset()
        for _ in range(steps):
            a_live, a_served = live.step(obs, TASK), served.step(obs, TASK)
            np.testing.assert_array_equal(a_served, a_live)
            obs = env.step(a_live)

    live_b = BatchedHulcPolicy(PORT_CFG, model, LANES, seed=11)
    served_b = ServedBatchedPolicy(tmp_path, seed=11, device="cpu")
    envs = [fake_env_for(PORT_CFG) for _ in range(LANES)]
    obs_batch = [e.reset() for e in envs]
    embs = np.stack([lang[TASK]] * LANES)
    s_live, s_served = live_b.initial_state(), served_b.initial_state()
    replan = np.ones(LANES, bool)
    for t in range(4):
        a_live, s_live = live_b.step(obs_batch, embs, s_live, replan)
        a_served, s_served = served_b.step(obs_batch, embs, s_served, replan)
        np.testing.assert_array_equal(a_served, a_live)
        obs_batch = [e.step(a) for e, a in zip(envs, a_live)]
        replan = np.array([t % 2 == 0, False, t == 1])


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def test_fit_two_steps_and_restore_bit_equal(tmp_path):
    """``Trainer.fit`` on an ``mcil_debug`` model over a fixture dataset:
    two steps and a validation, finite losses, and the checkpoint restores
    the parameters, the Adam state, the step and the generator bit-equal."""
    cfg = port_config.get_config("mcil_debug")
    root = make_fixture_dataset(tmp_path / "data", num_episodes=2, episode_len=16)
    loader = dict(batch_size=2, min_window=6, max_window=8)
    train = make_loaders(cfg, root, fuse=True, seed=0, **loader)
    val = make_loaders(cfg, root, split="validation", deterministic=True, **loader)
    tcfg = dict(log_every=1, val_max_batches=1)
    trainer = Trainer(cfg, TrainerConfig(run_dir=str(tmp_path / "run"), **tcfg), device="cpu")
    assert trainer.fit(train, val, max_epochs=1, max_steps=2) == 2
    records = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert {r["prefix"] for r in records} >= {"train", "val"}
    assert all(np.isfinite(v) for r in records for k, v in r.items() if k != "prefix")

    other = Trainer(cfg, TrainerConfig(run_dir=str(tmp_path / "other"), seed=7, **tcfg), device="cpu")
    other.init_state(1)
    other.restore(ckpt.latest_checkpoint(tmp_path / "run"))
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    a, b = trainer.optimizer.checkpoint_state(), other.optimizer.checkpoint_state()
    assert a["count"] == b["count"]
    for key in ("exp_avg", "exp_avg_sq"):
        assert all(torch.equal(m, n) for m, n in zip(a[key], b[key]))
    assert other.step == trainer.step == 2
    assert torch.equal(other.generator.get_state(), trainer.generator.get_state())
