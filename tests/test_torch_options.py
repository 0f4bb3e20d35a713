"""Dropout at every site where the JAX package has it, and the encoders'
options, in the port against the JAX package on the CPU.

Dropout: the test replaces each flax ``nn.Dropout`` call of the JAX
reference (test-side only, through ``flax.linen.intercept_methods``) with
flax's own ``where(keep, x / keep_prob, 0)`` on a mask drawn with numpy,
and hands the port the same masks site by site
(``layers.feed_dropout_masks``): the decoder's ``ScanRNN`` of each cell and
the ``ScanBiRNN`` of each cell as modules, then ``mcil_debug`` (gru BiRNN)
with dropout at all four of its sites: train losses (rtol 1e-5) and every
gradient (1e-4 relative L2). Eval mode draws nothing. The options
(``use_sinusoid``, ``l2_normalize_output``, the goal encoders'
``l2_normalize``, sinusoidal positions, ``positional_normalize``,
``encoder_normalize``), each on alone, against the JAX module at
``hulc_debug``, and all on at once through the train losses and
gradients; an exported policy whose decoder has ``rnn_dropout`` serves bit
for bit as the live one."""

import dataclasses

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_raw_batch
from hulc_tpu import config as jax_config
from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.models.layers import ScanBiRNN as JaxScanBiRNN
from hulc_tpu.models.layers import ScanRNN as JaxScanRNN
from hulc_tpu.models.plan_nets import sinusoidal_position_encoding as jax_sinusoid
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.convert import params_from_jax
from hulc_tpu_torch.evaluation.fake_env import fake_env_for
from hulc_tpu_torch.evaluation.policy import HulcPolicy
from hulc_tpu_torch.models.hulc import LOSS_KEYS, ModalityBatch
from hulc_tpu_torch.models.layers import Dropout, ScanBiRNN, ScanRNN, feed_dropout_masks, set_dropout_generator
from hulc_tpu_torch.models.plan_nets import sinusoidal_position_encoding
from hulc_tpu_torch.ops.recurrence import GATES
from hulc_tpu_torch.serving import ServedPolicy, export_policy
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from tests.torch_port_common import jax_call, jax_gumbel, jax_plan_noise, jax_random_params, port_model_from_jax

torch.set_num_threads(1)

B, S, F_IN, H = 3, 6, 9, 12
RATE = 0.3  # a high rate: many units dropped in a small test
LOSS_RTOL, GRAD_REL, ATOL = 1e-5, 1e-4, 1e-5
ZERO_GRAD = 1e-7  # share of the whole gradient's norm below which a leaf's is rounding noise
KL_BETA = 0.01


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class JaxMasks:
    """A ``flax.linen.intercept_methods`` interceptor: each training-mode
    ``nn.Dropout`` call of the JAX reference returns flax's
    ``where(keep, x / keep_prob, 0)`` on a keep mask drawn with numpy
    (``masks[path]``, one per call in call order), instead of drawing from
    JAX's key."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks = {}

    def __call__(self, next_fun, args, kwargs, context):
        module = context.module
        if not isinstance(module, flax_nn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        deterministic = flax_nn.merge_param("deterministic", module.deterministic, kwargs.get("deterministic"))
        if module.rate == 0.0 or deterministic:
            return next_fun(*args, **kwargs)
        keep = self.rng.random(x.shape) >= module.rate
        self.masks.setdefault("/".join(module.scope.path), []).append(keep)
        keep_prob = 1.0 - module.rate
        return jax.lax.select(jnp.asarray(keep), x / keep_prob, jnp.zeros_like(x))

    def fed(self, sites):
        """The masks as ``feed_dropout_masks`` takes them: ``sites`` maps a
        JAX module path to the port's site."""
        assert set(self.masks) == set(sites), (sorted(self.masks), sorted(sites))
        return {sites[path]: [torch.from_numpy(k) for k in masks] for path, masks in self.masks.items()}


# ---------------------------------------------------------------------------
# the RNNs' dropout between layers, module by module
# ---------------------------------------------------------------------------

def _rnn_tree(rng, cell, in_features, hidden, layers):
    g = GATES.get(cell, 1)

    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32) / np.sqrt(hidden)

    tree = {}
    for k in range(layers):
        tree[f"ih_{k}"] = {"kernel": u(in_features if k == 0 else hidden, g * hidden), "bias": u(g * hidden)}
        tree[f"hh_{k}"] = u(hidden, g * hidden)
        tree[f"bhh_{k}"] = u(g * hidden)
    return tree


def _port_layer(tree, k, suffix="", src_k=None):
    j = k if src_k is None else src_k
    return {f"weight_ih_l{k}{suffix}": _t(tree[f"ih_{j}"]["kernel"].T), f"bias_ih_l{k}{suffix}": _t(tree[f"ih_{j}"]["bias"]),
            f"weight_hh_l{k}{suffix}": _t(tree[f"hh_{j}"].T), f"bias_hh_l{k}{suffix}": _t(tree[f"bhh_{j}"])}


def _grads_match(net, want_tree, pairs):
    grads = dict(net.named_parameters())
    for port_name, want in pairs(want_tree):
        err = _rel_l2(grads[port_name].grad.numpy(), want)
        assert err <= 1e-5, (port_name, err)


@pytest.mark.parametrize("cell", ["rnn", "gru", "lstm"])
def test_scan_rnn_dropout_matches_jax_on_its_masks(cell):
    """The decoder's ``ScanRNN`` of each cell, 3 layers (two dropout sites:
    ``dropouts.0``, ``dropouts.1``), in train mode on JAX's masks: the
    output, the final carry and every gradient within 1e-5; in eval mode
    it draws nothing and is the dropout-free RNN."""
    layers = 3
    rng = np.random.default_rng(21)
    tree = _rnn_tree(rng, cell, F_IN, H, layers)
    x = rng.normal(size=(B, S, F_IN)).astype(np.float32)
    dy = rng.normal(size=(B, S, H)).astype(np.float32)
    module = JaxScanRNN(hidden_size=H, num_layers=layers, cell=cell, dropout=RATE)
    masks = JaxMasks(22)

    def loss(p, xin):
        with flax_nn.intercept_methods(masks):
            y, _ = module.apply({"params": p}, xin, deterministic=False)
        return jnp.sum(y * dy), y

    (_, want_y), (want_dp, want_dx) = jax_call(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True), tree, x)
    net = ScanRNN(F_IN, H, layers, cell, dropout=RATE)
    net.load_state_dict({k: v for i in range(layers) for k, v in _port_layer(tree, i).items()}, strict=True)
    assert [n for n, m in net.named_modules() if isinstance(m, Dropout)] == ["dropouts.0", "dropouts.1"]
    feed_dropout_masks(net, masks.fed({"Dropout_0": "dropouts.0", "Dropout_1": "dropouts.1"}))
    xt = _t(x).requires_grad_()
    y, _ = net.train()(xt)
    y.backward(_t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=ATOL, rtol=0)
    assert _rel_l2(xt.grad.numpy(), want_dx) <= 1e-5
    _grads_match(net, want_dp, lambda t: [(f"{n}_l{k}", w) for k in range(layers) for n, w in (
        ("weight_ih", np.asarray(t[f"ih_{k}"]["kernel"]).T), ("bias_ih", t[f"ih_{k}"]["bias"]),
        ("weight_hh", np.asarray(t[f"hh_{k}"]).T), ("bias_hh", t[f"bhh_{k}"]))])
    assert all(not m.masks for m in net.modules() if isinstance(m, Dropout))  # each fed mask taken once
    with torch.no_grad():
        got_eval = net.eval()(_t(x))[0]
    want_eval = jax_call(lambda p, xin: module.apply({"params": p}, xin, deterministic=True)[0], tree, x)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cell", ["rnn_tanh", "rnn", "gru"])
def test_scan_birnn_dropout_matches_jax_on_its_masks(cell):
    """``ScanBiRNN`` of each ported cell, 2 layers, dropout on layer 0's
    (B, S, 2H) output (``dropouts.0``) on JAX's mask: the output and every
    gradient within 1e-5 relative L2."""
    layers = 2
    rng = np.random.default_rng(23)
    tree = {f"{d}_{k}": _rnn_tree(rng, cell, F_IN if k == 0 else 2 * H, H, 1) for k in range(layers)
            for d in ("fwd", "bwd")}
    x = rng.normal(size=(B, S, F_IN)).astype(np.float32)
    dy = rng.normal(size=(B, S, 2 * H)).astype(np.float32)
    module = JaxScanBiRNN(hidden_size=H, num_layers=layers, cell=cell, dropout=RATE)
    masks = JaxMasks(24)

    def loss(p, xin):
        with flax_nn.intercept_methods(masks):
            y = module.apply({"params": p}, xin, deterministic=False)
        return jnp.sum(y * dy), y

    (_, want_y), want_dp = jax_call(jax.value_and_grad(loss, has_aux=True), tree, x)
    net = ScanBiRNN(F_IN, H, layers, cell, dropout=RATE)
    net.load_state_dict({k: v for i in range(layers) for d, sfx in (("fwd", ""), ("bwd", "_reverse"))
                         for k, v in _port_layer(tree[f"{d}_{i}"], i, sfx, 0).items()}, strict=True)
    feed_dropout_masks(net, masks.fed({"Dropout_0": "dropouts.0"}))
    y = net.train()(_t(x))
    y.backward(_t(dy))
    assert _rel_l2(y.detach().numpy(), want_y) <= 1e-5
    _grads_match(net, want_dp, lambda t: [(f"{n}_l{k}{sfx}", w) for k in range(layers)
                                          for d, sfx in (("fwd", ""), ("bwd", "_reverse")) for n, w in (
        ("weight_ih", np.asarray(t[f"{d}_{k}"]["ih_0"]["kernel"]).T), ("bias_ih", t[f"{d}_{k}"]["ih_0"]["bias"]),
        ("weight_hh", np.asarray(t[f"{d}_{k}"]["hh_0"]).T), ("bias_hh", t[f"{d}_{k}"]["bhh_0"]))])


def test_fed_masks_are_checked_and_the_generator_still_draws():
    """A fed mask of the wrong shape, a site fed too few masks, an unknown
    site: each raises. Without fed masks a site draws from its generator,
    and a generator seeded alike draws the same masks; eval mode takes no
    mask and draws nothing."""
    net = ScanRNN(F_IN, H, 2, "rnn", dropout=RATE)
    with torch.no_grad():
        for p in net.parameters():
            p.uniform_(-0.3, 0.3, generator=torch.Generator().manual_seed(6))
    x = torch.randn(B, S, F_IN)
    with pytest.raises(KeyError, match="no dropout site"):
        feed_dropout_masks(net, {"dropouts.7": []})
    feed_dropout_masks(net, {"dropouts.0": [torch.ones(B, S, H + 1, dtype=torch.bool)]})
    with pytest.raises(ValueError, match="shape"):
        net.train()(x)
    feed_dropout_masks(net, {"dropouts.0": []})
    with pytest.raises(RuntimeError, match="fewer masks"):
        net(x)
    feed_dropout_masks(net, None)
    with pytest.raises(RuntimeError, match="generator"):
        net(x)
    outs = []
    for _ in range(2):
        set_dropout_generator(net, torch.Generator().manual_seed(5))
        outs.append(net(x)[0])
    assert torch.equal(*outs)
    feed_dropout_masks(net, {"dropouts.0": [torch.zeros(B, S, H, dtype=torch.bool)]})
    net.eval()(x)
    assert len(net.dropouts[0].masks) == 1


# ---------------------------------------------------------------------------
# mcil_debug with dropout at every site: the train losses and gradients
# ---------------------------------------------------------------------------

ROWS, FRAMES = 3, 5
# JAX's Dropout paths on the mcil path and the port's sites
MCIL_SITES = {
    "perceptual_encoder/rgb_static/Dropout_0": "perceptual_encoder.rgb_static_encoder.dropout",
    "perceptual_encoder/rgb_gripper/Dropout_0": "perceptual_encoder.rgb_gripper_encoder.dropout",
    "plan_recognition/birnn/Dropout_0": "plan_recognition.birnn_model.dropouts.0",
    "action_decoder/rnn/Dropout_0": "action_decoder.rnn.dropouts.0",
}


def _dropout_cfg(m):
    """``mcil_debug`` with an 84 px gripper camera, the gru BiRNN and
    dropout at every site the JAX package has on this path, set as a user
    sets them."""
    cfg = m.get_config("mcil_debug", replan_freq=3)
    pe = cfg.perceptual_encoder
    pe = dataclasses.replace(pe, rgb_gripper=dataclasses.replace(pe.rgb_gripper, input_size=84))
    return m.apply_overrides(dataclasses.replace(cfg, perceptual_encoder=pe), [
        "plan_recognition.birnn_cell=gru", f"plan_recognition.birnn_dropout={RATE}",
        f"action_decoder.rnn_dropout={RATE}", f"perceptual_encoder.rgb_static.dropout={RATE}",
        f"perceptual_encoder.rgb_gripper.dropout={RATE}"])


def _port_grads_match(model, want_grads, cfg, skip=()):
    """Every parameter's gradient against JAX's, in the port's layout
    (``params_from_jax`` of JAX's gradient tree): 1e-4 relative L2, or
    rounding noise on both sides where JAX's is (ZERO_GRAD of the whole)."""
    want, unused = params_from_jax(jax.tree.map(np.asarray, want_grads), cfg)
    assert unused == []
    total = np.sqrt(sum(float(np.sum(np.square(w.numpy().astype(np.float64)))) for w in want.values()))
    checked = 0
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        if np.linalg.norm(w) <= ZERO_GRAD * total:
            assert np.linalg.norm(g) <= ZERO_GRAD * total, name
            continue
        if name.startswith(skip):
            continue
        assert _rel_l2(g, w) <= GRAD_REL, (name, _rel_l2(g, w))
        checked += 1
    return checked


def test_mcil_dropout_at_every_site_matches_jax_on_its_masks():
    """``train_losses`` of ``mcil_debug`` (gru BiRNN) with dropout at the
    static and gripper encoders, between the BiRNN's layers and between the
    decoder's, on a loader-fused batch with JAX's plan noise and JAX's
    masks fed site by site: every loss within rtol 1e-5 and every gradient
    within 1e-4 relative L2. Each site takes one mask a step (the fused
    pass), of the shape JAX drew. The weights and the batch are
    tests/test_torch_mcil.py's draw (the BiRNN's cell and the dropout
    rates change no tower's weights or frames): in another draw a relu of
    the static tower sat 1.5e-8 from zero, where XLA's and PyTorch's
    convolutions round to opposite sides, and its first two convolutions'
    gradients moved by 5e-3-1e-2 with dropout or without."""
    jax_cfg, cfg = _dropout_cfg(jax_config), _dropout_cfg(port_config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    jax_model, params = jax_random_params(jax_cfg, seed=60)
    raw = _make_raw_batch(jax_cfg, ROWS, FRAMES, seed=61)
    raw["lang"] = raw["lang"]._replace(use_for_aux_lang_loss=np.array([True, False, True]))
    batch = CombinedLoader.fuse_batch(raw)
    key = jax.random.key(92)
    prep = jax_preprocess_batch(jax_cfg, batch, rng=None, train=False)
    masks = JaxMasks(93)

    def loss_fn(p):
        with flax_nn.intercept_methods(masks):
            out = jax_model.apply({"params": p}, key, prep, KL_BETA, method=jax_model.train_losses)
        return out["total_loss"], out

    grads, want = jax_call(jax.grad(loss_fn, has_aux=True), params)
    assert {k: len(v) for k, v in masks.masks.items()} == dict.fromkeys(MCIL_SITES, 1)
    assert masks.masks["plan_recognition/birnn/Dropout_0"][0].shape == (2 * ROWS, FRAMES, 64)
    model, _ = port_model_from_jax(params, cfg)
    feed_dropout_masks(model, masks.fed(MCIL_SITES))
    normal = jax_plan_noise(jax.random.split(key)[1], 2 * ROWS, jax_cfg)["normal"]
    got = model.train().train_losses(
        preprocess_batch(cfg, batch_to_device({k: ModalityBatch(*v) for k, v in batch.items()}, "cpu"), train=False),
        KL_BETA, normal=normal)
    got["total_loss"].backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert _port_grads_match(model, grads, cfg) > 40
    assert all(not m.masks for m in model.modules() if isinstance(m, Dropout))


# ---------------------------------------------------------------------------
# the encoders' options
# ---------------------------------------------------------------------------

def _options_cfg(m, options):
    """``hulc_debug`` with an 84 px gripper camera, the recognition
    transformer's dropout 0 (its attention dropout is no ``nn.Dropout``
    that the masks could be fed through) and ``options`` set by
    ``apply_overrides``."""
    cfg = m.get_config("hulc_debug", replan_freq=3)
    pe = cfg.perceptual_encoder
    pe = dataclasses.replace(pe, rgb_gripper=dataclasses.replace(pe.rgb_gripper, input_size=84))
    cfg = dataclasses.replace(cfg, perceptual_encoder=pe,
                              plan_recognition=dataclasses.replace(cfg.plan_recognition, dropout=0.0))
    return m.apply_overrides(cfg, list(options))


def _setup(options, seed):
    jax_cfg, cfg = _options_cfg(jax_config, options), _options_cfg(port_config, options)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    jax_model, params = jax_random_params(jax_cfg, seed=seed)
    raw = _make_raw_batch(jax_cfg, ROWS, FRAMES, seed=seed + 1)
    model, unused = port_model_from_jax(params, cfg)
    assert unused == []
    return jax_cfg, cfg, jax_model, params, raw, model


ENCODER_OPTIONS = {
    "use_sinusoid": ["perceptual_encoder.rgb_static.use_sinusoid=true"],
    "l2_normalize_output": ["perceptual_encoder.rgb_static.l2_normalize_output=true",
                            "perceptual_encoder.rgb_gripper.l2_normalize_output=true"],
}


@pytest.mark.parametrize("option", list(ENCODER_OPTIONS))
def test_vision_encoder_option_matches_jax(option):
    """The perceptual encoder (static and gripper towers) with the option on,
    eval mode, against JAX's ``encode`` on the same frames: rtol 1e-5 (the
    sinusoid widens fc1 to 384 inputs)."""
    jax_cfg, cfg, jax_model, params, raw, model = _setup(ENCODER_OPTIONS[option], seed=100)
    prep = jax_preprocess_batch(jax_cfg, raw, rng=None, train=False)["vis"]
    want, _ = jax_call(lambda p, b: jax_model.apply({"params": p}, b, method=lambda m, b: m.encode(b)), params, prep)
    b = preprocess_batch(cfg, batch_to_device({"vis": ModalityBatch(*raw["vis"])}, "cpu"), train=False)["vis"]
    with torch.no_grad():
        got, _ = model.eval().encode(b.rgb_obs(), b.robot_obs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    fc1 = model.perceptual_encoder.rgb_static_encoder.fc1[0]
    assert fc1.in_features == (384 if option == "use_sinusoid" else 128)


@pytest.mark.parametrize("goal", ["visual_goal", "language_goal"])
def test_goal_encoder_l2_normalize_matches_jax(goal):
    """A goal encoder with ``l2_normalize``: its output (the fp32 norm's
    division, then the LayerNorm) against JAX's within rtol 1e-5."""
    jax_cfg, cfg, jax_model, params, _, model = _setup([f"{goal}.l2_normalize=true"], seed=102)
    width = getattr(cfg, goal).in_features
    x = np.random.default_rng(103).normal(size=(4, width)).astype(np.float32)
    method = {"visual_goal": lambda m, v: m.encode_visual_goal(v),
              "language_goal": lambda m, v: m.encode_language_goal(v)}[goal]
    want = jax_call(lambda p, v: jax_model.apply({"params": p}, v, method=method), params, x)
    with torch.no_grad():
        got = getattr(model.eval(), f"encode_{goal}")(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


RECOGNITION_OPTIONS = {
    "sinusoidal positions": ["plan_recognition.position_embedding=false"],
    "positional_normalize": ["plan_recognition.positional_normalize=true"],
    "encoder_normalize": ["plan_recognition.encoder_normalize=true"],
}


@pytest.mark.parametrize("option", list(RECOGNITION_OPTIONS))
def test_recognition_transformer_option_matches_jax(option):
    """The recognition transformer with the option on, eval mode: its plan
    state and seq_feat against JAX's within rtol 1e-5; the weights carried
    by ``params_from_jax`` (``positional_norm``, ``encoder/final_norm``;
    no position table with sinusoidal positions)."""
    jax_cfg, cfg, jax_model, params, _, model = _setup(RECOGNITION_OPTIONS[option], seed=104)
    pr = params["plan_recognition"]
    assert ("position_embeddings" in pr) == (option != "sinusoidal positions")
    assert ("positional_norm" in pr) == (option == "positional_normalize")
    assert ("final_norm" in pr["encoder"]) == (option == "encoder_normalize")
    x = np.random.default_rng(105).normal(size=(4, FRAMES, cfg.plan_recognition.in_features)).astype(np.float32)

    def recognize(m, v):
        state, seq_feat = m.plan_recognition(v)
        return state.logit, seq_feat

    want_logits, want_feat = jax_call(lambda p, v: jax_model.apply({"params": p}, v, method=recognize), params, x)
    with torch.no_grad():
        state, feat = model.eval().plan_recognition(_t(x))
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.logit.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d_model", [8, 9, 32])
def test_sinusoidal_position_encoding_matches_jax(d_model):
    """The fixed positions, an odd width too (the last cos column dropped)."""
    got = sinusoidal_position_encoding(7, d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_sinusoid(7, d_model)), rtol=1e-6, atol=1e-6)


ALL_OPTIONS = [o for opts in (*ENCODER_OPTIONS.values(), *RECOGNITION_OPTIONS.values()) for o in opts] + [
    "visual_goal.l2_normalize=true", "language_goal.l2_normalize=true"]
CLIP_HEAD = ("proj_vis_lang.", "logit_scale")


def test_all_options_train_losses_and_grads_match_jax():
    """``hulc_debug`` with every option on: ``train_losses`` on the fused
    batch with JAX's Gumbel noise, every loss within rtol 1e-5 and every
    gradient within 1e-4 relative L2 (compared in the port's layout: JAX's
    own converter knows neither new LayerNorm). The CLIP head's are left
    to tests/test_torch_train_step.py: its last bias's gradient is a sum
    over six windows that cancels to about 1e-3 of its terms."""
    jax_cfg, cfg, jax_model, params, raw, model = _setup(ALL_OPTIONS, seed=106)
    raw["lang"] = raw["lang"]._replace(use_for_aux_lang_loss=np.array([True, False, True]))
    fused = CombinedLoader.fuse_batch(raw)
    key = jax.random.key(107)
    prep = jax_preprocess_batch(jax_cfg, fused, rng=None, train=False)

    def loss_fn(p):
        out = jax_model.apply({"params": p}, key, prep, KL_BETA, method=jax_model.train_losses)
        return out["total_loss"], out

    grads, want = jax_call(jax.grad(loss_fn, has_aux=True), params)
    batch = preprocess_batch(cfg, batch_to_device({k: ModalityBatch(*m) for k, m in fused.items()}, "cpu"),
                             train=False)
    got = model.train().train_losses(batch, KL_BETA, gumbel=jax_gumbel(jax.random.split(key)[1], 2 * ROWS, jax_cfg))
    got["total_loss"].backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert _port_grads_match(model, grads, cfg, skip=CLIP_HEAD) > 40


# ---------------------------------------------------------------------------
# the export: the policy runs in eval mode
# ---------------------------------------------------------------------------

def test_export_with_decoder_dropout_serves_bit_equal(tmp_path):
    """An ``mcil_debug`` policy whose decoder has ``rnn_dropout`` 0.3 (and
    the gru BiRNN with its dropout) exported on the CPU serves the live
    policy's actions bit for bit across replans and a ``reset()``: the
    policy runs in eval mode, where no site draws."""
    cfg = _dropout_cfg(port_config)
    from hulc_tpu_torch.models import make_model

    model = make_model(cfg, "cpu", seed=3)
    lang = {"push_red_block_right": np.random.default_rng(4).normal(size=cfg.lang_dim).astype(np.float32)}
    export_policy(cfg, model.state_dict(), tmp_path, lang_embeddings=lang, lanes=2, device="cpu")
    live, served = HulcPolicy(cfg, model, lang_embeddings=lang, seed=7), ServedPolicy(tmp_path, seed=7, device="cpu")
    env = fake_env_for(cfg)
    for steps in (4, 2):
        obs = env.reset()
        live.reset()
        served.reset()
        for _ in range(steps):
            a_live, a_served = live.step(obs, "push_red_block_right"), served.step(obs, "push_red_block_right")
            np.testing.assert_array_equal(a_served, a_live)
            obs = env.step(a_live)
