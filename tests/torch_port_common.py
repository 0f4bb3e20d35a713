"""Helpers shared by the tests/test_torch_*.py files: weights made by the
JAX package and carried into the port, the noise JAX draws from its keys,
and the checks each variant of tests/test_torch_variants.py and
tests/test_torch_state_aux.py runs."""

import dataclasses
import json

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


def with_tactile(cfg, batch, seed=2):
    """``batch`` with (B, S, 64, 64, 6) preprocessed tactile frames where
    ``cfg`` has a tactile tower (JAX's ``example_batch`` makes none, and a
    model initialized without them builds no tactile tower), and its
    language ``cfg.lang_dim`` wide (``example_batch`` draws 384, so JAX's
    init builds ``hulc_clip_lang``'s language goal encoder 384 wide)."""
    rng = np.random.default_rng(seed)
    b, s = batch.actions.shape[:2]
    tac = cfg.perceptual_encoder.tactile
    if tac is not None:
        batch = batch._replace(rgb_tactile=rng.normal(size=(b, s, tac.input_size, tac.input_size, tac.num_channels))
                               .astype(np.float32))
    if batch.lang is not None and batch.lang.shape[-1] != cfg.lang_dim:
        batch = batch._replace(lang=rng.normal(size=(b, cfg.lang_dim)).astype(np.float32))
    return batch


def _example_batch(cfg):
    return {"vis": with_tactile(cfg, with_depth(cfg, example_batch(cfg, 1, 2))),
            "lang": with_tactile(cfg, with_depth(cfg, example_batch(cfg, 1, 2, lang=True)))}


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


# ---------------------------------------------------------------------------
# the GCBC / deterministic / state-only / auxiliary-loss variants
# (tests/test_torch_variants.py, tests/test_torch_state_aux.py)
# ---------------------------------------------------------------------------

# hulc's auxiliary losses on, with the proprio the state decoder regresses
AUX_OVERRIDES = ["state_recons=true", "perceptual_encoder.use_state_decoder=true", "perceptual_encoder.proprio=default",
                 "use_bc_z_auxiliary_loss=true", "use_mia_auxiliary_loss=true"]
# fetch_vision has no debug preset: its widths cut, its 84 px static camera kept
FETCH_VISION_SMALL = ["perceptual_encoder.rgb_static.visual_features=16", "plan_recognition.encoder_hidden_size=64",
                      "plan_recognition.fc_hidden_size=64", "plan_proposal.hidden_size=64",
                      "visual_goal.hidden_size=32", "visual_goal.latent_goal_features=8",
                      "language_goal.hidden_size=32", "language_goal.latent_goal_features=8",
                      "action_decoder.hidden_size=64", "action_decoder.latent_goal_features=8",
                      "plan_proposal.latent_goal_features=8"]
# each variant at debug width: (preset, overrides), replan every 3 steps and
# the recognition network's dropout 0 (the two frameworks cannot draw the
# same masks)
VARIANTS = {
    "gcbc": ("gcbc_debug", []),
    "deterministic": ("hulc_debug", ["action_decoder.kind=deterministic"]),
    "deterministic_mlp": ("hulc_debug", ["action_decoder.kind=deterministic", "action_decoder.rnn_cell=mlp"]),
    "state_only": ("state_only_debug", []),
    "fetch_state": ("fetch_state_debug", []),
    "fetch_vision": ("fetch_vision", FETCH_VISION_SMALL),
    "aux": ("hulc_debug", AUX_OVERRIDES),
    # hulc_clip_lang's one change to hulc (1024-d language) on hulc_debug: JAX has no debug preset of it
    "clip_lang": ("hulc_debug", ["lang_dim=1024", "language_goal.in_features=1024"]),
}


def variant_cfg(m, name):
    """Variant ``name`` in config module ``m`` (either package's)."""
    preset, overrides = VARIANTS[name]
    return m.apply_overrides(m.get_config(preset), [*overrides, "replan_freq=3", "plan_recognition.dropout=0.0"])


def variant_raw_batch(cfg, b, s, seed):
    """A raw uint8 {"vis", "lang"} batch of any config (its cameras only,
    proprio of its width): gripper commands of +-1, Euler angles in the
    canonical range, the second language window left out of the
    auxiliary losses."""
    from hulc_tpu.models.hulc import ModalityBatch as JaxModalityBatch

    rng = np.random.default_rng(seed)
    pe = cfg.perceptual_encoder
    n_state = pe.proprio.n_state_obs if pe.proprio else 8

    def frames(enc):
        return None if enc is None else rng.integers(0, 255, (b, s, enc.input_size, enc.input_size, 3), dtype=np.uint8)

    def mod(lang):
        actions = np.tanh(rng.normal(size=(b, s, 7))).astype(np.float32)
        actions[..., -1] = rng.choice([-1.0, 1.0], (b, s))
        state = rng.normal(size=(b, s, 15)).astype(np.float32)
        state[..., 3:6] = rng.uniform(-1.2, 1.2, (b, s, 3))
        return JaxModalityBatch(
            rgb_static=frames(pe.rgb_static), rgb_gripper=frames(pe.rgb_gripper),
            robot_obs=rng.normal(size=(b, s, n_state)).astype(np.float32), actions=actions,
            state_info_robot_obs=state,
            lang=rng.normal(size=(b, cfg.lang_dim)).astype(np.float32) if lang else None,
            use_for_aux_lang_loss=(np.arange(b) % 2 == 0) if lang else None,
            idx=np.arange(b) if lang else None,
        )

    return {"vis": mod(False), "lang": mod(True)}


def quick_jit(fn):
    """``fn`` jitted and compiled with QUICK_COMPILE at its first call's
    shapes (one set of shapes per wrapper)."""
    compiled = {}

    def call(*args):
        if "fn" not in compiled:
            compiled["fn"] = jax.jit(fn).lower(*args).compile(QUICK_COMPILE)
        return compiled["fn"](*args)

    return call


def jax_act_noise(key, lanes, cfg):
    """The act step's noise from ``key``: the logistic decoder's uniforms,
    none for the deterministic decoder."""
    if cfg.action_decoder.kind != "logistic":
        return {}
    u_mix, u_inv = jax_mixture_uniforms(key, lanes, cfg)
    return {"u_mix": u_mix, "u_inv": u_inv}


def jax_replan_noise(key, lanes, cfg):
    """A replan's plan noise from ``key``; GCBC draws none."""
    return {} if cfg.model_kind == "gcbc" else jax_plan_noise(key, lanes, cfg)


def jax_variant_step_noise(key, lanes, cfg):
    """``jax_batched_step_noise`` of any variant: only the draws it makes."""
    k_plan, k_act = jax.random.split(key)
    return {**jax_replan_noise(k_plan, lanes, cfg), **jax_act_noise(k_act, lanes, cfg)}


class JaxPolicyNoise:
    """The noise JAX's ``HulcPolicy`` draws from its key schedule (a split
    on every replan and every act, whatever the model draws), as the port's
    ``HulcPolicy.step(noise=)`` takes it."""

    def __init__(self, seed, cfg):
        self.base = self.rng = jax.random.key(seed)
        self.cfg = cfg

    def reset(self):
        self.rng = self.base

    def step(self, plans: bool):
        noise = {}
        if plans:
            self.rng, k = jax.random.split(self.rng)
            noise.update(jax_replan_noise(k, 1, self.cfg))
        self.rng, k_act = jax.random.split(self.rng)
        noise.update(jax_act_noise(k_act, 1, self.cfg))
        return noise


def jax_val_noise(key, scopes, b, s, cfg):
    """The noise JAX's ``val_metrics`` draws, by scope, as the port's takes
    it: a key split per scope in key order; then ``lmp_val``'s four-way
    split (each plan's noise and each decoded window's uniforms), or
    GCBC's one window decoded on the scope's key."""
    ad = cfg.action_decoder
    a = ad.out_features - 1 if ad.discrete_gripper else ad.out_features

    def window(k):
        if ad.kind != "logistic":
            return {}
        u = jax_act_noise(k, b * s, cfg)
        return {"u_mix": u["u_mix"].reshape(b, s, a, -1), "u_inv": u["u_inv"].reshape(b, s, a)}

    out = {}
    for scope in sorted(scopes):
        key, k = jax.random.split(key)
        if cfg.model_kind == "gcbc":
            out[scope] = {f"{n}_pp": v for n, v in window(k).items()}
            continue
        k_pp, k_pr, k_act_pp, k_act_pr = jax.random.split(k, 4)
        noise = {}
        for tag, k_plan, k_act in (("pp", k_pp, k_act_pp), ("pr", k_pr, k_act_pr)):
            noise.update({f"{n}_{tag}": v for n, v in jax_plan_noise(k_plan, b, cfg).items()})
            noise.update({f"{n}_{tag}": v for n, v in window(k_act).items()})
        out[scope] = noise
    return out


def jax_train_noise(key, cfg, b, fused):
    """The plan noise JAX's ``train_losses`` draws from ``key``, as the
    port's takes it: the fused pass's (2B) or a dict by scope; GCBC's none."""
    if cfg.model_kind == "gcbc":
        return {}
    if fused:
        return jax_plan_noise(jax.random.split(key)[1], 2 * b, cfg)
    k_vis, k_lang = (jax.random.split(k)[1] for k in (key, jax.random.split(key)[0]))
    vis, lang = jax_plan_noise(k_vis, b, cfg), jax_plan_noise(k_lang, b, cfg)
    return {k: {"vis": vis[k], "lang": lang[k]} for k in vis}


def grads_in_port_layout(jax_grads, port_cfg):
    """JAX's gradient tree as the port's state_dict (``params_from_jax`` is
    linear: transposes and permutations only)."""
    sd, unused = params_from_jax(jax.tree.map(np.asarray, jax_grads), port_cfg)
    assert unused == []
    return {k: v.numpy() for k, v in sd.items()}


VARIANT_B, VARIANT_S, VARIANT_KL_BETA = 3, 5, 0.01
VARIANT_LOSS_RTOL = 1e-5  # every train loss: fp32 sums in another order
# the whole gradient (every leaf concatenated), relative L2
VARIANT_GRAD_ALL_REL = 1e-5
# each leaf's gradient, relative L2 (the train-step tests' rule) of the
# larger of its own norm and a floor of 1e-1 of the largest leaf's norm:
# the CLIP head's leaves take a cancelling sum at this init, a small
# difference of O(1) terms that fp32 rounds in either framework (on the
# mlp decoder's, measured up to 2.2e-4 of the leaf's own norm and 5.1e-6
# of the largest leaf's; every other variant's leaves within 1e-4 of their own)
VARIANT_GRAD_REL, VARIANT_GRAD_FLOOR = 1e-4, 1e-1
VARIANT_VAL_RTOL = 1e-4  # val metrics, key by key
VARIANT_ATOL = 1e-4  # plans, MAEs and actions: the x100 of the TCP-frame rotation
# the deterministic decoder's TCP-frame criterion (validation; the
# verify skill's frame-transform rule)
VARIANT_TCP_RTOL = 5e-4


def variant_setup(name):
    """JAX's random weights for variant ``name``, a raw batch, and the port's
    model holding the weights (cached by name)."""
    if name not in _VARIANT_CACHE:
        from hulc_tpu import config as jax_config

        from hulc_tpu_torch import config as port_config

        jax_cfg, cfg = variant_cfg(jax_config, name), variant_cfg(port_config, name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
        jax_model, params = jax_random_params(jax_cfg, seed=80)
        raw = variant_raw_batch(jax_cfg, VARIANT_B, VARIANT_S, seed=81)
        model, unused = port_model_from_jax(params, cfg)
        assert unused == []
        _VARIANT_CACHE[name] = {"name": name, "jax_cfg": jax_cfg, "cfg": cfg, "jax_model": jax_model,
                                "params": params, "raw": raw, "model": model,
                                "lang": np.random.default_rng(82).normal(size=cfg.lang_dim).astype(np.float32)}
    return _VARIANT_CACHE[name]


_VARIANT_CACHE = {}


def port_batch(batch, cfg, train=False):
    """A raw batch (JAX's ModalityBatch of numpy arrays) preprocessed by the port on the CPU."""
    from hulc_tpu_torch.models.hulc import ModalityBatch
    from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch

    return preprocess_batch(cfg, batch_to_device({k: ModalityBatch(*v) for k, v in batch.items()}, "cpu"),
                            train=train)


def check_variant_weights(name):
    """``params_from_jax`` uses every leaf of JAX's tree (``variant_setup``
    asserts none unused) and fills every port parameter (the strict load),
    and the counts of numbers are equal; a GCBC model has no plan proposal."""
    v = variant_setup(name)
    leaves = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    model = v["model"]
    assert sum(p.numel() for p in model.parameters()) == sum(int(np.size(x)) for _, x in leaves)
    gcbc = v["cfg"].model_kind == "gcbc"
    assert ("plan_proposal" in v["params"]) != gcbc
    assert (model.plan_proposal is None) == gcbc


def check_variant_train_step(name, schema):
    """``train_losses`` on the loader-fused batch or on {"vis", "lang"}, on
    JAX's plan noise (GCBC draws none): every loss key within rtol 1e-5,
    the whole gradient within 1e-5 relative L2 and each leaf's within 1e-4
    (against VARIANT_GRAD_FLOOR of the largest leaf's norm)."""
    from hulc_tpu.data.loader import CombinedLoader
    from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch

    from hulc_tpu_torch.models.hulc import LOSS_KEYS

    v = variant_setup(name)
    jax_cfg, cfg, jax_model, params = v["jax_cfg"], v["cfg"], v["jax_model"], v["params"]
    fused = schema == "fused"
    batch = CombinedLoader.fuse_batch(v["raw"]) if fused else v["raw"]
    key = jax.random.key(83)
    prep = jax_preprocess_batch(jax_cfg, batch, rng=None, train=False)

    def loss_fn(p):
        out = jax_model.apply({"params": p}, key, prep, VARIANT_KL_BETA, method=jax_model.train_losses)
        return out["total_loss"], out

    grads, want = quick_jit(jax.grad(loss_fn, has_aux=True))(params)
    want = jax.device_get(want)
    model, _ = port_model_from_jax(params, cfg)
    got = model.train().train_losses(port_batch(batch, cfg), VARIANT_KL_BETA,
                                     **jax_train_noise(key, jax_cfg, VARIANT_B, fused))
    got["total_loss"].backward()
    keys = set(LOSS_KEYS) | {f"{k}_{s}" for k in ("action_loss", "kl_loss_scaled", "total_loss") for s in ("vis", "lang")}
    assert keys <= set(got) and set(want) <= set(got)
    for k in sorted(keys):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=VARIANT_LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    want_grads = grads_in_port_layout(grads, cfg)
    assert set(want_grads) == {k for k, _ in model.named_parameters()}
    floor = VARIANT_GRAD_FLOOR * max(np.linalg.norm(w) for w in want_grads.values())
    all_g, all_w = [], []
    for k, p in model.named_parameters():
        w = want_grads[k]
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.linalg.norm(g - w)
        assert err <= VARIANT_GRAD_REL * max(np.linalg.norm(w), floor), f"{k}: |g - w| {err}, |w| {np.linalg.norm(w)}"
        all_g.append(g.ravel()), all_w.append(w.ravel())
    all_g, all_w = np.concatenate(all_g), np.concatenate(all_w)
    assert np.linalg.norm(all_g - all_w) <= VARIANT_GRAD_ALL_REL * np.linalg.norm(all_w)
    return got, want


def check_variant_val(name):
    """``val_metrics`` on JAX's noise, key by key: losses rtol 1e-4 (the
    deterministic decoder's TCP-frame criterion 5e-4), MAEs and plans atol
    1e-4, gripper success rates equal."""
    from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch

    v = variant_setup(name)
    jax_cfg, cfg, jax_model, model = v["jax_cfg"], v["cfg"], v["jax_model"], v["model"]
    key = jax.random.key(84)
    prep = jax_preprocess_batch(jax_cfg, v["raw"], rng=None, train=False)
    want = jax.device_get(quick_jit(
        lambda p, k, b: jax_model.apply({"params": p}, k, b, VARIANT_KL_BETA, method=jax_model.val_metrics)
    )(v["params"], key, prep))
    with torch.no_grad():
        got = model.eval().val_metrics(port_batch(v["raw"], cfg), VARIANT_KL_BETA,
                                       noise=jax_val_noise(key, v["raw"], VARIANT_B, VARIANT_S, jax_cfg))
    assert set(got) == set(want)
    tcp = cfg.action_decoder.kind == "deterministic" and cfg.action_decoder.gripper_control
    for k in sorted(want):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if "gripper_sr" in k:
            # XLA takes the mean as the sum times 1 / n: compare the counts
            n = VARIANT_B * VARIANT_S
            np.testing.assert_array_equal(np.rint(g * n), np.rint(w * n), err_msg=k)
        elif "mae" in k or "sampled_plan" in k:
            np.testing.assert_allclose(g, w, atol=VARIANT_ATOL, rtol=0, err_msg=k)
        else:
            rtol = VARIANT_TCP_RTOL if tcp and "action_loss" in k else VARIANT_VAL_RTOL
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7, err_msg=k)
    return got, want


VARIANT_TASK = "push_red_block_right"


def check_variant_policies(name):
    """``HulcPolicy`` over two episodes (7 steps with replans at 0, 3, 6,
    ``reset()``, 4 steps) and ``BatchedHulcPolicy`` at 3 lanes over 5 steps
    with some lanes replanning, each fed the noise of JAX's key schedule,
    against JAX's ``build_policy_fns`` / ``build_batched_step`` on the same
    keys: actions and carries within 1e-4."""
    from hulc_tpu.evaluation.batched_eval import BatchedHulcPolicy as JaxBatchedHulcPolicy
    from hulc_tpu.evaluation.batched_eval import build_batched_step as jax_build_batched_step
    from hulc_tpu.evaluation.policy import HulcPolicy as JaxHulcPolicy
    from hulc_tpu.evaluation.policy import build_policy_fns as jax_build_policy_fns

    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
    from hulc_tpu_torch.evaluation.fake_env import fake_env_for
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    v = variant_setup(name)
    jax_cfg, cfg = v["jax_cfg"], v["cfg"]
    lang = {VARIANT_TASK: v["lang"]}
    jax_policy = JaxHulcPolicy(jax_cfg, v["params"], lang_embeddings=lang, seed=5)
    replan_lang, _, act = jax_build_policy_fns(jax_policy.model, jax_cfg)
    jax_policy._replan_lang, jax_policy._act = quick_jit(replan_lang), quick_jit(act)
    live = HulcPolicy(cfg, v["model"], lang_embeddings=lang, seed=5)
    noise = JaxPolicyNoise(5, jax_cfg)
    env = fake_env_for(cfg)
    for episode, steps in enumerate((7, 4)):
        obs = env.reset()
        for p in (jax_policy, live, noise):
            p.reset()
        for t in range(steps):
            want = np.asarray(jax_policy.step(obs, VARIANT_TASK))
            got = live.step(obs, VARIANT_TASK, noise=noise.step(t % cfg.replan_freq == 0))
            assert got.shape == (7,)
            np.testing.assert_allclose(got, want, atol=VARIANT_ATOL, rtol=0, err_msg=f"episode {episode} step {t}")
            obs = env.step(got)

    jax_batched = JaxBatchedHulcPolicy(jax_cfg, v["params"], 3, seed=9)
    jax_batched._step = quick_jit(jax_build_batched_step(jax_batched.model, jax_cfg))
    batched = BatchedHulcPolicy(cfg, v["model"], 3, seed=9)
    rng = jax.random.key(9)
    envs = [fake_env_for(cfg) for _ in range(3)]
    obs_batch = [e.reset() for e in envs]
    embs = np.stack([v["lang"]] * 3)
    s_jax, s_live = jax_batched.initial_state(), batched.initial_state()
    assert s_live[0].shape == tuple(s_jax[0].shape)
    replan = np.ones(3, bool)
    for t in range(5):
        want, s_jax = jax_batched.step(obs_batch, embs, s_jax, replan)
        rng, k = jax.random.split(rng)
        got, s_live = batched.step(obs_batch, embs, s_live, replan, noise=jax_variant_step_noise(k, 3, jax_cfg))
        np.testing.assert_allclose(got, np.asarray(want), atol=VARIANT_ATOL, rtol=0, err_msg=f"step {t}")
        for g, w in zip(jax.tree.leaves(s_live), jax.tree.leaves(s_jax)):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=VARIANT_ATOL, rtol=0, err_msg=f"state {t}")
        obs_batch = [e.step(a) for e, a in zip(envs, got)]
        replan = np.array([t % 2 == 0, False, t == 1])


def check_variant_export(name, out_dir):
    """The export served without model code, bit-equal to the live
    policies on the same noise: a language episode across replans, a
    ``reset()`` and a visual-goal episode, and 3 lanes with some replanning
    (``meta.json``'s noise lists only the draws the model makes); each
    program holds the ops its variant launches."""
    from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
    from hulc_tpu_torch.evaluation.fake_env import fake_env_for
    from hulc_tpu_torch.evaluation.policy import HulcPolicy
    from hulc_tpu_torch.serving import ServedBatchedPolicy, ServedPolicy, export_policy
    from hulc_tpu_torch.serving.export import expected_op_counts, op_counts

    v = variant_setup(name)
    cfg = v["cfg"]
    lang = {VARIANT_TASK: v["lang"]}
    export_policy(cfg, v["model"], out_dir, lang_embeddings=lang, lanes=3, device="cpu")
    meta = json.loads((out_dir / "meta.json").read_text())
    order = meta["noise"]["order"]
    assert ("gumbel" in order) == (cfg.model_kind != "gcbc")
    assert ("u_mix" in order) == (cfg.action_decoder.kind == "logistic")
    if cfg.action_decoder.rnn_cell == "mlp":
        assert meta["carry"]["rnn_cell"] == "mlp"
    for program in ("replan_lang", "replan_vision", "act", "step_batched"):
        assert op_counts(torch.export.load(out_dir / f"{program}.pt2")) == expected_op_counts(cfg, program)
    live = HulcPolicy(cfg, v["model"], lang_embeddings=lang, seed=3)
    served = ServedPolicy(out_dir, seed=3, device="cpu")
    env = fake_env_for(cfg)
    for goal_kind, steps in (("lang", 5), ("visual", 4)):
        obs = env.reset()
        goal = VARIANT_TASK if goal_kind == "lang" else env.step(np.zeros(7, np.float32))
        live.reset(), served.reset()
        for t in range(steps):
            got = live.step(obs, goal)
            np.testing.assert_array_equal(served.step(obs, goal), got, err_msg=f"{goal_kind} step {t}")
            obs = env.step(got)
    batched, served_batched = BatchedHulcPolicy(cfg, v["model"], 3, seed=4), ServedBatchedPolicy(out_dir, seed=4,
                                                                                               device="cpu")
    envs = [fake_env_for(cfg) for _ in range(3)]
    obs_batch = [e.reset() for e in envs]
    embs = np.stack([v["lang"]] * 3)
    s_live, s_served = batched.initial_state(), served_batched.initial_state()
    replan = np.ones(3, bool)
    for t in range(4):
        got, s_live = batched.step(obs_batch, embs, s_live, replan)
        a, s_served = served_batched.step(obs_batch, embs, s_served, replan)
        np.testing.assert_array_equal(a, got, err_msg=f"lockstep step {t}")
        obs_batch = [e.step(x) for e, x in zip(envs, got)]
        replan = np.array([t % 2 == 1, False, True])
