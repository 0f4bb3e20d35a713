"""``hulc_clip_vision``, ``hulc_tactile`` and ``hulc_clip_lang`` in the port
against the JAX package on the CPU.

* Each preset's parameter count at full width
  (the port's model on the meta device) against JAX's init, traced
  (``jax.eval_shape``), on a batch that carries what the preset reads: a
  tactile frame, 1024-d language (JAX's ``example_batch`` makes no tactile
  frame and draws 384-d language whatever ``lang_dim`` says, so its init
  of ``hulc_clip_lang`` would build a 384-wide language goal encoder);
  ``params_from_jax`` of each preset (ViT-B/32 too) uses every leaf and
  fills every port parameter.
* Small configs built the same way in both packages: ``hulc_debug`` with a
  CLIP static camera (a narrow RN50, swapped in for both packages'
  ``make_image_encoder``; 56 px frames resized to 64), and ``hulc_debug``
  with ``hulc_tactile``'s towers (no gripper camera, world-frame actions;
  160 x 120 tactile frames, resized twice; 3 windows of 4 frames, the
  tactile config 2 of 3). JAX's losses, gradients and val metrics of
  each come from one compiled program (``_jax_outputs``), shared by the
  module's tests. The port's model is fed JAX's preprocessed frames (the preprocess is held against JAX's in
  ``test_torch_clip_tactile.py``). The train losses, fused and per
  modality, on JAX's plan noise: losses rtol 1e-5, the whole gradient 1e-5
  relative L2; the frozen backbone's gradients are exactly zero in JAX and
  absent here, and one ``Trainer`` step with AdamW moves the backbone as
  optax's adamw moves it on those zeros (Adam leaves it). Validation on
  JAX's noise: rtol 1e-4.
* ``hulc_clip_lang`` (on ``hulc_debug``: ``torch_port_common.VARIANTS``
  ``clip_lang``): the weights and both policies on JAX's noise (atol
  1e-4); its export is a case of ``test_torch_variants.py``'s export test
  (which also holds the three presets field by field), its train CLI one
  of ``test_torch_cli.py``'s.
* The refusals, by their messages: the policies, the export and the
  evaluators for a CLIP camera and a tactile tower; the loader, ``fit``
  and the train CLI for a tactile tower.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.models import clip as jax_clip
from hulc_tpu.models import example_batch, init_params
from hulc_tpu.models import make_model as jax_make_model
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch
from hulc_tpu.training.trainer import Trainer as JaxTrainer
from hulc_tpu.training.trainer import TrainerConfig as JaxTrainerConfig

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.convert import frozen_tower_from_jax, params_from_jax
from hulc_tpu_torch.data.loader import make_loaders
from hulc_tpu_torch.evaluation import evaluate as port_evaluate
from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
from hulc_tpu_torch.evaluation.policy import HulcPolicy
from hulc_tpu_torch.models import clip, make_model
from hulc_tpu_torch.models.hulc import LOSS_KEYS, HulcModel, ModalityBatch
from hulc_tpu_torch.serving import export_policy
from hulc_tpu_torch.training import train as port_train
from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig
from tests.torch_port_common import (
    check_variant_policies,
    check_variant_weights,
    grads_in_port_layout,
    jax_train_noise,
    jax_val_noise,
    jax_call,
    to_torch,
    variant_raw_batch,
    with_tactile,
)

torch.set_num_threads(1)

KL_BETA = 0.01
# each small config's windows: (B, S); the tactile one's ResNet18 is the dearer on the CPU
WINDOWS = {"clip": (3, 4), "tactile": (2, 3)}
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5  # the whole gradient, relative L2
VAL_RTOL = 1e-4
ATOL = 1e-4  # MAEs and sampled plans
DECAY_RTOL = 2.4e-7  # two fp32 ulps: optax adds -lr * wd * p to p, the port's AdamW rounds its product otherwise

PRESETS = ("hulc_clip_vision", "hulc_clip_lang", "hulc_tactile")
VIT = ["perceptual_encoder.rgb_static.clip_model=ViT-B/32"]


def _full_width(m, name, overrides=()):
    return m.apply_overrides(m.get_config(name), list(overrides))


@pytest.mark.parametrize("name,overrides", [(n, []) for n in PRESETS] + [("hulc_clip_vision", VIT)],
                         ids=[*PRESETS, "hulc_clip_vision_vit"])
def test_full_width_parameters_are_jax(name, overrides):
    cfg, jcfg = _full_width(port_config, name, overrides), _full_width(jax_config, name, overrides)
    with torch.device("meta"):
        model = HulcModel(cfg)
    batch = {k: with_tactile(jcfg, example_batch(jcfg, 1, 2, lang=k == "lang")) for k in ("vis", "lang")}
    # JAX's fused pass traces each tower once; the params are the split pass's
    fused = dataclasses.replace(jcfg, fuse_modalities=True)
    shapes = jax.eval_shape(lambda: init_params(jax_make_model(fused), jax.random.key(0), batch))
    assert sum(p.numel() for p in model.parameters()) == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    sd, unused = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), cfg)
    assert unused == []
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(p.shape) for k, p in model.state_dict().items()}
    frozen = {id(p) for p in model.frozen_parameters()}
    assert len(frozen) == sum(1 for k in sd if ".visual." in k or ".backbone." in k)


# ---------------------------------------------------------------------------
# the small configs
# ---------------------------------------------------------------------------


def _narrow_rn(m, dtype=None):
    kw = {} if dtype is None else {"dtype": dtype}
    return m.ModifiedResNet(layers=(1, 1, 1, 1), width=8, heads=2, output_dim=24, input_resolution=64, **kw)


def _small(m, kind):
    """``hulc_debug`` with the preset's encoders, in config module ``m``."""
    cfg = m.get_config("hulc_debug")
    V = m.VisionEncoderConfig
    if kind == "clip":
        pe = dataclasses.replace(cfg.perceptual_encoder,
                                 rgb_static=V(kind="clip", input_size=64, visual_features=16, shift_pad=3))
        ad = cfg.action_decoder
    else:
        pe = dataclasses.replace(cfg.perceptual_encoder, rgb_gripper=None,
                                 tactile=V(kind="tactile", input_size=64, num_channels=6, visual_features=16))
        ad = dataclasses.replace(cfg.action_decoder, perceptual_emb_slice=None, gripper_control=False)
    return dataclasses.replace(cfg, perceptual_encoder=pe, action_decoder=ad,
                               plan_recognition=dataclasses.replace(cfg.plan_recognition, dropout=0.0)).resolve()


def _raw(cfg, b, s, seed):
    """A raw uint8 {"vis", "lang"} batch of ``b`` windows of ``s`` frames:
    56 px frames for a CLIP camera (resized to 64), 160 x 120 x 6 tactile
    frames."""
    raw = variant_raw_batch(cfg, b, s, seed)
    rng = np.random.default_rng(seed + 1)
    pe = cfg.perceptual_encoder
    out = {}
    for scope, mod in raw.items():
        if pe.rgb_static.kind == "clip":
            mod = mod._replace(rgb_static=rng.integers(0, 256, (b, s, 56, 56, 3), dtype=np.uint8))
        if pe.tactile is not None:
            mod = mod._replace(rgb_tactile=rng.integers(0, 256, (b, s, 160, 120, 6), dtype=np.uint8))
        out[scope] = mod
    return out


def _positive_statistics(params, seed):
    """JAX's random params with each FrozenBatchNorm's scale and var in
    [0.5, 1.5] and its bias and mean N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if not any(f"['{bn}" in name for bn in ("bn", "downsample_bn")):
            return leaf
        if name.endswith("['var']") or name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _jax_params(jcfg, raw, seed):
    """JAX's model and random weights in the tree its init builds on this
    raw batch's preprocessed frames (its tactile tower among them)."""
    prep = jax_preprocess_batch(jcfg, raw, rng=None, train=False)
    model = jax_make_model(jcfg)
    shapes = jax.eval_shape(lambda: init_params(model, jax.random.key(0), prep))
    rng = np.random.default_rng(seed)

    def fill(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else int(np.prod(leaf.shape))
        return (rng.uniform(-1.0, 1.0, leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return model, _positive_statistics(jax.tree.map(fill, shapes), seed + 1)


def _port_prep(prep):
    """JAX's preprocessed batch as the port's model reads it: frames NCHW."""
    def frame(x):
        return None if x is None else to_torch(x).permute(0, 1, 4, 2, 3).contiguous()

    return {k: ModalityBatch(*(frame(v) if f in ("rgb_static", "rgb_gripper", "rgb_tactile")
                               else None if v is None else to_torch(v) for f, v in zip(mod._fields, mod)))
            for k, mod in prep.items()}


def _narrow(mp):
    """Both packages' ``make_image_encoder`` giving the narrow RN50."""
    mp.setattr(jax_clip, "make_image_encoder", lambda name, dtype=jnp.float32: _narrow_rn(jax_clip, dtype))
    mp.setattr(clip, "make_image_encoder", lambda name, dtype=torch.float32: _narrow_rn(clip, dtype))


TRAIN_KEY, VAL_KEY = 92, 93


def _jax_outputs(jcfg, jax_model, params, raw):
    """JAX's train losses and gradients on the fused and the split batch, and
    its val metrics on the split batch, from one compiled program (one
    compile for the three); and those batches preprocessed. The train
    batches are constants of the program and the val batch an argument, as
    each check compiled them on its own: XLA folds a constant's arithmetic
    at compile time otherwise than its compiled code runs it, and the split
    action loss moves 1e-3 between the two (the port's agrees with the
    folded one)."""
    preps = {"fused": jax_preprocess_batch(jcfg, CombinedLoader.fuse_batch(raw), rng=None, train=False),
             "split": jax_preprocess_batch(jcfg, raw, rng=None, train=False)}

    def grads(p, prep):
        def loss_fn(q):
            out = jax_model.apply({"params": q}, jax.random.key(TRAIN_KEY), prep, KL_BETA,
                                  method=jax_model.train_losses)
            return out["total_loss"], out

        return jax.grad(loss_fn, has_aux=True)(p)

    def run(p, val_batch):
        val = jax_model.apply({"params": p}, jax.random.key(VAL_KEY), val_batch, KL_BETA,
                              method=jax_model.val_metrics)
        return {"fused": grads(p, preps["fused"]), "split": grads(p, preps["split"]), "val": val}

    return preps, jax_call(run, params, preps["split"])


@pytest.fixture(scope="module", params=["clip", "tactile"])
def small_setup(request):
    kind = request.param
    with pytest.MonkeyPatch.context() as mp:
        _narrow(mp)
        jcfg, cfg = _small(jax_config, kind), _small(port_config, kind)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        raw = _raw(jcfg, *WINDOWS[kind], 90)
        jax_model, params = _jax_params(jcfg, raw, 91)
        state_dict, unused = params_from_jax(params, cfg)
        preps, jax_out = _jax_outputs(jcfg, jax_model, params, raw)
    assert unused == []
    return {"kind": kind, "jcfg": jcfg, "cfg": cfg, "raw": raw, "params": params, "state_dict": state_dict,
            "preps": preps, "jax": jax_out}


@pytest.fixture
def small(small_setup, monkeypatch):
    """The small config's setup, the narrow RN50 in place for this test only
    (the port builds the tower inside the test)."""
    _narrow(monkeypatch)
    return small_setup


def _model(small):
    model = make_model(small["cfg"], device="cpu")
    model.load_state_dict(small["state_dict"], strict=True)
    return model


@pytest.mark.parametrize("schema", ["fused", "split"])
def test_train_losses_and_grads_match_jax(small, schema):
    jcfg = small["jcfg"]
    fused = schema == "fused"
    grads, want = small["jax"][schema]
    model = _model(small).train()
    noise = jax_train_noise(jax.random.key(TRAIN_KEY), jcfg, WINDOWS[small["kind"]][0], fused)
    got = model.train_losses(_port_prep(small["preps"][schema]), KL_BETA, **noise)
    got["total_loss"].backward()
    for k in sorted(set(LOSS_KEYS) & set(want)):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    want_grads = grads_in_port_layout(grads, small["cfg"])
    frozen = {id(p) for p in model.frozen_parameters()}
    all_g, all_w = [], []
    for k, p in model.named_parameters():
        w = want_grads[k]
        if id(p) in frozen:  # stop_gradient: exact zeros in JAX, no gradient here
            assert p.grad is None and not np.any(w), k
            continue
        all_g.append(p.grad.numpy().ravel()), all_w.append(w.ravel())
    all_g, all_w = np.concatenate(all_g), np.concatenate(all_w)
    assert np.linalg.norm(all_g - all_w) <= GRAD_REL * np.linalg.norm(all_w)
    assert frozen


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_trainer_steps_the_frozen_backbone_as_jax(small, optimizer, tmp_path):
    """One ``Trainer`` step: the backbone's zero gradients through the
    optimizer, against optax's update from JAX's trainer on the same zeros
    (at a learning rate of 1, where AdamW's decay lr * 1e-6 is above fp32's
    resolution: every entry moves, the statistics too; Adam leaves them),
    and B.7's norm counts them (finite, positive)."""
    cfg, jcfg, params = small["cfg"], small["jcfg"], small["params"]
    trainer = Trainer(cfg, TrainerConfig(lr=1.0, optimizer=optimizer, adam_mv_dtype="float32"), device="cpu")
    trainer.model.load_state_dict(small["state_dict"], strict=True)
    trainer.init_state(1)
    losses = trainer.train_step({k: ModalityBatch(*v) for k, v in small["raw"].items()}, KL_BETA)
    assert np.isfinite(float(losses["grad_norm"])) and float(losses["grad_norm"]) > 0
    tx = JaxTrainer(jcfg, JaxTrainerConfig(run_dir=str(tmp_path), num_devices=1, lr=1.0, optimizer=optimizer,
                                           adam_mv_dtype="float32")).build_optimizer(1)
    cam = "rgb_static" if small["kind"] == "clip" else "tactile"
    scope = "ModifiedResNet_0" if small["kind"] == "clip" else "backbone"
    head = params["perceptual_encoder"][cam]
    step = jax.jit(lambda n: optax.apply_updates(n, tx.update(jax.tree.map(jnp.zeros_like, n), tx.init(n), n)[0]))
    want_sd, _ = frozen_tower_from_jax({**head, scope: jax.device_get(step(head[scope]))}, small["kind"])
    prefix = f"perceptual_encoder.{cam}_encoder."
    got_sd = trainer.model.state_dict()
    moved = 0
    for k, w in want_sd.items():
        if k.startswith(("visual.", "backbone.")):
            np.testing.assert_allclose(got_sd[prefix + k].numpy(), w.numpy(), rtol=DECAY_RTOL, atol=0, err_msg=k)
            moved += int(not torch.equal(got_sd[prefix + k], small["state_dict"][prefix + k]))
    assert (moved > 0) == (optimizer == "adamw")


def test_val_metrics_match_jax(small):
    jcfg = small["jcfg"]
    b, s = WINDOWS[small["kind"]]
    want = small["jax"]["val"]
    with torch.no_grad():
        got = _model(small).eval().val_metrics(_port_prep(small["preps"]["split"]), KL_BETA,
                                               noise=jax_val_noise(jax.random.key(VAL_KEY), small["raw"], b, s, jcfg))
    assert set(got) == set(want)
    for k in sorted(want):
        g, w = got[k].numpy(), np.asarray(want[k])
        if "gripper_sr" in k:
            np.testing.assert_array_equal(np.rint(g * b * s), np.rint(w * b * s), err_msg=k)
        elif "mae" in k or "sampled_plan" in k:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=VAL_RTOL, atol=1e-7, err_msg=k)


def test_small_config_refusals(small, tmp_path):
    """The policies, the export and the batched evaluator refuse a CLIP
    camera and a tactile tower; the loader and ``fit`` a tactile tower."""
    cfg = small["cfg"]
    model = _model(small)
    match = "CLIP camera" if small["kind"] == "clip" else "tactile tower"
    for build in (lambda: HulcPolicy(cfg, model), lambda: BatchedHulcPolicy(cfg, model, 2),
                  lambda: export_policy(cfg, model, tmp_path / "art", device="cpu")):
        with pytest.raises(ValueError, match=match):
            build()
    if small["kind"] == "tactile":
        with pytest.raises(ValueError, match="never loads a tactile frame"):
            make_loaders(cfg, tmp_path, "training", 2)
        with pytest.raises(ValueError, match="never loads a tactile frame"):
            Trainer(cfg, TrainerConfig(run_dir=str(tmp_path)), device="cpu").fit([])


@pytest.mark.parametrize("name", ["hulc_clip_vision", "hulc_tactile"])
def test_cli_refusals(name, tmp_path):
    run = tmp_path / "run"
    with pytest.raises(SystemExit, match="CLIP camera" if name == "hulc_clip_vision" else "tactile tower"):
        port_evaluate.main(["--run-dir", str(run), "--config", name, "--device", "cpu"])
    if name == "hulc_tactile":
        with pytest.raises(SystemExit, match="never loads a tactile frame"):
            port_train.main(["--config", name, "--fixture", "--device", "cpu", "--run-dir", str(run)])


# ---------------------------------------------------------------------------
# hulc_clip_lang
# ---------------------------------------------------------------------------


def test_clip_lang_weights_and_policies():
    check_variant_weights("clip_lang")
    check_variant_policies("clip_lang")
