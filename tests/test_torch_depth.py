"""The ``hulc_depth`` model in the port against the JAX package on the CPU.

The small depth config is ``hulc_debug`` with a depth tower beside each RGB
camera (64 px static, 48 px gripper, 16 features each, the decoder on the
RGB gripper slice (32, 48)), built the same way in both packages (JAX has
no depth debug preset). JAX's ``example_batch`` makes no depth frames, so
``torch_port_common`` adds them before JAX initializes the model. Weights
go from JAX to the port through ``params_from_jax``; gradients are compared
in the port's layout (JAX's gradient tree through the same converter). The
port gets the shifts, the depth noise and the plan noise JAX drew from its
keys. The recognition network's dropout is 0 on both sides.

* The depth noise (B.10's plain version): bit-equal to JAX's ``_prep_depth``
  run op by op, and within rtol 1e-6 of it jitted (XLA's CPU code contracts
  the multiply-adds into FMAs, about an ulp apart); eval is the identity.
* B.10's draw mode: Random123's known answers for the numpy Philox, the
  counter layout (a rank's rows of the global draw, no counter repeated
  across consecutive offsets, a key apart from torch's), the plain version
  (the frames noised with its own Box-Muller normals) and the refusals.
* The kernel's C entry point and binding; the preset and its full-width
  parameter count; ``ConcatEncoders`` with depth (the feature order, the
  gripper depth dropped without an RGB gripper camera); the converter.
* A train step's losses (rtol 1e-5) and gradients (1e-4 relative L2), one
  ``Trainer`` step, the val metrics key by key, the loaders' depth batches
  byte for byte (JAX's, and the shm cache's against the ram cache's), a
  cut-and-resumed ``fit``, and the policies refusing a depth config where
  JAX's fail.
"""

import dataclasses
import itertools
import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training import train_state as flax_train_state

from __graft_entry__ import _make_raw_batch
from hulc_tpu import config as jax_config
from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.data.loader import make_loaders as jax_make_loaders
from hulc_tpu.evaluation.policy import HulcPolicy as JaxHulcPolicy
from hulc_tpu.models import example_batch, init_params
from hulc_tpu.models import make_model as jax_make_model
from hulc_tpu.models.perceptual import ConcatEncoders as JaxConcatEncoders
from hulc_tpu.training.preprocess import _prep_depth
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch
from hulc_tpu.training.trainer import Trainer as JaxTrainer
from hulc_tpu.training.trainer import TrainerConfig as JaxTrainerConfig

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch import kernels
from hulc_tpu_torch.convert import params_from_jax
from hulc_tpu_torch.data import shm_store
from hulc_tpu_torch.data.fixtures import make_fixture_dataset
from hulc_tpu_torch.data.loader import make_loaders
from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
from hulc_tpu_torch.evaluation.fake_env import fake_env_for
from hulc_tpu_torch.evaluation.policy import HulcPolicy
from hulc_tpu_torch.models import make_model
from hulc_tpu_torch.models.hulc import LOSS_KEYS, HulcModel, ModalityBatch
from hulc_tpu_torch.models.perceptual import ConcatEncoders
from hulc_tpu_torch.ops.depth_noise import (
    DRAW_DOMAIN,
    DRAW_OFFSET_STEP,
    GAMMA_SCALE,
    GAMMA_SHIFT,
    PHILOX_M,
    PHILOX_W,
    box_muller_plain,
    draw_depth_noise,
    draw_key,
    draw_layout,
    draw_words,
    philox4x32_10,
    prep_depth,
    prep_depth_draw,
    prep_depth_draw_plain,
    prep_depth_plain,
)
from hulc_tpu_torch.parallel.mesh import rows_of
from hulc_tpu_torch.serving import export_policy
from hulc_tpu_torch.training import checkpoint as ckpt
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig
from tests.torch_port_common import (
    jax_init,
    jax_mixture_uniforms,
    jax_plan_noise,
    jax_random_params,
    port_model_from_jax,
    to_torch,
    with_depth,
)

torch.set_num_threads(1)

B, S, KL_BETA, LR = 3, 4, 0.01, 2e-4
LOSS_RTOL = 1e-5  # fp32 sums in another order
GRAD_RTOL = 1e-4  # per parameter, relative L2
ZERO_GRAD = 1e-7  # share of the whole gradient's norm below which a leaf's is rounding noise
JIT_RTOL = 1e-6  # the depth noise against JAX's jitted _prep_depth (FMA-contracted, about an ulp)
ATOL = 1e-4  # MAEs and sampled plans
DEPTH_CAMERAS = ("depth_static", "depth_gripper")


def _cfg(m):
    """``hulc_debug`` with the two depth towers of ``hulc_depth``."""
    cfg = m.get_config("hulc_debug")
    V = m.VisionEncoderConfig
    pe = m.PerceptualEncoderConfig(
        rgb_static=V(input_size=64, visual_features=16, shift_pad=3),
        rgb_gripper=V(kind="nature_cnn", input_size=48, visual_features=16, shift_pad=2),
        depth_static=V(input_size=64, visual_features=16, num_channels=1, shift_pad=0),
        depth_gripper=V(kind="nature_cnn", input_size=48, visual_features=16, num_channels=1, shift_pad=0),
    )
    return dataclasses.replace(
        cfg, perceptual_encoder=pe,
        plan_recognition=dataclasses.replace(cfg.plan_recognition, dropout=0.0),
        action_decoder=dataclasses.replace(cfg.action_decoder, perceptual_emb_slice=(32, 48)),
    ).resolve()


JAX_CFG, PORT_CFG = _cfg(jax_config), _cfg(port_config)


def _port_batch(batch):
    return {scope: ModalityBatch(*mod) for scope, mod in batch.items()}


def _plan_gumbel(key, n):
    d = JAX_CFG.distribution
    return to_torch(jax.random.gumbel(key, (n, d.category_size, d.class_size)))


@pytest.fixture(scope="module")
def setup():
    jax_model, params = jax_random_params(JAX_CFG, seed=70)
    split = _make_raw_batch(JAX_CFG, B, S, seed=71)
    split["lang"] = split["lang"]._replace(use_for_aux_lang_loss=np.array([True, False, True]))
    model, unused = port_model_from_jax(params, PORT_CFG)
    assert unused == []
    return jax_model, params, split, CombinedLoader.fuse_batch(split), model


# ---------------------------------------------------------------------------
# the depth noise (B.10)
# ---------------------------------------------------------------------------

MODES = {"gamma": dict(gamma_noise=True), "gaussian": dict(gaussian_std=0.01)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_depth_noise_matches_jax(mode):
    """``prep_depth_plain`` on JAX's own draw: bit-equal to ``_prep_depth``
    op by op, within JIT_RTOL of it jitted; the CPU wrapper is the plain
    version (also writing into the draw's buffer), and eval passes the
    frames through."""
    x = np.random.default_rng(72).uniform(0.1, 5.0, (2, 3, 17, 19)).astype(np.float32)
    key = jax.random.key(73)
    z = to_torch(jax.random.normal(key, x.shape))
    eager = np.asarray(_prep_depth(jnp.asarray(x), key, True, **MODES[mode]))
    jitted = np.asarray(jax.jit(lambda a, k: _prep_depth(a, k, True, **MODES[mode]))(x, key))
    got = prep_depth_plain(torch.from_numpy(x), z, mode, 0.01)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), eager)
    np.testing.assert_allclose(got.numpy(), jitted, rtol=JIT_RTOL, atol=0)
    assert torch.equal(prep_depth(torch.from_numpy(x), z, mode, 0.01), got)
    zc = z.clone()
    assert prep_depth(torch.from_numpy(x), zc, mode, 0.01, out=zc) is zc and torch.equal(zc, got)
    np.testing.assert_array_equal(np.asarray(_prep_depth(jnp.asarray(x), key, False, **MODES[mode])), x)


def test_depth_noise_constants_and_refusals():
    """The constants round as JAX's do (fp32 c, an fp32 sqrt of it, the
    double 1 - c rounded once); the wrapper refuses a draw that requires a
    gradient, a draw of another shape, writing over the frames, an unknown
    mode and a gaussian without a std."""
    c = np.float32(1.0 / 9000.0)
    assert GAMMA_SCALE == float(np.asarray(jnp.sqrt(c))) == float(np.float32(np.sqrt(c)))
    assert GAMMA_SHIFT == float(np.float32(1.0 - 1.0 / 9000.0))
    x, z = torch.rand(2, 3, 4, 4), torch.randn(2, 3, 4, 4)
    with pytest.raises(ValueError, match="gradient"):
        prep_depth(x, z.requires_grad_(), "gamma")
    with pytest.raises(ValueError, match="shape"):
        prep_depth(x, torch.randn(2, 3, 4, 5), "gamma")
    with pytest.raises(ValueError, match="write over"):
        prep_depth(x, torch.randn(2, 3, 4, 4), "gamma", out=x)
    with pytest.raises(ValueError, match="mode"):
        prep_depth(x, torch.randn(2, 3, 4, 4), "poisson")
    with pytest.raises(ValueError, match="std"):
        prep_depth(x, torch.randn(2, 3, 4, 4), "gaussian")


def test_depth_noise_binding():
    """B.10's C entry point: x, z, y, the count, the mode, its two fp32
    constants, the draw mode's blocks of rows, block stride, base, seed,
    offset and debug outputs, then the stream; the wrapper's launches count
    in ``ALL_KERNELS``."""
    src = (kernels.CSRC_DIR / "depth_noise.cu").read_text()
    params = re.search(r'extern "C" int hulc_depth_noise\(([^)]*)\)', src).group(1)
    params = [re.sub(r"\s+", " ", p.strip()) for p in params.split(",")]
    assert params == ["const void* x", "const void* z", "void* y", "long long n", "int mode", "float a", "float b",
                      "int row_blocks", "long long block_stride", "long long base", "unsigned long long seed",
                      "unsigned long long offset", "void* z_out", "void* words_out", "void* stream"]
    k = kernels
    assert k._SIGNATURES["hulc_depth_noise"] == (
        k._P, k._P, k._P, k._I64, k._I32, k._F32, k._F32, k._I32, k._I64, k._I64, k._U64, k._U64, k._P, k._P)
    assert kernels.DEPTH_NOISE in kernels.ALL_KERNELS
    assert "__fadd_rn" in src and "__fmul_rn" in src
    # the kernel's Philox constants and key domain are the plain version's
    for value in (*PHILOX_M, *PHILOX_W, DRAW_DOMAIN):
        assert f"0x{value:08X}u" in src


# ---------------------------------------------------------------------------
# B.10's draw mode: the counter layout, the plain version, the refusals
# ---------------------------------------------------------------------------

# Random123's known answers for Philox4x32-10: (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
DRAW_SEED = 2**40 + 12345  # a seed with a high word, as torch's default seeds have


@pytest.mark.parametrize("case", range(len(PHILOX_KAT)))
def test_philox_known_answers(case):
    counter, key, want = PHILOX_KAT[case]
    assert tuple(int(v) for v in philox4x32_10(counter, key)) == want


@pytest.mark.parametrize("blocks", [1, 2])
def test_draw_rank_split_is_the_global_draw(blocks):
    """Each of two ranks' rows (its share of each of ``blocks`` blocks, as
    ``mesh.rows_of`` cuts them) draws its rows of the one-device draw bit
    for bit: words, normals and noised frames."""
    x = 0.1 + 4.9 * torch.rand((4 * blocks, 3, 6, 5), generator=torch.Generator().manual_seed(80))
    y, z, words = prep_depth_draw_plain(x, "gamma", 0.0, DRAW_SEED, 12)
    for r in range(2):
        local = rows_of(x, blocks, 2, r)
        yl, zl, wl = prep_depth_draw(local, "gamma", 0.0, DRAW_SEED, 12, (blocks, 2, r), debug=True)
        for got, want in ((yl, y), (zl, z), (wl, words)):
            assert torch.equal(got, rows_of(want, blocks, 2, r))


def test_draw_counters_never_repeat():
    """Counter (group index, offset), key (seed, high word xor the domain):
    within a draw every group has its own counter, consecutive offsets (the
    generator moved on by ``DRAW_OFFSET_STEP``) share none, a restored
    offset repeats the draw, and the key is not torch's (the seed's)."""
    layout = draw_layout((8, 2, 3, 4), (2, 2, 1))
    groups = layout.groups
    assert len(set(groups.tolist())) == len(groups) == layout.blocks * layout.block_n // 4
    assert layout.block_stride == 2 * layout.block_n and layout.base == layout.block_n
    first = {(int(g), 40) for g in groups}
    second = {(int(g), 40 + DRAW_OFFSET_STEP) for g in groups}
    assert not first & second
    a, b = draw_words(layout, DRAW_SEED, 40), draw_words(layout, DRAW_SEED, 40 + DRAW_OFFSET_STEP)
    assert np.mean(a == b) < 1e-2 and np.array_equal(a, draw_words(layout, DRAW_SEED, 40))
    assert draw_key(DRAW_SEED) == (DRAW_SEED & 0xFFFFFFFF, (DRAW_SEED >> 32) ^ DRAW_DOMAIN)
    assert draw_key(DRAW_SEED) != (DRAW_SEED & 0xFFFFFFFF, DRAW_SEED >> 32)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_draw_mode_plain_version(mode):
    """The CPU wrapper is the plain version; its frames are
    ``prep_depth_plain`` on its own normals, which are the Box-Muller of its
    words and standard normal in their moments (2^16 draws)."""
    x = 0.1 + 4.9 * torch.rand((4, 4, 64, 64), generator=torch.Generator().manual_seed(81))
    y, z, words = prep_depth_draw(x, mode, 0.01, DRAW_SEED, 0, debug=True)
    assert torch.equal(y, prep_depth_plain(x, z, mode, 0.01))
    assert torch.equal(z.reshape(-1), box_muller_plain(words.reshape(-1)))
    assert torch.equal(prep_depth_draw(x, mode, 0.01, DRAW_SEED, 0), y)
    assert int(words.min()) >= 0 and int(words.max()) < 2**32
    assert abs(float(z.mean())) < 0.02 and abs(float(z.var()) - 1.0) < 0.03
    out = torch.empty_like(x)
    assert prep_depth_draw(x, mode, 0.01, DRAW_SEED, 0, out=out) is out and torch.equal(out, y)


def test_draw_mode_refusals():
    """The draw mode refuses CUDA frames with a CPU generator (the frames
    faked on the CPU), a misaligned base (a rank's block of rows not a
    multiple of four elements) and an output over the frames."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        frames = torch.empty((2, 3, 4, 4), device="cuda")
    with pytest.raises(ValueError, match="generator"):
        draw_depth_noise(frames, "gamma", 0.0, torch.Generator())
    with pytest.raises(ValueError, match="CUDA frames"):
        draw_depth_noise(torch.rand(2, 3, 4, 4), "gamma", 0.0, torch.Generator())
    with pytest.raises(ValueError, match="misaligned base"):
        prep_depth_draw(torch.rand(2, 3, 1, 1), "gamma", 0.0, DRAW_SEED, 0, (2, 2, 1))
    x = torch.rand(2, 3, 4, 4)
    with pytest.raises(ValueError, match="write over"):
        prep_depth_draw(x, "gamma", 0.0, DRAW_SEED, 0, out=x)
    with pytest.raises(ValueError, match="std"):
        prep_depth_draw(x, "gaussian", 0.0, DRAW_SEED, 0)


# ---------------------------------------------------------------------------
# preset, encoders, weights
# ---------------------------------------------------------------------------

def test_preset_matches_jax_and_builds_at_full_width():
    """``hulc_depth`` field by field, and the full-width model (on the meta
    device) with JAX's parameter count when JAX is initialized on a batch
    with depth frames: 50,293,559, the depth towers taking one input
    channel."""
    assert dataclasses.asdict(port_config.get_config("hulc_depth")) == dataclasses.asdict(
        jax_config.get_config("hulc_depth"))
    cfg = port_config.get_config("hulc_depth")
    assert cfg.perceptual_encoder.latent_size == 256 and cfg.action_decoder.perceptual_emb_slice == (128, 192)
    with torch.device("meta"):
        model = HulcModel(cfg)
    jcfg = jax_config.get_config("hulc_depth")
    batch = {"vis": with_depth(jcfg, example_batch(jcfg, 1, 2)), "lang": with_depth(jcfg, example_batch(jcfg, 1, 2, lang=True))}
    shapes = jax.eval_shape(lambda: init_params(jax_make_model(jcfg), jax.random.key(0), batch))
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == 50_293_559
    pe = model.perceptual_encoder
    assert pe.depth_static_encoder.conv_model[0].weight.shape == (32, 1, 8, 8)
    assert pe.depth_gripper_encoder.conv_model[7].weight.shape == (128, 64 * 7 * 7)


def _encoder_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    pe = cfg.perceptual_encoder
    rgb = {c: rng.normal(size=(2, 3, getattr(pe, c).input_size, getattr(pe, c).input_size, 3)).astype(np.float32)
           for c in ("rgb_static", "rgb_gripper") if getattr(pe, c) is not None}
    depth = {c: rng.uniform(0.1, 5.0, (2, 3, getattr(pe, c).input_size, getattr(pe, c).input_size)).astype(np.float32)
             for c in DEPTH_CAMERAS}
    return rgb, depth


def _port_encode(encoder, rgb, depth):
    with torch.no_grad():
        return encoder({c: to_torch(v).permute(0, 1, 4, 2, 3) for c, v in rgb.items()}, None,
                       {c: to_torch(v) for c, v in depth.items()})[0].numpy()


def test_concat_encoders_match_jax(setup):
    """The four towers' features in JAX's order (RGB static, depth static,
    RGB gripper, depth gripper); and with no RGB gripper camera the gripper
    depth is dropped, as JAX drops it (JAX then builds no such tower)."""
    _, params, _, _, model = setup
    pe_params = params["perceptual_encoder"]
    rgb, depth = _encoder_inputs(JAX_CFG, 74)
    jax_pe = JaxConcatEncoders(JAX_CFG.perceptual_encoder)
    want = np.asarray(jax_pe.apply({"params": pe_params}, rgb, depth)[0])
    got = _port_encode(model.perceptual_encoder, rgb, depth)
    assert got.shape == want.shape == (2, 3, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # each 16-wide block is one tower's output, in JAX's order
    for i, cam in enumerate(("rgb_static", "depth_static", "rgb_gripper", "depth_gripper")):
        one = {cam: (rgb if cam.startswith("rgb") else depth)[cam]}
        enc = getattr(model.perceptual_encoder, f"{cam}_encoder")
        x = to_torch(one[cam])
        x = x.permute(0, 1, 4, 2, 3) if cam.startswith("rgb") else x.unsqueeze(2)
        with torch.no_grad():
            block = enc(x.reshape((6,) + x.shape[2:])).reshape(2, 3, -1).numpy()
        np.testing.assert_array_equal(got[..., 16 * i:16 * (i + 1)], block, err_msg=cam)

    no_gripper = dataclasses.replace(JAX_CFG.perceptual_encoder, rgb_gripper=None)
    jax_drop = JaxConcatEncoders(no_gripper)
    rgb.pop("rgb_gripper")
    init = jax_drop.init(jax.random.key(75), rgb, depth)["params"]
    assert sorted(init) == ["depth_static", "rgb_static"]
    want = np.asarray(jax_drop.apply({"params": {k: pe_params[k] for k in init}}, rgb, depth)[0])
    port_drop = ConcatEncoders(dataclasses.replace(PORT_CFG.perceptual_encoder, rgb_gripper=None))
    port_drop.load_state_dict(model.perceptual_encoder.state_dict(), strict=False)
    got = _port_encode(port_drop, rgb, depth)
    assert got.shape == want.shape == (2, 3, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_params_from_jax_carries_the_depth_towers_and_refuses_params_without(setup):
    """Every parameter of the port's model, the depth towers' among them,
    from JAX's tree with no key left over; JAX params initialized on a
    batch without depth frames (JAX's own ``example_batch``) have no depth
    towers, and the converter refuses them."""
    _, params, _, _, model = setup
    state, unused = params_from_jax(params, PORT_CFG)
    assert unused == [] and set(state) == set(model.state_dict())
    assert {k.split(".")[1] for k in state if k.startswith("perceptual_encoder.")} == {
        "rgb_static_encoder", "depth_static_encoder", "rgb_gripper_encoder", "depth_gripper_encoder"}
    np.testing.assert_array_equal(state["perceptual_encoder.depth_static_encoder.conv_model.0.weight"].numpy(),
                                  params["perceptual_encoder"]["depth_static"]["conv0"]["kernel"].transpose(3, 2, 0, 1))
    jax_model = jax_make_model(JAX_CFG)
    batch = {"vis": example_batch(JAX_CFG, 1, 2), "lang": example_batch(JAX_CFG, 1, 2, lang=True)}
    shapes = jax.eval_shape(lambda: init_params(jax_model, jax.random.key(0), batch))
    assert not {"depth_static", "depth_gripper"} & set(shapes["perceptual_encoder"])
    rgb_only = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    with pytest.raises(ValueError, match="depth_static"):
        params_from_jax(rgb_only, PORT_CFG)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _jax_step_noise(rng, n):
    """The shifts, depth noise and plan noise of JAX's ``make_train_step``
    from ``rng`` at step 0, by the port's names ({"fused": ...})."""
    k_aug, k_loss, _ = jax.random.split(jax.random.fold_in(rng, 0), 3)
    _, k_scope = jax.random.split(k_aug)
    k_static, k_gripper, _, k_ds, k_dg = jax.random.split(k_scope, 5)
    pe = JAX_CFG.perceptual_encoder
    shifts = {cam: to_torch(jax.random.randint(k, (n * S, 2), 0, 2 * getattr(pe, cam).shift_pad + 1))
              for cam, k in (("rgb_static", k_static), ("rgb_gripper", k_gripper))}
    depth = {cam: to_torch(jax.random.normal(k, (n, S, getattr(pe, cam).input_size, getattr(pe, cam).input_size)))
             for cam, k in (("depth_static", k_ds), ("depth_gripper", k_dg))}
    return k_aug, k_loss, {"fused": shifts}, {"fused": depth}, _plan_gumbel(jax.random.split(k_loss)[1], n)


@pytest.fixture(scope="module")
def jax_step(setup, tmp_path_factory):
    """One JAX train step (losses, new params), the noise it drew, and the
    gradients of its loss on its own preprocessed batch."""
    jax_model, params, _, fused, _ = setup
    tcfg = JaxTrainerConfig(run_dir=str(tmp_path_factory.mktemp("jax_depth_run")), num_devices=1,
                            donate_state=False, lr=LR)
    trainer = JaxTrainer(JAX_CFG, tcfg)
    state = flax_train_state.TrainState.create(
        apply_fn=jax_model.apply, params=jax.tree.map(jnp.asarray, params), tx=trainer.build_optimizer(1))
    rng = jax.random.key(76)
    _, losses = trainer.make_train_step()(state, fused, rng, jnp.asarray(KL_BETA, jnp.float32))
    k_aug, k_loss, shifts, depth, gumbel = _jax_step_noise(rng, 2 * B)
    prep = jax_preprocess_batch(JAX_CFG, fused, rng=k_aug, train=True)

    def loss_fn(p):
        out = jax_model.apply({"params": p}, k_loss, prep, KL_BETA, method=jax_model.train_losses)
        return out["total_loss"], out

    grads, want = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    return {"losses": jax.device_get(losses), "grads": jax.device_get(grads), "grad_losses": jax.device_get(want),
            "shifts": shifts, "depth": depth, "gumbel": gumbel, "prep": prep}


def _check_losses(got, want):
    keys = set(LOSS_KEYS) | {f"{k}_{s}" for k in ("action_loss", "kl_loss_scaled", "total_loss") for s in ("vis", "lang")}
    assert keys <= set(got) and keys <= set(want)
    for k in sorted(keys):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert float(want["lang_clip_loss"]) != 0.0


def _check_grads(model, want_tree):
    """Each parameter's gradient against JAX's, carried into the port's
    layout by ``params_from_jax``."""
    want, unused = params_from_jax(jax.tree.map(np.asarray, want_tree), PORT_CFG)
    assert unused == []
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    total = float(torch.sqrt(sum((w.double() ** 2).sum() for w in want.values())))
    depth_leaves = 0
    for name, w in want.items():
        g = got[name]
        if float(w.norm()) <= ZERO_GRAD * total:
            # zero in exact arithmetic (the attention's key bias); both sides hold rounding noise
            assert float(g.norm()) <= ZERO_GRAD * total, name
            continue
        err = float((g.double() - w.double()).norm() / w.double().norm())
        assert err <= GRAD_RTOL, f"{name}: relative L2 error {err}"
        depth_leaves += "depth_" in name
    assert depth_leaves == 2 * (3 * 2 + 2 + 2 + 2) + 2  # both towers' convs, fc1, fc2, ln, and the CNN's fc0


def test_train_losses_and_grads_match_jax(setup, jax_step):
    """The loader-fused batch through the port's preprocess on JAX's shifts
    and depth noise (the noised depth frames within JIT_RTOL of JAX's),
    then ``train_losses`` on JAX's Gumbel noise: every loss within rtol
    1e-5, every gradient within 1e-4 relative L2."""
    _, params, _, fused, _ = setup
    model, _ = port_model_from_jax(params, PORT_CFG)
    batch = preprocess_batch(PORT_CFG, batch_to_device(_port_batch(fused), "cpu"), shifts=jax_step["shifts"],
                             depth_noise=jax_step["depth"])
    for cam in DEPTH_CAMERAS:
        want = np.asarray(getattr(jax_step["prep"]["fused"], cam))
        np.testing.assert_allclose(getattr(batch["fused"], cam).numpy(), want, rtol=JIT_RTOL, atol=0, err_msg=cam)
        assert not np.array_equal(want, getattr(fused["fused"], cam))
    losses = model.train().train_losses(batch, KL_BETA, gumbel=jax_step["gumbel"])
    losses["total_loss"].backward()
    _check_losses(losses, jax_step["grad_losses"])
    _check_grads(model, jax_step["grads"])


def test_trainer_step_matches_jax(setup, jax_step):
    """One ``Trainer.train_step`` on the raw batch with JAX's noise: the
    losses and ``grad_norm`` of JAX's jitted step (rtol 1e-5); the raw
    depth frames are not written."""
    _, params, _, fused, _ = setup
    trainer = Trainer(PORT_CFG, TrainerConfig(lr=LR), device="cpu")
    state, unused = params_from_jax(params, PORT_CFG)
    assert unused == []
    trainer.model.load_state_dict(state, strict=True)
    trainer.init_state(1)
    raw = batch_to_device(_port_batch(fused), "cpu")
    before = {c: getattr(raw["fused"], c).clone() for c in DEPTH_CAMERAS}
    losses = trainer.train_step(raw, KL_BETA, shifts=jax_step["shifts"], depth_noise=jax_step["depth"],
                                gumbel=jax_step["gumbel"])
    _check_losses(losses, jax_step["losses"])
    np.testing.assert_allclose(float(losses["grad_norm"]), float(jax_step["losses"]["grad_norm"]), rtol=LOSS_RTOL)
    assert all(torch.equal(getattr(raw["fused"], c), before[c]) for c in DEPTH_CAMERAS)


def test_trainer_draws_depth_noise_after_the_shifts():
    """Without injected noise the depth draws come from the trainer's
    generator right after the shifts, static camera first, and a fresh
    draw each step (as ``echo_factor`` steps on one uploaded batch)."""
    raw = _port_batch(CombinedLoader.fuse_batch(_make_raw_batch(JAX_CFG, 2, 3, seed=77)))
    fused = raw["fused"]
    trainer = Trainer(PORT_CFG, TrainerConfig(seed=5), device="cpu")
    gen = torch.Generator().manual_seed(6)
    shifts = {c: torch.randint(0, 2 * getattr(PORT_CFG.perceptual_encoder, c).shift_pad + 1, (12, 2), generator=gen,
                               dtype=torch.int32) for c in ("rgb_static", "rgb_gripper")}
    z = {c: torch.randn(getattr(fused, c).shape, generator=gen) for c in DEPTH_CAMERAS}
    gen = torch.Generator().manual_seed(6)
    got = preprocess_batch(PORT_CFG, batch_to_device(raw, "cpu"), generator=gen)["fused"]
    want = preprocess_batch(PORT_CFG, batch_to_device(raw, "cpu"), shifts={"fused": shifts},
                            depth_noise={"fused": z})["fused"]
    for name in ("rgb_static", "rgb_gripper", *DEPTH_CAMERAS):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    trainer.init_state(10)
    steps = trainer.train_steps(2, [raw], KL_BETA)
    assert all(np.isfinite(float(v)) for s in steps for v in s.values())
    assert not torch.equal(steps[0]["total_loss"], steps[1]["total_loss"])


def _val_noise(key, scopes, b, s):
    """The noise JAX's val_metrics draws, by scope (a key split per scope in
    key order, then lmp_val's four-way split)."""
    out = {}
    ad = JAX_CFG.action_decoder
    for scope in sorted(scopes):
        key, k = jax.random.split(key)
        k_pp, k_pr, k_act_pp, k_act_pr = jax.random.split(k, 4)
        noise = {}
        for tag, k_plan, k_act in (("pp", k_pp, k_act_pp), ("pr", k_pr, k_act_pr)):
            noise[f"gumbel_{tag}"] = jax_plan_noise(k_plan, b, JAX_CFG)["gumbel"]
            u_mix, u_inv = jax_mixture_uniforms(k_act, b * s, JAX_CFG)
            noise[f"u_mix_{tag}"] = u_mix.reshape(b, s, ad.out_features - 1, -1)
            noise[f"u_inv_{tag}"] = u_inv.reshape(b, s, ad.out_features - 1)
        out[scope] = noise
    return out


def test_val_metrics_match_jax(setup):
    """``val_metrics`` on the eval-preprocessed batch (depth passed
    through) on JAX's noise: losses rtol 1e-5, MAEs and plans atol 1e-4,
    gripper success rates exact."""
    jax_model, params, split, _, model = setup
    prep = jax_preprocess_batch(JAX_CFG, split, rng=None, train=False)
    key = jax.random.key(78)
    want = jax.device_get(jax.jit(
        lambda p, k, b: jax_model.apply({"params": p}, k, b, KL_BETA, method=jax_model.val_metrics)
    )(params, key, prep))
    batch = preprocess_batch(PORT_CFG, batch_to_device(_port_batch(split), "cpu"), train=False)
    assert all(torch.equal(getattr(batch[s], c), to_torch(getattr(split[s], c))) for s in split for c in DEPTH_CAMERAS)
    with torch.no_grad():
        got = model.eval().val_metrics(batch, KL_BETA, noise=_val_noise(key, split, B, S))
    assert set(got) == set(want)
    for k in sorted(want):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if "gripper_sr" in k:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif "mae" in k or "sampled_plan" in k:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the data layer and the training loop
# ---------------------------------------------------------------------------

LOADER = dict(batch_size=2, min_window=6, max_window=8)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_fixture_dataset(tmp_path_factory.mktemp("depth_data"), num_episodes=2, episode_len=16)


@pytest.mark.parametrize("case", ["fused", "validation"])
def test_loader_depth_batches_match_jax(root, case):
    """``make_loaders`` at the depth config: JAX's batches byte for byte,
    the fp32 (B, S, H, W) depth frames among them."""
    kwargs = dict(LOADER, seed=7, **({"fuse": True} if case == "fused" else
                                     {"split": "validation", "deterministic": True}))
    got_loader, want_loader = make_loaders(PORT_CFG, root, **kwargs), jax_make_loaders(JAX_CFG, root, **kwargs)
    draws = 0
    for (got, want), _ in zip(zip(got_loader, want_loader), range(2)):
        assert list(got) == list(want)
        for scope in got:
            for name, g, w in zip(got[scope]._fields, got[scope], want[scope]):
                assert (g is None) == (w is None), name
                if g is not None:
                    g, w = np.asarray(g), np.asarray(w)
                    assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), name
            d = got[scope].depth_static
            assert d.dtype == np.float32 and d.shape[2:] == (64, 64) and got[scope].depth_gripper.shape[2:] == (48, 48)
        draws += 1
    assert draws == 2


def test_shm_cache_gives_the_ram_depth_batches(root):
    """The shm arena (the port's g++ build) holds the depth frames too: the
    ram cache's fused batches byte for byte, depth fields included."""
    kwargs = dict(LOADER, seed=9, fuse=True)
    ram = make_loaders(PORT_CFG, root, cache="ram", **kwargs)
    shm = make_loaders(PORT_CFG, root, cache="shm", gather_threads=2, **kwargs)
    arena = shm.loaders["vis"].store.shm
    try:
        assert {"depth_static", "depth_gripper"} <= set(shm.loaders["vis"].store.keys)
        for (got, want), _ in zip(zip(shm, ram), range(2)):
            for name, g, w in zip(got["fused"]._fields, got["fused"], want["fused"]):
                assert (g is None) == (w is None), name
                if g is not None:
                    assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), name
            assert got["fused"].depth_static is not None and got["fused"].depth_gripper.dtype == np.float32
    finally:
        for loader in shm.loaders.values():
            loader.store.shm.close()
        shm_store.ShmEpisodeCache.unlink(arena.name)


def _depth_trainer(run_dir):
    return Trainer(PORT_CFG, TrainerConfig(run_dir=str(run_dir), log_every=1, val_max_batches=1), device="cpu")


def test_fit_cut_and_resumed_is_bit_equal(root, tmp_path):
    """``fit`` for 2 epochs of 1 step on the depth fixture, and the same run
    cut after its first step and resumed by a new Trainer: the parameters,
    the Adam state, the step and the generator bit-equal. Epoch e trains on
    the loader's batch e, both drawn up front in one pass: taking one batch
    from each of two passes would leave the second to the first pass's
    worker thread, which draws ahead a number of batches that depends on
    the host's timing."""
    train = make_loaders(PORT_CFG, root, fuse=True, seed=0, **LOADER)
    batches = list(itertools.islice(train, 2))
    del train

    class Epochs:
        """One batch an epoch: batch ``start`` + e in the e-th pass."""

        def __init__(self, start=0):
            self.next = start

        def __len__(self):
            return 1

        def __iter__(self):
            self.next += 1
            return iter([batches[self.next - 1]])

    def val():
        return make_loaders(PORT_CFG, root, split="validation", deterministic=True, **LOADER)

    whole = _depth_trainer(tmp_path / "whole")
    assert whole.fit(Epochs(), val(), max_epochs=2) == 2
    assert _depth_trainer(tmp_path / "cut").fit(Epochs(), val(), max_epochs=2, max_steps=1) == 1
    resumed = _depth_trainer(tmp_path / "cut")
    assert resumed.fit(Epochs(start=1), val(), max_epochs=2) == 2
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    a, b = whole.optimizer.checkpoint_state(), resumed.optimizer.checkpoint_state()
    assert a["count"] == b["count"]
    for key in ("exp_avg", "exp_avg_sq"):
        assert all(torch.equal(m, n) for m, n in zip(a[key], b[key]))
    assert torch.equal(whole.generator.get_state(), resumed.generator.get_state())
    assert [ckpt.checkpoint_epoch(p) for p in ckpt.all_checkpoints(tmp_path / "cut")] == [0, 1]


# ---------------------------------------------------------------------------
# the policies refuse a depth config
# ---------------------------------------------------------------------------

def test_policies_refuse_a_depth_config_where_jax_fails(setup, tmp_path):
    """JAX's policy feeds no depth, so the latent misses the depth features
    and its first step fails; the port's policy, batched policy and export
    refuse the config at construction."""
    _, params, _, _, model = setup
    env = fake_env_for(PORT_CFG)
    obs = env.reset()
    lang = {"task": np.zeros(PORT_CFG.lang_dim, np.float32)}
    jax_policy = JaxHulcPolicy(JAX_CFG, jax.tree.map(jnp.asarray, params), lang_embeddings=lang)
    with pytest.raises(flax.errors.ScopeParamShapeError, match="plan_proposal"):
        jax_policy.step(obs, "task")  # a 32-d latent (RGB only) into the proposal of a 64-d one
    with pytest.raises(ValueError, match="depth cameras"):
        HulcPolicy(PORT_CFG, model, lang_embeddings=lang)
    with pytest.raises(ValueError, match="depth cameras"):
        BatchedHulcPolicy(PORT_CFG, model, 2)
    with pytest.raises(ValueError, match="depth cameras"):
        export_policy(PORT_CFG, model, tmp_path / "art", device="cpu")
    assert not (tmp_path / "art").exists()


def test_jax_init_builds_the_depth_towers():
    """``torch_port_common.jax_init`` initializes JAX on a batch with depth
    frames: the depth towers exist and the port takes every weight."""
    _, params = jax_init(JAX_CFG)
    assert {"depth_static", "depth_gripper"} <= set(params["perceptual_encoder"])
    model, unused = port_model_from_jax(params, PORT_CFG)
    assert unused == [] and model.perceptual_encoder.depth_gripper_encoder is not None
    assert make_model(port_config.get_config("hulc_debug"), device="cpu").perceptual_encoder.depth_static_encoder is None
