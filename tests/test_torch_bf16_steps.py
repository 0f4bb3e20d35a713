"""bf16 compute in the port against the JAX package on the CPU
(tests/torch_bf16_common.py's configurations): ``mcil_debug``'s train
step, its losses and every parameter's gradient, and a ``hulc_debug``
validation step's metrics, each by tests/test_torch_bf16.py's end-to-end
parity rule."""

import jax
import pytest
import torch

from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch

from hulc_tpu_torch.models.hulc import ModalityBatch
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from tests.torch_bf16_common import (
    B,
    CHAOS_SHARE,
    KL_BETA,
    LOSS_FLOOR,
    S,
    bf16_setup,
    check_bf16,
    check_parity,
    check_train,
    jax_train,
)
from tests.torch_port_common import jax_gumbel, jax_mixture_uniforms, jax_plan_noise

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mcil_setup():
    return bf16_setup("mcil_debug", seed=86)


def test_mcil_train_losses_and_grads_match_jax(mcil_setup):
    """``mcil_debug`` (the bf16 BiRNN recognition's input projections, the
    Normal plan from an fp32 ``fc_state``), the fused batch, eval
    preprocessing, JAX's plan noise: losses and gradients by the parity
    rule."""
    setup = mcil_setup
    fused = CombinedLoader.fuse_batch(setup["raw"])
    key = jax.random.key(89)
    want = jax_train(setup, key, None, fused, train=False)
    model = setup["model"]
    batch = preprocess_batch(setup["cfg"], batch_to_device({k: ModalityBatch(*m) for k, m in fused.items()}, "cpu"),
                             train=False)
    normal = jax_plan_noise(jax.random.split(key)[1], 2 * B, setup["jax_cfgs"]["float32"])["normal"]
    got = model.train().train_losses(batch, KL_BETA, normal=normal)
    got["total_loss"].backward()
    model.eval()
    check_train("mcil_debug train", setup, got, model, want)


@pytest.fixture(scope="module")
def hulc_setup():
    return bf16_setup("hulc_debug", seed=84)


def _val_noise(key, scopes, cfg):
    """The noise JAX's val_metrics draws, by scope (a key split per scope in
    key order, then lmp_val's four-way split)."""
    out = {}
    for scope in sorted(scopes):
        key, k = jax.random.split(key)
        k_pp, k_pr, k_act_pp, k_act_pr = jax.random.split(k, 4)
        noise = {}
        for tag, k_plan, k_act in (("pp", k_pp, k_act_pp), ("pr", k_pr, k_act_pr)):
            noise[f"gumbel_{tag}"] = jax_gumbel(k_plan, B, cfg)
            u_mix, u_inv = jax_mixture_uniforms(k_act, B * S, cfg)
            noise[f"u_mix_{tag}"] = u_mix.reshape(B, S, *u_mix.shape[2:])
            noise[f"u_inv_{tag}"] = u_inv.reshape(B, S, *u_inv.shape[2:])
        out[scope] = noise
    return out


def test_hulc_val_metrics_match_jax(hulc_setup):
    """A validation step on the language scope (bf16 frames from the eval
    preprocess of both cameras; both plans decoded, the CLIP loss), on
    JAX's noise: every metric by the parity rule."""
    setup = hulc_setup
    raw, key = {"lang": setup["raw"]["lang"]}, jax.random.key(90)
    want = {}
    for dt, jax_model in setup["jax_models"].items():
        prep = jax_preprocess_batch(setup["jax_cfgs"][dt], raw, rng=None, train=False)
        want[dt] = jax.device_get(jax.jit(
            lambda p, k, b, m=jax_model: m.apply({"params": p}, k, b, KL_BETA, method=m.val_metrics)
        )(setup["params"], key, prep))
    batch = preprocess_batch(setup["cfg"], batch_to_device({k: ModalityBatch(*m) for k, m in raw.items()}, "cpu"),
                             train=False)
    with torch.no_grad():
        noise = _val_noise(key, raw, setup["jax_cfgs"]["float32"])
        got = setup["model"].eval().val_metrics(batch, KL_BETA, noise=noise)
    assert set(got) == set(want["bfloat16"]) and {"lang_mae_pr", "val_pred_clip_loss"} <= set(got)
    rows = []
    for k in sorted(want["bfloat16"]):
        assert got[k].shape == want["bfloat16"][k].shape, k
        rows.append(check_parity(k, got[k], want["bfloat16"][k], want["float32"][k], CHAOS_SHARE, floor=LOSS_FLOOR))
    check_bf16("val metrics", rows)
