"""GCBC and the deterministic decoder (with its RNN and with the ``mlp``
cell) in the port against the JAX package on the CPU, at debug width
(``gcbc_debug``; ``hulc_debug`` with ``action_decoder.kind=deterministic``
and ``action_decoder.rnn_cell=mlp`` by ``apply_overrides``; replan every 3
steps, the recognition network's dropout 0): the presets field by field
and their full-width parameter counts, the weights' conversion, the train
losses and gradients (fused and per modality), the validation metrics,
``HulcPolicy`` and ``BatchedHulcPolicy`` on JAX's noise, and the serving
export bit-equal to the live policies. The checks are
``torch_port_common.check_variant_*``; their tolerances are stated there
(losses rtol 1e-5, the whole gradient 1e-5 relative L2 and each leaf 1e-4, val
1e-4, the deterministic
decoder's TCP-frame criterion 5e-4, actions atol 1e-4).

GCBC draws no plan noise and has no plan proposal (JAX's init never calls
one); the deterministic decoder draws no action noise and trains on the
world-frame criterion while its validation takes the TCP frame's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.models import example_batch, init_params
from hulc_tpu.models import make_model as jax_make_model

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.models.hulc import HulcModel
from tests.torch_port_common import (
    check_variant_export,
    check_variant_policies,
    check_variant_train_step,
    check_variant_val,
    check_variant_weights,
    variant_setup,
)

torch.set_num_threads(1)

NAMES = ("gcbc", "deterministic", "deterministic_mlp")
PRESETS = ("gcbc", "gcbc_debug", "hulc_deterministic", "hulc_state_only", "state_only_debug", "fetch_state",
           "fetch_state_debug", "fetch_vision", "hulc_clip_vision", "hulc_clip_lang", "hulc_tactile")


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax_field_by_field(name):
    assert dataclasses.asdict(port_config.get_config(name)) == dataclasses.asdict(jax_config.get_config(name))


@pytest.mark.parametrize("name,overrides", [
    ("gcbc", []), ("hulc_deterministic", []), ("hulc_deterministic", ["action_decoder.rnn_cell=mlp"]),
    ("hulc_state_only", []), ("fetch_state", []), ("fetch_vision", []),
], ids=["gcbc", "hulc_deterministic", "hulc_deterministic_mlp", "hulc_state_only", "fetch_state", "fetch_vision"])
def test_full_width_parameter_count_is_jax(name, overrides):
    """The full-width model (on the meta device) holds as many parameters as
    JAX's init creates (traced, not run: ``jax.eval_shape``)."""
    cfg = port_config.apply_overrides(port_config.get_config(name), overrides)
    with torch.device("meta"):
        model = HulcModel(cfg)
    jcfg = jax_config.apply_overrides(jax_config.get_config(name), overrides)
    batch = {"vis": example_batch(jcfg, 1, 2), "lang": example_batch(jcfg, 1, 2, lang=True)}
    shapes = jax.eval_shape(lambda: init_params(jax_make_model(jcfg), jax.random.key(0), batch))
    assert sum(p.numel() for p in model.parameters()) == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert ("plan_proposal" in shapes) == (cfg.model_kind != "gcbc") == (model.plan_proposal is not None)


@pytest.mark.parametrize("name", NAMES)
def test_weights_convert_one_to_one(name):
    check_variant_weights(name)


@pytest.mark.parametrize("schema", ["fused", "split"])
@pytest.mark.parametrize("name", NAMES)
def test_train_losses_and_grads_match_jax(name, schema):
    got, want = check_variant_train_step(name, schema)
    if name == "gcbc":
        assert float(want["kl_loss"]) == 0.0 == float(got["kl_loss"])


@pytest.mark.parametrize("name", NAMES)
def test_val_metrics_match_jax(name):
    got, _ = check_variant_val(name)
    if name == "gcbc":
        assert float(got["vis_action_loss_pp"]) == float(got["vis_action_loss_pr"])
        assert got["sampled_plan_pp_lang"].shape == (3, 1)


@pytest.mark.parametrize("name", NAMES)
def test_policies_match_jax(name):
    check_variant_policies(name)


@pytest.mark.parametrize("name", ["gcbc", "deterministic_mlp", "clip_lang"])
def test_export_served_bit_equal_to_live(name, tmp_path):
    check_variant_export(name, tmp_path)
    v = variant_setup(name)
    if name == "deterministic_mlp":
        assert tuple(v["model"].init_decoder_carry(3).shape) == (0,)


def test_gcbc_refuses_plan_noise():
    model = variant_setup("gcbc")["model"]
    emb = torch.zeros(1, 1, model.cfg.perceptual_encoder.latent_size)
    with pytest.raises(ValueError, match="no plan noise"):
        model.propose_plan(emb, torch.zeros(1, 8), gumbel=torch.zeros(1, 4, 4))
    assert tuple(model.propose_plan(emb, torch.zeros(1, 8)).shape) == (1, 0)
