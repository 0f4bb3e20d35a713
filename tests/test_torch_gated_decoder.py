"""The decoder's gated cells through the port's policies and serving
export against the JAX package on the CPU: ``hulc_debug`` with
``action_decoder.rnn_cell`` set to gru or to lstm by ``apply_overrides`` in
both packages (``torch_port_common.gated_cfg``; the weights' conversion,
the train step's losses and gradients and the validation metrics are in
tests/test_torch_gated_rnn.py). The live policies and their served
artifact, on JAX's noise, against JAX's served artifact of the same
weights within 1e-4 (across replans, a ``reset()``, and replans of
only some lanes, which reset those lanes' carries: lstm's is the pair (h,
c)); served actions bit-equal to the live ones on the same noise; each
program that acts holding one op node of the cell a decoder layer; and
``meta.json`` key by key against JAX's."""

import json

import jax
import numpy as np
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.serving import ServedBatchedPolicy as JaxServedBatchedPolicy
from hulc_tpu.serving import ServedPolicy as JaxServedPolicy
from hulc_tpu.serving import export_policy as jax_export_policy

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
from hulc_tpu_torch.evaluation.fake_env import fake_env_for
from hulc_tpu_torch.evaluation.policy import HulcPolicy
from hulc_tpu_torch.serving import ServedBatchedPolicy, ServedPolicy, export_policy
from hulc_tpu_torch.serving.export import op_counts
from tests.torch_port_common import gated_setup, jax_batched_step_noise, jax_gumbel, jax_mixture_uniforms

torch.set_num_threads(1)

ATOL = 1e-4  # plans, MAEs and actions: the x100 of the TCP-frame rotation
LANES = 3
TASK = "push_red_block_right"
CELLS = ("gru", "lstm")


@pytest.fixture(scope="module", params=CELLS)
def setup(request, tmp_path_factory):
    """``gated_setup`` of the cell, and both packages' artifacts of its
    weights (3 lanes, the same language embedding)."""
    out = gated_setup(request.param, jax_config, port_config)
    lang = {TASK: out["lang"]}
    out["dir"], out["jax_dir"] = tmp_path_factory.mktemp("port_artifact"), tmp_path_factory.mktemp("jax_artifact")
    export_policy(out["cfg"], out["model"].state_dict(), out["dir"], lang_embeddings=lang, lanes=LANES, device="cpu")
    jax_export_policy(out["jax_cfg"], out["params"], out["jax_dir"], lang_embeddings=lang, platforms=None,
                      lanes=LANES)
    out["lang"] = lang
    return out


# ---------------------------------------------------------------------------
# policies, live and served
# ---------------------------------------------------------------------------

class _JaxNoise:
    """The noise JAX's ``HulcPolicy`` (and its ``ServedPolicy``) draws from
    its key schedule, as the port's ``step(noise=)`` takes it."""

    def __init__(self, seed, cfg):
        self.base = self.rng = jax.random.key(seed)
        self.cfg = cfg

    def reset(self):
        self.rng = self.base

    def step(self, plans: bool):
        noise = {}
        if plans:
            self.rng, k = jax.random.split(self.rng)
            noise["gumbel"] = jax_gumbel(k, 1, self.cfg)
        self.rng, k_act = jax.random.split(self.rng)
        noise["u_mix"], noise["u_inv"] = jax_mixture_uniforms(k_act, 1, self.cfg)
        return noise


def test_policy_and_served_policy_match_jax_across_replans_and_reset(setup):
    """``HulcPolicy`` and the port's ``ServedPolicy``, each fed the noise
    JAX's ``ServedPolicy`` draws, over two language-goal episodes of 7 and
    4 steps (replans at 0, 3, 6; ``reset()`` between): within 1e-4 of JAX's
    served actions, and the served port bit-equal to the live port."""
    cfg, lang = setup["cfg"], setup["lang"]
    jax_served = JaxServedPolicy(setup["jax_dir"], seed=5)
    live = HulcPolicy(cfg, setup["model"], lang_embeddings=lang, seed=5)
    served = ServedPolicy(setup["dir"], seed=5, device="cpu")
    noise = _JaxNoise(5, setup["jax_cfg"])
    env = fake_env_for(cfg)
    for episode, steps in enumerate((7, 4)):
        obs = env.reset()
        for p in (jax_served, live, served, noise):
            p.reset()
        for t in range(steps):
            want = jax_served.step(obs, TASK)
            n = noise.step(t % cfg.replan_freq == 0)
            got = live.step(obs, TASK, noise=n)
            assert got.shape == (7,)
            np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, err_msg=f"episode {episode} step {t}")
            np.testing.assert_array_equal(served.step(obs, TASK, noise=n), got)
            obs = env.step(got)
    assert isinstance(live._state.carry, tuple) == (setup["cell"] == "lstm")


def test_batched_policies_match_jax_across_lane_replans(setup):
    """``BatchedHulcPolicy`` and the port's ``ServedBatchedPolicy`` at 3
    lanes, each fed the noise of JAX's lockstep step, against JAX's
    ``ServedBatchedPolicy``, replanning only some lanes at some steps: those
    lanes' carries (lstm's h and c) restart from zero, the others run on.
    Actions and carries within 1e-4 of JAX's; served bit-equal to live."""
    cfg, jax_cfg = setup["cfg"], setup["jax_cfg"]
    jax_served = JaxServedBatchedPolicy(setup["jax_dir"], seed=9)
    live = BatchedHulcPolicy(cfg, setup["model"], LANES, seed=9)
    served = ServedBatchedPolicy(setup["dir"], seed=9, device="cpu")
    rng = jax.random.key(9)
    envs = [fake_env_for(cfg) for _ in range(LANES)]
    obs_batch = [e.reset() for e in envs]
    embs = np.stack([setup["lang"][TASK]] * LANES)
    s_jax, s_live, s_served = jax_served.initial_state(), live.initial_state(), served.initial_state()
    assert isinstance(s_served[2], tuple) == isinstance(s_live[2], tuple) == (setup["cell"] == "lstm")
    replan = np.ones(LANES, bool)
    for t in range(5):
        want, s_jax = jax_served.step(obs_batch, embs, s_jax, replan)
        rng, k = jax.random.split(rng)
        noise = jax_batched_step_noise(k, LANES, jax_cfg)
        got, s_live = live.step(obs_batch, embs, s_live, replan, noise=noise)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, err_msg=f"step {t}")
        for g, w in zip(jax.tree.leaves(s_live[2]), jax.tree.leaves(s_jax[2])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0, err_msg=f"carry at step {t}")
        a_served, s_served = served.step(obs_batch, embs, s_served, replan, noise=noise)
        np.testing.assert_array_equal(a_served, got)
        obs_batch = [e.step(a) for e, a in zip(envs, got)]
        replan = np.array([t % 2 == 0, False, t == 1])


def test_artifact_ops_and_meta_match_jax(setup):
    """Each program that acts holds one op node of the cell a decoder layer
    (and none of the relu cell's); ``meta.json`` key by key against JAX's
    artifact's (only the framework's own keys differ), its carry spec the
    cell's."""
    cell, cfg = setup["cell"], setup["cfg"]
    for name in ("act", "step_batched"):
        counts = op_counts(torch.export.load(setup["dir"] / f"{name}.pt2"))
        assert counts[f"rnn_{cell}_fwd"] == cfg.action_decoder.num_layers and "rnn_relu_fwd" not in counts, name
    port_meta, jax_meta = (json.loads((d / "meta.json").read_text()) for d in (setup["dir"], setup["jax_dir"]))
    assert set(port_meta) - set(jax_meta) == {"torch_version", "device", "noise"}
    assert set(jax_meta) - set(port_meta) == {"jax_version", "platforms"}
    for key in set(port_meta) & set(jax_meta):
        assert port_meta[key] == jax_meta[key], key
    assert port_meta["carry"] == {"rnn_cell": cell, "num_layers": 2, "hidden_size": cfg.action_decoder.hidden_size}
