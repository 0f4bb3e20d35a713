"""bf16 compute (``compute_dtype="bfloat16"``) in the port's policies
and serving export against the JAX package on the CPU, at
``hulc_debug`` (tests/torch_bf16_common.py's configuration): the
single-lane and the lockstep policies' actions on JAX's noise, each by
tests/test_torch_bf16.py's end-to-end parity rule; a bf16 export served
bit-equal to the live bf16 policy, its programs' ops and ``meta.json``."""

import json

import jax
import numpy as np
import pytest
import torch

from hulc_tpu.evaluation.batched_eval import BatchedHulcPolicy as JaxBatchedHulcPolicy
from hulc_tpu.evaluation.policy import HulcPolicy as JaxHulcPolicy

from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
from hulc_tpu_torch.evaluation.fake_env import fake_env_for
from hulc_tpu_torch.evaluation.policy import HulcPolicy
from hulc_tpu_torch.serving import ServedBatchedPolicy, ServedPolicy, export_policy
from hulc_tpu_torch.serving.export import op_counts
from tests.torch_bf16_common import CHAOS_SHARE, LANES, bf16_setup, check_bf16, check_parity
from tests.torch_port_common import jax_batched_step_noise, jax_gumbel, jax_mixture_uniforms

torch.set_num_threads(1)

TASK = "push_red_block_right"


@pytest.fixture(scope="module")
def hulc_setup():
    return bf16_setup("hulc_debug", seed=84)


class _JaxNoise:
    """The noise JAX's ``HulcPolicy`` draws from its key schedule, as the
    port's ``step(noise=)`` takes it."""

    def __init__(self, seed, cfg):
        self.rng = jax.random.key(seed)
        self.cfg = cfg

    def step(self, plans: bool):
        noise = {}
        if plans:
            self.rng, k = jax.random.split(self.rng)
            noise["gumbel"] = jax_gumbel(k, 1, self.cfg)
        self.rng, k_act = jax.random.split(self.rng)
        noise["u_mix"], noise["u_inv"] = jax_mixture_uniforms(k_act, 1, self.cfg)
        return noise


@pytest.fixture(scope="module")
def hulc_artifact(hulc_setup, tmp_path_factory):
    out = tmp_path_factory.mktemp("bf16_artifact")
    lang = np.random.default_rng(91).normal(size=hulc_setup["cfg"].lang_dim).astype(np.float32)
    export_policy(hulc_setup["cfg"], hulc_setup["model"], out, lang_embeddings={TASK: lang}, lanes=LANES,
                  device="cpu")
    return out, {TASK: lang}


def test_hulc_policy_and_served_policy_match_jax(hulc_setup, hulc_artifact):
    """``HulcPolicy`` over 5 language-goal steps (replans at 0, 3) on
    the noise JAX's draws: the actions by the parity rule against JAX's
    bf16 and fp32 policies; the bf16 artifact's ``ServedPolicy`` on the same
    noise bit-equal to the live policy."""
    setup = hulc_setup
    art, lang = hulc_artifact
    cfg = setup["cfg"]
    jax_policies = {dt: JaxHulcPolicy(setup["jax_cfgs"][dt], setup["params"], lang_embeddings=lang, seed=5)
                    for dt in setup["jax_models"]}
    live = HulcPolicy(cfg, setup["model"], lang_embeddings=lang, seed=5)
    served = ServedPolicy(art, seed=5, device="cpu")
    noise = _JaxNoise(5, setup["jax_cfgs"]["float32"])
    env = fake_env_for(cfg)
    obs = env.reset()
    for p in (*jax_policies.values(), live, served):
        p.reset()
    got, want16, want32 = [], [], []
    for t in range(5):
        want16.append(np.asarray(jax_policies["bfloat16"].step(obs, TASK)))
        want32.append(np.asarray(jax_policies["float32"].step(obs, TASK)))
        n = noise.step(t % cfg.replan_freq == 0)
        got.append(live.step(obs, TASK, noise=n))
        np.testing.assert_array_equal(served.step(obs, TASK, noise=n), got[-1])
        obs = env.step(got[-1])
    check_bf16("single lane", [check_parity("single-lane actions", np.stack(got), np.stack(want16), np.stack(want32), CHAOS_SHARE)])


def test_hulc_batched_policies_match_jax(hulc_setup, hulc_artifact):
    """``BatchedHulcPolicy`` at 3 lanes over 3 lockstep steps (some lanes
    replanning at some steps) on the noise of JAX's lockstep step: actions
    and carries by the parity rule against JAX's bf16 and fp32 policies;
    the bf16 artifact's ``ServedBatchedPolicy`` bit-equal to the live one."""
    setup = hulc_setup
    art, lang = hulc_artifact
    cfg = setup["cfg"]
    jax_policies = {dt: JaxBatchedHulcPolicy(setup["jax_cfgs"][dt], setup["params"], LANES, seed=9)
                    for dt in setup["jax_models"]}
    live = BatchedHulcPolicy(cfg, setup["model"], LANES, seed=9)
    served = ServedBatchedPolicy(art, seed=9, device="cpu")
    envs = [fake_env_for(cfg) for _ in range(LANES)]
    obs_batch = [e.reset() for e in envs]
    embs = np.stack([lang[TASK]] * LANES)
    states = {dt: p.initial_state() for dt, p in jax_policies.items()}
    s_live, s_served = live.initial_state(), served.initial_state()
    rng = jax.random.key(9)
    replan = np.ones(LANES, bool)
    got, want16, want32, carries = [], [], [], []
    for t in range(3):
        a16, states["bfloat16"] = jax_policies["bfloat16"].step(obs_batch, embs, states["bfloat16"], replan)
        a32, states["float32"] = jax_policies["float32"].step(obs_batch, embs, states["float32"], replan)
        rng, k = jax.random.split(rng)
        noise = jax_batched_step_noise(k, LANES, setup["jax_cfgs"]["float32"])
        a, s_live = live.step(obs_batch, embs, s_live, replan, noise=noise)
        a_served, s_served = served.step(obs_batch, embs, s_served, replan, noise=noise)
        np.testing.assert_array_equal(a_served, a)
        got.append(a), want16.append(np.asarray(a16)), want32.append(np.asarray(a32))
        carries.append((s_live[2], states["bfloat16"][2], states["float32"][2]))
        obs_batch = [e.step(x) for e, x in zip(envs, a)]
        replan = np.array([t % 2 == 0, False, t == 1])
    check_bf16("lockstep", [
        check_parity("batched actions", np.stack(got), np.stack(want16), np.stack(want32), CHAOS_SHARE),
        check_parity("batched carries", *(np.stack([np.asarray(c[i]) for c in carries]) for i in range(3)),
                     CHAOS_SHARE)])


def test_bf16_artifact_holds_its_ops_and_records_its_dtype(hulc_setup, hulc_artifact):
    """The bf16 artifact's programs hold the serving ops (SpatialSoftmax's
    one node per static-camera encode on the bf16 map), ``params.npz`` is
    fp32, and ``meta.json`` records ``compute_dtype``."""
    art, _ = hulc_artifact
    meta = json.loads((art / "meta.json").read_text())
    assert meta["compute_dtype"] == "bfloat16"
    params = np.load(art / "params.npz")
    assert {params[k].dtype for k in params.files} == {np.dtype(np.float32)}
    for name in ("replan_lang", "act", "step_batched"):
        counts = op_counts(torch.export.load(art / f"{name}.pt2"))
        assert counts["spatial_softmax"] >= 1 and counts["preprocess_rgb"] == 2, (name, counts)
