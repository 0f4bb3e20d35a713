"""The port's LH-MTLC evaluators against the JAX package's on the CPU.

* The scripted expert through both batched evaluators (1, 3 and 4 lanes,
  chain counts that are not a multiple of the lanes, with and without
  matched initial states, the uniform-sampling fallback) and through both
  sequential ones gives byte-identical results.json files.
* The port's BatchedHulcPolicy at ``hulc_debug``, holding the JAX weights
  (``params_from_jax``) and fed the noise JAX's BatchedHulcPolicy draws
  from its key, gives JAX's evaluator's actions within 1e-4 at every env
  step, the same results.json and the same t-SNE dump (ids and labels
  equal, plans and latent goals within 1e-4).
* The port's HulcPolicy, with the same weights and fed the noise JAX's
  HulcPolicy draws, through both sequential evaluators: the same actions
  within 1e-4, the same results.json and the same t-SNE dump.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.evaluation import chain_sampler as jax_chains
from hulc_tpu.evaluation import expert as jax_expert
from hulc_tpu.evaluation import fake_env as jax_env
from hulc_tpu.evaluation import lh_eval as jax_lh_eval
from hulc_tpu.evaluation.batched_eval import evaluate_policy_batched as jax_evaluate_policy_batched
from hulc_tpu.evaluation.policy import HulcPolicy as JaxHulcPolicy

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.evaluation import chain_sampler, expert, fake_env, lh_eval
from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy, evaluate_policy_batched
from hulc_tpu_torch.evaluation.policy import HulcPolicy
from hulc_tpu_torch.models import make_model
from tests.torch_port_common import (
    jax_batched_step_noise, jax_gumbel, jax_init, jax_mixture_uniforms, port_model_from_jax,
)

torch.set_num_threads(1)

ATOL = 1e-4
JAX_CFG = jax_config.get_config("hulc_debug")
PORT_CFG = port_config.get_config("hulc_debug")
#: each package's (config, evaluator, chain sampler, expert module, env module)
SIDES = {
    "jax": (JAX_CFG, jax_evaluate_policy_batched, jax_chains, jax_expert, jax_env, jax_lh_eval),
    "port": (PORT_CFG, evaluate_policy_batched, chain_sampler, expert, fake_env, lh_eval),
}


def _expert_batched(side, out, lanes, n_chains, matched, ep_len=240):
    cfg, evaluate, chains_mod, expert_mod, env_mod, _ = SIDES[side]
    embs = expert_mod.task_embeddings(cfg.lang_dim)
    envs = [env_mod.FakeCalvinEnv(interactive=True, seed=i) for i in range(lanes)]
    if n_chains is None:  # the evaluator's uniform fallback over its own pool
        sequences, initial_states = None, None
    else:
        pairs = chains_mod.get_sequences(n_chains, seed=5)
        sequences = [chain for _, chain in pairs]
        initial_states = chains_mod.resets_for_env(pairs, envs[0]) if matched else None
    results = evaluate(
        cfg, None, num_sequences=7, ep_len=ep_len, sequences=sequences, lang_embeddings=embs,
        output_dir=out, envs=envs, policy=expert_mod.ScriptedExpertPolicy(lanes, embs),
        initial_states=initial_states, seed=2,
    )
    assert isinstance(results.pop("_policy"), expert_mod.ScriptedExpertPolicy)
    return results, (out / "results.json").read_bytes()


@pytest.mark.parametrize(
    "lanes,n_chains,matched",
    [(1, 8, True), (3, 8, True), (4, 7, True), (3, 7, False), (3, None, False)],
    ids=["1lane", "3lanes", "4lanes_7chains", "3lanes_env_resets", "3lanes_uniform_chains"],
)
def test_expert_batched_results_match_jax(tmp_path, lanes, n_chains, matched):
    """Chain for chain the same successes: identical results.json."""
    want, want_bytes = _expert_batched("jax", tmp_path / "jax", lanes, n_chains, matched)
    got, got_bytes = _expert_batched("port", tmp_path / "port", lanes, n_chains, matched)
    assert got == want
    assert got_bytes == want_bytes
    if matched:
        assert want["0"]["avg_seq_len"] > 3.5  # the expert succeeds, so successes are compared


class _SingleLaneExpert:
    """The expert behind the sequential policy contract (``reset`` /
    ``step(obs, instruction)``), the instruction being the task name."""

    def __init__(self, expert_mod, embs):
        self.embs = embs
        self.inner = expert_mod.ScriptedExpertPolicy(1, embs)
        self.reset()

    def reset(self):
        self.state, self.replan = self.inner.initial_state(), True

    def step(self, obs, instruction):
        actions, self.state = self.inner.step([obs], self.embs[instruction][None], self.state,
                                              np.array([self.replan]))
        self.replan = False
        return actions[0]


@pytest.mark.parametrize("matched", [True, False], ids=["matched_resets", "env_resets"])
def test_expert_sequential_results_match_jax(tmp_path, matched):
    out = {}
    for side in ("jax", "port"):
        cfg, _, chains_mod, expert_mod, env_mod, lh = SIDES[side]
        env = env_mod.FakeCalvinEnv(interactive=True, seed=3)
        pairs = chains_mod.get_sequences(6, seed=7)
        results = lh.evaluate_policy(
            _SingleLaneExpert(expert_mod, expert_mod.task_embeddings(cfg.lang_dim)), env,
            ep_len=240, sequences=[c for _, c in pairs],
            initial_states=chains_mod.resets_for_env(pairs, env) if matched else None,
            output_dir=tmp_path / side,
        )
        out[side] = results, (tmp_path / side / "results.json").read_bytes()
    assert out["port"] == out["jax"]
    if matched:
        assert out["jax"][0]["0"]["avg_seq_len"] > 3.5


@pytest.mark.parametrize("seed", [0, 3])
def test_uniform_get_sequences_matches_jax(seed):
    pool = sorted(lh_eval.ALL_TASKS)[:4]
    assert lh_eval.get_sequences(20, seed=seed) == jax_lh_eval.get_sequences(20, seed=seed)
    assert lh_eval.get_sequences(5, tasks=pool, seed=seed) == jax_lh_eval.get_sequences(5, tasks=pool, seed=seed)


# --------------------------------------------------------------------------
# the model policy
# --------------------------------------------------------------------------

LANES, N_CHAINS, EP_LEN, REPLAN = 3, 4, 12, 5


class _RecordingEnv:
    """An env that keeps every action it is stepped with."""

    def __init__(self, env):
        self.env, self.actions = env, []

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, action):
        self.actions.append(np.asarray(action, np.float32).copy())
        return self.env.step(action)

    def get_info(self):
        return self.env.get_info()

    def get_obs(self):
        return self.env.get_obs()


class _JaxNoisePolicy:
    """The port's BatchedHulcPolicy fed the noise that JAX's draws from
    ``jax.random.key(seed)``: one split per step, then (plan, act)."""

    def __init__(self, inner, seed):
        self.inner, self.rng = inner, jax.random.key(seed)
        self.num_envs, self.replan_freq = inner.num_envs, inner.replan_freq

    def initial_state(self):
        return self.inner.initial_state()

    def step(self, obs_batch, lang_embs, state, replan_mask):
        self.rng, k = jax.random.split(self.rng)
        noise = jax_batched_step_noise(k, self.num_envs, self.inner.cfg)
        return self.inner.step(obs_batch, lang_embs, state, replan_mask, noise=noise)


@pytest.fixture(scope="module")
def debug_weights():
    _, params = jax_init(JAX_CFG)
    return params, port_model_from_jax(params, PORT_CFG)[0]


def _model_run(side, out, params, port_model):
    cfg, evaluate, chains_mod, _, env_mod, _ = SIDES[side]
    cfg = dataclasses.replace(cfg, replan_freq=REPLAN)  # replans inside an instruction too
    rng = np.random.default_rng(0)
    embs = {t: rng.normal(size=cfg.lang_dim).astype(np.float32) for t in lh_eval.ALL_TASKS}
    envs = [_RecordingEnv(env_mod.fake_env_for(cfg, interactive=True)) for _ in range(LANES)]
    pairs = chains_mod.get_sequences(N_CHAINS, seed=1)
    kw = dict(
        num_envs=LANES, ep_len=EP_LEN, sequences=[c for _, c in pairs], lang_embeddings=embs,
        output_dir=out, envs=envs, initial_states=chains_mod.resets_for_env(pairs, envs[0].env),
        seed=4, tsne_path=out / "tsne.npz",
    )
    if side == "jax":
        evaluate(cfg, params, **kw)
    else:
        policy = _JaxNoisePolicy(BatchedHulcPolicy(cfg, port_model, LANES, seed=4), seed=4)
        evaluate(cfg, None, policy=policy, **kw)
    return [e.actions for e in envs], (out / "results.json").read_bytes(), dict(np.load(out / "tsne.npz"))


def test_model_policy_through_evaluator_matches_jax(tmp_path, debug_weights):
    params, port_model = debug_weights
    want_actions, want_results, want_tsne = _model_run("jax", tmp_path / "jax", params, None)
    got_actions, got_results, got_tsne = _model_run("port", tmp_path / "port", None, port_model)
    assert [len(a) for a in got_actions] == [len(a) for a in want_actions]
    assert sum(len(a) for a in want_actions) >= N_CHAINS * EP_LEN
    for lane, (got, want) in enumerate(zip(got_actions, want_actions)):
        np.testing.assert_allclose(np.stack(got), np.stack(want), atol=ATOL, rtol=0, err_msg=f"lane {lane}")
    assert got_results == want_results
    assert got_tsne.keys() == want_tsne.keys() == {"ids", "labels", "plans", "latent_goals"}
    np.testing.assert_array_equal(got_tsne["ids"], want_tsne["ids"])
    np.testing.assert_array_equal(got_tsne["labels"], want_tsne["labels"])
    assert len(want_tsne["ids"]) >= N_CHAINS
    for key in ("plans", "latent_goals"):
        assert got_tsne[key].dtype == want_tsne[key].dtype == np.float32
        np.testing.assert_allclose(got_tsne[key], want_tsne[key], atol=ATOL, rtol=0, err_msg=key)


class _JaxNoiseHulcPolicy:
    """The port's HulcPolicy fed the noise that JAX's HulcPolicy draws: after
    a reset the chain restarts from ``jax.random.key(seed)``; a step that
    plans splits off the plan key, and every step then splits off the act
    key. The policy's state stays readable for the t-SNE capture."""

    def __init__(self, inner, seed):
        self.inner, self.base, self.rng = inner, jax.random.key(seed), None

    @property
    def _state(self):
        return self.inner._state

    def reset(self):
        self.inner.reset()
        self.rng = None

    def step(self, obs, goal):
        state, cfg, noise = self.inner._state, self.inner.cfg, {}
        if state is None or state.step_count % self.inner.replan_freq == 0:
            self.rng, k = jax.random.split(self.base if state is None else self.rng)
            noise["gumbel"] = jax_gumbel(k, 1, cfg)
        self.rng, k_act = jax.random.split(self.rng)
        noise["u_mix"], noise["u_inv"] = jax_mixture_uniforms(k_act, 1, cfg)
        return self.inner.step(obs, goal, noise=noise)


def _sequential_model_run(side, out, params, port_model):
    cfg, _, chains_mod, _, env_mod, lh = SIDES[side]
    cfg = dataclasses.replace(cfg, replan_freq=REPLAN)
    rng = np.random.default_rng(0)
    embs = {t: rng.normal(size=cfg.lang_dim).astype(np.float32) for t in lh_eval.ALL_TASKS}
    env = _RecordingEnv(env_mod.fake_env_for(cfg, interactive=True))
    pairs = chains_mod.get_sequences(N_CHAINS, seed=1)
    if side == "jax":
        policy = JaxHulcPolicy(cfg, params, lang_embeddings=embs, seed=4)
    else:
        policy = _JaxNoiseHulcPolicy(HulcPolicy(cfg, port_model, lang_embeddings=embs, seed=4), seed=4)
    lh.evaluate_policy(
        policy, env, ep_len=EP_LEN, sequences=[c for _, c in pairs],
        initial_states=chains_mod.resets_for_env(pairs, env.env), output_dir=out, tsne_path=out / "tsne.npz",
    )
    return env.actions, (out / "results.json").read_bytes(), dict(np.load(out / "tsne.npz"))


def test_model_policy_through_sequential_evaluator_matches_jax(tmp_path, debug_weights):
    params, port_model = debug_weights
    want_actions, want_results, want_tsne = _sequential_model_run("jax", tmp_path / "jax", params, None)
    got_actions, got_results, got_tsne = _sequential_model_run("port", tmp_path / "port", None, port_model)
    assert len(got_actions) == len(want_actions) >= N_CHAINS * EP_LEN
    np.testing.assert_allclose(np.stack(got_actions), np.stack(want_actions), atol=ATOL, rtol=0)
    assert got_results == want_results
    assert got_tsne.keys() == want_tsne.keys() == {"ids", "labels", "plans", "latent_goals"}
    np.testing.assert_array_equal(got_tsne["ids"], want_tsne["ids"])
    np.testing.assert_array_equal(got_tsne["labels"], want_tsne["labels"])
    assert len(want_tsne["ids"]) >= N_CHAINS
    for key in ("plans", "latent_goals"):
        assert got_tsne[key].dtype == want_tsne[key].dtype == np.float32
        np.testing.assert_allclose(got_tsne[key], want_tsne[key], atol=ATOL, rtol=0, err_msg=key)


def test_evaluator_loads_given_model_into_policy(tmp_path, debug_weights):
    """A model and a policy: the policy's model takes the model's weights in
    place (no new policy), and its lanes bound the evaluator's."""
    _, port_model = debug_weights
    policy = BatchedHulcPolicy(PORT_CFG, make_model(PORT_CFG, "cpu", seed=9), 2, seed=0)
    policy_model = policy.model
    results = evaluate_policy_batched(
        PORT_CFG, port_model, env_factory=lambda: fake_env.fake_env_for(PORT_CFG), num_envs=8,
        ep_len=2, sequences=[["open_drawer"]] * 3, output_dir=tmp_path, policy=policy,
    )
    assert results["_policy"] is policy and policy.model is policy_model
    for name, p in port_model.state_dict().items():
        assert torch.equal(policy_model.state_dict()[name], p), name
    assert results["0"]["task_info"] == {"open_drawer": {"success": 0, "total": 3}}


def test_eval_split_counts_and_clocks(tmp_path, debug_weights):
    """eval_split's wrappers: every chain started once, the iterations the
    evaluator ran, the env steps against them, the first iterations kept as
    the policy saw them, and the sequential run's replans."""
    from hulc_tpu_torch.evaluation.eval_split import run_batched, run_sequential
    from hulc_tpu_torch.evaluation.policy import HulcPolicy

    _, port_model = debug_weights
    policy = BatchedHulcPolicy(PORT_CFG, port_model, LANES, seed=0)
    stats, timed, started = run_batched(PORT_CFG, policy, N_CHAINS, 7, 0, tmp_path / "batched", record=2)
    assert sorted(started) == list(range(N_CHAINS))
    iters = stats["lockstep_iters"]
    assert iters == timed.calls and stats["lanes"] == LANES
    assert iters <= stats["env_steps"] <= LANES * iters and stats["env_steps"] >= N_CHAINS * 7
    assert 0 < stats["policy_s"] < stats["wall_s"]
    assert stats["env_oracle_loop_s"] == pytest.approx(stats["wall_s"] - stats["policy_s"])
    first, second = timed.records
    assert first.replan_mask.all() and not second.replan_mask.any()
    assert first.actions.shape == (LANES, 7) and first.new_state[0].shape == (LANES, 16)
    assert second.state is first.new_state
    assert (tmp_path / "batched" / "results.json").exists()

    embs = {t: np.ones(PORT_CFG.lang_dim, np.float32) for t in lh_eval.ALL_TASKS}
    seq, seq_started = run_sequential(PORT_CFG, HulcPolicy(PORT_CFG, port_model, lang_embeddings=embs), 2, 35, 0,
                                      tmp_path / "seq")
    assert seq_started == [0, 1]
    # random weights: both chains time out on their first instruction, which
    # plans at its step 0 and at step replan_freq = 30
    assert seq["results"]["avg_seq_len"] == 0.0
    assert seq["env_steps"] == seq["policy_steps"] == 2 * 35
    assert seq["replans"] == 2 * 2
