"""The port's copies of the evaluator's numpy modules against the JAX
package's originals on the CPU: the fake CALVIN env (scripted and
interactive, at ``hulc_debug``'s and the ``hulc`` preset's camera sizes),
the task oracle, the chain sampler, the scripted expert and the task-pool
restriction. These are copies, so every comparison is exact: byte-equal
frames, equal info dicts, equal task sets, chains and actions."""

import numpy as np
import pytest

from hulc_tpu import config as jax_config
from hulc_tpu.data.language import restrict_task_pool as jax_restrict_task_pool
from hulc_tpu.evaluation import chain_sampler as jax_chains
from hulc_tpu.evaluation import expert as jax_expert
from hulc_tpu.evaluation import fake_env as jax_env
from hulc_tpu.evaluation import tasks as jax_tasks

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.data.language import restrict_task_pool
from hulc_tpu_torch.evaluation import chain_sampler, expert, fake_env, tasks

#: (static px, gripper px) of hulc_debug and of the full-width hulc preset
SIZES = {"hulc_debug": (64, 48), "hulc": (200, 84)}
MODES = ("scripted", "interactive_expert", "interactive_random", "interactive_probe")


def _script(env, t):
    """A scripted scene: slider and drawer drift, the bulb turns on, the red
    block rises off the table."""
    env.scene_obs[0] = 0.01 * t
    env.scene_obs[1] = min(0.005 * t, 0.22)
    if t == 5:
        env.scene_obs[4] = 1.0
    env.scene_obs[8] += 0.002


def _random_actions(rng, n):
    a = rng.uniform(-1.0, 1.0, (n, 7)).astype(np.float32)
    a[:, 6] = rng.choice([-1.0, 0.0, 1.0], n)
    return a


def _assert_obs_equal(got, want):
    assert got.keys() == want.keys()
    for key in ("rgb_static", "rgb_gripper"):
        g, w = got["rgb_obs"][key], want["rgb_obs"][key]
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        assert g.tobytes() == w.tobytes(), key
    for key in ("robot_obs", "scene_obs"):
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes(), key
    assert got["depth_obs"] == want["depth_obs"]


def _assert_info_equal(got, want):
    assert got.keys() == want.keys()
    assert got["scene_obs"].tobytes() == want["scene_obs"].tobytes()
    assert got.get("block_contacts") == want.get("block_contacts")


class _Pair:
    """A JAX and a port FakeCalvinEnv built alike and stepped alike; every
    observation and info is compared, and the port's infos are kept."""

    def __init__(self, size, interactive, seed=0):
        static, gripper = SIZES[size]
        self.jax = jax_env.FakeCalvinEnv(static, gripper, seed=seed, interactive=interactive)
        self.port = fake_env.FakeCalvinEnv(static, gripper, seed=seed, interactive=interactive)
        self.infos = []

    def _check(self, j_obs, p_obs):
        _assert_obs_equal(p_obs, j_obs)
        j_info, p_info = self.jax.get_info(), self.port.get_info()
        _assert_info_equal(p_info, j_info)
        self.infos.append(p_info)
        return j_obs

    def reset(self, **kw):
        return self._check(self.jax.reset(**kw), self.port.reset(**kw))

    def step(self, action):
        return self._check(self.jax.step(action), self.port.step(action))


def _drive(size, mode, seed=0):
    """Roll a pair of envs in ``mode``; returns the pair."""
    rng = np.random.default_rng(seed)
    pair = _Pair(size, interactive=mode != "scripted", seed=seed)
    if mode == "scripted":
        pair.jax.script_scene(_script)
        pair.port.script_scene(_script)
        pair.reset()
        for a in _random_actions(rng, 40):
            pair.step(a)
    elif mode == "interactive_random":
        pair.reset()
        for a in _random_actions(rng, 60):
            pair.step(a)
    elif mode == "interactive_probe":
        # the TCP put at about one of the env's radii from a block, a handle
        # or a light site (in the table's plane or not), the gripper
        # closing and opening in turns: every threshold in play
        radii = (jax_env.GRASP_R, jax_env.PUSH_R, jax_env.HANDLE_R, jax_env.TOGGLE_R)
        pair.reset()
        for t, a in enumerate(_random_actions(rng, 400)):
            scene = pair.port.scene_obs
            sites = [scene[6:9], scene[12:15], scene[18:21], fake_env.slider_handle(float(scene[0])),
                     fake_env.drawer_handle(float(scene[1])), fake_env.BUTTON_SITE, fake_env.SWITCH_SITE]
            offset = rng.normal(size=3)
            offset[2] *= t % 2
            offset *= radii[rng.integers(len(radii))] * rng.uniform(0.97, 1.03) / np.linalg.norm(offset)
            tcp = (sites[rng.integers(len(sites))] + offset).astype(np.float32)
            for env in (pair.jax, pair.port):
                env.robot_obs[:3] = tcp
            a[:6] *= 0.1
            a[6] = (-1.0, 1.0)[(t // 2) % 2]
            pair.step(a)
    else:  # the JAX expert drives both envs through protocol chains
        embs = jax_expert.task_embeddings(32)
        oracle = jax_tasks.SceneObsTasks()
        for initial, chain in jax_chains.get_sequences(2, seed=seed + 3):
            robot, scene = jax_chains.initial_state_to_obs(initial)
            obs = pair.reset(robot_obs=robot, scene_obs=scene)
            policy = jax_expert.ScriptedExpertPolicy(1, embs)
            state, replan, start = policy.initial_state(), np.ones(1, bool), pair.jax.get_info()
            pos = steps = 0
            while pos < len(chain) and steps < 150:
                actions, state = policy.step([obs], np.stack([embs[chain[pos]]]), state, replan)
                obs, replan, steps = pair.step(actions[0]), np.zeros(1, bool), steps + 1
                if chain[pos] in oracle.get_task_info_for_set(start, pair.jax.get_info(), {chain[pos]}):
                    pos, steps, replan, start = pos + 1, 0, np.ones(1, bool), pair.jax.get_info()
    return pair


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("mode", MODES)
def test_fake_env_matches_jax(mode, size):
    """Same seed, same resets, same actions: byte-equal observations and
    equal infos at every step."""
    pair = _drive(size, mode)
    assert len(pair.infos) > 40


@pytest.fixture(scope="module")
def recorded_infos():
    """Infos of debug-size rollouts: with block contacts (interactive) and
    without (the oracle's position-derived fallbacks)."""
    return {
        "contacts": _drive("hulc_debug", "interactive_expert").infos
        + _drive("hulc_debug", "interactive_random", seed=1).infos
        + _drive("hulc_debug", "interactive_probe", seed=2).infos,
        "positions": _drive("hulc_debug", "scripted").infos,
    }


@pytest.mark.parametrize("regions", [None, {"drawer_box": ((0.0, 0.4), (-0.2, 0.25), (0.28, 0.44)),
                                            "table_z": 0.47, "table_z_tol": 0.03}])
@pytest.mark.parametrize("source", ["contacts", "positions"])
def test_oracle_matches_jax(recorded_infos, source, regions):
    """get_task_info and get_task_info_for_set over a few hundred recorded
    (start, end) pairs, with the nominal and with calibrated region boxes."""
    infos = recorded_infos[source]
    rng = np.random.default_rng(4)
    j_oracle, p_oracle = jax_tasks.SceneObsTasks(regions=regions), tasks.SceneObsTasks(regions=regions)
    assert p_oracle.tasks == j_oracle.tasks == jax_tasks.ALL_TASKS == tasks.ALL_TASKS
    found = set()
    for _ in range(300):
        i, j = sorted(rng.integers(0, len(infos), 2))
        start, end = infos[i], infos[j]
        want = j_oracle.get_task_info(start, end)
        assert p_oracle.get_task_info(start, end) == want
        subset = set(rng.choice(tasks.ALL_TASKS, 6, replace=False)) | {"not_a_task"}
        assert p_oracle.get_task_info_for_set(start, end, subset) == j_oracle.get_task_info_for_set(
            start, end, subset
        )
        found |= want
    assert found  # some task fires between the recorded states


def test_oracle_boxes_and_task_tables_match_jax():
    for name in ("DRAWER_BOX", "SLIDER_BOX", "TABLE_Z", "ROTATE_TASKS", "PUSH_TASKS", "DOOR_TASKS",
                 "LIFT_TASKS", "LIGHT_TASKS", "PLACE_TASKS", "BLOCKS"):
        assert getattr(tasks, name) == getattr(jax_tasks, name), name
    with pytest.raises(KeyError):
        tasks.SceneObsTasks(tasks=["bogus"])._check("bogus", {"scene_obs": np.zeros(24)}, {"scene_obs": np.zeros(24)})


def test_contacts_from_state_matches_jax(recorded_infos):
    """The pure contact reconstruction on recorded scene states, with the
    held block inferred (a closed gripper on a block, an open one, a random
    pose), none and named."""
    rng = np.random.default_rng(6)
    for info in recorded_infos["contacts"][::5]:
        scene = info["scene_obs"]
        robot = rng.normal(size=15).astype(np.float32)
        on_block = robot.copy()
        on_block[:3], on_block[14] = scene[6:9], -1.0
        opened = on_block.copy()
        opened[14] = 1.0
        for r in (robot, on_block, opened):
            for held in ("infer", None, "block_blue"):
                assert fake_env.contacts_from_state(r, scene, held=held) == jax_env.contacts_from_state(
                    r, scene, held=held
                )


@pytest.mark.parametrize("preset", sorted(SIZES))
def test_fake_env_for_matches_jax(preset):
    for interactive in (False, True):
        j = jax_env.fake_env_for(jax_config.get_config(preset), interactive=interactive)
        p = fake_env.fake_env_for(port_config.get_config(preset), interactive=interactive)
        assert (p.static_px, p.gripper_px, p.interactive) == (j.static_px, j.gripper_px, j.interactive)
        assert (p.static_px, p.gripper_px) == SIZES[preset]


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_chain_sampler_matches_jax(seed):
    """get_sequences over the full pool and a restricted one; the reset
    vectors of every chain's initial state."""
    pool = sorted(tasks.ALL_TASKS)[::2]
    for kw in ({}, {"tasks": pool, "chain_len": 4}):
        want = jax_chains.get_sequences(40, seed=seed, **kw)
        got = chain_sampler.get_sequences(40, seed=seed, **kw)
        assert got == want
    for (j_state, _), (p_state, _) in zip(want, got):
        for a, b in zip(chain_sampler.initial_state_to_obs(p_state), jax_chains.initial_state_to_obs(j_state)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_chain_sampler_rules_and_resets_match_jax():
    """Every valid initial state (and the mid-chain ones: a block grasped,
    stacked, in the drawer) through every task's rule and to reset vectors;
    resets_for_env on the port's env and on an unknown one."""
    states = chain_sampler.valid_initial_states()
    assert states == jax_chains.valid_initial_states()
    mid = [{**states[0], "red_block": where, "grasped": int(where == "grasped")}
           for where in ("grasped", "stacked", "drawer")]
    for state in states + mid:
        for task in sorted(chain_sampler.TASK_RULES):
            assert chain_sampler.feasible_effects(state, task) == jax_chains.feasible_effects(state, task)
        for a, b in zip(chain_sampler.initial_state_to_obs(state), jax_chains.initial_state_to_obs(state)):
            assert a.tobytes() == b.tobytes()
    pairs = chain_sampler.get_sequences(6, seed=1)
    got = chain_sampler.resets_for_env(pairs, fake_env.FakeCalvinEnv())
    want = jax_chains.resets_for_env(pairs, jax_env.FakeCalvinEnv())
    assert [(r.tobytes(), s.tobytes()) for r, s in got] == [(r.tobytes(), s.tobytes()) for r, s in want]
    assert chain_sampler.resets_for_env(pairs, object()) is None
    assert chain_sampler.chain_is_feasible(*pairs[0]) and jax_chains.chain_is_feasible(*pairs[0])
    with pytest.raises(ValueError):
        chain_sampler.get_sequences(2, tasks=["bogus"])


@pytest.mark.parametrize("cap_noise", [(1.0, 0.0), (0.85, 0.05)])
def test_scripted_expert_matches_jax(cap_noise):
    """Each expert on its own package's env, two lanes through protocol
    chains: bit-equal actions at every step."""
    cap, noise = cap_noise
    lanes = 2
    embs = expert.task_embeddings(32)
    j_pol = jax_expert.ScriptedExpertPolicy(lanes, jax_expert.task_embeddings(32), cap, noise, seed=3)
    p_pol = expert.ScriptedExpertPolicy(lanes, embs, cap, noise, seed=3)
    pairs = [_Pair("hulc_debug", True, seed=i) for i in range(lanes)]
    oracle = tasks.SceneObsTasks()
    chains = chain_sampler.get_sequences(lanes, seed=8)
    obs, start, pos = [], [], [0] * lanes
    for pair, (initial, _) in zip(pairs, chains):
        robot, scene = chain_sampler.initial_state_to_obs(initial)
        obs.append(pair.reset(robot_obs=robot, scene_obs=scene))
        start.append(pair.port.get_info())
    j_state, p_state = j_pol.initial_state(), p_pol.initial_state()
    replan = np.ones(lanes, bool)
    for _ in range(400):
        lang = np.stack([embs[chain[min(p, 4)]] for (_, chain), p in zip(chains, pos)])
        j_act, j_state = j_pol.step(obs, lang, j_state, replan)
        p_act, p_state = p_pol.step(obs, lang, p_state, replan)
        assert p_act.dtype == j_act.dtype and p_act.tobytes() == j_act.tobytes()
        replan = np.zeros(lanes, bool)
        for i, pair in enumerate(pairs):
            obs[i] = pair.step(p_act[i])
            task = chains[i][1][min(pos[i], 4)]
            if pos[i] < 5 and task in oracle.get_task_info_for_set(start[i], pair.port.get_info(), {task}):
                pos[i], replan[i], start[i] = pos[i] + 1, True, pair.port.get_info()
    assert sum(pos) >= 6  # the expert makes progress, so the compared actions cover several scripts


def test_task_embeddings_match_jax():
    for dim in (6, 32, 384):
        got, want = expert.task_embeddings(dim), jax_expert.task_embeddings(dim)
        assert got.keys() == want.keys()
        assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    with pytest.raises(ValueError):
        expert.task_embeddings(5)


@pytest.mark.parametrize("case", ["none", "empty", "all", "few", "many_with_extra"])
def test_restrict_task_pool_matches_jax(case):
    rng = np.random.default_rng(9)
    all_tasks = tasks.ALL_TASKS

    def embs(names):
        return {n: rng.normal(size=4).astype(np.float32) for n in names}

    lang = {
        "none": None,
        "empty": {},
        "all": embs(all_tasks),
        "few": embs(all_tasks[:3] + ["wave"]),
        "many_with_extra": embs(all_tasks[5:13] + ["wave", "dance"]),
    }[case]
    for min_pool in (5, 9):
        got = restrict_task_pool(lang, all_tasks, min_pool)
        assert got == jax_restrict_task_pool(lang, all_tasks, min_pool)
        assert isinstance(got, list)
