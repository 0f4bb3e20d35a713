"""The port's serving export on the CPU: ``torch.export`` artifacts ->
a runtime without model code -> action parity.

* The ``hulc::`` ops are their plain versions bit for bit on the CPU,
  and ``torch.library.opcheck`` passes on each (schema, fake
  implementation, dynamic shapes) at ``hulc_debug``'s and at odd shapes.
* Every exported program holds its ``hulc::`` op nodes and no random node,
  its weights are its first input (no lifted parameter or constant), and a
  ``use_kernels=False`` model is refused.
* The artifact's files, ``params.npz`` bit for bit, and ``meta.json`` key by
  key against the one JAX's ``export_policy`` writes for the same config,
  statistics and lanes.
* Served actions equal the live port policy's bit for bit (language goal
  across replans and ``reset()``, visual goal, 3 lanes with mixed masks),
  and match JAX's served artifact within 1e-4 when fed JAX's noise.
* ``warmup``, the missing batched step, the evaluator driven by the served
  batched policy, the runtime's imports, the export CLI on a trained
  checkpoint, and the CLI's helpers (``restore_params``,
  ``load_task_embeddings``) against JAX's.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.data.dataset import DatasetStatistics as JaxStatistics
from hulc_tpu.data.language import load_task_embeddings as jax_load_task_embeddings
from hulc_tpu.serving import ServedBatchedPolicy as JaxServedBatchedPolicy
from hulc_tpu.serving import ServedPolicy as JaxServedPolicy
from hulc_tpu.serving import export_policy as jax_export_policy
from hulc_tpu.training import checkpoint as jax_ckpt

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.data.language import load_task_embeddings
from hulc_tpu_torch.data.statistics import DatasetStatistics
from hulc_tpu_torch.evaluation.batched_eval import BatchedHulcPolicy
from hulc_tpu_torch.evaluation.fake_env import fake_env_for
from hulc_tpu_torch.evaluation.policy import HulcPolicy
from hulc_tpu_torch.models import make_model
from hulc_tpu_torch.ops import image_ops, library, logistic_mixture, recurrence, spatial_softmax
from hulc_tpu_torch.serving import ServedBatchedPolicy, ServedPolicy, export_policy
from hulc_tpu_torch.serving.export import expected_op_counts, op_counts, random_nodes
from hulc_tpu_torch.serving.params_io import flatten_params, unflatten_params
from hulc_tpu_torch.training import checkpoint as ckpt
from tests.torch_port_common import jax_batched_step_noise, jax_gumbel, jax_init, jax_mixture_uniforms
from tests.torch_port_common import port_model_from_jax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4  # against JAX: fp32 sums in another order, and the x100 of the TCP-frame rotation
LANES = 3
TASK = "push_red_block_right"
JAX_CFG = jax_config.get_config("hulc_debug", replan_freq=3)
PORT_CFG = port_config.get_config("hulc_debug", replan_freq=3)
PROGRAMS = ("replan_lang", "replan_vision", "act", "step_batched")


def _stats():
    rng = np.random.default_rng(4)
    s = [rng.normal(size=15), rng.uniform(0.5, 2.0, 15), -np.ones(7), np.ones(7),
         rng.normal(size=24), rng.uniform(0.5, 2.0, 24)]
    return [v.astype(np.float32) for v in s]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's weights in both packages, and both packages' artifacts of them
    (hulc_debug, replan_freq 3, 3 lanes, the same statistics)."""
    _, params = jax_init(JAX_CFG)
    model, _ = port_model_from_jax(params, PORT_CFG)
    lang = {TASK: np.random.default_rng(1).normal(size=PORT_CFG.lang_dim).astype(np.float32)}
    stats = _stats()
    port_dir, jax_dir = tmp_path_factory.mktemp("port_artifact"), tmp_path_factory.mktemp("jax_artifact")
    export_policy(PORT_CFG, model.state_dict(), port_dir, DatasetStatistics(*stats), lang, lanes=LANES, device="cpu")
    jax_export_policy(JAX_CFG, params, jax_dir, JaxStatistics(*stats), lang, platforms=None, lanes=LANES)
    return {"model": model, "params": params, "lang": lang, "stats": DatasetStatistics(*stats),
            "dir": port_dir, "jax_dir": jax_dir}


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


def _op_cases():
    """(op, args, plain version's result) at hulc_debug's and at odd shapes."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    def frames(*shape):
        return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)

    def uniforms(*shape):
        return torch.rand(shape, generator=g)

    pre = [(frames(2, 1, 64, 64, 3), 0.5, 0.5), (frames(3, 2, 7, 5, 3), 0.45, 0.27)]
    ss = [(randn(2, 64, 4, 4), None, 1.0), (randn(3, 5, 7, 7), torch.tensor([0.7]), 1.0)]
    sample = [
        (randn(2, 1, 6, 10), randn(2, 1, 6, 10) - 2.0, randn(2, 1, 6, 10), uniforms(2, 1, 6, 10), uniforms(2, 1, 6),
         randn(2, 1, 2), -1.0, 1.0, logistic_mixture.U_MIN, logistic_mixture.U_SPAN),
        (randn(3, 2, 5, 7), randn(3, 2, 5, 7) - 2.0, randn(3, 2, 5, 7), uniforms(3, 2, 5, 7), uniforms(3, 2, 5),
         None, -1.0, 1.0, 0.0, 1.0),
    ]
    rnn = [(randn(2, 1, 64), randn(2, 64).abs(), 0.1 * randn(64, 64), randn(64)),
           (randn(3, 5, 37), randn(3, 37).abs(), 0.1 * randn(37, 37), randn(37))]
    cases = {}
    for i, args in enumerate(pre):
        cases[f"preprocess_rgb-{i}"] = (library.preprocess_rgb, args, image_ops.preprocess_rgb_seq_plain(*args))
    for i, (x, t, fixed) in enumerate(ss):
        want = spatial_softmax.spatial_softmax_plain(x, fixed if t is None else t)
        cases[f"spatial_softmax-{i}"] = (library.spatial_softmax_fwd, (x, t, fixed), want)
    for i, a in enumerate(sample):
        want = logistic_mixture.sample_action_plain(*a[:6], a[6:8], a[8:])
        cases[f"sample_action-{i}"] = (library.sample_action, a, want)
    for i, args in enumerate(rnn):
        y = recurrence.rnn_relu_fwd_plain(*args)
        cases[f"rnn_relu_fwd-{i}"] = (library.rnn_relu_fwd, args, (y, y[:, -1]))
    for i, (b, s, h) in enumerate(((2, 1, 64), (3, 5, 37))):
        gru = (randn(b, s, 3 * h), randn(b, h).tanh(), 0.1 * randn(3 * h, h), randn(3 * h))
        y = recurrence.rnn_gru_fwd_plain(*gru)
        cases[f"rnn_gru_fwd-{i}"] = (library.rnn_gru_fwd, gru, (y, y[:, -1]))
        lstm = (randn(b, s, 4 * h), randn(b, h).tanh(), randn(b, h), 0.1 * randn(4 * h, h), randn(4 * h))
        y, c = recurrence.rnn_lstm_fwd_plain(*lstm)
        cases[f"rnn_lstm_fwd-{i}"] = (library.rnn_lstm_fwd, lstm, (y, y[:, -1], c))
    return cases


OP_CASES = _op_cases()


@pytest.mark.parametrize("op", library.OPS)
def test_op_is_its_plain_version_on_the_cpu(op):
    for case, (fn, args, want) in OP_CASES.items():
        if case.startswith(op + "-"):
            got = fn(*args)
            for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
                assert g.shape == w.shape and torch.equal(g, w), case


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_opcheck(case):
    fn, args, _ = OP_CASES[case]
    torch.library.opcheck(fn, args)


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_holds_the_kernel_ops_and_takes_its_noise_and_weights_as_inputs(setup, name):
    program = torch.export.load(setup["dir"] / f"{name}.pt2")
    assert op_counts(program) == expected_op_counts(PORT_CFG, name)
    assert op_counts(program)["preprocess_rgb"] == 2 and op_counts(program)["spatial_softmax"] == 1
    if name in ("act", "step_batched"):
        assert op_counts(program)["rnn_relu_fwd"] == PORT_CFG.action_decoder.num_layers
        assert op_counts(program)["sample_action"] == 1
    assert random_nodes(program) == []
    specs = program.graph_signature.input_specs
    assert {s.kind for s in specs} == {torch.export.graph_signature.InputKind.USER_INPUT}
    assert not program.constants and not program.state_dict
    n_params = len(setup["model"].state_dict())
    assert [s.arg.name for s in specs[:n_params]] == [
        "params_" + k.replace(".", "_") for k in setup["model"].state_dict()
    ]


def test_export_refuses_a_plain_model(tmp_path):
    plain = make_model(PORT_CFG, "cpu", use_kernels=False)
    with pytest.raises(ValueError, match="use_kernels=False"):
        export_policy(PORT_CFG, plain, tmp_path / "plain", device="cpu")
    assert not (tmp_path / "plain").exists()


def test_artifact_files(setup):
    names = {p.name for p in setup["dir"].iterdir()}
    assert {"meta.json", "params.npz", "replan_lang.pt2", "replan_vision.pt2", "act.pt2", "step_batched.pt2",
            "lang_embeddings.npy"} <= names
    # the weights are stored once: no program carries them (as example inputs or otherwise)
    programs = [setup["dir"] / f"{name}.pt2" for name in PROGRAMS]
    assert all(p.stat().st_size < (setup["dir"] / "params.npz").stat().st_size / 2 for p in programs)
    assert all(torch.export.load(p).example_inputs is None for p in programs)


def test_params_roundtrip(setup):
    state = setup["model"].state_dict()
    with np.load(setup["dir"] / "params.npz") as z:
        loaded = unflatten_params({k: z[k] for k in z.files})
    assert list(loaded) == list(state) == list(unflatten_params(flatten_params(state)))
    for k, v in state.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k


def test_meta_matches_jax(setup):
    port = json.loads((setup["dir"] / "meta.json").read_text())
    jax_meta = json.loads((setup["jax_dir"] / "meta.json").read_text())
    assert set(port) - set(jax_meta) == {"torch_version", "device", "noise"}
    assert set(jax_meta) - set(port) == {"jax_version", "platforms"}
    for key in set(port) & set(jax_meta):
        assert port[key] == jax_meta[key], key
    assert port["device"] == "cpu" and port["torch_version"] == torch.__version__
    d, ad = PORT_CFG.distribution, PORT_CFG.action_decoder
    assert port["noise"] == {"order": ["gumbel", "u_mix", "u_inv"], "gumbel": [d.category_size, d.class_size],
                             "u_mix": [1, ad.out_features - 1, ad.n_mixtures], "u_inv": [1, ad.out_features - 1],
                             "uniform_map": [logistic_mixture.U_MIN, logistic_mixture.U_SPAN]}


# ---------------------------------------------------------------------------
# served against live, in the port
# ---------------------------------------------------------------------------


def test_served_policy_matches_live_lang_goal(setup):
    live = HulcPolicy(PORT_CFG, setup["model"], setup["stats"], lang_embeddings=setup["lang"], seed=7)
    served = ServedPolicy(setup["dir"], seed=7, device="cpu")
    assert served.lang_embeddings  # bundled in the artifact
    env = fake_env_for(PORT_CFG)
    # 7 steps with replan_freq=3 cross two replans; reset() restarts both noise streams
    for steps in (7, 4):
        obs = env.reset()
        live.reset()
        served.reset()
        for _ in range(steps):
            a_live, a_served = live.step(obs, TASK), served.step(obs, TASK)
            np.testing.assert_array_equal(a_served, a_live)
            obs = env.step(a_live)


def test_served_policy_matches_live_vision_goal(setup):
    live = HulcPolicy(PORT_CFG, setup["model"], setup["stats"], seed=3)
    served = ServedPolicy(setup["dir"], seed=3, device="cpu")
    env = fake_env_for(PORT_CFG)
    obs = env.reset()
    for _ in range(5):
        env.step(np.asarray([0.5, 0, 0, 0, 0, 0, 1.0]))
    goal = env.get_obs()
    live.reset()
    served.reset()
    for _ in range(4):
        a_live, a_served = live.step(obs, goal), served.step(obs, goal)
        np.testing.assert_array_equal(a_served, a_live)
        obs = env.step(a_live)


def test_served_batched_matches_live(setup):
    live = BatchedHulcPolicy(PORT_CFG, setup["model"], LANES, setup["stats"], seed=11)
    served = ServedBatchedPolicy(setup["dir"], seed=11, device="cpu")
    assert served.num_envs == LANES
    envs = [fake_env_for(PORT_CFG) for _ in range(LANES)]
    obs_batch = [e.reset() for e in envs]
    embs = np.stack([setup["lang"][TASK]] * LANES)
    s_live, s_served = live.initial_state(), served.initial_state()
    replan = np.array([True, True, True])
    for t in range(4):
        a_live, s_live = live.step(obs_batch, embs, s_live, replan)
        a_served, s_served = served.step(obs_batch, embs, s_served, replan)
        np.testing.assert_array_equal(a_served, a_live)
        for x, y in zip(s_served, s_live):
            assert torch.equal(x, y)
        obs_batch = [e.step(a) for e, a in zip(envs, a_live)]
        replan = np.array([t % 2 == 0, False, t == 1])  # mixed per-lane replans


# ---------------------------------------------------------------------------
# served against JAX's served artifact, on JAX's noise
# ---------------------------------------------------------------------------


class _JaxServedNoise:
    """The noise JAX's ``ServedPolicy`` draws from its key schedule, as the
    port's ``ServedPolicy.step(noise=)`` takes it."""

    def __init__(self, seed):
        self.base = self.rng = jax.random.key(seed)

    def reset(self):
        self.rng = self.base

    def step(self, plans: bool):
        noise = {}
        if plans:
            self.rng, k = jax.random.split(self.rng)
            noise["gumbel"] = jax_gumbel(k, 1, JAX_CFG)
        self.rng, k_act = jax.random.split(self.rng)
        noise["u_mix"], noise["u_inv"] = jax_mixture_uniforms(k_act, 1, JAX_CFG)
        return noise


def test_served_policy_matches_jax_on_its_noise(setup):
    jax_served = JaxServedPolicy(setup["jax_dir"], seed=5)
    served = ServedPolicy(setup["dir"], seed=5, device="cpu")
    noise = _JaxServedNoise(5)
    env = fake_env_for(PORT_CFG)
    goal_obs = None
    for episode, steps in enumerate((7, 4)):
        obs = env.reset()
        for sp in (jax_served, served, noise):
            sp.reset()
        goal = TASK if episode == 0 else goal_obs
        for t in range(steps):
            want = jax_served.step(obs, goal)
            got = served.step(obs, goal, noise=noise.step(t % JAX_CFG.replan_freq == 0))
            np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, err_msg=f"episode {episode} step {t}")
            obs = env.step(got)
        goal_obs = obs


def test_served_batched_matches_jax_on_its_noise(setup):
    jax_served = JaxServedBatchedPolicy(setup["jax_dir"], seed=9)
    served = ServedBatchedPolicy(setup["dir"], seed=9, device="cpu")
    rng = jax.random.key(9)
    envs = [fake_env_for(PORT_CFG) for _ in range(LANES)]
    obs_batch = [e.reset() for e in envs]
    embs = np.stack([setup["lang"][TASK]] * LANES)
    s_jax, s_port = jax_served.initial_state(), served.initial_state()
    replan = np.ones(LANES, bool)
    for t in range(4):
        want, s_jax = jax_served.step(obs_batch, embs, s_jax, replan)
        rng, k = jax.random.split(rng)
        got, s_port = served.step(obs_batch, embs, s_port, replan, noise=jax_batched_step_noise(k, LANES, JAX_CFG))
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0, err_msg=f"step {t}")
        obs_batch = [e.step(a) for e, a in zip(envs, got)]
        replan = np.array([t % 2 == 0, False, t == 1])


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------


def test_warmup_leaves_the_noise_stream_and_state_untouched(setup):
    warmed = ServedPolicy(setup["dir"], seed=5, device="cpu")
    cold = ServedPolicy(setup["dir"], seed=5, device="cpu")
    env = fake_env_for(PORT_CFG)
    obs = env.reset()
    for p in (warmed, cold):
        p.reset()
        p.step(obs, TASK)
    state = warmed.generator.get_state()
    warmed.warmup()
    assert torch.equal(warmed.generator.get_state(), state) and warmed._step_count == 1
    for _ in range(4):
        a_w, a_c = warmed.step(obs, TASK), cold.step(obs, TASK)
        np.testing.assert_array_equal(a_w, a_c)
        obs = env.step(a_w)

    b = ServedBatchedPolicy(setup["dir"], seed=5, device="cpu")
    state = b.generator.get_state()
    b.warmup()
    assert torch.equal(b.generator.get_state(), state)


def test_served_batched_policy_errors_without_batched_export(setup, tmp_path):
    out = export_policy(PORT_CFG, setup["model"].state_dict(), tmp_path / "nolanes", lanes=0, device="cpu")
    assert not (out / "step_batched.pt2").exists()
    with pytest.raises(ValueError, match="no batched step"):
        ServedBatchedPolicy(out, device="cpu")


def test_served_batched_drives_lh_eval(setup):
    """The LH-MTLC batched protocol with no model code: 2 chains on the 3
    exported lanes (the served step pads the third)."""
    from hulc_tpu_torch.evaluation.batched_eval import evaluate_policy_batched
    from hulc_tpu_torch.evaluation.fake_env import FakeCalvinEnv
    from hulc_tpu_torch.evaluation.tasks import ALL_TASKS

    served = ServedBatchedPolicy(setup["dir"], seed=2, device="cpu")

    def scripted_env_factory():
        env = FakeCalvinEnv()
        env.script_scene(lambda e, t: e.scene_obs.__setitem__(1, min(0.2, 0.03 * (t + 1))))
        return env

    lang = {t: np.zeros(PORT_CFG.lang_dim, np.float32) for t in ALL_TASKS}
    results = evaluate_policy_batched(
        PORT_CFG, None, scripted_env_factory, num_envs=8, ep_len=12, sequences=[["open_drawer"]] * 2,
        lang_embeddings=lang, policy=served, epoch=0,
    )
    assert results["0"]["chain_sr"]["1"] == 1.0  # the scripted drawer opens on every lane
    assert results["_policy"] is served


def test_runtime_import_is_model_code_free():
    """A serving host importing the runtime loads no model, evaluator,
    trainer, config or data module of the port, and no jax or hulc_tpu."""
    code = (
        "import sys\n"
        "from hulc_tpu_torch.serving import ServedPolicy, ServedBatchedPolicy\n"
        "banned = ('hulc_tpu_torch.models', 'hulc_tpu_torch.evaluation', 'hulc_tpu_torch.training',\n"
        "          'hulc_tpu_torch.config', 'hulc_tpu_torch.data')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'hulc_tpu', 'flax')\n"
        "             or any(m == b or m.startswith(b + '.') for b in banned)))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_export_cli_end_to_end(tmp_path):
    """Train 2 steps on a fixture -> the export CLI restores the checkpoint
    and writes an artifact -> ServedPolicy steps on the CPU."""
    from hulc_tpu_torch.data.fixtures import LANG_FOLDER, make_fixture_dataset
    from hulc_tpu_torch.data.loader import make_loaders
    from hulc_tpu_torch.serving.export import main as export_main
    from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg = port_config.get_config("hulc_debug")
    root = make_fixture_dataset(tmp_path / "data", num_episodes=2, episode_len=16)
    train = make_loaders(cfg, root, fuse=True, seed=0, batch_size=2, min_window=6, max_window=8)
    run_dir = tmp_path / "run"
    Trainer(cfg, TrainerConfig(run_dir=str(run_dir)), device="cpu").fit(train, None, max_epochs=1, max_steps=2)
    art_dir = tmp_path / "artifact"
    export_main(["--run-dir", str(run_dir), "--config", "hulc_debug", "--out", str(art_dir), "--device", "cpu",
                 "--dataset-dir", str(root), "--lang-folder", LANG_FOLDER, "--lanes", "2"])
    served = ServedPolicy(art_dir, seed=0, device="cpu")
    trained = ckpt.restore_checkpoint(ckpt.latest_checkpoint(run_dir))["params"]
    assert all(torch.equal(served.params[k], v) for k, v in trained.items())
    assert served.lang_embeddings and served.meta["lanes"] == 2
    env = fake_env_for(cfg)
    obs = env.reset()
    served.reset()
    for task in list(served.lang_embeddings)[:2]:
        action = served.step(obs, task)
        assert action.shape == (7,) and np.isfinite(action).all()
        obs = env.step(action)


# ---------------------------------------------------------------------------
# the CLI's helpers against JAX's
# ---------------------------------------------------------------------------


def test_load_task_embeddings_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    raw = {t: {"ann": [f"do {t}"], "emb": rng.normal(size=(1, 384)).astype(np.float32)} for t in ("a", "b", "c")}
    np.save(tmp_path / "embeddings.npy", raw, allow_pickle=True)
    got, want = load_task_embeddings(tmp_path / "embeddings.npy"), jax_load_task_embeddings(tmp_path / "embeddings.npy")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32 and got[k].shape == (384,)
        np.testing.assert_array_equal(got[k], want[k])


def test_restore_params_matches_jax(tmp_path):
    """A checkpoint's params by name in the template's order, and the same
    loud refusals as JAX's: missing and extra names, a shape mismatch."""
    flat = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(4, np.float32)}
    jax_ckpt.save_checkpoint(tmp_path / "jax", 0, {"params": {k: jax.numpy.asarray(v) for k, v in flat.items()}})
    ckpt.save_checkpoint(tmp_path / "port", 0, {"params": {k: torch.from_numpy(v) for k, v in flat.items()}})
    jax_path, port_path = jax_ckpt.latest_checkpoint(tmp_path / "jax"), ckpt.latest_checkpoint(tmp_path / "port")

    want = jax_ckpt.restore_params(jax_path, {"b": np.zeros(4, np.float32), "a": np.zeros((2, 3), np.float32)})
    got = ckpt.restore_params(port_path, {"b": torch.zeros(4), "a": torch.zeros(2, 3)})
    assert list(got) == ["b", "a"]
    for k in flat:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    cases = {
        "extra=": ({"a": np.zeros((2, 3), np.float32)}),
        "missing=": ({**flat, "c": np.zeros(1, np.float32)}),
        "shape mismatch for": ({"a": np.zeros((3, 2), np.float32), "b": np.zeros(4, np.float32)}),
    }
    for message, template in cases.items():
        with pytest.raises(ValueError, match=message):
            jax_ckpt.restore_params(jax_path, template)
        with pytest.raises(ValueError, match=message):
            ckpt.restore_params(port_path, {k: torch.from_numpy(v) for k, v in template.items()})
