"""The port's train and evaluate CLIs, the checkpoint import, the warm start
and the rollout callbacks, on the CPU at ``hulc_debug`` against the JAX
package's.

* ``python -m hulc_tpu_torch.training.train`` (its ``main``): a fixture run
  and a relaunch that trains the remainder (``--steps-total``), with each
  optimizer; JAX's option strings and defaults, ``--device`` besides; the
  multi-device flags refused, naming ROADMAP A.4.
* ``python -m hulc_tpu_torch.evaluation.evaluate``: the epochs ``--checkpoint
  last | best | all | <epochs>`` selects are the JAX CLI's on the same
  layout; the protocol's chains and resets are JAX's ``chain_sampler``'s;
  a batched run at 2 lanes writes what a direct ``evaluate_policy_batched``
  call writes, in JAX's results.json schema; the sequential loop too.
* ``training.import_checkpoint`` on a synthetic ``.ckpt`` (an 84 px gripper
  camera: JAX's converter cannot map ``hulc_debug``'s 48 px one): the
  params JAX's import writes, carried over by ``convert.params_from_jax``,
  equal the port's restored ones bit for bit, and the unused keys match;
  ``training.pretrain``'s graft (position-embedding trim and extension,
  ``exclude_plan_recognition``) equals JAX's on the same weights.
* The rollout callbacks return JAX's metric keys and leave the trainer's
  model alone; the batched policy is built once.
"""

import argparse
import dataclasses
import json
import tempfile

import jax
import numpy as np
import pytest
import torch

import hulc_tpu.evaluation.batched_eval as jax_batched_eval
import hulc_tpu.models as jax_models
import hulc_tpu.training.checkpoint as jax_ckpt
import hulc_tpu.utils.tunnel as jax_tunnel
from hulc_tpu import config as jax_config
from hulc_tpu.evaluation import chain_sampler as jax_chain_sampler
from hulc_tpu.evaluation import evaluate as jax_evaluate
from hulc_tpu.evaluation.fake_env import fake_env_for as jax_fake_env_for
from hulc_tpu.evaluation.lh_eval import build_results as jax_build_results
from hulc_tpu.evaluation.lh_eval import get_sequences as jax_get_sequences
from hulc_tpu.training import import_checkpoint as jax_import
from hulc_tpu.training import pretrain as jax_pretrain
from hulc_tpu.training import train as jax_train

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.convert import params_from_jax
from hulc_tpu_torch.evaluation import evaluate as port_evaluate
from hulc_tpu_torch.evaluation.batched_eval import evaluate_policy_batched
from hulc_tpu_torch.evaluation.fake_env import fake_env_for
from hulc_tpu_torch.evaluation.rollout_callback import RolloutCallback, RolloutLongHorizonCallback
from hulc_tpu_torch.evaluation.tasks import ALL_TASKS, SceneObsTasks
from hulc_tpu_torch.models import make_model
from hulc_tpu_torch.training import checkpoint as ckpt
from hulc_tpu_torch.training import import_checkpoint as port_import
from hulc_tpu_torch.training import pretrain as port_pretrain
from hulc_tpu_torch.training import train as port_train
from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

from tests.torch_port_common import jax_random_params

torch.set_num_threads(1)

PORT_CFG = port_config.get_config("hulc_debug")


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch, argv=()):
    """The ArgumentParser ``main`` builds, caught at its ``parse_args``."""
    caught = {}

    def parse(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse)
        m.setattr(jax_tunnel, "compact_tunnel_journal", lambda: False)
        with pytest.raises(_Parsed):
            main(list(argv))
    return caught["parser"]


def _options(parser):
    """{option string: (dest, default, choices, type, required, nargs)}."""
    return {s: (a.dest, a.default, a.choices, a.type, a.required, a.nargs)
            for a in parser._actions if not isinstance(a, argparse._HelpAction) for s in a.option_strings}


@pytest.mark.parametrize("port_module,jax_module", [(port_train, jax_train), (port_evaluate, jax_evaluate)],
                         ids=["train", "evaluate"])
def test_cli_takes_jax_options_and_defaults(port_module, jax_module, monkeypatch):
    want = _options(_parser_of(jax_module.main, monkeypatch))
    got = _options(_parser_of(port_module.main, monkeypatch))
    assert got.pop("--device") == ("device", "cuda", None, None, False, None)
    assert got == want


# hulc_clip_lang's widest layers, cut for a CPU run
CLIP_LANG_CUTS = ("plan_proposal.hidden_size", "plan_recognition.encoder_hidden_size",
                  "plan_recognition.fc_hidden_size", "action_decoder.hidden_size", "language_goal.hidden_size",
                  "visual_goal.hidden_size")


def _train_argv(run, *extra):
    return ["--config", "hulc_debug", "--fixture", "--batch-size", "2", "--cache", "none", "--device", "cpu",
            "--run-dir", str(run), "--val-max-batches", "1", *extra]


def test_train_cli_runs_and_a_relaunch_trains_the_remainder(tmp_path, monkeypatch):
    """``--steps 2``, then the same command with ``--steps-total 3``: it
    resumes from the first run's checkpoint and trains one step."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the fixture's directory
    run = tmp_path / "run"
    first = port_train.main(_train_argv(run, "--steps", "2"))
    assert first.step == 2 and type(first.optimizer).__name__ == "AdamLowp"
    assert [ckpt.checkpoint_epoch(p) for p in ckpt.all_checkpoints(run)] == [0]
    again = port_train.main(_train_argv(run, "--steps-total", "3"))
    assert again.step == 3 and again.epoch == 1
    assert [ckpt.checkpoint_epoch(p) for p in ckpt.all_checkpoints(run)] == [0, 1]
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if r["prefix"] == "train"] == [1, 3]
    assert {"val", "epoch"} <= {r["prefix"] for r in records}
    assert port_train.main(_train_argv(run, "--steps-total", "3")).step == 3  # nothing left to train


@pytest.mark.parametrize("flags,kind", [(("--optimizer", "adamw"), "adamw"), (("--optimizer", "sgd"), "sgd"),
                                        (("--adam-mv-dtype", "float32"), "adam"),
                                        # tests/test_config_overrides.py's gcbc_debug run (the last --config wins)
                                        (("--config", "gcbc_debug", "--set", "action_decoder.hidden_size=48",
                                          "--set", "loss.kl_beta=0.1"), "adam_lowp"),
                                        # hulc_clip_lang (1024-d language, the fixture's at the config's
                                        # lang_dim) on the full-size fixture, its widest layers cut
                                        (("--config", "hulc_clip_lang", "--min-window", "8", "--max-window", "8",
                                          *(f"--set={k}=64" for k in CLIP_LANG_CUTS)), "adam_lowp")])
def test_train_cli_optimizers_resume(flags, kind, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    run = tmp_path / "run"
    assert port_train.main(_train_argv(run, "--steps", "1", *flags)).step == 1
    saved = ckpt.restore_checkpoint(ckpt.latest_checkpoint(run))
    assert saved["optimizer"]["kind"] == kind and saved["step"] == 1
    resumed = port_train.main(_train_argv(run, "--steps-total", "2", *flags))
    assert resumed.step == 2 and resumed.optimizer.KIND == kind and resumed.optimizer.count == 2


@pytest.mark.parametrize("flags", [("--fsdp",), ("--tp", "2"), ("--sp", "2")], ids=["fsdp", "tp", "sp"])
def test_train_cli_refuses_multi_device_flags(flags, tmp_path):
    """Tensor and sequence parallelism are refused, naming ROADMAP A.4's
    next slice; ``--fsdp``, ported since, trains in one process over a group
    of one rank (tests/test_torch_parallel.py runs it at two)."""
    if flags == ("--fsdp",):
        assert port_train.main(_train_argv(tmp_path / "run", "--steps", "1", *flags)).step == 1
        assert ckpt.latest_checkpoint(tmp_path / "run") is not None
        return
    with pytest.raises(SystemExit, match="next slice of ROADMAP A.4"):
        port_train.main(_train_argv(tmp_path / "run", "--steps", "1", *flags))
    assert not (tmp_path / "run").exists()


# ---------------------------------------------------------------------------
# the evaluate CLI
# ---------------------------------------------------------------------------


def _jax_selected_epochs(run, spec, monkeypatch):
    """The epochs JAX's evaluate CLI restores for ``--checkpoint spec``,
    with its model init and its evaluator stubbed out."""
    seen = []
    with monkeypatch.context() as m:
        m.setattr(jax_tunnel, "compact_tunnel_journal", lambda: False)
        m.setattr(jax_models, "make_model", lambda cfg: None)
        m.setattr(jax_models, "example_batch", lambda *a, **k: None)
        m.setattr(jax_models, "init_params", lambda *a: {})
        m.setattr(jax_ckpt, "restore_params", lambda path, template: seen.append(path) or {})
        m.setattr(jax_batched_eval, "evaluate_policy_batched",
                  lambda cfg, params, **kw: {str(kw["epoch"]): {"avg_seq_len": 0.0}})
        jax_evaluate.main(["--run-dir", str(run), "--config", "hulc_debug", "--checkpoint", spec, "--batched",
                           "--num-envs", "1", "--num-sequences", "1"])
    return [jax_ckpt.checkpoint_epoch(p) for p in seen]


def test_checkpoint_selection_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    scored, unscored = tmp_path / "scored", tmp_path / "unscored"
    for run in (scored, unscored):
        for epoch in (0, 2, 5, 11):
            ckpt.save_checkpoint(run, epoch, {"params": {}, "optimizer": None, "step": 0, "epoch": epoch})
    journal = {"0": {"eval_lh/avg_seq_len": 0.4}, "2": {"eval_lh/avg_seq_len": 1.2}, "5": {"val/x": 1.0}, "11": {}}
    (scored / "saved_models" / "monitor.json").write_text(json.dumps(journal))
    for run, spec in [(scored, "last"), (scored, "all"), (scored, "0,5"), (scored, "2"), (scored, "best"),
                      (unscored, "best")]:
        want = _jax_selected_epochs(run, spec, monkeypatch)
        got = [ckpt.checkpoint_epoch(p) for p in port_evaluate.select_checkpoints(run, spec)]
        assert got == want, spec
    assert _jax_selected_epochs(scored, "best", monkeypatch) == [2]
    capsys.readouterr()
    port_evaluate.select_checkpoints(unscored, "best")
    assert "monitor 'eval_lh/avg_seq_len' was never recorded" in capsys.readouterr().out


@pytest.mark.parametrize("seed", [0, 3])
def test_protocol_chains_are_the_jax_chain_samplers(seed):
    env, jax_env = fake_env_for(PORT_CFG), jax_fake_env_for(jax_config.get_config("hulc_debug"))
    pool, sequences, resets = port_evaluate.protocol_chains(9, seed, None, env)
    pairs = jax_chain_sampler.get_sequences(9, seed=seed)
    assert pool == list(ALL_TASKS) and sequences == [chain for _, chain in pairs]
    for (r, s), (wr, ws) in zip(resets, jax_chain_sampler.resets_for_env(pairs, jax_env), strict=True):
        np.testing.assert_array_equal(r, wr)
        np.testing.assert_array_equal(s, ws)
    restricted = {t: np.zeros(PORT_CFG.lang_dim, np.float32) for t in ALL_TASKS[:7]}
    pool, sequences, resets = port_evaluate.protocol_chains(9, seed, restricted, env)
    assert resets is None and pool == sorted(ALL_TASKS[:7])
    assert sequences == jax_get_sequences(9, tasks=pool, seed=seed)


def test_evaluate_cli_writes_a_direct_evaluators_results(tmp_path):
    """A batched run at 2 lanes writes what ``evaluate_policy_batched``
    writes with the same arguments, in JAX's schema; the sequential loop
    writes its own file of that schema."""
    model = make_model(PORT_CFG, "cpu", seed=5)
    run = tmp_path / "run"
    ckpt.save_checkpoint(run, 4, {"params": model.state_dict(), "optimizer": None, "step": 0, "epoch": 4})
    argv = ["--run-dir", str(run), "--config", "hulc_debug", "--device", "cpu", "--num-sequences", "2", "--ep-len", "8"]
    port_evaluate.main([*argv, "--batched", "--num-envs", "2"])
    got = json.loads((run / "evaluation" / "results.json").read_text())

    envs = [fake_env_for(PORT_CFG, interactive=True) for _ in range(2)]
    pool, sequences, resets = port_evaluate.protocol_chains(2, 0, None, envs[0])
    direct = make_model(PORT_CFG, "cpu", seed=0).eval()
    direct.load_state_dict(model.state_dict())
    evaluate_policy_batched(
        PORT_CFG, direct, num_sequences=2, num_envs=2, ep_len=8, oracle=SceneObsTasks(), sequences=sequences,
        lang_embeddings={t: np.zeros(PORT_CFG.lang_dim, np.float32) for t in pool}, statistics=None, epoch=4,
        output_dir=tmp_path / "direct", seed=0, envs=envs, initial_states=resets,
    )
    assert got == json.loads((tmp_path / "direct" / "results.json").read_text())
    schema = jax_build_results(4, [0, 1], np.zeros(5, np.int64), 2, {"a": 0}, {"a": 1})["4"]
    assert set(got) == {"4"} and set(got["4"]) == set(schema) and set(got["4"]["chain_sr"]) == set(schema["chain_sr"])

    port_evaluate.main([*argv, "--num-sequences", "1", "--results-name", "sequential.json"])
    seq = json.loads((run / "evaluation" / "sequential.json").read_text())
    assert set(seq) == {"4"} and set(seq["4"]) == set(schema)


# ---------------------------------------------------------------------------
# the import and the warm start
# ---------------------------------------------------------------------------


def _cfg84(m, **plan_recognition):
    """``hulc_debug`` of config module ``m`` with an 84 px gripper camera."""
    cfg = m.get_config("hulc_debug")
    pe = cfg.perceptual_encoder
    pe = dataclasses.replace(pe, rgb_gripper=dataclasses.replace(pe.rgb_gripper, input_size=84))
    pr = dataclasses.replace(cfg.plan_recognition, **plan_recognition)
    return dataclasses.replace(cfg, perceptual_encoder=pe, plan_recognition=pr).resolve()


EXTRA_KEY = "perceptual_encoder.rgb_static_encoder.spatial_softmax.x_map"  # a reference buffer the port lacks


def test_import_matches_jax_and_evaluates(tmp_path, monkeypatch):
    """The synthetic ``.ckpt`` holds every parameter, so no fresh init
    survives the graft: JAX's import gets an all-zero init of the right
    tree (``init_params`` traced, not run) to save its un-jitted init."""
    init_params = jax_models.init_params
    monkeypatch.setattr(jax_models, "init_params", lambda model, key, batch: jax.tree.map(
        lambda leaf: np.zeros(leaf.shape, leaf.dtype), jax.eval_shape(lambda: init_params(model, key, batch))))
    port_cfg, jax_cfg = _cfg84(port_config), _cfg84(jax_config)
    source = make_model(port_cfg, "cpu", seed=11).state_dict()
    ckpt_file = tmp_path / "HULC_D_D" / "epoch=7.ckpt"
    ckpt_file.parent.mkdir()
    torch.save({"state_dict": {**source, EXTRA_KEY: torch.zeros(3)}, "epoch": 7}, ckpt_file)

    jax_path, jax_unused = jax_import.import_checkpoint(ckpt_file, jax_cfg, tmp_path / "jax")
    path, unused = port_import.import_checkpoint(ckpt_file, port_cfg, tmp_path / "port", device="cpu")
    assert unused == jax_unused == [EXTRA_KEY]
    assert ckpt.checkpoint_epoch(path) == jax_ckpt.checkpoint_epoch(jax_path) == 7

    template = make_model(port_cfg, "cpu", seed=0).state_dict()
    got = ckpt.restore_params(path, template)
    jax_params = jax_ckpt.restore_params(jax_path, jax_random_params(jax_cfg, 0)[1])
    want, jax_left = params_from_jax(jax_params, port_cfg)
    assert not jax_left and list(got) == list(template) and set(want) == set(source) == set(template)
    for k in source:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], source[k]), k

    port_evaluate.main(["--run-dir", str(tmp_path / "port"), "--config", "hulc_debug", "--set",
                        "perceptual_encoder.rgb_gripper.input_size=84", "--device", "cpu", "--batched", "--num-envs",
                        "1", "--num-sequences", "1", "--ep-len", "4"])
    assert set(json.loads((tmp_path / "port" / "evaluation" / "results.json").read_text())) == {"7"}

    trainer = Trainer(port_cfg, TrainerConfig(run_dir=str(tmp_path / "port")), device="cpu")
    trainer.init_state(1)
    with pytest.raises(ValueError, match="parameters only"):
        trainer.restore(path)
    with pytest.raises(ValueError, match="parameters only"):
        trainer.fit([], None)  # resume finds the imported checkpoint


_JAX_PARAMS = {}


def _jax_params(cfg, seed):
    """``jax_random_params``, made once per (config, seed)."""
    key = (repr(cfg), seed)
    if key not in _JAX_PARAMS:
        _JAX_PARAMS[key] = jax_random_params(cfg, seed)[1]
    return _JAX_PARAMS[key]


@pytest.mark.parametrize("source_rows,exclude", [(5, False), (12, False), (12, True)],
                         ids=["extend", "trim", "exclude_plan_recognition"])
def test_warm_start_graft_matches_jax(source_rows, exclude, tmp_path):
    """JAX's ``initialize_pretrained_weights`` and the port's on the same
    weights (a source whose position-embedding table has another row count
    than the target's 8), compared in the port's layout; then
    ``load_pretrained`` of a port run dir, and of a ``.pt``, give the same."""
    port_target_cfg, jax_target_cfg = _cfg84(port_config), _cfg84(jax_config)
    port_source_cfg = _cfg84(port_config, max_position_embeddings=source_rows)
    jax_source_cfg = _cfg84(jax_config, max_position_embeddings=source_rows)
    jax_target, jax_source = _jax_params(jax_target_cfg, 1), _jax_params(jax_source_cfg, 2)
    want, _ = params_from_jax(jax_pretrain.initialize_pretrained_weights(jax_target, jax_source, exclude),
                              port_target_cfg)
    target, _ = params_from_jax(jax_target, port_target_cfg)
    source, _ = params_from_jax(jax_source, port_source_cfg)
    got = port_pretrain.initialize_pretrained_weights(target, source, exclude)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    pe = port_pretrain.POSITION_EMBEDDINGS
    assert got[pe].shape[0] == 8 and torch.equal(got[pe], (target if exclude else want)[pe])
    assert all(torch.equal(got[k], (target if exclude else source)[k]) for k in got if k.startswith("plan_recognition.")
               and k != pe)

    ckpt.save_checkpoint(tmp_path / "run", 0, {"params": source, "optimizer": None, "step": 0, "epoch": 0})
    torch.save(source, tmp_path / "source.pt")
    for where in (tmp_path / "run", tmp_path / "source.pt"):
        loaded = port_pretrain.load_pretrained(where, target, exclude)
        assert all(torch.equal(loaded[k], want[k]) for k in want), where


def test_position_embedding_resize_equals_jax():
    pe = np.random.default_rng(4).normal(size=(8, 6)).astype(np.float32)
    for rows in (3, 8, 21):
        jax_tree = {"plan_recognition": {"position_embeddings": pe.copy()}}
        jax_pretrain._resize_position_embeddings(jax_tree, rows)
        port = {port_pretrain.POSITION_EMBEDDINGS: torch.from_numpy(pe.copy())}
        port_pretrain._resize_position_embeddings(port, rows)
        np.testing.assert_array_equal(port[port_pretrain.POSITION_EMBEDDINGS].numpy(),
                                      np.asarray(jax_tree["plan_recognition"]["position_embeddings"]))


# ---------------------------------------------------------------------------
# the rollout callbacks
# ---------------------------------------------------------------------------


def test_rollout_callbacks_return_jax_metric_keys(tmp_path):
    """JAX's keys: ``eval_lh/avg_seq_len`` and ``eval_lh/chain_sr_1..5``
    (RolloutLongHorizonCallback), ``tasks/average_sr`` and
    ``tasks/<task>_sr`` (RolloutCallback), logged under ``rollout``. The
    trainer's model stays in train mode and is not the policy's; the
    batched policy is built once and takes the trainer's new weights."""
    trainer = Trainer(PORT_CFG, TrainerConfig(run_dir=str(tmp_path), seed=3), device="cpu")
    trainer.init_state(1)
    lh_keys = {"eval_lh/avg_seq_len", *(f"eval_lh/chain_sr_{k}" for k in range(1, 6))}
    batched = RolloutLongHorizonCallback(num_sequences=2, ep_len=4, skip_epochs=0, num_envs=2,
                                         env_factory=lambda: fake_env_for(PORT_CFG))
    assert set(batched.on_epoch_end(trainer, 0)) == lh_keys
    policy = batched._batched_policy
    assert trainer.model.training and policy.model is not trainer.model and policy.num_envs == 2
    with torch.no_grad():
        next(trainer.model.parameters()).add_(1.0)
    assert set(batched.on_epoch_end(trainer, 1)) == lh_keys
    assert batched._batched_policy is policy
    assert torch.equal(next(policy.model.parameters()), next(trainer.model.parameters()))

    sequential = RolloutLongHorizonCallback(fake_env_for(PORT_CFG), num_sequences=1, ep_len=3, skip_epochs=0,
                                            mode="sequential")
    assert set(sequential.on_epoch_end(trainer, 0)) == lh_keys
    short = RolloutCallback(fake_env_for(PORT_CFG), num_rollouts=2, ep_len=3, skip_epochs=0)
    metrics = short.on_epoch_end(trainer, 0)
    assert set(metrics) == {"tasks/average_sr", *(f"tasks/{t}_sr" for t in ALL_TASKS[:2])}
    assert RolloutCallback(fake_env_for(PORT_CFG), skip_epochs=1).on_epoch_end(trainer, 0) is None
    assert trainer.model.training
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["prefix"] for r in records] == ["rollout"] * 4
