"""The port's training loop on the CPU, at ``hulc_debug`` on a small fixture
dataset written by the port's fixture writer.

* ``fit`` over 2 epochs with validation writes the JSONL lines JAX's ``fit``
  writes on the same loaders: the same prefixes in the same order, at the
  same steps, with the same keys.
* A run cut by ``max_steps`` and resumed from its checkpoint by a new
  Trainer ends with the parameters and the Adam state of an uninterrupted
  run, bit for bit (the checkpoint holds the generator's state).
* ``max_total_steps`` is idempotent; ``echo_factor=2`` takes two steps per
  batch; a partial checkpoint directory is skipped; a save replaces an
  epoch's checkpoint atomically, and a save cut between its two renames
  leaves that epoch's old checkpoint where resume finds it; checkpoints
  restore bit-equal; top-k retention and the presets; the TensorBoard sink.
* A Trainer keeps no reference to the loaders it was given.
"""

import gc
import json
import weakref

import numpy as np
import pytest
import torch
from tensorboard.compat.proto import event_pb2

from hulc_tpu import config as jax_config
from hulc_tpu.data.loader import make_loaders as jax_make_loaders
from hulc_tpu.training.trainer import Trainer as JaxTrainer
from hulc_tpu.training.trainer import TrainerConfig as JaxTrainerConfig

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.data.fixtures import make_fixture_dataset
from hulc_tpu_torch.data.loader import make_loaders
from hulc_tpu_torch.training import checkpoint as ckpt
from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig
from hulc_tpu_torch.utils.loggers import MultiLogger, TensorBoardLogger, make_logger

torch.set_num_threads(1)

PORT_CFG = port_config.get_config("hulc_debug")
LOADER = dict(batch_size=4, min_window=6, max_window=8)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_fixture_dataset(tmp_path_factory.mktemp("fit_data"), num_episodes=2, episode_len=16)


def _loaders(root, cfg=PORT_CFG, make=make_loaders, seed=0):
    train = make(cfg, root, fuse=True, seed=seed, **LOADER)
    val = make(cfg, root, split="validation", deterministic=True, **LOADER)
    return train, val


def _records(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def _tcfg(run_dir, **kw):
    return TrainerConfig(run_dir=str(run_dir), log_every=1, val_max_batches=1, **kw)


def test_fit_writes_the_jsonl_of_jax_fit(root, tmp_path):
    jax_train, jax_val = _loaders(root, jax_config.get_config("hulc_debug"), jax_make_loaders)
    jax_dir = tmp_path / "jax"
    JaxTrainer(jax_config.get_config("hulc_debug"), JaxTrainerConfig(
        run_dir=str(jax_dir), log_every=1, val_max_batches=1, num_devices=1, donate_state=False
    )).fit(jax_train, jax_val, max_epochs=2)
    train, val = _loaders(root)
    port_dir = tmp_path / "port"
    assert Trainer(PORT_CFG, _tcfg(port_dir), device="cpu").fit(train, val, max_epochs=2) == 2 * len(train)
    want, got = _records(jax_dir), _records(port_dir)
    assert [(r["prefix"], r["step"]) for r in got] == [(r["prefix"], r["step"]) for r in want]
    assert {r["prefix"] for r in got} == {"train", "val", "epoch"}
    for g, w in zip(got, want):
        assert set(g) == set(w), (g["prefix"], sorted(set(g) ^ set(w)))
        assert all(np.isfinite(v) for k, v in g.items() if k != "prefix")
    epochs = [r for r in got if r["prefix"] == "epoch"]
    assert [r["kl_beta"] for r in epochs] == [PORT_CFG.loss.kl_beta] * 2
    saved = ckpt.all_checkpoints(port_dir)
    assert [ckpt.checkpoint_epoch(p) for p in saved] == [0, 1]
    journal = json.loads((port_dir / "saved_models" / "monitor.json").read_text())
    assert "val/action_loss_pp" in journal["1"] and "train/grad_norm" in journal["1"]


def _state(trainer):
    return (
        {k: v.clone() for k, v in trainer.model.state_dict().items()},
        trainer.optimizer.checkpoint_state(),
        trainer.step,
        trainer.generator.get_state(),
    )


def _assert_same_state(a, b):
    params_a, opt_a, step_a, gen_a = a
    params_b, opt_b, step_b, gen_b = b
    assert step_a == step_b and opt_a["count"] == opt_b["count"]
    assert params_a.keys() == params_b.keys()
    for k in params_a:
        assert torch.equal(params_a[k], params_b[k]), k
    for key in ("exp_avg", "exp_avg_sq"):
        assert len(opt_a[key]) == len(opt_b[key])
        for m, n in zip(opt_a[key], opt_b[key]):
            assert torch.equal(m, n)
    assert torch.equal(gen_a, gen_b)


def test_resumed_fit_is_bit_equal_to_an_uninterrupted_one(root, tmp_path):
    train, val = _loaders(root)
    whole = Trainer(PORT_CFG, _tcfg(tmp_path / "whole"), device="cpu")
    whole.fit(train, val, max_epochs=2)

    train, val = _loaders(root)  # the same seed: the cut run sees the same batches
    first = Trainer(PORT_CFG, _tcfg(tmp_path / "cut"), device="cpu")
    assert first.fit(train, val, max_epochs=2, max_steps=len(train)) == len(train)
    assert [ckpt.checkpoint_epoch(p) for p in ckpt.all_checkpoints(tmp_path / "cut")] == [0]
    resumed = Trainer(PORT_CFG, _tcfg(tmp_path / "cut"), device="cpu")
    assert resumed.fit(train, val, max_epochs=2) == 2 * len(train)
    _assert_same_state(_state(resumed), _state(whole))


def test_checkpoint_restores_bit_equal(root, tmp_path):
    train, _ = _loaders(root)
    trainer = Trainer(PORT_CFG, _tcfg(tmp_path / "run"), device="cpu")
    trainer.fit(train, None, max_epochs=1, max_steps=3)
    other = Trainer(PORT_CFG, _tcfg(tmp_path / "other", seed=7), device="cpu")
    other.init_state(1)
    other.restore(ckpt.latest_checkpoint(tmp_path / "run"))
    _assert_same_state(_state(other), _state(trainer))
    assert other.epoch == 0


def test_the_trainer_keeps_no_loader(root, tmp_path):
    train, val = _loaders(root)
    trainer = Trainer(PORT_CFG, _tcfg(tmp_path / "run"), device="cpu")
    trainer.fit(train, val, max_epochs=1, max_steps=1)
    refs = [weakref.ref(train), weakref.ref(val)]
    del train, val
    gc.collect()
    assert [r() for r in refs] == [None, None]  # nor their stores nor staging memory
    assert trainer.staging is None  # on the CPU batches go up by batch_to_device


def test_max_total_steps_is_idempotent(root, tmp_path):
    train, _ = _loaders(root)
    run = tmp_path / "run"
    assert Trainer(PORT_CFG, _tcfg(run), device="cpu").fit(train, None, max_epochs=5, max_total_steps=3) == 3
    lines = len(_records(run))
    again = Trainer(PORT_CFG, _tcfg(run), device="cpu")
    assert again.fit(train, None, max_epochs=5, max_total_steps=3) == 3
    assert len(_records(run)) == lines  # nothing trained, nothing logged
    assert Trainer(PORT_CFG, _tcfg(run), device="cpu").fit(train, None, max_epochs=5, max_total_steps=4) == 4


def test_echo_factor_takes_two_steps_per_batch(root, tmp_path):
    train, _ = _loaders(root)
    trainer = Trainer(PORT_CFG, _tcfg(tmp_path / "run", echo_factor=2), device="cpu")
    assert trainer.fit(train, None, max_epochs=1) == 2 * len(train)
    records = _records(tmp_path / "run")
    assert [r["step"] for r in records if r["prefix"] == "train"] == [2 * (i + 1) for i in range(len(train))]
    (epoch,) = [r for r in records if r["prefix"] == "epoch"]
    assert epoch["seq_per_sec"] * epoch["epoch_time_s"] == pytest.approx(2 * len(train) * 2 * LOADER["batch_size"])


def test_partial_checkpoints_are_skipped_and_saves_are_atomic(root, tmp_path):
    train, _ = _loaders(root)
    run = tmp_path / "run"
    trainer = Trainer(PORT_CFG, _tcfg(run, checkpoint_every_steps=2), device="cpu")
    trainer.fit(train, None, max_epochs=1, max_steps=5)
    saved = run / "saved_models"
    # the mid-epoch saves at steps 2 and 4 replaced epoch_0 in place, then the capped end saved it
    assert sorted(p.name for p in saved.iterdir()) == ["epoch_0", "monitor.json"]
    assert ckpt.restore_checkpoint(saved / "epoch_0")["step"] == 5
    (saved / "epoch_3").mkdir()  # a save cut before its state was written
    (saved / "epoch_4").mkdir()
    (saved / "epoch_4" / "other.bin").write_bytes(b"\0")
    (saved / ".tmp-epoch_5-1").mkdir()
    torch.save({}, saved / ".tmp-epoch_5-1" / ckpt.STATE_FILE)
    assert ckpt.all_checkpoints(run) == [saved / "epoch_0"]
    resumed = Trainer(PORT_CFG, _tcfg(run), device="cpu")
    assert resumed.fit(train, None, max_epochs=2, max_steps=1) == 6
    assert [ckpt.checkpoint_epoch(p) for p in ckpt.all_checkpoints(run)] == [0, 1]


def test_a_save_cut_between_its_renames_keeps_the_epoch(tmp_path, monkeypatch):
    run = tmp_path / "run"
    ckpt.save_checkpoint(run, 0, {"w": torch.zeros(2)})
    ckpt.save_checkpoint(run, 1, {"w": torch.ones(2)})
    rename, calls = ckpt.os.rename, []

    def cut_after_one(src, dst):  # the save dies after renaming the old epoch_1 aside
        calls.append(dst)
        if len(calls) > 1:
            raise OSError("cut")
        rename(src, dst)

    monkeypatch.setattr(ckpt.os, "rename", cut_after_one)
    with pytest.raises(OSError, match="cut"):
        ckpt.save_checkpoint(run, 1, {"w": torch.full((2,), 2.0)})
    monkeypatch.setattr(ckpt.os, "rename", rename)
    saved = run / "saved_models"
    assert not (saved / "epoch_1").exists()
    latest = ckpt.latest_checkpoint(run)
    assert latest.name.startswith(".old-epoch_1-") and ckpt.checkpoint_epoch(latest) == 1
    assert [ckpt.checkpoint_epoch(p) for p in ckpt.all_checkpoints(run)] == [0, 1]
    assert torch.equal(ckpt.restore_checkpoint(latest)["w"], torch.ones(2))
    # the next save of that epoch takes its place and clears what the cut save left aside
    ckpt.save_checkpoint(run, 1, {"w": torch.full((2,), 3.0)})
    assert ckpt.all_checkpoints(run) == [saved / "epoch_0", saved / "epoch_1"]
    assert not list(saved.glob(".old-*"))
    assert torch.equal(ckpt.restore_checkpoint(ckpt.latest_checkpoint(run))["w"], torch.full((2,), 3.0))


def test_monitored_topk_checkpointing(tmp_path):
    run_dir = tmp_path / "run"
    policy = ckpt.CheckpointPolicy("val/action_loss_pp", "min", top_k=2)
    mgr = ckpt.MonitoredCheckpointer(run_dir, policy)
    for epoch, val in {0: 5.0, 1: 1.0, 2: 3.0, 3: 0.5, 4: 4.0}.items():
        mgr.save(epoch, {"w": torch.full((3,), float(epoch))}, {"val/action_loss_pp": val})
    # top-2 by min value: epochs 3 (0.5) and 1 (1.0); the latest (4) always kept
    assert {ckpt.checkpoint_epoch(p) for p in ckpt.all_checkpoints(run_dir)} == {1, 3, 4}
    assert ckpt.checkpoint_epoch(mgr.best()) == 3
    best_max = ckpt.best_checkpoint(run_dir, ckpt.CheckpointPolicy("val/action_loss_pp", "max"))
    assert ckpt.checkpoint_epoch(best_max) == 4
    assert torch.equal(ckpt.restore_checkpoint(mgr.best())["w"], torch.full((3,), 3.0))
    assert ckpt.resolve_checkpoint_policy("lh_sr").monitor == "eval_lh/avg_seq_len"
    assert ckpt.resolve_checkpoint_policy("all").monitor is None
    with pytest.raises(ValueError):
        ckpt.resolve_checkpoint_policy("nope")


def _events(path):
    """The events of a TFRecord file: each record is its length (8 bytes),
    a CRC (4), the serialized event and a CRC (4)."""
    data, pos, out = path.read_bytes(), 0, []
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 8], "little")
        out.append(event_pb2.Event.FromString(data[pos + 12:pos + 12 + n]))
        pos += 12 + n + 4
    return out


def test_loggers(tmp_path):
    tb = TensorBoardLogger(str(tmp_path / "tb"))
    jsonl = make_logger("jsonl", str(tmp_path / "run"))
    both = MultiLogger([jsonl, tb])
    both.log({"loss": torch.tensor(1.5), "note": "skipped"}, 3, "val")
    both.close()
    assert _records(tmp_path / "run") == [{"step": 3, "prefix": "val", "loss": 1.5}]
    (events,) = (tmp_path / "tb").glob("events.out.tfevents.*")
    scalars = [(e.step, v.tag, v.simple_value) for e in _events(events) for v in e.summary.value]
    assert scalars == [(3, "val/loss", 1.5)]
    with pytest.raises(ValueError):
        make_logger("wandb", str(tmp_path))
