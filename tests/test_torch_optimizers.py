"""The optimizers of the JAX trainer in the port (``training/optimizers.py``:
``AdamLowp``, ``Adam``, ``AdamW``, ``SGD``) and the trainer's choice among
them, on the CPU at ``hulc_debug``.

* Each optimizer against its optax chain over 3 steps of a numpy-seeded
  tree whose one parameter never has a gradient (optax sees zeros), under a
  schedule that changes every step: the moments (the trace for SGD)
  bit-equal, the parameters within atol 1e-7, the returned norm within rtol
  1e-6 of ``optax.global_norm`` and bit-equal to the plain ``global_norm``:
  the tolerances ``tests/test_torch_grad_norm.py`` holds ``AdamLowp`` to.
  The optax updates run jitted on the host (``torch_port_common.jax_call``).
* The kernels' C launchers and the plain pointer table for SGD's one moment.
* ``Trainer.build_optimizer`` against the JAX trainer's for every
  (optimizer, adam_mv_dtype) pair: the same optimizer (two steps from the
  same state agree) or the same refusal.
* A ``fit`` with SGD cut and resumed is bit-equal to an uninterrupted one;
  a checkpoint of another optimizer, or without one, is refused.
"""

import itertools
import json
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hulc_tpu.training.optimizers import adam_lowp as jax_adam_lowp
from hulc_tpu.training.trainer import Trainer as JaxTrainer
from hulc_tpu.training.trainer import TrainerConfig as JaxTrainerConfig

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch import kernels
from hulc_tpu_torch.data.fixtures import make_fixture_dataset
from hulc_tpu_torch.data.loader import make_loaders
from hulc_tpu_torch.training import checkpoint as ckpt
from hulc_tpu_torch.training import optimizers
from hulc_tpu_torch.training.optimizers import (
    SGD,
    Adam,
    AdamLowp,
    AdamW,
    PointerTable,
    adam_update,
    global_norm,
    pointer_table_rows,
    sgd_update,
)
from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig

from tests.torch_port_common import jax_call

torch.set_num_threads(1)

SHAPES = {"a": (33, 7), "b": (5,), "c": (1,), "d": (2, 3, 4), "e": (9, 11)}
NO_GRAD = "c"  # never has a gradient: optax updates it with zeros
PARAM_ATOL, NORM_RTOL = 1e-7, 1e-6  # as tests/test_torch_grad_norm.py holds AdamLowp


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * 10.0 ** rng.uniform(-4, 1, s)).astype(np.float32) for k, s in SHAPES.items()}


def _schedule(count):
    """A learning rate that changes every step, so reading it at the wrong
    count shows."""
    return 3e-3 / (1.0 + count)


def JAX_SCHEDULE(count):
    """``_schedule`` for optax (``count`` is traced): its fp32 values, so
    both sides scale by the same learning rate bit for bit."""
    return jnp.asarray([_schedule(c) for c in range(4)], jnp.float32)[count]


CASES = {
    # name: (optax chain, port optimizer, the port's moment keys and optax's moment fields)
    "adam_lowp": (lambda: jax_adam_lowp(JAX_SCHEDULE), lambda ps: AdamLowp(ps, lr=_schedule),
                  (("exp_avg", "mu"), ("exp_avg_sq", "nu"))),
    "adam": (lambda: optax.adam(JAX_SCHEDULE), lambda ps: Adam(ps, lr=_schedule),
             (("exp_avg", "mu"), ("exp_avg_sq", "nu"))),
    "adamw": (lambda: optax.adamw(JAX_SCHEDULE, weight_decay=1e-6), lambda ps: AdamW(ps, lr=_schedule),
              (("exp_avg", "mu"), ("exp_avg_sq", "nu"))),
    "sgd": (lambda: optax.sgd(JAX_SCHEDULE, momentum=0.9), lambda ps: SGD(ps, lr=_schedule),
            (("momentum_buffer", "trace"),)),
}


def _optax_step(tx):
    def step(params, state, grads):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, optax.global_norm(grads)
    return step


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_matches_optax_for_three_steps(name):
    make_tx, make_port, moment_keys = CASES[name]
    params = _tree(10)
    tx = make_tx()
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_port(t_params.values())
    step = _optax_step(tx)
    for i in range(3):
        grads = _tree(20 + i)
        grads[NO_GRAD] = np.zeros_like(grads[NO_GRAD])
        j_params, j_state, j_norm = jax_call(step, j_params, j_state, jax.tree.map(jnp.asarray, grads))
        for k, p in t_params.items():
            p.grad = None if k == NO_GRAD else torch.from_numpy(grads[k])
        norm = opt.step()
        assert norm.dtype == torch.float32 and norm.dim() == 0
        np.testing.assert_allclose(float(norm), float(j_norm), rtol=NORM_RTOL)
        assert torch.equal(norm, global_norm([p.grad for p in t_params.values()]))
    inner = j_state[0]
    for k, p in t_params.items():
        for port_key, optax_field in moment_keys:
            got = opt.state[p][port_key]
            assert got.dtype == opt.MOMENT_DTYPE
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(getattr(inner, optax_field)[k], np.float32),
                                          err_msg=f"{name} {port_key} of {k}")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]), atol=PARAM_ATOL, rtol=0, err_msg=k)
    assert opt.count == 3 and opt.checkpoint_state()["kind"] == opt.KIND


@pytest.mark.parametrize("name", list(CASES))
def test_checkpoint_state_round_trip_and_kind_refusal(name):
    """A state loads into a fresh optimizer of its kind (moments copied in
    place, the count kept) and is refused by every other kind."""
    _, make_port, moment_keys = CASES[name]
    ps = [torch.nn.Parameter(torch.randn(5, generator=torch.Generator().manual_seed(i))) for i in range(3)]
    opt = make_port(ps)
    for p in ps:
        p.grad = torch.ones_like(p)
    opt.step()
    state = opt.checkpoint_state()
    assert state["kind"] == opt.KIND and set(state) == {"kind", "count", *(k for k, _ in moment_keys)}
    other_params = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    fresh = make_port(other_params)
    fresh.step()  # makes the buffers whose addresses must stay
    buffers = [fresh.state[p][moment_keys[0][0]] for p in other_params]
    fresh.load_checkpoint_state(state)
    assert fresh.count == 1
    for p, q, buf in zip(ps, other_params, buffers):
        assert fresh.state[q][moment_keys[0][0]] is buf
        for key, _ in moment_keys:
            assert torch.equal(fresh.state[q][key], opt.state[p][key])
    for other in CASES:
        if other != name:
            with pytest.raises(ValueError, match=f"state of a '{opt.KIND}' optimizer"):
                CASES[other][1]([torch.nn.Parameter(p.detach().clone()) for p in ps]).load_checkpoint_state(state)


def test_launchers_and_template_instances_match_the_cuda_source():
    """B.5' adds three instances of csrc/adam_lowp.cu's template, each its
    own C launcher: fp32 Adam (B.5's arguments), AdamW (and the weight
    decay), SGD (the momentum and the negated learning rate), counted in
    ``ALL_KERNELS``; the template takes the rule at compile time."""
    src = (kernels.CSRC_DIR / "adam_lowp.cu").read_text()
    launchers = dict(re.findall(r'extern "C" int (hulc_\w+)\(([^)]*)\)', src))
    counts = {name: len(params.split(",")) - 1 for name, params in launchers.items()}  # less the stream
    assert counts == {"hulc_adam_lowp": 17, "hulc_adam_fp32": 17, "hulc_adamw": 18, "hulc_sgd": 11,
                      "hulc_grad_norm_finish": 3}
    for name, n in counts.items():
        assert len(kernels._SIGNATURES[name]) == n, name
    assert kernels._SIGNATURES["hulc_adam_fp32"] == kernels._SIGNATURES["hulc_adam_lowp"]
    assert kernels._SIGNATURES["hulc_adamw"] == (*kernels._SIGNATURES["hulc_adam_lowp"], kernels._F32)
    assert kernels._SIGNATURES["hulc_sgd"] == (*kernels._SIGNATURES["hulc_adam_lowp"][:9], kernels._F32, kernels._F32)
    instances = re.findall(r"launch_update<([^>]+)>", src)
    assert sorted(instances) == sorted(["__nv_bfloat16, kAdam", "float, kAdam", "float, kAdamW", "float, kSgd"])
    assert "template <typename M, int kRule>\n__global__" in src
    assert {kernels.ADAM_FP32, kernels.ADAMW, kernels.SGD} <= set(kernels.ALL_KERNELS)
    assert (optimizers.ADAMW_WEIGHT_DECAY, optimizers.SGD_MOMENTUM) == (1e-6, 0.9)


def test_wrappers_refuse_cpu_tensors_and_sgd_has_no_second_moment():
    """No wrapper runs a plain version: CPU tensors raise. SGD's table rows
    carry 0 for the missing second moment, and the cache keys on it."""
    p = [torch.randn(6), torch.randn(3)]
    g = [torch.randn(6), None]
    m = [torch.zeros(6), torch.zeros(3)]
    with pytest.raises(ValueError, match="CUDA"):
        adam_update(p, g, m, [torch.zeros(6), torch.zeros(3)], 0.9, 0.999, 1e-8, -1e-3, 0.1, 0.001)
    with pytest.raises(ValueError, match="CUDA"):
        adam_update(p, g, m, [torch.zeros(6), torch.zeros(3)], 0.9, 0.999, 1e-8, -1e-3, 0.1, 0.001, weight_decay=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        sgd_update(p, g, m, 0.9, -1e-3)
    rows, _ = pointer_table_rows(p, m, [None, None])
    assert [row[2] for row in rows] == [0, 0] and [row[1] for row in rows] == [t.data_ptr() for t in m]
    table = PointerTable()
    first = table.get(p, m, [None, None])
    assert table.get(p, m, [None, None]) is first and table.builds == 1


# ---------------------------------------------------------------------------
# the trainer's choice
# ---------------------------------------------------------------------------

PAIRS = list(itertools.product(["adam", "adamw", "sgd", "lion"], [None, "float32", "bfloat16"]))
PORT_CHOICE = {("adam", None): Adam, ("adam", "float32"): Adam, ("adam", "bfloat16"): AdamLowp}


@pytest.mark.parametrize("optimizer,mv_dtype", PAIRS)
def test_build_optimizer_makes_the_jax_trainers_choice(optimizer, mv_dtype):
    """The JAX trainer's ``build_optimizer`` and the port's on the same
    fields: both refuse an unknown name, or two steps from the same
    parameters and gradients agree (moments stored as the port's optimizer
    stores them, bf16 only for adam with non-fp32 moments)."""
    kw = dict(optimizer=optimizer, adam_mv_dtype=mv_dtype, lr=1e-3, max_epochs=1)
    jax_self = types.SimpleNamespace(tcfg=JaxTrainerConfig(**kw))
    params = _tree(3)
    t_params = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in params.values()]
    port_self = types.SimpleNamespace(tcfg=TrainerConfig(**kw), model=torch.nn.ParameterList(t_params), use_kernels=True)
    if optimizer == "lion":
        with pytest.raises(ValueError, match="unknown optimizer"):
            JaxTrainer.build_optimizer(jax_self, 4)
        with pytest.raises(ValueError, match="unknown optimizer"):
            Trainer.build_optimizer(port_self, 4)
        return
    tx = JaxTrainer.build_optimizer(jax_self, 4)
    opt = Trainer.build_optimizer(port_self, 4)
    assert type(opt) is PORT_CHOICE.get((optimizer, mv_dtype), {"adamw": AdamW, "sgd": SGD}.get(optimizer))
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    step = _optax_step(tx)
    for i in range(2):
        grads = _tree(30 + i)
        j_params, j_state, _ = jax_call(step, j_params, j_state, jax.tree.map(jnp.asarray, grads))
        for p, g in zip(t_params, grads.values()):
            p.grad = torch.from_numpy(g)
        opt.step()
    for p, k in zip(t_params, params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]), atol=PARAM_ATOL, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# fit with SGD, and refused checkpoints
# ---------------------------------------------------------------------------

PORT_CFG = port_config.get_config("hulc_debug")
LOADER = dict(batch_size=4, min_window=6, max_window=8)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_fixture_dataset(tmp_path_factory.mktemp("opt_data"), num_episodes=2, episode_len=16)


def _loaders(root):
    return (make_loaders(PORT_CFG, root, fuse=True, seed=0, **LOADER),
            make_loaders(PORT_CFG, root, split="validation", deterministic=True, **LOADER))


def _tcfg(run_dir, optimizer="sgd"):
    return TrainerConfig(run_dir=str(run_dir), log_every=1, val_max_batches=1, optimizer=optimizer)


def test_sgd_fit_cut_and_resumed_is_bit_equal(root, tmp_path):
    """2 epochs with SGD, and the same run cut after its first epoch and
    resumed by a new Trainer: parameters, trace, count, step and generator
    bit-equal; the checkpoint names the kind."""
    train, val = _loaders(root)
    whole = Trainer(PORT_CFG, _tcfg(tmp_path / "whole"), device="cpu")
    whole.fit(train, val, max_epochs=2)
    train, val = _loaders(root)
    assert Trainer(PORT_CFG, _tcfg(tmp_path / "cut"), device="cpu").fit(
        train, val, max_epochs=2, max_steps=len(train)) == len(train)
    saved = ckpt.restore_checkpoint(ckpt.latest_checkpoint(tmp_path / "cut"))
    assert saved["optimizer"]["kind"] == "sgd" and set(saved["optimizer"]) == {"kind", "count", "momentum_buffer"}
    resumed = Trainer(PORT_CFG, _tcfg(tmp_path / "cut"), device="cpu")
    assert resumed.fit(train, val, max_epochs=2) == whole.step == 2 * len(train)
    assert isinstance(resumed.optimizer, SGD)
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    a, b = whole.optimizer.checkpoint_state(), resumed.optimizer.checkpoint_state()
    assert a["count"] == b["count"] == whole.step
    assert all(torch.equal(m, n) for m, n in zip(a["momentum_buffer"], b["momentum_buffer"]))
    assert torch.equal(whole.generator.get_state(), resumed.generator.get_state())


@pytest.mark.parametrize("start,steps,want", [(1, 2, "trace_steps_1-2.json"), (2, 50, "trace_steps_2-3.json")],
                         ids=["inside", "cut_by_the_run"])
def test_fit_profile_window_writes_a_trace(root, tmp_path, start, steps, want):
    """``profile_start`` / ``profile_steps``: the steps of the window run
    under torch.profiler (one optimizer span a step) and its trace is
    written to ``<run_dir>/profile``, also when the run ends inside it."""
    train, _ = _loaders(root)
    tcfg = TrainerConfig(run_dir=str(tmp_path), log_every=1, profile_start=start, profile_steps=steps)
    assert Trainer(PORT_CFG, tcfg, device="cpu").fit(train, None, max_epochs=1, max_steps=4) == 4
    traces = sorted(p.name for p in (tmp_path / "profile").iterdir())
    assert traces == [want]
    events = json.loads((tmp_path / "profile" / want).read_text())["traceEvents"]
    assert sum(e.get("name") == optimizers.OPTIMIZER_SPAN for e in events) == min(steps, 4 - start)


def test_restore_refuses_another_optimizer_and_a_params_only_checkpoint(tmp_path):
    sgd = Trainer(PORT_CFG, _tcfg(tmp_path / "sgd"), device="cpu")
    sgd.init_state(1)
    sgd._save(0, {})
    adam = Trainer(PORT_CFG, _tcfg(tmp_path / "adam", optimizer="adam"), device="cpu")
    adam.init_state(1)
    with pytest.raises(ValueError, match="'sgd' optimizer, not of 'adam_lowp'"):
        adam.restore(ckpt.latest_checkpoint(tmp_path / "sgd"))
    path = ckpt.save_checkpoint(tmp_path / "imported", 3,
                                {"params": sgd.model.state_dict(), "optimizer": None, "step": 0, "epoch": 3})
    with pytest.raises(ValueError, match="parameters only"):
        sgd.restore(path)
    assert set(ckpt.restore_params(path, sgd.model.state_dict())) == set(sgd.model.state_dict())
