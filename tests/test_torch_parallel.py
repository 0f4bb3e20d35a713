"""Data-parallel and ZeRO-3 training at two ranks on the CPU (gloo) against
one process and the JAX package's single-device step, at ``hulc_debug``
with an 84 px gripper camera.

One spawn of two ranks (``parallel.mesh.Ranks``, a ``file://``
rendezvous under the test's tmp_path) runs every check of
``tests/torch_parallel_workers.py`` while this process computes the
references; ``dryrun_multichip(2, "cpu")`` spawns its own beside them.
Tolerances: the
CLIP loss and its gradients rtol 1e-6 (a gradient's
entries also within 1e-6 of the tensor's largest: the ranks' products
over fewer rows round otherwise); the two-rank steps against the
one-process port: ``grad_norm`` rtol 1e-6 (1e-5 after the first step,
``_check_steps_against``), every
parameter within 1e-5 of its largest entry (``_check_params``), each bf16
moment's entries within one bf16
ulp, or within 1e-3 of the moment's largest entry where the gradient is
rounding noise (a gradient the ranks' sums round otherwise can round to
the neighbouring bf16 value: a relative L2 of 1e-5 is below bf16's
resolution); losses by the JAX package's equal-loss rule,
``|a - b| <= 1e-5 * max(1, |b|)``; against JAX's step (its shifts and
plan noise injected): losses rtol 1e-5 (as test_torch_train_step.py),
``grad_norm`` rtol 1e-5, parameters relative L2 1e-5 per leaf."""

import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training import train_state as flax_train_state

from __graft_entry__ import _make_raw_batch
from hulc_tpu import config as jax_config
from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.models.hulc import masked_clip_loss as jax_masked_clip_loss
from hulc_tpu.training.torch_convert import convert_state_dict
from hulc_tpu.training.trainer import Trainer as JaxTrainer
from hulc_tpu.training.trainer import TrainerConfig as JaxTrainerConfig

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch.convert import params_from_jax
from hulc_tpu_torch.data.fixtures import make_fixture_dataset
from hulc_tpu_torch.models.hulc import ModalityBatch
from hulc_tpu_torch.parallel import mesh
from hulc_tpu_torch.parallel.dryrun import dryrun_multichip
from hulc_tpu_torch.training.trainer import Trainer, TrainerConfig
from tests import torch_parallel_workers as workers
from tests.torch_port_common import QUICK_COMPILE, jax_random_params

torch.set_num_threads(1)

B, S, RANKS = 4, 4, 2  # global windows per modality, frames, ranks
JAX_CFG, PORT_CFG = workers.debug_cfg(jax_config), workers.debug_cfg(port_config)
CLIP_ROWS = 6  # rank 1's three rows are all masked out
BF16_ULP = 2.0 ** -7  # a bf16 ulp, relative: the largest step between neighbours
# share of a moment's largest entry below which its gradient is rounding
# noise (the attention's key bias, zero in exact arithmetic, among them)
MOMENT_FLOOR = 1e-3
CLIP_MASK = np.array([True, False, True, False, False, False])


def _raw(seed):
    split = _make_raw_batch(JAX_CFG, B, S, seed=seed)
    split["lang"] = split["lang"]._replace(use_for_aux_lang_loss=np.array([True, False, True, True]))
    return {scope: tuple(mod) for scope, mod in CombinedLoader.fuse_batch(split).items()}


def _jax_noise(rng, step):
    """The shifts and plan noise of JAX's train step ``step`` (its key chain)."""
    k_aug, k_loss, _ = jax.random.split(jax.random.fold_in(rng, step), 3)
    _, k_scope = jax.random.split(k_aug)
    k_static, k_gripper = jax.random.split(k_scope, 5)[:2]
    pe, d = JAX_CFG.perceptual_encoder, JAX_CFG.distribution
    shifts = {"fused": {
        cam: torch.from_numpy(np.array(jax.random.randint(k, (2 * B * S, 2), 0, 2 * enc.shift_pad + 1)))
        for cam, k, enc in (("rgb_static", k_static, pe.rgb_static), ("rgb_gripper", k_gripper, pe.rgb_gripper))
    }}
    gumbel = jax.random.gumbel(jax.random.split(k_loss)[1], (2 * B, d.category_size, d.class_size))
    return {"shifts": shifts, "gumbel": torch.from_numpy(np.array(gumbel))}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results and this process's references."""
    tmp = tmp_path_factory.mktemp("parallel")
    dryrun = {}
    dryrun_thread = threading.Thread(target=_dryrun_into, args=(dryrun,))
    dryrun_thread.start()
    jax_model, params = jax_random_params(JAX_CFG, seed=30)
    state, unused = params_from_jax(params, PORT_CFG)
    assert unused == []
    rng = jax.random.key(32)
    raw = _raw(31)
    noise = [_jax_noise(rng, k) for k in range(2)]
    data = tmp / "data"
    make_fixture_dataset(data, num_episodes=2, episode_len=48, small=True)
    clip_rng = np.random.default_rng(5)
    torch.manual_seed(0)
    clip = ({k: v.detach().clone() for k, v in workers.ClipHead().state_dict().items()},
            torch.from_numpy(clip_rng.normal(size=(CLIP_ROWS, 16)).astype(np.float32)),
            torch.from_numpy(clip_rng.normal(size=(CLIP_ROWS, 12)).astype(np.float32)),
            torch.from_numpy(CLIP_MASK))
    fit_batches = [_raw(40), _raw(41)]
    spec = {"clip": clip, "state": state, "raw": raw, "noise": noise, "data_root": str(data),
            "fit_dir": str(tmp / "fit"), "fit_batches": fit_batches, "cli_dir": str(tmp / "cli")}
    ranks = mesh.Ranks(workers.rank_checks, RANKS, "cpu", (spec,), init_method=f"file://{tmp}/rendezvous")

    # the references, while the ranks run
    ref = {
        "clip": workers.clip_grads(*clip),
        "steps": workers.train_steps("ddp", state, raw, noise),
        "dropout": workers.train_steps("ddp", None, raw, [None], workers.dropout_cfg(), seed=5),
        "loader": workers.first_batches(str(data), 4),
    }
    tcfg = JaxTrainerConfig(run_dir=str(tmp / "jax_run"), num_devices=1, donate_state=False, lr=workers.LR)
    jax_trainer = JaxTrainer(JAX_CFG, tcfg)
    jstate = flax_train_state.TrainState.create(
        apply_fn=jax_model.apply, params=jax.tree.map(jnp.asarray, params), tx=jax_trainer.build_optimizer(1)
    )
    fused = {scope: jax_config_batch(mod) for scope, mod in raw.items()}
    kl_beta = jnp.asarray(workers.KL_BETA, jnp.float32)
    step = jax_trainer.make_train_step().lower(jstate, fused, rng, kl_beta).compile(QUICK_COMPILE)
    jax_losses = []
    for _ in range(2):
        jstate, losses = step(jstate, fused, rng, kl_beta)
        jax_losses.append(jax.device_get(losses))
    ref["jax"] = {"losses": jax_losses, "params": jax.device_get(jstate.params)}
    results = ranks.results()
    dryrun_thread.join()
    return {"ranks": results, "ref": ref, "spec": spec, "tmp": tmp, "dryrun": dryrun}


def _dryrun_into(out):
    """``dryrun_multichip(2, "cpu")``'s result or error into ``out``."""
    try:
        out["result"] = dryrun_multichip(2, "cpu")
    except BaseException as e:  # re-raised by the test
        out["error"] = e


def jax_config_batch(mod):
    from hulc_tpu.models.hulc import ModalityBatch as JaxModalityBatch

    return JaxModalityBatch(*mod)


def test_clip_loss_over_ranks_is_the_whole_batch_loss(run):
    """(a) ``masked_clip_loss`` over ``gather_rows`` with rank 1's rows all
    masked out: the loss on both ranks is the one-process loss and JAX's on
    the whole batch; the features' gradients (divided by the ranks, which
    DDP's average of the parameters' gradients undoes) and the
    ``proj_vis_lang`` and ``logit_scale`` gradients after DDP's average are
    the one-process ones: a factor of 2 would show."""
    ref = run["ref"]["clip"]
    head = workers.ClipHead()
    head.load_state_dict(run["spec"]["clip"][0])
    _, seq_feat, goal, mask = run["spec"]["clip"]
    with torch.no_grad():
        img, txt = head.proj_vis_lang(seq_feat, goal)
    want = float(jax_masked_clip_loss(jnp.asarray(img.numpy()), jnp.asarray(txt.numpy()),
                                      jnp.exp(jnp.asarray(head.logit_scale.item())), jnp.asarray(mask.numpy())))
    np.testing.assert_allclose(float(ref["loss"]), want, rtol=1e-6)
    rows = CLIP_ROWS // RANKS
    for got in run["ranks"]:
        r = got["rank"]
        clip = got["clip"]
        np.testing.assert_allclose(float(clip["loss"]), float(ref["loss"]), rtol=1e-6)
        for name in ("seq_feat", "goal"):
            want_rows = ref[name][r * rows:(r + 1) * rows].numpy()
            np.testing.assert_allclose(clip[name].numpy() / RANKS, want_rows, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref[name].numpy()).max(), err_msg=name)
        for name, g in clip["params"].items():
            want = ref["params"][name].numpy()
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max(), err_msg=name)
    assert float(np.abs(ref["params"]["logit_scale"].numpy())) > 1e-4  # the comparison is not vacuous


def _check_params(got, want, steps):
    """Each parameter within 1e-5 of its largest entry, but for the entries
    Adam moved by about lr * sign(g) where g is rounding noise (each within
    2 lr a step; at most 10% of a tensor, or one entry, and 0.1% of the
    model): tensors whose gradient is zero in exact arithmetic hold noise
    on both sides, as test_torch_train_step.py finds (the attention's key
    bias: a constant added to every key of a query cancels in its softmax;
    a conv bias a spatial softmax normalizes away)."""
    apart_total = size_total = 0
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        if k.endswith("self_attn.in_proj_bias"):  # the key bias: noise
            d = len(w) // 3
            g, w = np.concatenate([g[:d], g[2 * d:]]), np.concatenate([w[:d], w[2 * d:]])
        diff = np.abs(g - w)
        apart = diff > 1e-5 * np.abs(w).max()
        assert apart.sum() <= max(1, apart.size // 10), (k, int(apart.sum()))
        assert np.all(diff[apart] <= 2 * workers.LR * steps * (1 + 1e-3)), (k, float(diff.max()))
        apart_total, size_total = apart_total + apart.sum(), size_total + apart.size
    assert apart_total <= size_total // 1000, apart_total


def _check_steps_against(got, want):
    """Each step's losses by the equal-loss rule; the first step's norm to
    rtol 1e-6, a later step's to 1e-4 (test_torch_train_step.py's gradient
    tolerance): Adam's first update moves every entry by about lr * sign(g),
    so where g is rounding noise the ranks' parameters and the one
    process's step apart (``_check_params``), and relu units that switch
    move the next gradients by more than rounding."""
    assert len(got["steps"]) == len(want["steps"])
    for i, (a, b) in enumerate(zip(got["steps"], want["steps"])):
        assert set(a) == set(b)
        for k in b:
            if k == "grad_norm":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6 if i == 0 else 1e-4, err_msg=k)
            else:
                assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), (k, a[k], b[k])


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_two_rank_steps_match_one_rank_and_jax(run, mode):
    """(b) Two train steps at two ranks on JAX's shifts and plan noise: the
    losses, ``grad_norm``, every parameter and both bf16 moments against the
    one-process port, and the losses, norms and parameters against JAX's
    single-device steps. Both ranks hold the same parameters."""
    ref = run["ref"]["steps"]
    results = [r["steps"][mode] for r in run["ranks"]]
    for got in results:
        _check_steps_against(got, ref)
        _check_params(got["params"], ref["params"], 2)
        for name in ("exp_avg", "exp_avg_sq"):
            for i, (a, b) in enumerate(zip(got["optimizer"][name], ref["optimizer"][name])):
                assert a.dtype == b.dtype == torch.bfloat16, (name, i)
                a, b = a.float(), b.float()
                limit = BF16_ULP * torch.maximum(a.abs(), b.abs()) + MOMENT_FLOOR * b.abs().max()
                assert torch.all((a - b).abs() <= limit), (name, i)
    for k in ref["params"]:
        assert torch.equal(results[0]["params"][k], results[1]["params"][k]), k
    jax_ref = run["ref"]["jax"]
    for a, b in zip(results[0]["steps"], jax_ref["losses"]):
        for k in a:
            np.testing.assert_allclose(a[k], float(b[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    got_params, _ = convert_state_dict({k: v.numpy() for k, v in results[0]["params"].items()}, JAX_CFG)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    for (path, g), (_, w) in zip(flat(got_params), flat(jax_ref["params"])):
        assert _rel(g, w) <= 1e-5, jax.tree_util.keystr(path)


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_two_rank_steps_draw_what_one_rank_draws(run, mode):
    """(c) A step with nothing injected, dropout on at every site of
    ``hulc_debug`` (the towers, the word dropout, the recognition
    transformer with its attention's batch-shared mask): the shifts, plan
    noise and masks each rank keeps are its rows of the one-process draws,
    so the step equals the one-process step at the same seed."""
    ref = run["ref"]["dropout"]
    for got in (r["dropout"][mode] for r in run["ranks"]):
        _check_steps_against(got, ref)
        _check_params(got["params"], ref["params"], 1)


def _cat_rows(parts, blocks):
    """The ranks' rows stacked back into the global batch."""
    return np.concatenate([np.concatenate([np.split(p, blocks)[k] for p in parts]) for k in range(blocks)])


def test_loader_rows_stack_to_the_one_rank_batch(run):
    """(d) Each rank's first fused, per-modality and validation batch,
    stacked by rank, is the one-process batch byte for byte."""
    ref = run["ref"]["loader"]
    for name, want in ref.items():
        for scope, mod in want.items():
            for field, w in zip(ModalityBatch._fields, mod):
                parts = [getattr(r["loader"][name][scope], field) for r in run["ranks"]]
                if w is None:
                    assert all(p is None for p in parts)
                    continue
                blocks = 2 if scope == "fused" and field not in ModalityBatch.LANG_ONLY_FIELDS else 1
                got = _cat_rows([np.asarray(p) for p in parts], blocks)
                assert got.dtype == np.asarray(w).dtype and np.array_equal(got, np.asarray(w)), (name, scope, field)


def test_fsdp_checkpoint_resumes_in_one_process(run):
    """(e) A two-rank FSDP ``fit`` of one epoch (2 steps) saves a checkpoint
    (rank 0, the one-device format); one process without a group resumes
    it for a third step, which matches the two ranks' uninterrupted 3-step
    ``fit`` (``_check_params``; the step's losses by the equal-loss rule).
    Rank 0 alone wrote the JSONL."""
    whole, cut = (run["ranks"][0]["fit"][k] for k in ("whole", "cut"))
    assert whole["step"] == 3 and cut["step"] == 2
    resumed = Trainer(PORT_CFG, TrainerConfig(run_dir=cut["run_dir"], lr=workers.LR, seed=7, log_every=1),
                      device="cpu")
    assert resumed.fit([workers.as_batch(b) for b in run["spec"]["fit_batches"]], None, max_epochs=2,
                       max_total_steps=3) == 3
    _check_params(resumed.model.state_dict(), whole["params"], 1)

    def train_lines(run_dir):
        lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
        return [x for x in lines if x["prefix"] == "train"]

    got, want = train_lines(Path(cut["run_dir"])), train_lines(Path(whole["run_dir"]))
    assert [x["step"] for x in got] == [x["step"] for x in want] == [1, 2, 3]
    for a, b in zip(got, want):
        assert abs(a["total_loss"] - b["total_loss"]) <= 1e-5 * max(1.0, abs(b["total_loss"]))


def test_cli_trains_with_fsdp_and_refuses_tp_and_uneven_batches(run):
    """(f) ``train.main`` under the group with ``--fsdp`` trains 2 steps and
    saves; ``--tp 2`` is refused naming ROADMAP A.4's next slice, and a
    batch of 3 windows that 2 ranks do not divide is refused."""
    for r in run["ranks"]:
        cli = r["cli"]
        assert cli["step"] == 2 and cli["saved"]
        assert "next slice of ROADMAP A.4" in cli["refusals"]["tp"]
        assert "does not split over 2 ranks" in cli["refusals"]["batch"]


def test_dryrun_multichip_two_ranks_cpu(run):
    """(g) ``parallel.dryrun.dryrun_multichip(2, "cpu")`` (run beside the
    other ranks): the dp, fused and fsdp steps at two ranks equal one
    rank's by the JAX rule."""
    if "error" in run["dryrun"]:
        raise run["dryrun"]["error"]
    assert set(run["dryrun"]["result"]["many"]) == {"dp", "fused", "fsdp"}


def test_rows_of_takes_each_ranks_share_of_each_block():
    """The fused layout: rank r holds [vis_r; lang_r] of [vis; lang]."""
    x = np.arange(8)
    assert mesh.rows_of(x, 2, 2, 0).tolist() == [0, 1, 4, 5]
    assert mesh.rows_of(x, 2, 2, 1).tolist() == [2, 3, 6, 7]
    assert mesh.rows_of(list(range(6)), 1, 3, 2) == [4, 5]
    with pytest.raises(ValueError):
        mesh.rows_of(x, 2, 3, 0)
    assert mesh.world() == 1 and mesh.gather_rows(torch.ones(2)).shape == (2,)  # no group: the identity
