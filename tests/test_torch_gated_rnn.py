"""The decoder RNN's gated cells in the port, gru (B.11) and lstm (B.12),
against the JAX package on the CPU: ``ScanRNN``'s plain loops, the
autograd Functions' closed-form backward (the dh chains the kernels
compute, one dW product and the bias sum) and autograd through the loop
against ``jax.grad``; a step at a time with the carry against the whole
sequence; the C entry points' bindings and the launch plan against
``csrc/rnn_gates.cu``; the cells still refused; ``apply_overrides``
against the JAX package's on the assignments of
tests/test_config_overrides.py; and at ``hulc_debug`` with the cell set by
``apply_overrides`` (``torch_port_common.gated_cfg``), the weights'
conversion both ways, the train step's losses and gradients and the
validation metrics (tests/test_torch_gated_decoder.py has the policies and
the export).
Inputs and weights are made with numpy in the JAX layout and carried into
the port as ``hulc_tpu_torch.convert`` does (kernels transposed)."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulc_tpu import config as jax_config
from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.models.layers import ScanRNN as JaxScanRNN
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch
from hulc_tpu.training.torch_convert import convert_state_dict

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch import kernels
from hulc_tpu_torch.models.hulc import LOSS_KEYS, ModalityBatch
from hulc_tpu_torch.models.layers import ScanBiRNN, ScanRNN
from hulc_tpu_torch.ops import recurrence
from hulc_tpu_torch.ops.recurrence import (
    GATES,
    dh_chain_gru_plain,
    dh_chain_lstm_plain,
    gated_plan,
    gated_smem_bytes,
    recurrence_weight_grads,
    rnn_gru,
    rnn_lstm,
)
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from tests.torch_port_common import GATED_B, GATED_S, gated_setup, jax_call, jax_gumbel, jax_mixture_uniforms
from tests.torch_port_common import port_model_from_jax

torch.set_num_threads(1)

B, S, F_IN, H, LAYERS = 3, 5, 7, 16, 2
ATOL = 1e-5  # fp32 sums in another order through S steps
CELLS = tuple(GATES)
H100_SMEM_OPTIN = 232_448  # bytes of shared memory a block may opt in to on an H100
H100_SMS = 132
H100_CLUSTERS = {8: 15, 4: 30, 2: 66, 1: 132}  # clusters an H100 holds at once at one block per SM


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _jax_params(rng, cell, in_features=F_IN, hidden=H, layers=LAYERS):
    """A JAX ScanRNN tree of the cell, torch's U(-1/sqrt(H), 1/sqrt(H)) by numpy."""
    g = GATES[cell]

    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32) / np.sqrt(hidden)

    params = {}
    for k in range(layers):
        params[f"ih_{k}"] = {"kernel": u(in_features if k == 0 else hidden, g * hidden), "bias": u(g * hidden)}
        params[f"hh_{k}"] = u(hidden, g * hidden)
        params[f"bhh_{k}"] = u(g * hidden)
    return params


def _port_rnn(params, cell, use_kernels, in_features=F_IN, hidden=H, layers=LAYERS):
    rnn = ScanRNN(in_features, hidden, layers, cell, use_kernels)
    sd = {}
    for k in range(layers):
        sd.update({f"weight_ih_l{k}": _t(params[f"ih_{k}"]["kernel"].T), f"bias_ih_l{k}": _t(params[f"ih_{k}"]["bias"]),
                   f"weight_hh_l{k}": _t(params[f"hh_{k}"].T), f"bias_hh_l{k}": _t(params[f"bhh_{k}"])})
    rnn.load_state_dict(sd, strict=True)
    return rnn


def _inputs(cell, seed):
    """x, a nonzero carry (lstm's pair; h a tanh state, c of N(0, 1)) and
    cotangents for y and for each carry tensor, from numpy."""
    rng = np.random.default_rng(seed)
    params = _jax_params(rng, cell)
    x = rng.normal(size=(B, S, F_IN)).astype(np.float32)
    shape = (LAYERS, B, H)
    h = np.tanh(rng.normal(size=shape)).astype(np.float32)
    carry = (h, rng.normal(size=shape).astype(np.float32)) if cell == "lstm" else h
    dy = rng.normal(size=(B, S, H)).astype(np.float32)
    dcarry = tuple(rng.normal(size=shape).astype(np.float32) for _ in range(1 + (cell == "lstm")))
    return params, x, carry, dy, dcarry


def _leaves(carry):
    return carry if isinstance(carry, tuple) else (carry,)


def _to_port(carry):
    return tuple(map(_t, carry)) if isinstance(carry, tuple) else _t(carry)


@functools.cache
def _jax_forward(cell):
    """JAX's ScanRNN on ``_inputs(cell, seed=1)``: (y, the final carry),
    once for both port paths."""
    params, x, carry, _, _ = _inputs(cell, seed=1)
    return JaxScanRNN(hidden_size=H, num_layers=LAYERS, cell=cell).apply(
        {"params": params}, jnp.asarray(x), jax.tree.map(jnp.asarray, carry))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_scan_rnn_matches_jax_with_carry(cell, use_kernels):
    """Two layers from a nonzero carry (lstm's pair): y and the final carry
    against JAX's ScanRNN, through the Functions (here on their plain
    versions) and through the plain loop."""
    params, x, carry, _, _ = _inputs(cell, seed=1)
    want_y, want_carry = _jax_forward(cell)
    rnn = _port_rnn(params, cell, use_kernels)
    with torch.no_grad():
        got_y, got_carry = rnn(_t(x), _to_port(carry))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL, rtol=0)
    assert isinstance(got_carry, tuple) == (cell == "lstm")
    for g, w in zip(_leaves(got_carry), _leaves(want_carry)):
        assert g.shape == (LAYERS, B, H)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@functools.cache
def _jax_grads(cell):
    """jax.grad of <y, dy> + <final carry, dcarry> on ``_inputs(cell,
    seed=2)`` for x, the carry and every parameter (weights in torch
    layout), once for both port paths."""
    params, x, carry, dy, dcarry = _inputs(cell, seed=2)
    module = JaxScanRNN(hidden_size=H, num_layers=LAYERS, cell=cell)

    def loss(p, xx, c):
        y, final = module.apply({"params": p}, xx, c)
        return jnp.sum(y * dy) + sum(jnp.sum(f * d) for f, d in zip(_leaves(final), dcarry))

    dp, dx, dc = jax.grad(loss, argnums=(0, 1, 2))(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                                    jax.tree.map(jnp.asarray, carry))
    grads = {"x": np.asarray(dx)}
    for i, d in enumerate(_leaves(dc)):
        grads[f"carry_{i}"] = np.asarray(d)
    for k in range(LAYERS):
        grads[f"weight_ih_l{k}"] = np.asarray(dp[f"ih_{k}"]["kernel"]).T
        grads[f"bias_ih_l{k}"] = np.asarray(dp[f"ih_{k}"]["bias"])
        grads[f"weight_hh_l{k}"] = np.asarray(dp[f"hh_{k}"]).T
        grads[f"bias_hh_l{k}"] = np.asarray(dp[f"bhh_{k}"])
    return grads


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("use_kernels", [True, False], ids=["function", "autograd"])
def test_grads_match_jax_grad(cell, use_kernels):
    """Gradients of a random linear function of y and of the final carry
    (lstm's h and c) for x, the carry and every weight: the Function's
    closed form (``use_kernels``, on the CPU the plain dh chain) and
    autograd through the plain loop, each against jax.grad."""
    params, x, carry, dy, dcarry = _inputs(cell, seed=2)
    want = _jax_grads(cell)
    rnn = _port_rnn(params, cell, use_kernels)
    xt = _t(x).requires_grad_()
    ct = tuple(_t(c).requires_grad_() for c in _leaves(carry))
    y, final = rnn(xt, ct if cell == "lstm" else ct[0])
    outs = [y, *_leaves(final)]
    grads = torch.autograd.grad(outs, [xt, *ct, *rnn.parameters()], [_t(dy), *map(_t, dcarry)])
    names = ["x", *(f"carry_{i}" for i in range(len(ct))), *(n for n, _ in rnn.named_parameters())]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("hidden", [16, 37])
def test_dh_chain_is_autograd_of_the_loop(cell, hidden):
    """The plain dh chain (what the backward kernel computes) on one layer,
    with one dW product and the bias sum, against autograd through the
    plain loop, with cotangents on y and on the final carry; gru's dhp is
    dxp but in the n slice, dxp_n * r."""
    rng = np.random.default_rng(hidden)
    g = GATES[cell]
    xp = _t(rng.normal(size=(B, S, g * hidden)))
    h0 = _t(np.tanh(rng.normal(size=(B, hidden))))
    c0 = _t(rng.normal(size=(B, hidden)))
    w = _t(rng.uniform(-1, 1, (g * hidden, hidden)) / np.sqrt(hidden))
    b = _t(rng.uniform(-1, 1, g * hidden) / np.sqrt(hidden))
    dy, dh_last, dc_last = (_t(rng.normal(size=s)) for s in ((B, S, hidden), (B, hidden), (B, hidden)))
    leaves = [t.clone().requires_grad_() for t in ((xp, h0, c0, w, b) if cell == "lstm" else (xp, h0, w, b))]
    y, _, saved = recurrence._gated_loop(cell, *(leaves if cell == "lstm" else (*leaves[:2], None, *leaves[2:])),
                                         save=True)
    if cell == "lstm":
        c_last = saved[:, -1, 4 * hidden:]
        auto = torch.autograd.grad([y, y[:, -1], c_last], leaves, [dy, dh_last, dc_last])
        dpre, dh0, dc0 = dh_chain_lstm_plain(dy, dh_last, dc_last, saved.detach(), c0, w)
        closed = (dpre, dh0, dc0, *recurrence_weight_grads(dpre, h0, y.detach()))
    else:
        auto = torch.autograd.grad([y, y[:, -1]], leaves, [dy, dh_last])
        dxp, dhp, dh0 = dh_chain_gru_plain(dy, dh_last, y.detach(), h0, saved.detach(), w)
        _, _, n_r = dhp.chunk(3, dim=-1)
        r, _, _, _ = saved.detach().chunk(4, dim=-1)
        np.testing.assert_allclose(n_r.numpy(), (dxp.chunk(3, dim=-1)[2] * r).numpy(), atol=0, rtol=0)
        closed = (dxp, dh0, *recurrence_weight_grads(dhp, h0, y.detach()))
    for i, (c, a) in enumerate(zip(closed, auto)):
        np.testing.assert_allclose(c.numpy(), a.numpy(), atol=ATOL, rtol=0, err_msg=f"gradient {i}")


@pytest.mark.parametrize("cell", CELLS)
def test_one_step_at_a_time_equals_the_sequence(cell):
    """S one-step calls (the serving path: the inference op, the one-step
    launch on the card) carrying the carry give the whole sequence's y and
    final carry."""
    params, x, carry, _, _ = _inputs(cell, seed=3)
    rnn = _port_rnn(params, cell, True)
    with torch.no_grad():
        want_y, want_carry = rnn(_t(x), _to_port(carry))
        c, ys = _to_port(carry), []
        for t in range(S):
            y, c = rnn(_t(x[:, t:t + 1]), c)
            ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), want_y.numpy(), atol=ATOL, rtol=0)
    for g, w in zip(_leaves(c), _leaves(want_carry)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cell", CELLS)
def test_functions_take_the_op_without_a_gradient(cell):
    """Without a gradient ``rnn_gru`` / ``rnn_lstm`` are the inference op
    (no saved gates, no autograd node); with one, the Function, whose
    outputs are the op's."""
    rng = np.random.default_rng(4)
    g = GATES[cell]
    xp, h0, c0 = _t(rng.normal(size=(B, S, g * H))), _t(rng.normal(size=(B, H))), _t(rng.normal(size=(B, H)))
    w, b = _t(rng.normal(size=(g * H, H)) / 4), _t(rng.normal(size=g * H))
    fn = rnn_lstm if cell == "lstm" else rnn_gru
    states = (h0, c0) if cell == "lstm" else (h0,)
    plain = fn(xp, *states, w, b)
    assert all(o.grad_fn is None for o in plain)
    wl = w.clone().requires_grad_()
    through = fn(xp, *states, wl, b)
    assert type(through[0].grad_fn).__name__.startswith("_Gru" if cell == "gru" else "_Lstm")
    for p, q in zip(plain, through):
        assert torch.equal(p, q.detach())


# ---------------------------------------------------------------------------
# the C entry points and the launch plan
# ---------------------------------------------------------------------------

def test_gated_entry_points_and_geometry_match_the_cuda_source():
    """csrc/rnn_gates.cu's constants are the plan's, and each entry point
    takes its pointers, the three sizes and the plan's six fields."""
    src = (kernels.CSRC_DIR / "rnn_gates.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kFwdCols"), const("kCols"), const("kRows"), const("kSkew"), const("kAlign"), const("kBwdChunk"),
            const("kBwdStages"), const("kStepRows")) == (
        recurrence.GATED_COLS["forward"], recurrence.GATED_COLS["backward"], recurrence.GATED_ROWS,
        recurrence.GATED_SKEW, recurrence.GATED_ALIGN, recurrence.GATED_BWD_CHUNK, recurrence.GATED_BWD_STAGES,
        recurrence.GATED_STEP_ROWS)
    assert "static constexpr int kFwdChunk = kLstm ? 64 : 128;" in src
    assert recurrence.GATED_FWD_CHUNK == {"gru": 128, "lstm": 64}
    assert const("kStepThreads") // 32 == recurrence.GATED_STEP_COLS
    assert const("kMaxCluster") == max(max(sizes) for sizes in recurrence.GATED_CLUSTERS.values())
    assert "static constexpr int kFwdStages = kLstm ? 3 : 2;" in src
    assert recurrence.GATED_FWD_STAGES == {"gru": 2, "lstm": 3}
    pointers = {"hulc_rnn_gru_fwd": 7, "hulc_rnn_gru_bwd": 10, "hulc_rnn_lstm_fwd": 9, "hulc_rnn_lstm_bwd": 10}
    for symbol, n in pointers.items():
        assert kernels._SIGNATURES[symbol] == (*(kernels._P,) * n, *(kernels._I32,) * 9), symbol
    assert {k.symbol for k in (kernels.RNN_GRU_FWD, kernels.RNN_GRU_BWD, kernels.RNN_LSTM_FWD,
                               kernels.RNN_LSTM_BWD)} == set(pointers)
    assert set(pointers) <= {k.symbol for k in kernels.ALL_KERNELS}
    assert re.search(r'extern "C" int hulc_rnn_gated_check\((\s*int \w+,?){13}\)', src)
    assert len(dataclasses.fields(recurrence.GatedPlan)) == 6
    # the reduce slices, whole quads of columns (ops.recurrence.gated_reduce_columns)
    assert "g.q0 = g.rank * (cols / 4) / g.cluster;" in src
    assert "g.nq = (g.rank + 1) * (cols / 4) / g.cluster - g.q0;" in src


@pytest.mark.parametrize("cell", CELLS)
def test_gated_plan_at_h2048_and_at_a_small_h(cell):
    """At the train step's (64, 32, 2048): the forward on 64 clusters of 2
    blocks, 32 columns a cluster, on 128 of the H100's 132 SMs, k-slices of
    1024 (of H); the dh chain on 29 clusters of 4, 72 columns a cluster, on
    116 SMs, k-slices of 512 G (of G H); shared memory within the H100's
    opt-in; the one-step launch at 1 and 8 serving lanes only when nothing
    is saved; a sequence launch at 9 lanes; at H = 37 clusters of 1 (one
    forward chunk of 64 or 128 k holds H)."""
    g = GATES[cell]
    for backward in (False, True):
        plan = gated_plan(cell, 2048, 64, 32, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS, backward,
                          saves=not backward)
        cluster, cols, blocks = (4, 72, 116) if backward else (2, 32, 128)
        assert (plan.launch, plan.cluster, plan.cols) == ("sequence", cluster, cols)
        assert plan.k_slice == (512 * g if backward else 1024)
        assert plan.blocks(2048) == blocks <= H100_SMS and plan.stages == (3 if cell == "lstm" and not backward else 2)
        assert plan.smem_bytes == gated_smem_bytes(cell, backward) <= H100_SMEM_OPTIN
        assert plan.c_args() == (0, cluster, plan.k_slice, cols, plan.stages, plan.smem_bytes)
    stages, stride = {"gru": (2, 132), "lstm": (3, 68)}[cell]
    assert gated_smem_bytes(cell, False) == 4 * (stages * (64 + 32 * g) * stride + 64 * (32 * g + 4)) + 128
    assert gated_smem_bytes(cell, True) == 4 * (2 * (64 + 72) * 132 + 64 * 76) + 128
    for lanes in (1, 8):
        step = gated_plan(cell, 2048, lanes, 1, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS)
        assert step.launch == "step" and step.c_args() == (1, 1, 2048, 8, 0, 0) and step.blocks(2048) == 256
        assert gated_plan(cell, 2048, lanes, 1, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS,
                          saves=True).launch == "sequence"
    assert gated_plan(cell, 2048, 9, 1, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS).launch == "sequence"
    small = gated_plan(cell, 37, 3, 5, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS)
    assert (small.cluster, small.k_slice, small.blocks(37)) == (1, recurrence.GATED_FWD_CHUNK[cell], 2)
    with pytest.raises(ValueError, match="too large"):
        gated_plan(cell, 2048, 64, 32, H100_SMS, 48 * 1024, H100_CLUSTERS)
    with pytest.raises(ValueError, match="positive"):
        gated_plan(cell, 0, 64, 32, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS)


def _covered_once(ranges, n) -> bool:
    """Whether the half-open ranges, cut at n, cover [0, n) each index once."""
    hits = np.zeros(n, int)
    for lo, hi in ranges:
        hits[max(lo, 0):min(hi, n)] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("batch,seq", [(1, 1), (8, 1), (64, 1), (96, 3), (64, 32)])
@pytest.mark.parametrize("hidden", [37, 64, 2048])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "dh_chain"])
@pytest.mark.parametrize("cell", CELLS)
def test_gated_plan_reduces_every_column_once_and_fits(cell, backward, hidden, batch, seq):
    """Every hidden column, with all its G gates, is reduced by exactly one
    block, and every k (of H forward, of G H in the dh chain) is in exactly
    one block's slice of each cluster; the shared memory fits the H100's
    opt-in and the clusters fit at once. A training forward saves (a
    sequence launch); an inference forward of one step at 8 rows or fewer
    takes the one-step GEMV, each hidden column a warp of one block."""
    g = GATES[cell]
    for saves in ((False,) if backward else (False, True)):
        plan = gated_plan(cell, hidden, batch, seq, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS, backward, saves)
        assert len(plan.c_args()) == 6
        if plan.launch == "step":
            assert not backward and not saves and seq == 1 and batch <= recurrence.GATED_STEP_ROWS
            assert (plan.cluster, plan.k_slice, plan.cols, plan.stages, plan.smem_bytes) == (1, hidden, 8, 0, 0)
            blocks = plan.blocks(hidden)
            assert _covered_once([(b * plan.cols, (b + 1) * plan.cols) for b in range(blocks)], hidden)
            continue
        assert plan.launch == "sequence" and plan.cols == recurrence.GATED_COLS["backward" if backward else "forward"]
        n, cols, ks = plan.cluster, plan.cols, plan.k_slice
        k_total = g * hidden if backward else hidden
        clusters = -(-hidden // cols)
        chunk = recurrence.GATED_BWD_CHUNK if backward else recurrence.GATED_FWD_CHUNK[cell]
        assert ks % chunk == 0
        # the reduce slices: block (c, r) whole quads of its cluster's columns
        slices = [recurrence.gated_reduce_columns(cols, n, r) for r in range(n)]
        assert all(lo % 4 == 0 and hi % 4 == 0 and hi > lo for lo, hi in slices)
        assert _covered_once([(c * cols + lo, c * cols + hi) for c in range(clusters) for lo, hi in slices], hidden)
        # each block's k-slice holds some k, the cluster's slices all of it once
        assert all(r * ks < k_total for r in range(n))
        assert _covered_once([(r * ks, (r + 1) * ks) for r in range(n)], k_total)
        assert plan.smem_bytes == gated_smem_bytes(cell, backward) <= H100_SMEM_OPTIN
        assert plan.stages == (recurrence.GATED_BWD_STAGES if backward else recurrence.GATED_FWD_STAGES[cell])
        assert plan.blocks(hidden) == clusters * n <= H100_SMS and clusters <= H100_CLUSTERS[n]
    with pytest.raises(ValueError, match="too large"):
        gated_plan(cell, 20_000, batch, max(seq, 2), H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS, backward, True)


def test_profiles_count_the_gated_kernels_as_hand_kernels():
    """Each ``__global__`` kernel of csrc/rnn_gates.cu is a hand kernel to
    the profilers' split by kind (``profile_policy.kind_of``)."""
    from hulc_tpu_torch.evaluation.profile_policy import kind_of

    src = (kernels.CSRC_DIR / "rnn_gates.cu").read_text()
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\) (\w+)\(", src)
    assert sorted(names) == ["gated_bwd_kernel", "gated_fwd_kernel", "gated_step_kernel", "gated_transpose_kernel"]
    for name in names:
        assert kind_of(f"void (anonymous namespace)::{name}<true>((anonymous namespace)::FwdArgs)") == "hand kernels"


# ---------------------------------------------------------------------------
# the cells still to port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module,cell", [(ScanRNN, "mlp"), (ScanBiRNN, "mlp"), (ScanBiRNN, "lstm")])
def test_cells_still_to_port_are_refused(module, cell):
    """ScanRNN refuses the decoder's mlp cell with JAX's message (the
    decoder builds an MLP for it); ScanBiRNN's lstm and mlp cells are not
    ported."""
    match = "use MLP module for the mlp decoder variant" if module is ScanRNN else "not ported yet"
    with pytest.raises(ValueError, match=match):
        module(F_IN, 8, 1, cell)


# ---------------------------------------------------------------------------
# apply_overrides
# ---------------------------------------------------------------------------

# tests/test_config_overrides.py's assignments, each list applied in turn,
# on the preset that test applies them to (OVERRIDE_BASE; hulc_debug else)
OVERRIDES = {
    "leaf_int": [["action_decoder.hidden_size=96"]],
    "distribution": [["distribution.category_size=8", "distribution.class_size=8"]],
    "literals": [["use_clip_auxiliary_loss=false", "loss.kl_beta=0.1", "action_decoder.rnn_cell=gru",
                  "loss.clip_auxiliary_loss_beta=1"]],
    "camera_field": [["perceptual_encoder.rgb_static.input_size=32"]],
    "none_then_default": [["perceptual_encoder.rgb_gripper=none"], ["perceptual_encoder.rgb_gripper=default"]],
    "into_none_optional": [["perceptual_encoder.proprio.n_state_obs=5"]],
    "tuples": [["action_decoder.perceptual_emb_slice=(0, 16)", "action_decoder.act_max_bound=[1, 1, 1, 1, 1, 1, 1]"]],
    "tuple_of_tuples": [["perceptual_encoder.proprio.keep_indices=((0, 3), (6, 7))",
                         "perceptual_encoder.proprio.n_state_obs=4"]],
    "gru_decoder": [["action_decoder.hidden_size=48", "action_decoder.rnn_cell=gru"]],
    "lstm_decoder": [["action_decoder.rnn_cell=lstm"]],
    "train_cli": [["action_decoder.hidden_size=48", "loss.kl_beta=0.1"]],
    "kl_beta": [["loss.kl_beta=0.5"]],
}
OVERRIDE_BASE = {"none_then_default": "gcbc_debug", "into_none_optional": "gcbc_debug",
                 "tuple_of_tuples": "fetch_state_debug", "gru_decoder": "gcbc_debug"}
OVERRIDE_ERRORS = {
    "unknown_field": "action_decoder.hiden_size=96",
    "not_an_int": "action_decoder.hidden_size=big",
    "not_optional": "loss.kl_beta=none",
    "config_node": "action_decoder=7",
    "no_value": "action_decoder.hidden_size",
    "leaf_field": "loss.kl_beta.x=1",
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_apply_overrides_gives_jax_fields(case):
    base = OVERRIDE_BASE.get(case, "hulc_debug")
    want, got = jax_config.get_config(base), port_config.get_config(base)
    for assignments in OVERRIDES[case]:
        want = jax_config.apply_overrides(want, assignments)
        got = port_config.apply_overrides(got, assignments)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.action_decoder.perceptual_features == got.perceptual_encoder.latent_size  # resolve() ran


@pytest.mark.parametrize("case", sorted(OVERRIDE_ERRORS))
def test_apply_overrides_errors_match_jax(case):
    assignment = OVERRIDE_ERRORS[case]
    with pytest.raises(Exception) as want:
        jax_config.apply_overrides(jax_config.get_config("hulc_debug"), [assignment])
    with pytest.raises(want.type) as got:
        port_config.apply_overrides(port_config.get_config("hulc_debug"), [assignment])
    assert str(got.value) == str(want.value)


def test_presets_are_left_as_they_were():
    before = port_config.get_config("hulc_debug")
    port_config.apply_overrides(before, ["action_decoder.rnn_cell=lstm"])
    assert dataclasses.asdict(port_config.get_config("hulc_debug")) == dataclasses.asdict(before)


# ---------------------------------------------------------------------------
# hulc_debug with the cell: the weights and the train step
# ---------------------------------------------------------------------------

KL_BETA = 0.01
LOSS_RTOL = 1e-5  # fp32 sums in another order
GRAD_RTOL = 1e-4  # per leaf, relative L2
ZERO_GRAD = 1e-7  # share of the whole gradient's norm below which a leaf's is rounding noise
CLIP_HEAD = ("['proj_vis_lang']", "['logit_scale']")  # leaves only the CLIP loss reaches
MAE_ATOL = 1e-4  # val MAEs of sampled actions: the x100 of the TCP-frame rotation


@pytest.fixture(scope="module", params=CELLS)
def model_setup(request):
    return gated_setup(request.param, jax_config, port_config)


def test_params_from_jax_round_trip(model_setup):
    """JAX's tree -> the port's state_dict -> JAX's tree, bit for bit, with
    the decoder's gate-wide W_hh as nn.GRU's / nn.LSTM's (G H, H)."""
    cfg, params = model_setup["cfg"], model_setup["params"]
    state = {k: v.numpy() for k, v in model_setup["model"].state_dict().items()}
    g, h = GATES[model_setup["cell"]], cfg.action_decoder.hidden_size
    assert state["action_decoder.rnn.weight_hh_l1"].shape == (g * h, h)
    assert state["action_decoder.rnn.weight_ih_l0"].shape[0] == state["action_decoder.rnn.bias_hh_l0"].shape[0] == g * h
    back, unused = convert_state_dict(state, model_setup["jax_cfg"])
    assert unused == []
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(params)]
    for (path, a), (_, b) in zip(flat(back), flat(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path))


def test_train_losses_and_grads_match_jax(model_setup):
    """``train_losses`` on the loader-fused batch (eval preprocessing), on
    JAX's Gumbel noise: every loss key within rtol 1e-5, and the gradient of
    every parameter the decoder's backward reaches within 1e-4 relative L2
    (the decoder's own through the Function's closed-form backward). The
    CLIP head's (``proj_vis_lang``, ``logit_scale``) gets no gradient from
    the decoder and is the same code for every cell;
    tests/test_torch_train_step.py holds it. Here its last bias's gradient
    is a sum over six windows that cancels to about 1e-3 of its terms, so
    it measures the summation order (1e-5 to 1.3e-4 relative L2 for this
    batch, by the thread count)."""
    jax_cfg, cfg, jax_model, params = (model_setup[k] for k in ("jax_cfg", "cfg", "jax_model", "params"))
    fused = CombinedLoader.fuse_batch(model_setup["raw"])
    key = jax.random.key(73)
    prep = jax_preprocess_batch(jax_cfg, fused, rng=None, train=False)

    def loss_fn(p):
        out = jax_model.apply({"params": p}, key, prep, KL_BETA, method=jax_model.train_losses)
        return out["total_loss"], out

    grads, want = jax_call(jax.grad(loss_fn, has_aux=True), params)
    model, _ = port_model_from_jax(params, cfg)
    batch = preprocess_batch(cfg, batch_to_device({k: ModalityBatch(*m) for k, m in fused.items()}, "cpu"),
                             train=False)
    gumbel = jax_gumbel(jax.random.split(key)[1], 2 * GATED_B, jax_cfg)
    got = model.train().train_losses(batch, KL_BETA, gumbel=gumbel)
    got["total_loss"].backward()
    keys = set(LOSS_KEYS) | {f"{k}_{s}" for k in ("action_loss", "kl_loss_scaled", "total_loss") for s in ("vis", "lang")}
    assert keys <= set(got) and keys <= set(want)
    for k in sorted(keys):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    port_grads, unused = convert_state_dict({k: p.grad.numpy() for k, p in model.named_parameters()}, jax_cfg)
    assert unused == []
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    want_leaves = flat(grads)
    assert [p for p, _ in flat(port_grads)] == [p for p, _ in want_leaves]
    total = np.sqrt(sum(np.sum(np.square(np.asarray(w))) for _, w in want_leaves))
    decoder = 0
    for (path, g), (_, w) in zip(flat(port_grads), want_leaves):
        g, w, name = np.asarray(g), np.asarray(w), jax.tree_util.keystr(path)
        if np.linalg.norm(w) <= ZERO_GRAD * total:
            assert np.linalg.norm(g) <= ZERO_GRAD * total, name  # zero in exact arithmetic
            continue
        decoder += "['rnn']" in name
        if name.startswith(CLIP_HEAD):
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, f"{name}: relative L2 error {err}"
    assert decoder == 8  # 2 layers x (W_ih, b_ih, W_hh, b_hh)


def _window_uniforms(key, b, s, cfg):
    u_mix, u_inv = jax_mixture_uniforms(key, b * s, cfg)
    return u_mix.reshape(b, s, *u_mix.shape[2:]), u_inv.reshape(b, s, *u_inv.shape[2:])


def _val_noise(key, scopes, b, s, cfg):
    """The noise JAX's val_metrics draws, by scope (a key split per scope in
    key order, then lmp_val's four-way split)."""
    out = {}
    for scope in sorted(scopes):
        key, k = jax.random.split(key)
        k_pp, k_pr, k_act_pp, k_act_pr = jax.random.split(k, 4)
        noise = {}
        for tag, k_plan, k_act in (("pp", k_pp, k_act_pp), ("pr", k_pr, k_act_pr)):
            noise[f"gumbel_{tag}"] = jax_gumbel(k_plan, b, cfg)
            noise[f"u_mix_{tag}"], noise[f"u_inv_{tag}"] = _window_uniforms(k_act, b, s, cfg)
        out[scope] = noise
    return out


def test_val_metrics_match_jax(model_setup):
    """``val_metrics`` on the language scope (both plans decoded, through
    the cell's inference op) on JAX's noise: losses rtol 1e-5, MAEs 1e-4,
    plans exact, the gripper's successes counted alike."""
    jax_cfg, cfg, jax_model, params = (model_setup[k] for k in ("jax_cfg", "cfg", "jax_model", "params"))
    raw = {"lang": model_setup["raw"]["lang"]}
    prep = jax_preprocess_batch(jax_cfg, raw, rng=None, train=False)
    key = jax.random.key(74)
    want = jax_call(lambda p, k, b: jax_model.apply({"params": p}, k, b, KL_BETA, method=jax_model.val_metrics),
                    params, key, prep)
    batch = preprocess_batch(cfg, batch_to_device({k: ModalityBatch(*m) for k, m in raw.items()}, "cpu"), train=False)
    with torch.no_grad():
        noise = _val_noise(key, raw, GATED_B, GATED_S, jax_cfg)
        got = model_setup["model"].eval().val_metrics(batch, KL_BETA, noise=noise)
    assert set(got) == set(want) and "lang_mae_pp" in want
    for k in sorted(want):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if "sampled_plan" in k:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif "gripper_sr" in k:
            # the same gripper picks: equal counts of the frames (XLA takes the
            # mean as the sum times 1 / n, torch divides: 7 / 15 one ulp apart)
            n = GATED_B * GATED_S
            np.testing.assert_array_equal(np.round(g * n), np.round(w * n), err_msg=k)
            np.testing.assert_allclose(g, w, rtol=2.0**-23, atol=0, err_msg=k)
        elif "mae" in k:
            np.testing.assert_allclose(g, w, atol=MAE_ATOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
