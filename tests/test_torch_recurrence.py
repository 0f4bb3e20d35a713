"""The decoder RNN's recurrence (hulc_tpu_torch.ops.recurrence, B.6) and
``ScanRNN`` against the JAX package's ``ScanRNN`` on the CPU, at
``hulc_debug``'s width (H = 64) and an odd one (H = 37), with a nonzero
carry. Weights are made with numpy in the JAX layout and carried into the
port as ``hulc_tpu_torch.convert`` does (kernels transposed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulc_tpu.models.layers import ScanRNN as JaxScanRNN

from hulc_tpu_torch import kernels
from hulc_tpu_torch.models.layers import ScanRNN
from hulc_tpu_torch.models.vision import _aligned
from hulc_tpu_torch.ops import recurrence
from hulc_tpu_torch.ops.recurrence import rnn_relu, rnn_relu_bwd_plain, rnn_relu_fwd_plain, recurrence_plan

torch.set_num_threads(1)

B, S, F_IN = 3, 7, 10
FWD_ATOL = 1e-5  # fp32 sums in another order through S relu steps
GRAD_REL = 1e-5  # per gradient tensor, relative L2


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_params(rng, in_features, hidden, layers):
    """The JAX ScanRNN tree, torch's U(-1/sqrt(H), 1/sqrt(H)) drawn by numpy."""
    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32) / np.sqrt(hidden)

    params = {}
    for k in range(layers):
        fan_in = in_features if k == 0 else hidden
        params[f"ih_{k}"] = {"kernel": u(fan_in, hidden), "bias": u(hidden)}
        params[f"hh_{k}"] = u(hidden, hidden)
        params[f"bhh_{k}"] = u(hidden)
    return params


def _port_rnn(params, in_features, hidden, layers) -> ScanRNN:
    """ScanRNN holding ``params``, laid out as ``convert.params_from_jax``
    lays out ``action_decoder/rnn``."""
    rnn = ScanRNN(in_features, hidden, layers)
    state = {}
    for k in range(layers):
        state[f"weight_ih_l{k}"] = _t(params[f"ih_{k}"]["kernel"].T)
        state[f"bias_ih_l{k}"] = _t(params[f"ih_{k}"]["bias"])
        state[f"weight_hh_l{k}"] = _t(params[f"hh_{k}"].T)
        state[f"bias_hh_l{k}"] = _t(params[f"bhh_{k}"])
    rnn.load_state_dict(state, strict=True)
    return rnn


def _carry(rng, layers, hidden):
    return np.maximum(rng.normal(size=(layers, B, hidden)), 0.0).astype(np.float32)


@pytest.mark.parametrize("hidden", [64, 37])
@pytest.mark.parametrize("layers", [1, 2])
def test_scan_rnn_matches_jax_with_carry(layers, hidden):
    rng = np.random.default_rng(layers * 100 + hidden)
    params = _jax_params(rng, F_IN, hidden, layers)
    x = rng.normal(size=(B, S, F_IN)).astype(np.float32)
    carry = _carry(rng, layers, hidden)
    want_y, want_carry = JaxScanRNN(hidden_size=hidden, num_layers=layers, cell="rnn").apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(carry)
    )
    with torch.no_grad():
        got_y, got_carry = _port_rnn(params, F_IN, hidden, layers)(_t(x), _t(carry))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(got_carry.numpy(), np.asarray(want_carry), atol=FWD_ATOL, rtol=0)
    assert (np.asarray(want_y) > 0).mean() > 0.2  # relu units on both sides of the edge


def _one_layer(hidden, seed):
    """A one-layer JAX ScanRNN whose input projection is the identity
    (ih kernel I, bias 0), so its input IS xp and jax.grad's gradient for it
    is dxp; and the inputs, carry and cotangents, from numpy."""
    rng = np.random.default_rng(seed)
    params = _jax_params(rng, hidden, hidden, 1)
    params["ih_0"] = {"kernel": np.eye(hidden, dtype=np.float32), "bias": np.zeros(hidden, np.float32)}
    xp = rng.normal(size=(B, S, hidden)).astype(np.float32)
    h0 = _carry(rng, 1, hidden)[0]
    dy = rng.normal(size=(B, S, hidden)).astype(np.float32)
    dcarry = rng.normal(size=(B, hidden)).astype(np.float32)
    return params, xp, h0, dy, dcarry


@pytest.mark.parametrize("hidden,batch,seq", [
    pytest.param(64, B, S, id="64"),
    pytest.param(37, B, S, id="37"),
    # the serving shapes: one time step, one lane or a few (the one-step launch)
    pytest.param(64, 1, 1, id="64-one-step-1-lane"),
    pytest.param(64, 3, 1, id="64-one-step-3-lanes"),
    pytest.param(37, 1, 1, id="37-one-step-1-lane"),
    pytest.param(37, 3, 1, id="37-one-step-3-lanes"),
])
def test_rnn_relu_fwd_plain_matches_jax(hidden, batch, seq):
    params, xp, h0, _, _ = _one_layer(hidden, seed=hidden)
    xp, h0 = xp[:batch, :seq], h0[:batch]
    want, _ = JaxScanRNN(hidden_size=hidden, num_layers=1, cell="rnn").apply(
        {"params": params}, jnp.asarray(xp), jnp.asarray(h0[None])
    )
    got = rnn_relu_fwd_plain(_t(xp), _t(h0), _t(params["hh_0"].T), _t(params["bhh_0"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)


def _jax_grads(params, xp, h0, dy, dcarry):
    """jax.grad of <y, dy> + <final carry, dcarry>: (dxp, dh0, dW_hh in
    torch layout, db_hh)."""
    hidden = xp.shape[-1]
    module = JaxScanRNN(hidden_size=hidden, num_layers=1, cell="rnn")

    def loss(x, carry, hh, bhh):
        p = dict(params, hh_0=hh, bhh_0=bhh)
        y, final = module.apply({"params": p}, x, carry)
        return jnp.sum(y * dy) + jnp.sum(final[0] * dcarry)

    dx, dcarry0, dhh, dbhh = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(xp), jnp.asarray(h0[None]), jnp.asarray(params["hh_0"]), jnp.asarray(params["bhh_0"])
    )
    return np.asarray(dx), np.asarray(dcarry0)[0], np.asarray(dhh).T, np.asarray(dbhh)


@pytest.mark.parametrize("hidden", [64, 37])
def test_rnn_relu_bwd_plain_matches_jax_grad_and_autograd(hidden):
    """The closed form (the dh chain, then one dW product and the bias sum)
    against jax.grad of the JAX module and autograd through the loop, with
    cotangents on y and on the final carry; the autograd Function the CUDA
    path runs (here on its plain versions) gives the same."""
    params, xp, h0, dy, dcarry = _one_layer(hidden, seed=hidden + 1)
    w, b = params["hh_0"].T, params["bhh_0"]
    want = _jax_grads(params, xp, h0, dy, dcarry)

    y = rnn_relu_fwd_plain(_t(xp), _t(h0), _t(w), _t(b))
    closed = rnn_relu_bwd_plain(_t(dy), y, _t(dcarry), _t(h0), _t(w))

    leaves = [_t(v).requires_grad_() for v in (xp, h0, w, b)]
    y_loop = rnn_relu_fwd_plain(*leaves)
    auto = torch.autograd.grad([y_loop, y_loop[:, -1]], leaves, [_t(dy), _t(dcarry)])

    leaves = [_t(v).requires_grad_() for v in (xp, h0, w, b)]
    function = torch.autograd.grad(rnn_relu(*leaves), leaves, [_t(dy), _t(dcarry)])

    for name, c, a, f, j in zip(("dxp", "dh0", "dW_hh", "db_hh"), closed, auto, function, want):
        assert c.shape == a.shape == f.shape == j.shape, name
        assert _rel_l2(c, j) <= GRAD_REL, (name, "closed form vs jax.grad", _rel_l2(c, j))
        assert _rel_l2(c, a) <= GRAD_REL, (name, "closed form vs autograd", _rel_l2(c, a))
        assert _rel_l2(f, a) <= GRAD_REL, (name, "Function vs autograd", _rel_l2(f, a))


def test_relu_mask_at_exactly_zero_passes_no_gradient():
    """Pre-activations exactly 0 (W = 0, b = 0, xp with zeros): y = 0 there,
    and the gradient through it is 0, as the JAX custom VJP g * (y > 0)
    gives, in the closed form, through autograd and in jax.grad."""
    hidden = 8
    rng = np.random.default_rng(3)
    params = {"ih_0": {"kernel": np.eye(hidden, dtype=np.float32), "bias": np.zeros(hidden, np.float32)},
              "hh_0": np.zeros((hidden, hidden), np.float32), "bhh_0": np.zeros(hidden, np.float32)}
    xp = rng.normal(size=(B, S, hidden)).astype(np.float32)
    zero = rng.random(xp.shape) < 0.3
    xp[zero] = 0.0
    h0 = np.zeros((B, hidden), np.float32)
    dy = rng.normal(size=xp.shape).astype(np.float32)
    dcarry = rng.normal(size=(B, hidden)).astype(np.float32)

    y = rnn_relu_fwd_plain(_t(xp), _t(h0), _t(params["hh_0"]), _t(params["bhh_0"]))
    assert np.all(y.numpy()[zero] == 0.0)
    dxp, *_ = rnn_relu_bwd_plain(_t(dy), y, _t(dcarry), _t(h0), _t(params["hh_0"]))
    leaves = [_t(v).requires_grad_() for v in (xp, h0, params["hh_0"], params["bhh_0"])]
    y_loop = rnn_relu_fwd_plain(*leaves)
    (auto,) = torch.autograd.grad([y_loop, y_loop[:, -1]], leaves[:1], [_t(dy), _t(dcarry)])
    jax_dxp = _jax_grads(params, xp, h0, dy, dcarry)[0]
    for got in (dxp.numpy(), auto.numpy(), jax_dxp):
        assert np.all(got[zero] == 0.0)
        assert np.all(got[xp > 0] != 0.0)


def test_aligned_copies_a_misaligned_view():
    """The SpatialSoftmax wrappers' ``_aligned``: a view that starts 588
    bytes in (12 mod 16) comes back as an aligned copy with equal values;
    an aligned tensor comes back as itself."""
    x = torch.randn(5, 3, 7, 7, generator=torch.Generator().manual_seed(0))
    view = x[1:]
    assert view.data_ptr() % 16 == 12
    got = _aligned(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, view)
    assert _aligned(x) is x


# what this H100 (NVIDIA H100 80GB HBM3) reports: SMs, shared memory a block
# may opt in to, and clusters it holds at once at one block per SM, by size
H100_SMS, H100_SMEM_OPTIN = 132, 232_448
H100_CLUSTERS = {8: 15, 4: 30, 1: 132}


def _covered_once(ranges, n):
    counts = np.zeros(n, int)
    for lo, hi in ranges:
        counts[lo:min(hi, n)] += 1
    return bool(np.all(counts == 1))


@pytest.mark.parametrize("seq", [1, 32])
@pytest.mark.parametrize("batch", [1, 64, 96])
@pytest.mark.parametrize("hidden", [37, 64, 2048, 5])
def test_recurrence_plan_covers_every_column_and_k_once_and_fits(hidden, batch, seq):
    """The launch plan of the forward and the backward (at the widths the
    issue names, and a tiny H = 5 that only one block a cluster can split):
    every output column and every k of W covered exactly once (columns by clusters and, within a
    cluster, by reduce slices; k by the blocks of a cluster, none empty),
    shared memory within the card's, every cluster resident at once, the
    one-step GEMV only for a forward of one step at a few lanes."""
    for backward in (False, True):
        plan = recurrence_plan(hidden, batch, seq, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS, backward)
        assert len(plan.c_args()) == 5
        if plan.launch == "step":
            assert not backward and seq == 1 and batch <= recurrence.STEP_ROWS
            assert plan.k_slice == hidden and plan.smem_bytes == 0 and plan.cluster == 1
            assert plan.cols == recurrence.STEP_COLS
            blocks = -(-hidden // plan.cols)
            assert _covered_once([(b * plan.cols, (b + 1) * plan.cols) for b in range(blocks)], hidden)
            continue
        assert plan.launch == "sequence"
        assert (backward or seq > 1 or batch > recurrence.STEP_ROWS)
        cl, cols, ks = plan.cluster, plan.cols, plan.k_slice
        clusters = -(-hidden // cols)
        assert cols == recurrence.COLS and cols % cl == 0 and ks % 4 == 0
        assert _covered_once([(c * cols, (c + 1) * cols) for c in range(clusters)], hidden)
        nred = cols // cl
        assert _covered_once([(c * cols + j * nred, c * cols + (j + 1) * nred)
                              for c in range(clusters) for j in range(cl)], hidden)
        assert _covered_once([(j * ks, (j + 1) * ks) for j in range(cl)], hidden)
        assert all(j * ks < hidden for j in range(cl))  # no block without k
        assert 4 * cols * ks <= plan.smem_bytes <= H100_SMEM_OPTIN
        assert clusters * cl <= H100_SMS and clusters <= H100_CLUSTERS[cl]


def test_recurrence_plan_at_h2048_on_the_h100():
    """H = 2048 on this H100: 15 clusters of 8 (not the 16 of 128 columns
    it does not hold at once) of 144 columns, k-slice 256, on 120 SMs; the
    smaller widths the smoke holds take clusters of 8, 4 and 1; one serving
    lane takes the one-step launch."""
    for backward in (False, True):
        plan = recurrence_plan(2048, 64, 32, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS, backward)
        assert (plan.launch, plan.cluster, plan.cols, plan.k_slice) == ("sequence", 8, 144, 256)
    for hidden, cluster in ((64, 8), (37, 4), (5, 1)):
        assert recurrence_plan(hidden, 3, 5, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS).cluster == cluster
    assert recurrence_plan(2048, 1, 1, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS).launch == "step"


@pytest.mark.parametrize("hidden,batch,seq,backward", [
    (4096, 64, 32, False), (4096, 64, 32, True), (4096, 64, 1, False), (2048, 64, 32, True),
])
def test_recurrence_plan_raises_when_the_card_cannot_hold_it(hidden, batch, seq, backward):
    """An H too large for the card's shared memory and SMs raises; so does
    H = 2048 on a card that holds too few clusters of any size at once."""
    limits = H100_CLUSTERS if hidden != 2048 else {8: 8, 4: 16, 1: 64}
    with pytest.raises(ValueError, match="too large"):
        recurrence_plan(hidden, batch, seq, H100_SMS, H100_SMEM_OPTIN, limits, backward)


def test_recurrence_plan_matches_the_cuda_source():
    """The plan's geometry is csrc/rnn.cu's: its constants, and the
    entry points' argument counts in kernels.py (the sizes, then the plan's
    five fields)."""
    import re

    src = (kernels.CSRC_DIR / "rnn.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRows") == recurrence.ROWS and const("kChunk") == recurrence.CHUNK
    assert const("kSkew") == recurrence.SKEW and const("kStepRows") == recurrence.STEP_ROWS
    assert const("kStepThreads") // 32 == recurrence.STEP_COLS and const("kCols") == recurrence.COLS
    assert const("kMaxCluster") >= max(recurrence.CLUSTERS)
    for symbol in ("hulc_rnn_relu_fwd", "hulc_rnn_relu_bwd"):
        assert len(kernels._SIGNATURES[symbol]) == 6 + 3 + 5


def test_ptxas_report_names_each_entry_function():
    """The build log's report is keyed by each kernel's own name."""
    log = (
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119rnn_relu_fwd_kernelEPKfS1_S1_S1_PfS2_iiiiii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 254 registers, used 1 barriers\n"
    )
    assert kernels.ptxas_report(log) == {
        "rnn_relu_fwd_kernel": {"stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
                                "registers": 254, "static_smem_bytes": 0},
    }
