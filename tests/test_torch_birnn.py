"""The tanh recurrence (B.8) and the bidirectional layer (B.9) of
hulc_tpu_torch.ops.recurrence, ``ScanRNN(cell="rnn_tanh")`` and
``ScanBiRNN`` against the JAX package's ``ScanRNN`` / ``ScanBiRNN`` on the
CPU, the relu cell (B.6) beside the tanh one where a test holds both;
plus the C entry points' bindings and the launch plan at MCIL's width.
Weights are made with numpy in the JAX layout and carried into the port as
``hulc_tpu_torch.convert`` does (kernels transposed)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hulc_tpu.models.layers import ScanBiRNN as JaxScanBiRNN
from hulc_tpu.models.layers import ScanRNN as JaxScanRNN

from hulc_tpu_torch import kernels
from hulc_tpu_torch.models.layers import ScanBiRNN, ScanRNN
from hulc_tpu_torch.ops import recurrence
from hulc_tpu_torch.ops.recurrence import (
    birnn_layer,
    birnn_layer_bwd_plain,
    birnn_layer_plain,
    dh_chain_plain,
    dh_chain_tanh_plain,
    recurrence_plan,
    recurrence_weight_grads,
    rnn_relu,
    rnn_relu_fwd_plain,
    rnn_tanh,
    rnn_tanh_fwd_plain,
    sequence_smem_bytes,
    tanh_chain_bwd_plain,
    tanh_chain_fwd_plain,
)

torch.set_num_threads(1)

B, S, F_IN = 3, 7, 10
ATOL = 1e-5  # fp32 sums in another order through S steps
GRAD_REL = 1e-5  # per parameter gradient, relative L2
CELLS = {"rnn": (rnn_relu, rnn_relu_fwd_plain, dh_chain_plain),
         "rnn_tanh": (rnn_tanh, rnn_tanh_fwd_plain, dh_chain_tanh_plain)}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rnn_params(rng, in_features, hidden, layers):
    """A JAX ScanRNN tree, torch's U(-1/sqrt(H), 1/sqrt(H)) drawn by numpy."""
    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32) / np.sqrt(hidden)

    params = {}
    for k in range(layers):
        params[f"ih_{k}"] = {"kernel": u(in_features if k == 0 else hidden, hidden), "bias": u(hidden)}
        params[f"hh_{k}"] = u(hidden, hidden)
        params[f"bhh_{k}"] = u(hidden)
    return params


def _port_layer(params, k, suffix="", src_k=None):
    """ScanRNN layer ``src_k`` of a JAX tree as nn.RNN's layer k."""
    j = k if src_k is None else src_k
    return {f"weight_ih_l{k}{suffix}": _t(params[f"ih_{j}"]["kernel"].T),
            f"bias_ih_l{k}{suffix}": _t(params[f"ih_{j}"]["bias"]),
            f"weight_hh_l{k}{suffix}": _t(params[f"hh_{j}"].T), f"bias_hh_l{k}{suffix}": _t(params[f"bhh_{j}"])}


def _one_layer(hidden, seed, batch=B, seq=S):
    """A one-layer JAX ScanRNN whose input projection is the identity, so
    its input is xp and jax.grad's gradient for it is dxp; inputs, carry and
    cotangents from numpy (the carry in (-1, 1), a tanh state)."""
    rng = np.random.default_rng(seed)
    params = _rnn_params(rng, hidden, hidden, 1)
    params["ih_0"] = {"kernel": np.eye(hidden, dtype=np.float32), "bias": np.zeros(hidden, np.float32)}
    xp = rng.normal(size=(batch, seq, hidden)).astype(np.float32)
    h0 = np.tanh(rng.normal(size=(batch, hidden))).astype(np.float32)
    dy = rng.normal(size=(batch, seq, hidden)).astype(np.float32)
    dcarry = rng.normal(size=(batch, hidden)).astype(np.float32)
    return params, xp, h0, dy, dcarry


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("hidden,batch,seq", [(64, B, S), (37, B, S), (64, 1, 1), (37, 3, 1)])
def test_rnn_fwd_plain_matches_jax(cell, hidden, batch, seq):
    """The plain loop of either cell against JAX's ScanRNN forward, over a
    sequence and at one step (the serving shapes)."""
    params, xp, h0, _, _ = _one_layer(hidden, seed=hidden + seq)
    xp, h0 = xp[:batch, :seq], h0[:batch]
    want, _ = JaxScanRNN(hidden_size=hidden, num_layers=1, cell=cell).apply(
        {"params": params}, jnp.asarray(xp), jnp.asarray(h0[None]))
    got = CELLS[cell][1](_t(xp), _t(h0), _t(params["hh_0"].T), _t(params["bhh_0"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _jax_grads(cell, params, xp, h0, dy, dcarry):
    """jax.grad of <y, dy> + <final carry, dcarry>: (dxp, dh0, dW_hh in
    torch layout, db_hh)."""
    module = JaxScanRNN(hidden_size=xp.shape[-1], num_layers=1, cell=cell)

    def loss(x, carry, hh, bhh):
        y, final = module.apply({"params": dict(params, hh_0=hh, bhh_0=bhh)}, x, carry)
        return jnp.sum(y * dy) + jnp.sum(final[0] * dcarry)

    dx, dcarry0, dhh, dbhh = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(xp), jnp.asarray(h0[None]), jnp.asarray(params["hh_0"]), jnp.asarray(params["bhh_0"]))
    return np.asarray(dx), np.asarray(dcarry0)[0], np.asarray(dhh).T, np.asarray(dbhh)


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("hidden", [64, 37])
def test_dh_chain_and_function_match_jax_grad(cell, hidden):
    """The plain dh chain (the backward kernel's arithmetic) with one dW
    product and the bias sum, and the autograd Function the CUDA path runs
    (here on its plain versions), against jax.grad, with cotangents on y and
    on the final carry."""
    params, xp, h0, dy, dcarry = _one_layer(hidden, seed=hidden + 1)
    w, b = params["hh_0"].T, params["bhh_0"]
    function, fwd_plain, dh_chain = CELLS[cell]
    want = _jax_grads(cell, params, xp, h0, dy, dcarry)

    y = fwd_plain(_t(xp), _t(h0), _t(w), _t(b))
    dpre, dh0 = dh_chain(_t(dy), y, _t(dcarry), _t(w))
    closed = (dpre, dh0, *recurrence_weight_grads(dpre, _t(h0), y))
    leaves = [_t(v).requires_grad_() for v in (xp, h0, w, b)]
    through = torch.autograd.grad(function(*leaves), leaves, [_t(dy), _t(dcarry)])
    for name, c, f, j in zip(("dxp", "dh0", "dW_hh", "db_hh"), closed, through, want):
        np.testing.assert_allclose(c.numpy(), j, atol=ATOL, rtol=0, err_msg=f"{name} closed form vs jax.grad")
        np.testing.assert_allclose(f.numpy(), j, atol=ATOL, rtol=0, err_msg=f"{name} Function vs jax.grad")


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("use_kernels", [True, False])
def test_scan_rnn_matches_jax_with_carry(cell, use_kernels):
    """``ScanRNN`` of either cell, two layers, from a nonzero carry: outputs
    and final carry against JAX's."""
    rng = np.random.default_rng(7)
    hidden, layers = 37, 2
    params = _rnn_params(rng, F_IN, hidden, layers)
    x = rng.normal(size=(B, S, F_IN)).astype(np.float32)
    carry = np.tanh(rng.normal(size=(layers, B, hidden))).astype(np.float32)
    want_y, want_carry = JaxScanRNN(hidden_size=hidden, num_layers=layers, cell=cell).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(carry))
    rnn = ScanRNN(F_IN, hidden, layers, cell, use_kernels)
    rnn.load_state_dict({k: v for i in range(layers) for k, v in _port_layer(params, i).items()}, strict=True)
    with torch.no_grad():
        got_y, got_carry = rnn(_t(x), _t(carry))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_carry.numpy(), np.asarray(want_carry), atol=ATOL, rtol=0)


def test_scan_rnn_refuses_the_cells_still_to_port():
    """The decoder's mlp cell, which is no RNN (JAX's ScanRNN refuses it
    with this message; the decoder builds an MLP for it), and the
    bidirectional lstm and mlp cells (the relu and gru ones:
    tests/test_torch_birnn_cells.py)."""
    with pytest.raises(ValueError, match="use MLP module for the mlp decoder variant"):
        ScanRNN(F_IN, 8, 1, "mlp")
    for cell in ("lstm", "mlp"):
        with pytest.raises(ValueError, match="not ported yet"):
            ScanBiRNN(F_IN, 8, 1, cell)


def _birnn_params(rng, in_features, hidden, layers):
    """JAX ScanBiRNN's tree: fwd_k / bwd_k, each a one-layer ScanRNN."""
    return {f"{d}_{k}": _rnn_params(rng, in_features if k == 0 else 2 * hidden, hidden, 1)
            for k in range(layers) for d in ("fwd", "bwd")}


def _port_birnn(params, in_features, hidden, layers, use_kernels):
    net = ScanBiRNN(in_features, hidden, layers, "rnn_tanh", use_kernels)
    state = {}
    for k in range(layers):
        state.update(_port_layer(params[f"fwd_{k}"], k, "", 0))
        state.update(_port_layer(params[f"bwd_{k}"], k, "_reverse", 0))
    net.load_state_dict(state, strict=True)
    return net


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("hidden", [32, 37])
def test_scan_birnn_matches_jax_outputs_and_every_gradient(hidden, use_kernels):
    """Two bidirectional layers (layer 1 reads layer 0's 2H output):
    ``ScanBiRNN`` through ``birnn_layer`` (the autograd Function: on the CPU
    the kernels' index-by-index mirrors, forward and closed-form backward)
    and through JAX's flip-and-concatenate definition (``use_kernels=False``,
    autograd), against JAX's ScanBiRNN: the (B, S, 2H) output and the
    gradient of every parameter and of the input under a dense cotangent."""
    layers = 2
    rng = np.random.default_rng(hidden)
    params = _birnn_params(rng, F_IN, hidden, layers)
    x = rng.normal(size=(B, S, F_IN)).astype(np.float32)
    dy = rng.normal(size=(B, S, 2 * hidden)).astype(np.float32)
    module = JaxScanBiRNN(hidden_size=hidden, num_layers=layers, cell="rnn_tanh")

    def loss(p, xin):
        return jnp.sum(module.apply({"params": p}, xin) * dy)

    want_y = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    want_dp, want_dx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    net = _port_birnn(params, F_IN, hidden, layers, use_kernels)
    xt = _t(x).requires_grad_()
    y = net(xt)
    y.backward(_t(dy))
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=ATOL, rtol=0)
    assert _rel_l2(xt.grad.numpy(), np.asarray(want_dx)) <= GRAD_REL
    grads = dict(net.named_parameters())
    for k in range(layers):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            jp = want_dp[f"{d}_{k}"]
            pairs = {"weight_ih": np.asarray(jp["ih_0"]["kernel"]).T, "bias_ih": jp["ih_0"]["bias"],
                     "weight_hh": np.asarray(jp["hh_0"]).T, "bias_hh": jp["bhh_0"]}
            for name, want in pairs.items():
                got = grads[f"{name}_l{k}{suffix}"].grad.numpy()
                err = _rel_l2(got, want)
                assert err <= GRAD_REL, (f"{name}_l{k}{suffix}", err)


def test_birnn_last_step_features_and_their_gradients():
    """JAX's x[:, -1] (the plan recognition's seq_feat): the reverse half of
    the last row is the reverse chain's first step, a function of the last
    frame alone; the gradients of the layer's Function agree with autograd
    through JAX's definition under that sparse cotangent."""
    hidden = 16
    rng = np.random.default_rng(11)
    xp_f, xp_b = (_t(rng.normal(size=(B, S, hidden))) for _ in range(2))
    w_f, w_b = (_t(rng.uniform(-0.25, 0.25, (hidden, hidden))) for _ in range(2))
    b_f, b_b = (_t(rng.uniform(-0.25, 0.25, hidden)) for _ in range(2))
    h0s = torch.zeros(2, B, hidden)
    y = birnn_layer_plain(xp_f, xp_b, h0s, w_f, w_b, b_f, b_b)
    first_reverse_step = torch.tanh(xp_b[:, -1] + b_b)
    np.testing.assert_allclose(y[:, -1, hidden:].numpy(), first_reverse_step.numpy(), atol=1e-7, rtol=0)

    def grads(layer):
        leaves = [t.clone().requires_grad_() for t in (xp_f, xp_b, h0s, w_f, w_b, b_f, b_b)]
        out = layer(*leaves)[:, -1]
        return torch.autograd.grad(out.sum(), leaves)

    for name, got, want in zip(("xp_f", "xp_b", "h0s", "w_f", "w_b", "b_f", "b_b"),
                               grads(birnn_layer), grads(birnn_layer_plain)):
        assert _rel_l2(got, want) <= GRAD_REL, name
    assert float(grads(birnn_layer)[1][:, :-1].abs().max()) == 0.0  # xp_b reaches the output at t = S-1 only


def test_chain_layout_indexing_is_the_flip_and_concatenation():
    """The kernels' indexing, mirrored step by step (``tanh_chain_fwd_plain``
    / ``tanh_chain_bwd_plain``: step t at time S-1-t when reversed, the
    chain's columns [offset, offset + H) of a (B, S, 2H) output) against
    JAX's definition (flip the input, run, flip back, concatenate) and its
    backward (the dh chain over the flipped halves), bit for bit; and a
    chain alone at offset 0 of its own (B, S, H) is the unidirectional loop."""
    hidden = 13
    rng = np.random.default_rng(12)
    xp_f, xp_b = (_t(rng.normal(size=(B, S, hidden))) for _ in range(2))
    h0s = _t(np.tanh(rng.normal(size=(2, B, hidden))))
    w_f, w_b = (_t(rng.uniform(-0.3, 0.3, (hidden, hidden))) for _ in range(2))
    b_f, b_b = (_t(rng.uniform(-0.3, 0.3, hidden)) for _ in range(2))
    want = birnn_layer_plain(xp_f, xp_b, h0s, w_f, w_b, b_f, b_b)
    y = torch.full((B, S, 2 * hidden), float("nan"))
    tanh_chain_fwd_plain(xp_f, h0s[0], w_f, b_f, y, 0, False)
    tanh_chain_fwd_plain(xp_b, h0s[1], w_b, b_b, y, hidden, True)
    assert torch.equal(y, want)
    alone = tanh_chain_fwd_plain(xp_f, h0s[0], w_f, b_f, torch.empty(B, S, hidden), 0, False)
    assert torch.equal(alone, rnn_tanh_fwd_plain(xp_f, h0s[0], w_f, b_f))

    dy = _t(rng.normal(size=(B, S, 2 * hidden)))
    want_f, want_b, want_dh0s = birnn_layer_bwd_plain(dy, y, w_f, w_b)
    got_f, dh0_f = tanh_chain_bwd_plain(dy, y, None, w_f, 0, False)
    got_b, dh0_b = tanh_chain_bwd_plain(dy, y, None, w_b, hidden, True)
    assert torch.equal(got_f, want_f) and torch.equal(got_b, want_b)
    assert torch.equal(torch.stack([dh0_f, dh0_b]), want_dh0s)


def test_reverse_weight_gradient_reads_the_next_time_step():
    """A reverse chain's dW_hh pairs dpre at time p with the state it read,
    y at p + 1 (h0 at S-1): the same product as the forward-time chain over
    the flipped tensors."""
    rng = np.random.default_rng(13)
    dpre, y = (_t(rng.normal(size=(B, S, 6))) for _ in range(2))
    h0 = _t(rng.normal(size=(B, 6)))
    got = recurrence_weight_grads(dpre, h0, y, reverse=True)
    want = recurrence_weight_grads(dpre.flip(1), h0, y.flip(1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)


def test_cpu_tensors_launch_no_kernel():
    kernels.reset_launch_counts()
    hidden = 8
    xp = torch.randn(2, 3, hidden)
    w, b = torch.randn(hidden, hidden) * 0.1, torch.zeros(hidden)
    rnn_tanh(xp, torch.zeros(2, hidden), w, b)
    birnn_layer(xp, xp, torch.zeros(2, 2, hidden), w, w, b, b)
    assert all(k.launches == 0 for k in kernels.ALL_KERNELS)
    assert kernels.BIRNN_TANH_FWD in kernels.ALL_KERNELS and kernels.RNN_TANH_BWD in kernels.ALL_KERNELS


# ---------------------------------------------------------------------------
# the C entry points and the launch plan
# ---------------------------------------------------------------------------

def _c_params(name):
    src = (kernels.CSRC_DIR / "rnn.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    return [re.sub(r"\s+", " ", p.strip()) for p in params.split(",")]


@pytest.mark.parametrize("cell", ["relu", "tanh"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_entry_point_bindings(cell, direction):
    """Each recurrence entry point's ctypes signature: six pointers, the
    sizes, (tanh only) the chain's layout (reverse, y's row width, its
    column offset), the plan's five fields, then the stream."""
    name = f"hulc_rnn_{cell}_{direction}"
    params = _c_params(name)
    sig = kernels._SIGNATURES[name]
    layout = ["int reverse", "int y_width", "int y_offset"] if cell == "tanh" else []
    assert len(params) == len(sig) + 1 == 6 + 3 + len(layout) + 5 + 1
    assert all(p.endswith("*") or p.startswith("const void*") or p.startswith("void*") for p in params[:6])
    assert params[6:9] == ["int batch", "int seq", "int hidden"] and params[9:9 + len(layout)] == layout
    assert params[-6:] == ["int launch", "int cluster", "int k_slice", "int cols", "int smem", "void* stream"]
    assert list(sig[:6]) == [kernels._P] * 6 and list(sig[6:]) == [kernels._I32] * (3 + len(layout) + 5)


def test_plan_check_binding():
    """``hulc_rnn_check`` takes the cell, the direction, the sizes and the
    plan's five fields, ten ints, as ``kernels.check_rnn_plan`` passes them."""
    assert _c_params("hulc_rnn_check") == [
        "int cell", "int backward", "int batch", "int seq", "int hidden", "int launch", "int cluster",
        "int k_slice", "int cols", "int smem"]


H100_SMS, H100_SMEM_OPTIN = 132, 232_448  # what the H100 measured reports (test_torch_recurrence.py)
H100_CLUSTERS = {8: 15, 4: 30, 1: 132}


@pytest.mark.parametrize("backward", [False, True])
def test_plan_at_mcil_width_fits_the_h100(backward):
    """MCIL's BiRNN chains at the train step's (64, 32, 2048), either layer
    (the plan depends on H, not on the input width): 15 clusters of 8 on
    120 SMs, k-slice 256; a block's shared memory holds the W slice, two
    chunk buffers, the partials and the epilogue's inputs, xp forward and
    dy and y backward (227,072 and 231,680 bytes), within the card's
    232,448. The tanh cell takes the relu cell's plan."""
    plan = recurrence_plan(2048, 64, 32, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS, backward)
    assert (plan.launch, plan.cluster, plan.cols, plan.k_slice) == ("sequence", 8, 144, 256)
    assert plan.smem_bytes == sequence_smem_bytes(256, 8, backward) == (231_680 if backward else 227_072)
    assert plan.smem_bytes <= H100_SMEM_OPTIN
    assert -(-2048 // plan.cols) * plan.cluster == 120
    assert sequence_smem_bytes(256, 8, True) - sequence_smem_bytes(256, 8, False) == 4 * recurrence.ROWS * 144 // 8
