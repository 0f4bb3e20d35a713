"""The bidirectional relu and gru layers (B.13) of hulc_tpu_torch.ops.recurrence
and ``ScanBiRNN(cell="rnn" | "gru")`` against the JAX package's
``ScanBiRNN`` on the CPU: outputs and every gradient through the chain
kernels' index-by-index mirrors and through JAX's flip-and-concatenate
definition; the mirrors against that definition bit for bit; ``mcil_debug``
with ``plan_recognition.birnn_cell=gru`` (set by ``apply_overrides``): the
train losses and every gradient on JAX's plan noise; and the new C entry
points' bindings and the gru chain's launch plan at MCIL's width. Weights
are made with numpy in the JAX layout and carried into the port as
``hulc_tpu_torch.convert`` does (kernels transposed)."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_raw_batch
from hulc_tpu import config as jax_config
from hulc_tpu.data.loader import CombinedLoader
from hulc_tpu.models.layers import ScanBiRNN as JaxScanBiRNN
from hulc_tpu.training.preprocess import preprocess_batch as jax_preprocess_batch
from hulc_tpu.training.torch_convert import convert_state_dict

from hulc_tpu_torch import config as port_config
from hulc_tpu_torch import kernels
from hulc_tpu_torch.models.hulc import LOSS_KEYS, ModalityBatch
from hulc_tpu_torch.models.layers import ScanBiRNN
from hulc_tpu_torch.ops import recurrence
from hulc_tpu_torch.ops.recurrence import (
    GATES,
    _gated_loop,
    birnn_layer,
    birnn_layer_bwd,
    birnn_layer_fwd,
    birnn_layer_plain,
    dh_chain_gru_plain,
    dh_chain_plain,
    gated_plan,
    gated_smem_bytes,
    gru_chain_bwd_plain,
    gru_chain_fwd_plain,
    recurrence_plan,
    relu_chain_bwd_plain,
    relu_chain_fwd_plain,
    rnn_relu_fwd_plain,
)
from hulc_tpu_torch.training.preprocess import batch_to_device, preprocess_batch
from tests.torch_port_common import jax_call, jax_plan_noise, jax_random_params, port_model_from_jax

torch.set_num_threads(1)

B, S, F_IN = 3, 7, 10
ATOL = 1e-5  # fp32 sums in another order through S steps
GRAD_REL = 1e-5  # per gradient, relative L2
CELLS = ("rnn", "gru")
H100_SMS, H100_SMEM_OPTIN = 132, 232_448
H100_CLUSTERS = {8: 15, 4: 30, 2: 66, 1: 132}  # clusters an H100 holds at once at one block per SM


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _chain_params(rng, in_features, hidden, g):
    """One direction of a layer, as JAX's one-layer ScanRNN holds it."""
    def u(*shape):
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32) / np.sqrt(hidden)

    return {"ih_0": {"kernel": u(in_features, g * hidden), "bias": u(g * hidden)}, "hh_0": u(hidden, g * hidden),
            "bhh_0": u(g * hidden)}


def _birnn_params(rng, cell, in_features, hidden, layers):
    g = GATES.get(cell, 1)
    return {f"{d}_{k}": _chain_params(rng, in_features if k == 0 else 2 * hidden, hidden, g)
            for k in range(layers) for d in ("fwd", "bwd")}


def _port_birnn(params, cell, hidden, layers, use_kernels):
    net = ScanBiRNN(F_IN, hidden, layers, cell, use_kernels)
    state = {}
    for k in range(layers):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            p = params[f"{d}_{k}"]
            state.update({f"weight_ih_l{k}{suffix}": _t(p["ih_0"]["kernel"].T),
                          f"bias_ih_l{k}{suffix}": _t(p["ih_0"]["bias"]),
                          f"weight_hh_l{k}{suffix}": _t(p["hh_0"].T), f"bias_hh_l{k}{suffix}": _t(p["bhh_0"])})
    net.load_state_dict(state, strict=True)
    return net


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("hidden", [32, 37])
@pytest.mark.parametrize("cell", CELLS)
def test_scan_birnn_cell_matches_jax_outputs_and_every_gradient(cell, hidden, use_kernels):
    """Two bidirectional layers of the relu or gru cell (layer 1 reads layer
    0's 2H output): ``ScanBiRNN`` through ``birnn_layer`` (the autograd
    Function: on the CPU the chain kernels' index-by-index mirrors, forward
    and closed-form backward) and through JAX's flip-and-concatenate
    definition (``use_kernels=False``, autograd), against JAX's ScanBiRNN:
    the (B, S, 2H) output and the gradient of every parameter and of the
    input under a dense cotangent, each within 1e-5 relative L2."""
    layers = 2
    rng = np.random.default_rng(hidden + (7 if cell == "gru" else 0))
    params = _birnn_params(rng, cell, F_IN, hidden, layers)
    x = rng.normal(size=(B, S, F_IN)).astype(np.float32)
    dy = rng.normal(size=(B, S, 2 * hidden)).astype(np.float32)
    module = JaxScanBiRNN(hidden_size=hidden, num_layers=layers, cell=cell)

    def loss(p, xin):
        return jnp.sum(module.apply({"params": p}, xin) * dy)

    want_y = np.asarray(jax_call(lambda p, xin: module.apply({"params": p}, xin), params, x))
    want_dp, want_dx = jax_call(jax.grad(loss, argnums=(0, 1)), params, x)

    net = _port_birnn(params, cell, hidden, layers, use_kernels)
    xt = _t(x).requires_grad_()
    y = net(xt)
    y.backward(_t(dy))
    assert _rel_l2(y.detach().numpy(), want_y) <= GRAD_REL
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=ATOL, rtol=0)
    assert _rel_l2(xt.grad.numpy(), want_dx) <= GRAD_REL
    grads = dict(net.named_parameters())
    for k in range(layers):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            jp = want_dp[f"{d}_{k}"]
            pairs = {"weight_ih": np.asarray(jp["ih_0"]["kernel"]).T, "bias_ih": jp["ih_0"]["bias"],
                     "weight_hh": np.asarray(jp["hh_0"]).T, "bias_hh": jp["bhh_0"]}
            for name, want in pairs.items():
                err = _rel_l2(grads[f"{name}_l{k}{suffix}"].grad.numpy(), want)
                assert err <= GRAD_REL, (f"{name}_l{k}{suffix}", err)


def _layer_inputs(cell, hidden, seed):
    rng = np.random.default_rng(seed)
    g = GATES.get(cell, 1)
    xp_f, xp_b = (_t(rng.normal(size=(B, S, g * hidden))) for _ in range(2))
    h0s = _t(np.tanh(rng.normal(size=(2, B, hidden))))
    w_f, w_b = (_t(rng.uniform(-0.3, 0.3, (g * hidden, hidden))) for _ in range(2))
    b_f, b_b = (_t(rng.uniform(-0.3, 0.3, g * hidden)) for _ in range(2))
    dy = _t(rng.normal(size=(B, S, 2 * hidden)))
    return (xp_f, xp_b, h0s, w_f, w_b, b_f, b_b), dy


@pytest.mark.parametrize("cell", CELLS)
def test_chain_layout_indexing_is_the_flip_and_concatenation(cell):
    """The B.13 kernels' indexing, mirrored step by step (``relu_chain_*`` /
    ``gru_chain_*_plain``: step t at time S-1-t when reversed, the chain's
    columns [offset, offset + H) of a (B, S, 2H) output, the gru's saved
    gates and its dxp and dhp in xp's time order) against JAX's definition
    (flip the input, run, flip back, concatenate) and the cell's dh chain
    over the flipped halves, bit for bit; a chain alone at offset 0 of its
    own (B, S, H) is the unidirectional loop."""
    hidden = 13
    (xp_f, xp_b, h0s, w_f, w_b, b_f, b_b), dy = _layer_inputs(cell, hidden, 12)
    want = birnn_layer_plain(xp_f, xp_b, h0s, w_f, w_b, b_f, b_b, cell)
    y = torch.full((B, S, 2 * hidden), float("nan"))
    if cell == "gru":
        saved = torch.full((2, B, S, 4 * hidden), float("nan"))
        gru_chain_fwd_plain(xp_f, h0s[0], w_f, b_f, y, 0, False, saved[0])
        gru_chain_fwd_plain(xp_b, h0s[1], w_b, b_b, y, hidden, True, saved[1])
        _, _, want_saved_f = _gated_loop("gru", xp_f, h0s[0], None, w_f, b_f, True)
        _, _, want_saved_b = _gated_loop("gru", xp_b.flip(1), h0s[1], None, w_b, b_b, True)
        assert torch.equal(saved[0], want_saved_f) and torch.equal(saved[1], want_saved_b.flip(1))
        alone = gru_chain_fwd_plain(xp_f, h0s[0], w_f, b_f, torch.empty(B, S, hidden), 0, False)
        assert torch.equal(alone, _gated_loop("gru", xp_f, h0s[0], None, w_f, b_f, False)[0])
    else:
        relu_chain_fwd_plain(xp_f, h0s[0], w_f, b_f, y, 0, False)
        relu_chain_fwd_plain(xp_b, h0s[1], w_b, b_b, y, hidden, True)
        alone = relu_chain_fwd_plain(xp_f, h0s[0], w_f, b_f, torch.empty(B, S, hidden), 0, False)
        assert torch.equal(alone, rnn_relu_fwd_plain(xp_f, h0s[0], w_f, b_f))
    assert torch.equal(y, want)

    if cell == "gru":
        got_f = gru_chain_bwd_plain(dy, None, y, h0s[0], saved[0], w_f, 0, False)
        got_b = gru_chain_bwd_plain(dy, None, y, h0s[1], saved[1], w_b, hidden, True)
        want_f = dh_chain_gru_plain(dy[..., :hidden], None, y[..., :hidden], h0s[0], saved[0], w_f)
        want_b = dh_chain_gru_plain(dy[..., hidden:].flip(1), None, y[..., hidden:].flip(1), h0s[1],
                                    saved[1].flip(1), w_b)
        want_b = (want_b[0].flip(1), want_b[1].flip(1), want_b[2])
    else:
        got_f = relu_chain_bwd_plain(dy, y, None, w_f, 0, False)
        got_b = relu_chain_bwd_plain(dy, y, None, w_b, hidden, True)
        want_f = dh_chain_plain(dy[..., :hidden], y[..., :hidden], None, w_f)
        want_b = dh_chain_plain(dy[..., hidden:].flip(1), y[..., hidden:].flip(1), None, w_b)
        want_b = (want_b[0].flip(1), want_b[1])
    for got, wants in ((got_f, want_f), (got_b, want_b)):
        assert all(torch.equal(g, w) for g, w in zip(got, wants))


@pytest.mark.parametrize("cell", CELLS)
def test_layer_function_matches_autograd_through_the_definition(cell):
    """One layer's autograd Function on the CPU (``birnn_layer``: the chain
    mirrors forward, their dh chains and one dW product a chain backward)
    against autograd through ``birnn_layer_plain``, every input's gradient
    within 1e-5 relative L2 from nonzero initial states; without a gradient
    it saves nothing and gives the same output."""
    hidden = 11
    inputs, dy = _layer_inputs(cell, hidden, 13)

    def grads(layer):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = layer(*leaves, cell)
        return out.detach(), torch.autograd.grad(out, leaves, dy)

    (y, got), (want_y, want) = grads(birnn_layer), grads(birnn_layer_plain)
    assert torch.equal(y, want_y)
    for name, g, w in zip(("xp_f", "xp_b", "h0s", "w_f", "w_b", "b_f", "b_b"), got, want):
        assert _rel_l2(g, w) <= GRAD_REL, name
    with torch.no_grad():
        assert torch.equal(birnn_layer(*inputs, cell), want_y)
    outs = birnn_layer_bwd(dy, want_y, inputs[3], inputs[4], cell, inputs[2],
                           None if cell == "rnn" else torch.stack([
                               _gated_loop("gru", inputs[0], inputs[2][0], None, inputs[3], inputs[5], True)[2],
                               _gated_loop("gru", inputs[1].flip(1), inputs[2][1], None, inputs[4], inputs[6],
                                           True)[2].flip(1)]))
    # dhp, the gradient of hp, is the relu cell's dxp (the same memory); the gru's its own
    assert len(outs) == 5 and (outs[3].data_ptr() == outs[0].data_ptr()) == (cell == "rnn")


def test_layers_refuse_what_they_do_not_take():
    inputs, dy = _layer_inputs("rnn", 5, 14)
    with pytest.raises(ValueError, match="saves no gates"):
        birnn_layer_fwd(*inputs, "rnn", torch.empty(2, B, S, 20))
    with pytest.raises(ValueError, match="not ported yet"):
        birnn_layer_plain(*inputs, "lstm")
    with pytest.raises(ValueError, match="saved gates"):
        birnn_layer_bwd(dy, dy, inputs[3], inputs[4], "gru")


def test_cpu_tensors_launch_no_kernel():
    kernels.reset_launch_counts()
    for cell in CELLS:
        inputs, _ = _layer_inputs(cell, 6, 15)
        birnn_layer(*inputs, cell)
    assert all(k.launches == 0 for k in kernels.ALL_KERNELS)
    new = {"hulc_rnn_relu_chain_fwd", "hulc_rnn_relu_chain_bwd", "hulc_rnn_gru_chain_fwd", "hulc_rnn_gru_chain_bwd"}
    assert new <= {k.symbol for k in kernels.ALL_KERNELS}


# ---------------------------------------------------------------------------
# mcil_debug with the gru BiRNN: train losses and gradients against JAX's
# ---------------------------------------------------------------------------

KL_BETA, ROWS, FRAMES = 0.01, 3, 5
LOSS_RTOL, STEP_GRAD_REL = 1e-5, 1e-4


def _gru_cfg(m):
    """``mcil_debug`` of config module ``m`` with an 84 px gripper camera
    (the size ``torch_convert`` maps) and the BiRNN's cell set as a user
    sets it."""
    cfg = m.get_config("mcil_debug", replan_freq=3)
    pe = cfg.perceptual_encoder
    pe = dataclasses.replace(pe, rgb_gripper=dataclasses.replace(pe.rgb_gripper, input_size=84))
    return m.apply_overrides(dataclasses.replace(cfg, perceptual_encoder=pe), ["plan_recognition.birnn_cell=gru"])


def test_mcil_gru_train_losses_and_grads_match_jax():
    """``train_losses`` on a loader-fused batch of ``mcil_debug`` with the
    gru BiRNN, eval preprocessing, on JAX's plan noise: every loss within
    rtol 1e-5 and every parameter's gradient within 1e-4 relative L2 (the
    last layer's reverse W_hh and b_hh exactly zero on both sides where
    JAX's are: seq_feat reads that chain's first step, from h0 = 0)."""
    jax_cfg, cfg = _gru_cfg(jax_config), _gru_cfg(port_config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg) and cfg.plan_recognition.birnn_cell == "gru"
    jax_model, params = jax_random_params(jax_cfg, seed=80)
    assert params["plan_recognition"]["birnn"]["fwd_1"]["hh_0"].shape == (32, 96)
    raw = _make_raw_batch(jax_cfg, ROWS, FRAMES, seed=81)
    raw["lang"] = raw["lang"]._replace(use_for_aux_lang_loss=np.array([True, False, True]))
    batch = CombinedLoader.fuse_batch(raw)
    key = jax.random.key(82)
    prep = jax_preprocess_batch(jax_cfg, batch, rng=None, train=False)

    def loss_fn(p):
        out = jax_model.apply({"params": p}, key, prep, KL_BETA, method=jax_model.train_losses)
        return out["total_loss"], out

    grads, want = jax_call(jax.grad(loss_fn, has_aux=True), params)
    normal = jax_plan_noise(jax.random.split(key)[1], 2 * ROWS, jax_cfg)["normal"]
    model, unused = port_model_from_jax(params, cfg)
    assert unused == []
    got = model.train().train_losses(
        preprocess_batch(cfg, batch_to_device({k: ModalityBatch(*v) for k, v in batch.items()}, "cpu"), train=False),
        KL_BETA, normal=normal)
    got["total_loss"].backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    got_grads, unused = convert_state_dict({k: p.grad.numpy() for k, p in model.named_parameters()}, jax_cfg)
    assert unused == []
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    zero = []
    for (path, g), (_, w) in zip(flat(got_grads), flat(grads)):
        name, g, w = jax.tree_util.keystr(path), np.asarray(g), np.asarray(w)
        if not np.any(w):
            np.testing.assert_array_equal(g, w, err_msg=name)
            zero.append(name)
            continue
        assert _rel_l2(g, w) <= STEP_GRAD_REL, (name, _rel_l2(g, w))
    assert "['plan_recognition']['birnn']['bwd_1']['hh_0']" in zero


# ---------------------------------------------------------------------------
# the C entry points and the launch plans
# ---------------------------------------------------------------------------

def _c_params(source, name):
    src = (kernels.CSRC_DIR / source).read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    return [re.sub(r"\s+", " ", p.strip()) for p in params.split(",")]


LAYOUT = ["int reverse", "int y_width", "int y_offset"]


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_relu_chain_bindings(direction):
    """``hulc_rnn_relu_chain_*``: the tanh chain's parameters (six pointers,
    the sizes, the layout, the plan's five fields, the stream)."""
    name = f"hulc_rnn_relu_chain_{direction}"
    params, sig = _c_params("rnn.cu", name), kernels._SIGNATURES[name]
    assert len(params) == len(sig) + 1 == 6 + 3 + 3 + 5 + 1
    assert params[6:12] == ["int batch", "int seq", "int hidden", *LAYOUT]
    assert params[-6:] == ["int launch", "int cluster", "int k_slice", "int cols", "int smem", "void* stream"]
    assert sig == kernels._SIGNATURES[f"hulc_rnn_tanh_{direction}"]
    assert list(sig) == [kernels._P] * 6 + [kernels._I32] * 11


@pytest.mark.parametrize("direction,pointers", [("fwd", 7), ("bwd", 10)])
def test_gru_chain_bindings(direction, pointers):
    """``hulc_rnn_gru_chain_*``: B.11's pointers, the sizes, the chain's
    layout, GatedPlan's six fields, the stream."""
    name = f"hulc_rnn_gru_chain_{direction}"
    params, sig = _c_params("rnn_gates.cu", name), kernels._SIGNATURES[name]
    assert len(params) == len(sig) + 1 == pointers + 3 + 3 + 6 + 1
    assert all("void*" in p for p in params[:pointers])
    assert params[pointers:pointers + 6] == ["int batch", "int seq", "int hidden", *LAYOUT]
    assert params[-7:] == ["int launch", "int cluster", "int k_slice", "int cols", "int stages", "int smem",
                           "void* stream"]
    assert list(sig) == [kernels._P] * pointers + [kernels._I32] * 12
    assert _c_params("rnn_gates.cu", f"hulc_rnn_gru_{direction}")[:pointers] == params[:pointers]


def test_plan_checks_name_the_chain_kernels():
    """``hulc_rnn_check`` takes the cell (``kernels.RNN_CELLS``: 2 for the
    relu chain with a layout) and ``hulc_rnn_gated_check`` the layout
    flag, as ``kernels.check_rnn_plan`` / ``check_gated_plan`` pass them."""
    assert kernels.RNN_CELLS == {"rnn": 0, "rnn_tanh": 1, "rnn_chain": 2}
    src = (kernels.CSRC_DIR / "rnn.cu").read_text()
    assert "enum Cell { kRelu = 0, kTanhChain = 1, kReluChain = 2 };" in src
    assert _c_params("rnn_gates.cu", "hulc_rnn_gated_check")[:4] == ["int lstm", "int laid", "int backward",
                                                                    "int saves"]
    assert recurrence.CHAIN_KERNELS["rnn"] == ("rnn_chain", "RNN_RELU_CHAIN_FWD", "RNN_RELU_CHAIN_BWD")


@pytest.mark.parametrize("backward", [False, True])
def test_gru_chain_plan_at_mcil_width_fits_the_h100(backward):
    """The gru BiRNN's chains at the train step's (64, 32, 2048) take B.11's
    plan: the forward (saving its gates) on 64 clusters of 2 on 128 SMs,
    k-slices of 1024; the dh chain on 29 clusters of 4 on 116 SMs, k-slices
    of 1536; shared memory within the H100's opt-in. The relu chain takes
    the tanh chain's plan (15 clusters of 8, k-slice 256)."""
    plan = gated_plan("gru", 2048, 64, 32, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS, backward,
                      saves=not backward, laid=True)
    assert plan == gated_plan("gru", 2048, 64, 32, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS, backward,
                              saves=not backward)
    assert (plan.launch, plan.cluster, plan.k_slice) == (("sequence", 4, 1536) if backward else ("sequence", 2, 1024))
    assert plan.blocks(2048) == (116 if backward else 128) <= H100_SMS
    assert plan.smem_bytes == gated_smem_bytes("gru", backward) <= H100_SMEM_OPTIN
    relu = recurrence_plan(2048, 64, 32, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS, backward)
    assert (relu.launch, relu.cluster, relu.k_slice) == ("sequence", 8, 256)


@pytest.mark.parametrize("lanes", [1, 8])
def test_a_laid_gru_chain_never_takes_the_one_step_launch(lanes):
    """One step at a serving lane's rows: the decoder's gru chain takes the
    GEMV, a chain with a layout the sequence launch (the GEMV writes rows of
    its own y only); the lstm takes no layout."""
    args = ("gru", 2048, lanes, 1, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS)
    assert gated_plan(*args).launch == "step"
    laid = gated_plan(*args, laid=True)
    assert laid.launch == "sequence" and laid.cluster == 2
    with pytest.raises(ValueError, match="only the gru chain"):
        gated_plan("lstm", 2048, lanes, 1, H100_SMS, H100_SMEM_OPTIN, H100_CLUSTERS, laid=True)
