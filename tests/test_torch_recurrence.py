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

from hulc_tpu_torch.models.layers import ScanRNN
from hulc_tpu_torch.models.vision import _aligned
from hulc_tpu_torch.ops.recurrence import rnn_relu, rnn_relu_bwd_plain, rnn_relu_fwd_plain

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


@pytest.mark.parametrize("hidden", [64, 37])
def test_rnn_relu_fwd_plain_matches_jax(hidden):
    params, xp, h0, _, _ = _one_layer(hidden, seed=hidden)
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
