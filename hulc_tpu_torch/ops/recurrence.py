"""The decoder RNN's relu recurrence (port of hulc_tpu/models/layers.py:233-267).

One layer, with the input projection ``xp`` (B, S, H) computed before the
loop (``b_ih`` in it) and ``w_hh`` in torch ``nn.RNN`` layout (H_out, H_in):
``y_t = relu(xp_t + h_{t-1} w_hh^T + b_hh)`` from ``h_{-1} = h0``. The
relu's gradient is the JAX package's custom VJP, ``g * (y > 0)``: 0 at
exactly 0.

On CUDA tensors ``rnn_relu`` is a ``torch.autograd.Function`` whose forward
is ``csrc/rnn_relu.cu``'s persistent forward kernel (one launch a layer) and
whose backward is that file's dh-chain kernel, then dW_hh as ONE matrix
product over all S * B rows, ``dpre^T [h0, y_{:-1}]``, and db_hh as dpre's
sum (``recurrence_weight_grads``). Each part runs inside a
``record_function`` span (``SPANS``) so a profile can find it. On CPU
tensors the wrappers take the plain versions below: ``rnn_relu_fwd_plain``
is the loop, ``rnn_relu_bwd_plain`` the closed form the backward computes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from hulc_tpu_torch import kernels

MAX_COLS_PER_SM = 16  # csrc/rnn_relu.cu kCols: each block owns at most 16 columns of W

# record_function span of each part of the recurrence, by the name
# profile_train's recurrence_split reports it under
SPANS = {
    "forward": "ScanRNN.recurrence",
    "backward": "ScanRNN.recurrence.dh",
    "weight_grad": "ScanRNN.recurrence.dw",
    "bias_grad": "ScanRNN.recurrence.db",
}


def rnn_relu_fwd_plain(xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The loop: one ``addmm`` per time step; y (B, S, H)."""
    h = h0
    steps = []
    for t in range(xp.shape[1]):
        h = torch.relu(xp[:, t] + torch.addmm(b_hh, h, w_hh.t()))
        steps.append(h)
    return torch.stack(steps, dim=1)


def recurrence_weight_grads(dpre: torch.Tensor, h0: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW_hh, db_hh): one (H x S*B) @ (S*B x H) product against the states
    each step read, ``[h0, y_0, ..., y_{S-2}]``, and dpre's sum."""
    with record_function(SPANS["weight_grad"]):
        h_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
        dw = dpre.flatten(0, 1).t() @ h_prev.flatten(0, 1)
    with record_function(SPANS["bias_grad"]):
        db = dpre.sum(dim=(0, 1))
    return dw, db


def dh_chain_plain(
    dy: torch.Tensor, y: torch.Tensor, dcarry: Optional[torch.Tensor], w_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the backward kernel computes: (dpre, dh0), the dh chain of
    ``rnn_relu_bwd_plain`` without the weight gradients."""
    dh = torch.zeros_like(y[:, 0]) if dcarry is None else dcarry
    dpre = torch.empty_like(y)
    for t in reversed(range(y.shape[1])):
        d = (dy[:, t] + dh) * (y[:, t] > 0).to(y.dtype)
        dpre[:, t] = d
        dh = d @ w_hh
    return dpre, dh


def rnn_relu_bwd_plain(
    dy: torch.Tensor, y: torch.Tensor, dcarry: Optional[torch.Tensor], h0: torch.Tensor, w_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The closed form of the backward: with dh_{S-1} = dcarry (None: no
    gradient reaches the final carry), step by step from t = S-1 down,
    ``dpre_t = (dy_t + dh_t) * (y_t > 0)`` and ``dh_{t-1} = dpre_t w_hh``;
    then ``recurrence_weight_grads``. Returns (dxp = dpre, dh0, dW_hh, db_hh)."""
    dpre, dh0 = dh_chain_plain(dy, y, dcarry, w_hh)
    return (dpre, dh0, *recurrence_weight_grads(dpre, h0, y))


def _check_hidden(hidden: int, device: torch.device) -> None:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if hidden > MAX_COLS_PER_SM * sms:
        raise ValueError(f"hidden size {hidden} is too large for the recurrence kernels' shared-memory "
                         f"slice: at most {MAX_COLS_PER_SM * sms} on this card ({sms} SMs)")


def rnn_relu_fwd(
    xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (y (B, S, H), the final state y[:, -1] as its
    own (B, H) tensor)."""
    if xp.device.type == "cpu":
        y = rnn_relu_fwd_plain(xp, h0, w_hh, b_hh)
        return y, y[:, -1]
    b, s, h = xp.shape
    kernels.require_cuda_tensor("xp", xp, torch.float32, 3)
    kernels.require_cuda_tensor("h0", h0, torch.float32, 2)
    kernels.require_cuda_tensor("w_hh", w_hh, torch.float32, 2)
    kernels.require_cuda_tensor("b_hh", b_hh, torch.float32, 1)
    if h0.shape != (b, h) or w_hh.shape != (h, h) or b_hh.shape != (h,):
        raise ValueError(f"rnn_relu_fwd: xp {tuple(xp.shape)}, h0 {tuple(h0.shape)}, w_hh {tuple(w_hh.shape)}, "
                         f"b_hh {tuple(b_hh.shape)} do not fit together")
    _check_hidden(h, xp.device)
    y = torch.empty_like(xp)
    h_last = torch.empty_like(h0)
    kernels.RNN_RELU_FWD(xp.device, xp.data_ptr(), h0.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                         y.data_ptr(), h_last.data_ptr(), b, s, h)
    return y, h_last


def rnn_relu_bwd(
    dy: torch.Tensor, y: torch.Tensor, dcarry: Optional[torch.Tensor], w_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dh-chain kernel: (dpre (B, S, H), dh0 (B, H)); ``dcarry`` None
    means no gradient reaches the final carry."""
    if y.device.type == "cpu":
        return dh_chain_plain(dy, y, dcarry, w_hh)
    b, s, h = y.shape
    dy = dy.contiguous()
    kernels.require_cuda_tensor("dy", dy, torch.float32, 3)
    kernels.require_cuda_tensor("y", y, torch.float32, 3)
    kernels.require_cuda_tensor("w_hh", w_hh, torch.float32, 2)
    if dcarry is not None:
        dcarry = dcarry.contiguous()
        kernels.require_cuda_tensor("dcarry", dcarry, torch.float32, 2)
    if dy.shape != y.shape or w_hh.shape != (h, h) or (dcarry is not None and dcarry.shape != (b, h)):
        raise ValueError(f"rnn_relu_bwd: dy {tuple(dy.shape)}, y {tuple(y.shape)}, w_hh {tuple(w_hh.shape)}, "
                         f"dcarry {None if dcarry is None else tuple(dcarry.shape)} do not fit together")
    _check_hidden(h, y.device)
    dpre = torch.empty_like(y)
    dh0 = torch.empty((b, h), dtype=y.dtype, device=y.device)
    kernels.RNN_RELU_BWD(y.device, dy.data_ptr(), y.data_ptr(), None if dcarry is None else dcarry.data_ptr(),
                         w_hh.data_ptr(), dpre.data_ptr(), dh0.data_ptr(), b, s, h)
    return dpre, dh0


class _RnnReluRecurrence(torch.autograd.Function):
    """Forward: the forward kernel. Backward: the dh-chain kernel, then the
    weight and bias gradients as one product and one sum per layer."""

    @staticmethod
    def forward(ctx, xp, h0, w_hh, b_hh):
        with record_function(SPANS["forward"]):
            y, h_last = rnn_relu_fwd(xp, h0, w_hh, b_hh)
        ctx.save_for_backward(y, h0, w_hh)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        y, h0, w_hh = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        with record_function(SPANS["backward"]):
            dpre, dh0 = rnn_relu_bwd(dy, y, dh_last, w_hh)
        dw, db = recurrence_weight_grads(dpre, h0, y)
        return dpre, dh0, dw, db


def rnn_relu(
    xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the recurrence through ``_RnnReluRecurrence``: (y (B, S,
    H), final state (B, H)), differentiable in all four inputs."""
    return _RnnReluRecurrence.apply(xp, h0, w_hh, b_hh)
