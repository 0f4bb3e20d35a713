"""The RNN recurrences (port of hulc_tpu/models/layers.py:233-313).

One layer, with the input projection ``xp`` (B, S, H) computed before the
loop (``b_ih`` in it) and ``w_hh`` in torch ``nn.RNN`` layout (H_out, H_in):
``y_t = act(xp_t + h_{t-1} w_hh^T + b_hh)`` from ``h_{-1} = h0``, act the
decoder's relu (B.6) or the MCIL plan recognition's tanh (B.8). The relu's
gradient is the JAX package's custom VJP, ``g * (y > 0)``: 0 at exactly 0;
the tanh's ``g * (1 - y^2)``.

``rnn_relu`` / ``rnn_tanh`` are a ``torch.autograd.Function`` whose forward
is, on CUDA tensors, ``csrc/rnn.cu``'s forward (one launch a layer: the
split-K cluster kernel over the sequence, or the one-step GEMV at a
serving lane; the relu's through the ``hulc::rnn_relu_fwd`` op,
``ops.library``). Its backward is that file's dh-chain kernel, then dW_hh
as ONE matrix product over all S * B rows, ``dpre^T [h0, y_{:-1}]``, and
db_hh as dpre's sum (``recurrence_weight_grads``). ``birnn_layer`` is one
bidirectional layer (``ScanBiRNN``) of the tanh (B.9), relu or gru cell
(B.13): a forward chain and a time-reversed chain written into the two
halves of one (B, S, 2H) output, two launches of the cell's chain kernel
with the chain's layout (the tanh's B.8; for relu ``csrc/rnn.cu``'s relu
instance with the runtime layout, for gru ``csrc/rnn_gates.cu``'s laid
instance), no flip and no concatenation copied. ``recurrence_plan`` chooses each launch's kernel,
cluster size, k-split, columns and shared memory, once per shape
(``device_plan``, cached), and csrc/rnn.cu checks it against the card
then. Each part runs inside a ``record_function`` span (``SPANS``,
``BIRNN_SPANS``) so a profile can find it. On CPU tensors the forward and
the dh chain take the plain versions below: ``rnn_relu_fwd_plain`` /
``rnn_tanh_fwd_plain`` are the loop, ``dh_chain_plain`` /
``dh_chain_tanh_plain`` the dh chain, ``tanh_chain_fwd_plain`` /
``tanh_chain_bwd_plain`` (``relu_chain_*_plain``, ``gru_chain_*_plain``)
one chain launch index by index (a chain's layout in a (B, S, 2H) output,
reversed or not), and ``birnn_layer_plain`` (any of the three cells) /
``birnn_layer_bwd_plain`` (tanh) JAX's flip and concatenation, which
``use_kernels=False`` runs.

The gated cells (layers.py:238-257), gru (B.11) and lstm (B.12), take xp
(B, S, G H) and W_hh (G H, H), G = 3 (r, z, n) or 4 (i, f, g, o), and
lstm a carry pair (h0, c0); ``csrc/rnn_gates.cu`` runs a layer in one
launch: split-K over clusters as B.6, W_hh streamed every step through a
ring of asynchronous copies (it does not fit in shared memory), or the
one-step GEMV at a serving lane (``gated_plan``, checked once a shape by
``gated_device_plan``).
``rnn_gru`` / ``rnn_lstm`` take the autograd Functions where a gradient is
wanted: a training forward that saves the gates (and c), then the dh
chain kernel and, as for B.6, dW_hh as one product of dhp and the states,
db_hh as its sum; without one they take the ``hulc::rnn_gru_fwd`` /
``hulc::rnn_lstm_fwd`` ops, which save nothing (one step at a serving
lane: the GEMV). ``rnn_gru_fwd_plain`` / ``rnn_lstm_fwd_plain`` are the
loops, ``dh_chain_gru_plain`` / ``dh_chain_lstm_plain`` the chains.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from hulc_tpu_torch import kernels

# csrc/rnn.cu's geometry
ROWS = 64  # kRows: batch rows per tile of the sequence kernels
CHUNK = 64  # kChunk: k values staged at a time
SKEW = 4  # kSkew: floats of bank skew per shared-memory row
COLS = 144  # kCols: output columns of a cluster of the sequence kernels
STEP_ROWS = 8  # kStepRows: most rows of the one-step launch
STEP_COLS = 8  # kStepWarps: columns per block of the one-step launch, one a warp
# The cluster sizes (= k-splits) the sequence launch tries, in order: 8
# (H = 2048 on an H100: 15 clusters, k-slice 256, on 120 SMs); 4 for an H
# too small to give each of 8 blocks some k; 1 for one too small for 4.
CLUSTERS = (8, 4, 1)


@dataclasses.dataclass(frozen=True)
class RecurrencePlan:
    """One launch of ``csrc/rnn.cu``, in the order its entry points take
    the fields. ``launch`` "sequence": ceil(H / ``cols``) clusters of
    ``cluster`` blocks of eight warps; cluster c owns the ``cols`` output
    columns from c * ``cols``, its block of rank j the k-slice [j *
    ``k_slice``, (j + 1) * ``k_slice``) and the reduce slice of ``cols //
    cluster`` columns from c * ``cols`` + j * ``cols // cluster``; ``smem``
    bytes of shared memory a block; cooperative (every cluster resident, one
    grid barrier a step) unless it is a forward of one step. "step":
    ceil(H / ``cols``) blocks of ``cols`` warps, one output column a warp,
    over the whole k (``k_slice`` = H) for at most STEP_ROWS rows."""

    launch: str
    cluster: int
    k_slice: int
    cols: int
    smem_bytes: int

    def c_args(self) -> Tuple[int, ...]:
        return 0 if self.launch == "sequence" else 1, self.cluster, self.k_slice, self.cols, self.smem_bytes


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def sequence_smem_bytes(k_slice: int, cluster: int, backward: bool) -> int:
    """csrc/rnn.cu ``sequence_smem_bytes``: the W slice (whole chunks
    plus the skew per column), two chunk buffers, the partial product, and
    the epilogue's inputs for the reduce slice (xp; or dy and y)."""
    w_stride = _ceil(k_slice, CHUNK) * CHUNK + SKEW
    return 4 * (COLS * w_stride + 2 * ROWS * (CHUNK + SKEW) + ROWS * (COLS + SKEW)
                + (2 if backward else 1) * ROWS * (COLS // cluster))


def recurrence_plan(hidden: int, batch: int, seq: int, sms: int, smem_optin: int, cluster_limits: Dict[int, int],
                    backward: bool = False) -> RecurrencePlan:
    """The launch for one layer at (batch, seq, hidden) on a card with
    ``sms`` SMs, ``smem_optin`` bytes of shared memory a block and room for
    ``cluster_limits[n]`` clusters of n blocks at once at one block per SM
    (a cluster stays inside one GPC). The one-step GEMV for a forward
    of one time step and at most STEP_ROWS rows; else the sequence launch
    with the first of CLUSTERS whose blocks all hold k, whose shared memory
    fits and whose clusters all fit at once. Raises ValueError when none
    fits."""
    if min(hidden, batch, seq) <= 0:
        raise ValueError(f"recurrence_plan: hidden {hidden}, batch {batch}, seq {seq} must be positive")
    if not backward and seq == 1 and batch <= STEP_ROWS:
        return RecurrencePlan("step", 1, hidden, STEP_COLS, 0)
    clusters = _ceil(hidden, COLS)
    for cluster in CLUSTERS:
        k_slice = _ceil(_ceil(hidden, cluster), 4) * 4
        smem = sequence_smem_bytes(k_slice, cluster, backward)
        if ((cluster - 1) * k_slice < hidden and smem <= smem_optin and clusters * cluster <= sms
                and clusters <= cluster_limits[cluster]):
            return RecurrencePlan("sequence", cluster, k_slice, COLS, smem)
    raise ValueError(f"hidden size {hidden} is too large for the recurrence kernels on this card ({sms} SMs, "
                     f"{smem_optin} B of shared memory a block, clusters at once {cluster_limits})")


@functools.cache
def device_plan(hidden: int, batch: int, seq: int, index: int, backward: bool, cell: str = "rnn") -> RecurrencePlan:
    """``recurrence_plan`` for CUDA device ``index``, from what the runtime
    reports, checked by csrc/rnn.cu against the card for the cell's kernel
    (``kernels.RNN_CELLS``: ``rnn`` the decoder's relu, ``rnn_tanh``,
    ``rnn_chain`` B.13's relu chain). Made once per shape: a launch only
    looks it up."""
    plan = recurrence_plan(hidden, batch, seq, *kernels.device_limits(index),
                           kernels.cluster_limits(index, CLUSTERS), backward)
    kernels.check_rnn_plan(index, cell, backward, batch, seq, hidden, plan.c_args())
    return plan


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# record_function span of each part of the recurrence, by the name
# profile_train's recurrence_split reports it under
SPANS = {
    "forward": "ScanRNN.recurrence",
    "backward": "ScanRNN.recurrence.dh",
    "weight_grad": "ScanRNN.recurrence.dw",
    "bias_grad": "ScanRNN.recurrence.db",
}
BIRNN_SPANS = {k: v.replace("ScanRNN", "ScanBiRNN") for k, v in SPANS.items()}


def _fwd_loop(xp, h0, w_hh, b_hh, act) -> torch.Tensor:
    h = h0
    steps = []
    for t in range(xp.shape[1]):
        h = act(xp[:, t] + torch.addmm(b_hh, h, w_hh.t()))
        steps.append(h)
    return torch.stack(steps, dim=1)


def rnn_relu_fwd_plain(xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The loop: one ``addmm`` per time step; y (B, S, H)."""
    return _fwd_loop(xp, h0, w_hh, b_hh, torch.relu)


def rnn_tanh_fwd_plain(xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The tanh cell's loop; y (B, S, H)."""
    return _fwd_loop(xp, h0, w_hh, b_hh, torch.tanh)


def recurrence_weight_grads(
    dpre: torch.Tensor, h0: torch.Tensor, y: torch.Tensor, reverse: bool = False, spans: Dict[str, str] = SPANS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW_hh, db_hh): one (H x S*B) @ (S*B x H) product against the states
    each step read, ``[h0, y_0, ..., y_{S-2}]`` (a ``reverse`` chain, whose
    dpre and y are in xp's time order: ``[y_1, ..., y_{S-1}, h0]``), and
    dpre's sum."""
    with record_function(spans["weight_grad"]):
        if reverse:
            h_prev = torch.cat([y[:, 1:], h0[:, None]], dim=1)
        else:
            h_prev = torch.cat([h0[:, None], y[:, :-1]], dim=1)
        dw = dpre.flatten(0, 1).t() @ h_prev.flatten(0, 1)
    with record_function(spans["bias_grad"]):
        db = dpre.sum(dim=(0, 1))
    return dw, db


def _dh_chain(dy, y, dcarry, w_hh, act_grad, offset: int = 0, reverse: bool = False):
    """(dpre (B, S, H), dh0): the chain's dy and y are columns [offset,
    offset + H) of (B, S, W) tensors, its step t at time S-1-t when
    ``reverse``; dpre in xp's time order."""
    b, s = y.shape[:2]
    h = w_hh.shape[0]
    dh = y.new_zeros(b, h) if dcarry is None else dcarry
    dpre = y.new_empty(b, s, h)
    for t in reversed(range(s)):
        p = s - 1 - t if reverse else t
        d = (dy[:, p, offset:offset + h] + dh) * act_grad(y[:, p, offset:offset + h])
        dpre[:, p] = d
        dh = d @ w_hh
    return dpre, dh


def dh_chain_plain(
    dy: torch.Tensor, y: torch.Tensor, dcarry: Optional[torch.Tensor], w_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the backward kernel computes: (dpre, dh0), the dh chain of
    ``rnn_relu_bwd_plain`` without the weight gradients."""
    return _dh_chain(dy, y, dcarry, w_hh, _relu_grad)


def _tanh_grad(y_t: torch.Tensor) -> torch.Tensor:
    return 1 - y_t * y_t


def dh_chain_tanh_plain(
    dy: torch.Tensor, y: torch.Tensor, dcarry: Optional[torch.Tensor], w_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tanh cell's dh chain: (dpre, dh0) with ``dpre_t = (dy_t + dh_t) *
    (1 - y_t^2)``, the derivative JAX's tanh JVP and torch's tanh_backward
    take from the output."""
    return _dh_chain(dy, y, dcarry, w_hh, _tanh_grad)


def _act_chain_fwd(act, xp, h0, w_hh, b_hh, y, offset: int, reverse: bool) -> torch.Tensor:
    """One chain of the relu or tanh cell, index by index: step t reads
    xp[:, time(t)] and writes y[:, time(t), offset:offset + H] of the (B, S,
    W) ``y``, time(t) = S-1-t when ``reverse``; returns y."""
    s, h = xp.shape[1], w_hh.shape[0]
    state = h0
    for t in range(s):
        p = s - 1 - t if reverse else t
        state = act(xp[:, p] + torch.addmm(b_hh, state, w_hh.t()))
        y[:, p, offset:offset + h] = state
    return y


def tanh_chain_fwd_plain(xp, h0, w_hh, b_hh, y, offset: int, reverse: bool) -> torch.Tensor:
    """What one launch of B.8's forward computes, index by index (a chain's
    layout in a (B, S, W) output, ``_act_chain_fwd``); returns y."""
    return _act_chain_fwd(torch.tanh, xp, h0, w_hh, b_hh, y, offset, reverse)


def tanh_chain_bwd_plain(dy, y, dcarry, w_hh, offset: int, reverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """What one launch of B.8's dh chain computes, index by index, over the
    forward's layout: (dpre (B, S, H) in xp's time order, dh0)."""
    return _dh_chain(dy, y, dcarry, w_hh, _tanh_grad, offset, reverse)


def relu_chain_fwd_plain(xp, h0, w_hh, b_hh, y, offset: int, reverse: bool) -> torch.Tensor:
    """What one launch of B.13's relu chain computes, index by index, as
    ``tanh_chain_fwd_plain``; returns y."""
    return _act_chain_fwd(torch.relu, xp, h0, w_hh, b_hh, y, offset, reverse)


def _relu_grad(y_t: torch.Tensor) -> torch.Tensor:
    return (y_t > 0).to(y_t.dtype)


def relu_chain_bwd_plain(dy, y, dcarry, w_hh, offset: int, reverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """What one launch of B.13's relu dh chain computes, index by index,
    over the forward's layout: (dpre (B, S, H) in xp's time order, dh0)."""
    return _dh_chain(dy, y, dcarry, w_hh, _relu_grad, offset, reverse)


def rnn_relu_bwd_plain(
    dy: torch.Tensor, y: torch.Tensor, dcarry: Optional[torch.Tensor], h0: torch.Tensor, w_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The closed form of the backward: with dh_{S-1} = dcarry (None: no
    gradient reaches the final carry), step by step from t = S-1 down,
    ``dpre_t = (dy_t + dh_t) * (y_t > 0)`` and ``dh_{t-1} = dpre_t w_hh``;
    then ``recurrence_weight_grads``. Returns (dxp = dpre, dh0, dW_hh, db_hh)."""
    dpre, dh0 = dh_chain_plain(dy, y, dcarry, w_hh)
    return (dpre, dh0, *recurrence_weight_grads(dpre, h0, y))


def rnn_relu_fwd(
    xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``hulc::rnn_relu_fwd`` op: (y (B, S, H), the final state y[:, -1]
    as its own (B, H) tensor); the forward kernel on CUDA tensors, the plain
    loop on CPU tensors."""
    return torch.ops.hulc.rnn_relu_fwd(xp, h0, w_hh, b_hh)


def rnn_relu_fwd_kernel(
    xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors, after its launch plan."""
    b, s, h = xp.shape
    kernels.require_cuda_tensor("xp", xp, torch.float32, 3)
    kernels.require_cuda_tensor("h0", h0, torch.float32, 2)
    kernels.require_cuda_tensor("w_hh", w_hh, torch.float32, 2)
    kernels.require_cuda_tensor("b_hh", b_hh, torch.float32, 1)
    if h0.shape != (b, h) or w_hh.shape != (h, h) or b_hh.shape != (h,):
        raise ValueError(f"rnn_relu_fwd: xp {tuple(xp.shape)}, h0 {tuple(h0.shape)}, w_hh {tuple(w_hh.shape)}, "
                         f"b_hh {tuple(b_hh.shape)} do not fit together")
    plan = device_plan(h, b, s, _index(xp.device), False)
    y = torch.empty_like(xp)
    h_last = torch.empty_like(h0)
    kernels.RNN_RELU_FWD(xp.device, xp.data_ptr(), h0.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                         y.data_ptr(), h_last.data_ptr(), b, s, h, *plan.c_args())
    return y, h_last


def _check_shapes(name, b, h, state, w_hh, b_hh=None):
    """The (B, H) state (h0 or dcarry, may be None), W_hh and b_hh of a
    chain of B rows and H columns, before their pointers are passed."""
    kernels.require_cuda_tensor("w_hh", w_hh, torch.float32, 2)
    if state is not None:
        kernels.require_cuda_tensor("state", state, torch.float32, 2)
    if b_hh is not None:
        kernels.require_cuda_tensor("b_hh", b_hh, torch.float32, 1)
    if (state is not None and state.shape != (b, h)) or w_hh.shape != (h, h) or (
            b_hh is not None and b_hh.shape != (h,)):
        raise ValueError(f"{name}: state {None if state is None else tuple(state.shape)}, w_hh "
                         f"{tuple(w_hh.shape)}, b_hh {None if b_hh is None else tuple(b_hh.shape)} do not fit "
                         f"(B, H) = {(b, h)}")


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
    plan = device_plan(h, b, s, _index(y.device), True)
    dpre = torch.empty_like(y)
    dh0 = torch.empty((b, h), dtype=y.dtype, device=y.device)
    kernels.RNN_RELU_BWD(y.device, dy.data_ptr(), y.data_ptr(), None if dcarry is None else dcarry.data_ptr(),
                         w_hh.data_ptr(), dpre.data_ptr(), dh0.data_ptr(), b, s, h, *plan.c_args())
    return dpre, dh0


# a chain's csrc/rnn.cu kernels by cell: (plan cell, forward entry point, dh chain entry point)
CHAIN_KERNELS = {"rnn_tanh": ("rnn_tanh", "RNN_TANH_FWD", "RNN_TANH_BWD"),
                 "rnn": ("rnn_chain", "RNN_RELU_CHAIN_FWD", "RNN_RELU_CHAIN_BWD")}


def _chain_fwd_launch(xp, h0, w_hh, b_hh, y, offset: int, reverse: bool, h_last, cell: str = "rnn_tanh") -> None:
    """One launch of B.8's forward (B.13's relu chain for ``cell`` "rnn"):
    the chain's columns [offset, offset + H) of y (B, S, W), run from the
    last step down when ``reverse``."""
    b, s, h = xp.shape
    kernels.require_cuda_tensor("xp", xp, torch.float32, 3)
    kernels.require_cuda_tensor("y", y, torch.float32, 3)
    _check_shapes(f"{cell} chain forward", b, h, h0, w_hh, b_hh)
    if y.shape[:2] != (b, s) or offset + h > y.shape[2]:
        raise ValueError(f"{cell} chain forward: y {tuple(y.shape)} has no columns [{offset}, {offset + h}) for xp "
                         f"{tuple(xp.shape)}")
    plan_cell, fwd, _ = CHAIN_KERNELS[cell]
    plan = device_plan(h, b, s, _index(xp.device), False, plan_cell)
    getattr(kernels, fwd)(xp.device, xp.data_ptr(), h0.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), y.data_ptr(),
                          _ptr(h_last), b, s, h, int(reverse), y.shape[2], offset, *plan.c_args())


def _chain_bwd_launch(dy, y, dcarry, w_hh, dpre, dh0, offset: int, reverse: bool, cell: str = "rnn_tanh") -> None:
    """One launch of B.8's dh chain (B.13's relu one for ``cell`` "rnn")
    over the chain's columns [offset, offset + H) of dy and y (B, S, W);
    dpre (B, S, H) and dh0 (B, H) its own."""
    b, s, h = dpre.shape
    kernels.require_cuda_tensor("dy", dy, torch.float32, 3)
    kernels.require_cuda_tensor("y", y, torch.float32, 3)
    _check_shapes(f"{cell} chain dh chain", b, h, dcarry, w_hh)
    if dy.shape != y.shape or y.shape[:2] != (b, s) or offset + h > y.shape[2]:
        raise ValueError(f"{cell} chain dh chain: dy {tuple(dy.shape)}, y {tuple(y.shape)} have no columns "
                         f"[{offset}, {offset + h}) for dpre {tuple(dpre.shape)}")
    plan_cell, _, bwd = CHAIN_KERNELS[cell]
    plan = device_plan(h, b, s, _index(y.device), True, plan_cell)
    getattr(kernels, bwd)(y.device, dy.data_ptr(), y.data_ptr(), _ptr(dcarry), w_hh.data_ptr(), dpre.data_ptr(),
                          dh0.data_ptr(), b, s, h, int(reverse), y.shape[2], offset, *plan.c_args())


def rnn_tanh_fwd(
    xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H), the final state (B, H)): B.8's forward kernel on CUDA
    tensors, the plain loop on CPU tensors."""
    if xp.device.type == "cpu":
        y = rnn_tanh_fwd_plain(xp, h0, w_hh, b_hh)
        return y, y[:, -1].clone()
    y, h_last = torch.empty_like(xp), torch.empty_like(h0)
    _chain_fwd_launch(xp, h0, w_hh, b_hh, y, 0, False, h_last)
    return y, h_last


def rnn_tanh_bwd(
    dy: torch.Tensor, y: torch.Tensor, dcarry: Optional[torch.Tensor], w_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B.8's dh-chain kernel (the plain chain on CPU tensors): (dpre, dh0)."""
    if y.device.type == "cpu":
        return dh_chain_tanh_plain(dy, y, dcarry, w_hh)
    dpre, dh0 = torch.empty_like(y), torch.empty_like(y[:, 0])
    _chain_bwd_launch(dy.contiguous(), y, None if dcarry is None else dcarry.contiguous(), w_hh, dpre, dh0, 0, False)
    return dpre, dh0


class _Recurrence(torch.autograd.Function):
    """Forward: the cell's forward kernel. Backward: its dh-chain kernel,
    then the weight and bias gradients as one product and one sum per
    layer."""

    @staticmethod
    def forward(ctx, xp, h0, w_hh, b_hh, cell):
        fwd, ctx.bwd = (rnn_relu_fwd, rnn_relu_bwd) if cell == "rnn" else (rnn_tanh_fwd, rnn_tanh_bwd)
        with record_function(SPANS["forward"]):
            y, h_last = fwd(xp, h0, w_hh, b_hh)
        ctx.save_for_backward(y, h0, w_hh)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        y, h0, w_hh = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        with record_function(SPANS["backward"]):
            dpre, dh0 = ctx.bwd(dy, y, dh_last, w_hh)
        dw, db = recurrence_weight_grads(dpre, h0, y)
        return dpre, dh0, dw, db, None


def rnn_relu(
    xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One relu layer through ``_Recurrence``: (y (B, S, H), final state
    (B, H)), differentiable in all four inputs."""
    return _Recurrence.apply(xp, h0, w_hh, b_hh, "rnn")


def rnn_tanh(
    xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tanh layer (B.8) through ``_Recurrence``, as ``rnn_relu``."""
    return _Recurrence.apply(xp, h0, w_hh, b_hh, "rnn_tanh")


# --------------------------------------------------------------------------
# B.11, B.12: the gated cells (gru, lstm)
# --------------------------------------------------------------------------

# csrc/rnn_gates.cu's geometry
GATED_COLS = {"forward": 32, "backward": 72}  # kFwdCols, kCols: hidden columns of a cluster
GATED_ROWS = 64  # kRows: batch rows per tile
GATED_SKEW = 4  # kSkew: floats a staged row is wider than its data (bank skew)
GATED_ALIGN = 128  # kAlign: bytes the ring is aligned to (a box's alignment)
GATED_FWD_CHUNK = {"gru": 128, "lstm": 64}  # Cell::kFwdChunk: k values of h's slice staged at a time
GATED_BWD_CHUNK = 128  # kBwdChunk: k values of dhp's slice staged at a time
GATED_FWD_STAGES = {"gru": 2, "lstm": 3}  # Cell::kFwdStages: the forward's ring of chunk buffers
GATED_BWD_STAGES = 2  # kBwdStages: the dh chain's
GATED_STEP_ROWS = 8  # kStepRows: most rows of the one-step launch
GATED_STEP_COLS = 8  # kStepWarps: hidden columns per block of the one-step launch, one a warp
GATES = {"gru": 3, "lstm": 4}  # gate columns per hidden column: r z n; i f g o
SAVED = {"gru": 4, "lstm": 5}  # what a training forward saves per hidden column: r z n hn; i f g o c
# The cluster sizes (= k-splits) the sequence launch tries, in order. The
# forward: 2 (H = 2048 on an H100: 64 clusters of 32 columns on 128 SMs,
# where the card holds 66 clusters of 2), then 1. The dh chain: 4 (29
# clusters of 72 columns on 116 SMs, where the card holds 30 of 4), 2, 1.
# A smaller cluster where H is too small to give each block some k.
GATED_CLUSTERS = {"forward": (2, 1), "backward": (4, 2, 1)}


@dataclasses.dataclass(frozen=True)
class GatedPlan:
    """One launch of ``csrc/rnn_gates.cu``, in the order its entry points
    take the fields. ``launch`` "sequence": ceil(H / ``cols``) clusters of
    ``cluster`` blocks; cluster c owns the ``cols`` hidden columns from c *
    ``cols`` and all gate columns of each, its block of rank r the k-slice
    [r * ``k_slice``, (r + 1) * ``k_slice``) of H (forward) or of G H (the
    dh chain), whole chunks streamed through a ring of ``stages`` buffers,
    and the reduce slice ``gated_reduce_columns(cols, cluster, r)`` of the
    cluster's columns; ``smem_bytes`` of shared memory a block; cooperative
    (every cluster resident, one grid barrier a step) unless it is a
    forward of one step. "step": ceil(H / ``cols``) blocks of ``cols``
    warps, one hidden column a warp over the whole k (``k_slice`` = H), for
    a forward of one step at most GATED_STEP_ROWS rows that saves nothing
    (a serving lane)."""

    launch: str
    cluster: int
    k_slice: int
    cols: int
    stages: int
    smem_bytes: int

    def c_args(self) -> Tuple[int, ...]:
        return (0 if self.launch == "sequence" else 1, self.cluster, self.k_slice, self.cols, self.stages,
                self.smem_bytes)

    def blocks(self, hidden: int) -> int:
        return _ceil(hidden, self.cols) * self.cluster


def gated_reduce_columns(cols: int, cluster: int, rank: int) -> Tuple[int, int]:
    """csrc/rnn_gates.cu ``geometry``: the columns [lo, hi) of its cluster's
    ``cols`` that the block of ``rank`` reduces (with all their gates),
    whole quads of 4: the quads [rank Q / cluster, (rank + 1) Q / cluster)
    of Q = cols / 4."""
    quads = cols // 4
    return 4 * (rank * quads // cluster), 4 * ((rank + 1) * quads // cluster)


def gated_smem_bytes(cell: str, backward: bool) -> int:
    """csrc/rnn_gates.cu ``sequence_smem_bytes``: the ring's stages (forward:
    h's 64 rows and the cluster's G * cols rows of W; dh chain: dhp's 64
    rows and the cluster's cols rows of W^T; each row a chunk and the skew
    wide), the block's partial product, and room to align the ring to
    GATED_ALIGN bytes."""
    g, skew = GATES[cell], GATED_SKEW
    if backward:
        cols = GATED_COLS["backward"]
        stage = (GATED_ROWS + cols) * (GATED_BWD_CHUNK + skew)
        floats = GATED_BWD_STAGES * stage + GATED_ROWS * (cols + skew)
    else:
        cols = GATED_COLS["forward"]
        stage = (GATED_ROWS + g * cols) * (GATED_FWD_CHUNK[cell] + skew)
        floats = GATED_FWD_STAGES[cell] * stage + GATED_ROWS * (g * cols + skew)
    return 4 * floats + GATED_ALIGN


def gated_plan(cell: str, hidden: int, batch: int, seq: int, sms: int, smem_optin: int,
               cluster_limits: Dict[int, int], backward: bool = False, saves: bool = False,
               laid: bool = False) -> GatedPlan:
    """The launch for one gated layer at (batch, seq, hidden) on a card with
    ``sms`` SMs, ``smem_optin`` bytes of shared memory a block and room for
    ``cluster_limits[n]`` clusters of n blocks at once at one block per SM:
    the one-step GEMV for a forward of one time step at most
    GATED_STEP_ROWS rows that saves no gates, of a chain that owns its y
    (not ``laid``, B.13's chain with a layout); else the sequence launch with
    the first of GATED_CLUSTERS whose blocks all hold k (of H forward, of G
    H in the dh chain; each block's slice whole chunks), whose shared memory
    fits and whose clusters all fit at once. Raises ValueError when none
    fits; csrc/rnn_gates.cu checks the plan against the kernel on the card
    (``hulc_rnn_gated_check``)."""
    if cell not in GATES:
        raise ValueError(f"gated_plan: cell {cell!r} is not gru or lstm")
    if min(hidden, batch, seq) <= 0:
        raise ValueError(f"gated_plan: hidden {hidden}, batch {batch}, seq {seq} must be positive")
    if laid and cell != "gru":
        raise ValueError(f"gated_plan: only the gru chain takes a layout, not {cell!r}")
    if not backward and not saves and not laid and seq == 1 and batch <= GATED_STEP_ROWS:
        return GatedPlan("step", 1, hidden, GATED_STEP_COLS, 0, 0)
    direction = "backward" if backward else "forward"
    k_total = GATES[cell] * hidden if backward else hidden
    cols = GATED_COLS[direction]
    clusters = _ceil(hidden, cols)
    smem = gated_smem_bytes(cell, backward)
    stages = GATED_BWD_STAGES if backward else GATED_FWD_STAGES[cell]
    chunk = GATED_BWD_CHUNK if backward else GATED_FWD_CHUNK[cell]
    for cluster in GATED_CLUSTERS[direction]:
        k_slice = _ceil(_ceil(k_total, cluster), chunk) * chunk
        if ((cluster - 1) * k_slice < k_total and smem <= smem_optin and clusters * cluster <= sms
                and clusters <= cluster_limits[cluster]):
            return GatedPlan("sequence", cluster, k_slice, cols, stages, smem)
    raise ValueError(f"hidden size {hidden} is too large for the {cell} kernels on this card ({sms} SMs, "
                     f"{smem_optin} B of shared memory a block, {smem} B needed, clusters at once {cluster_limits})")


@functools.cache
def gated_device_plan(cell: str, hidden: int, batch: int, seq: int, index: int, backward: bool,
                      saves: bool, laid: bool = False) -> GatedPlan:
    """``gated_plan`` for CUDA device ``index``, from what the runtime
    reports, checked by csrc/rnn_gates.cu against the card once per shape
    (``laid``: for B.13's gru chain): a launch only looks it up."""
    plan = gated_plan(cell, hidden, batch, seq, *kernels.device_limits(index),
                      kernels.cluster_limits(index, GATED_CLUSTERS["backward"]), backward, saves, laid)
    kernels.check_gated_plan(index, cell == "lstm", laid, backward, saves, batch, seq, hidden, plan.c_args())
    return plan


def _gru_gates(x_t, hp, h):
    """One gru step as JAX's ScanRNN writes it (layers.py:240-247) from x_t
    (B, 3H) and hp = h W_hh^T + b_hh: (h_t, its saved parts (r, z, n, hn))."""
    xr, xz, xn = x_t.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h, (r, z, n, hn)


def _gated_loop(cell: str, xp, h0, c0, w_hh, b_hh, save: bool):
    """The gated loop, one ``addmm`` a step, then the gate math as JAX's
    ScanRNN writes it (hulc_tpu/models/layers.py:239-260): (y (B, S, H),
    the final c (lstm; else None), the saved gates (B, S, SAVED[cell] * H)
    when ``save``, else None)."""
    h, c = h0, c0
    ys, saved = [], []
    for t in range(xp.shape[1]):
        hp = torch.addmm(b_hh, h, w_hh.t())
        if cell == "gru":
            h, parts = _gru_gates(xp[:, t], hp, h)
        else:
            xi, xf, xg, xo = xp[:, t].chunk(4, dim=-1)
            hi, hf, hg, ho = hp.chunk(4, dim=-1)
            i = torch.sigmoid(xi + hi)
            f = torch.sigmoid(xf + hf)
            g = torch.tanh(xg + hg)
            o = torch.sigmoid(xo + ho)
            c = f * c + i * g
            h = o * torch.tanh(c)
            parts = (i, f, g, o, c)
        ys.append(h)
        if save:
            saved.append(torch.cat(parts, dim=-1))
    return torch.stack(ys, dim=1), c, torch.stack(saved, dim=1) if save else None


def rnn_gru_fwd_plain(xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """The gru loop over xp (B, S, 3H) from h0 (B, H), W_hh (3H, H): y (B, S, H)."""
    return _gated_loop("gru", xp, h0, None, w_hh, b_hh, False)[0]


def rnn_lstm_fwd_plain(
    xp: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lstm loop over xp (B, S, 4H) from (h0, c0), W_hh (4H, H): (y (B,
    S, H), the final c (B, H))."""
    y, c, _ = _gated_loop("lstm", xp, h0, c0, w_hh, b_hh, False)
    return y, c


def dh_chain_gru_plain(dy, dh_last, y, h0, saved, w_hh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What B.11's backward computes: (dxp, dhp (B, S, 3H), dh0 (B, H)) from
    the training forward's saved [r | z | n | hn]; ``dh_last`` None means no
    gradient reaches the final carry. dhp is dxp but in the n slice, dxp_n
    * r; dh_{t-1} = gh_t z_t + dhp_t W_hh."""
    return _gru_dh_chain(dy, dh_last, y, h0, saved, w_hh)


def _gru_dh_chain(dy, dh_last, y, h0, saved, w_hh, offset: int = 0, reverse: bool = False):
    """``dh_chain_gru_plain`` with the chain's dy and y the columns [offset,
    offset + H) of (B, S, W) tensors, its step t at time S-1-t when
    ``reverse``; saved, dxp and dhp in xp's time order."""
    b, s = saved.shape[:2]
    h = w_hh.shape[1]
    dh = y.new_zeros(b, h) if dh_last is None else dh_last
    dxp, dhp = y.new_empty(b, s, 3 * h), y.new_empty(b, s, 3 * h)
    for t in reversed(range(s)):
        p = s - 1 - t if reverse else t
        r, z, n, hn = saved[:, p].chunk(4, dim=-1)
        h_prev = y[:, p + 1 if reverse else p - 1, offset:offset + h] if t > 0 else h0
        gh = dy[:, p, offset:offset + h] + dh
        dpn = gh * (1.0 - z) * (1.0 - n * n)
        dpr = dpn * hn * (r * (1.0 - r))
        dpz = gh * (h_prev - n) * (z * (1.0 - z))
        dxp[:, p] = torch.cat([dpr, dpz, dpn], dim=-1)
        dhp[:, p] = torch.cat([dpr, dpz, dpn * r], dim=-1)
        dh = gh * z + dhp[:, p] @ w_hh
    return dxp, dhp, dh


def gru_chain_fwd_plain(xp, h0, w_hh, b_hh, y, offset: int, reverse: bool, saved=None) -> torch.Tensor:
    """What one launch of B.13's gru chain computes, index by index: step t
    reads xp[:, time(t)] (B, S, 3H), writes y[:, time(t), offset:offset + H]
    of the (B, S, W) ``y`` and, when ``saved`` (B, S, 4H) is given, its
    [r | z | n | hn] at time(t), time(t) = S-1-t when ``reverse``; returns
    y."""
    s, h = xp.shape[1], w_hh.shape[1]
    state = h0
    for t in range(s):
        p = s - 1 - t if reverse else t
        state, parts = _gru_gates(xp[:, p], torch.addmm(b_hh, state, w_hh.t()), state)
        y[:, p, offset:offset + h] = state
        if saved is not None:
            saved[:, p] = torch.cat(parts, dim=-1)
    return y


def gru_chain_bwd_plain(dy, dh_last, y, h0, saved, w_hh, offset: int,
                        reverse: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What one launch of B.13's gru dh chain computes, index by index, over
    the forward's layout: (dxp, dhp (B, S, 3H) in xp's time order, dh0)."""
    return _gru_dh_chain(dy, dh_last, y, h0, saved, w_hh, offset, reverse)


def dh_chain_lstm_plain(dy, dh_last, dc_last, saved, c0, w_hh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What B.12's backward computes: (dpre (B, S, 4H), the gradient of xp
    and of hp alike, dh0, dc0 (B, H)) from the saved [i | f | g | o | c]:
    dc = dc_t + gh o (1 - tanh^2 c_t), dh_{t-1} = dpre_t W_hh, dc_{t-1} =
    dc f. ``dh_last`` / ``dc_last`` None: no gradient reaches that carry."""
    b, s, h5 = saved.shape
    h = h5 // 5
    dh = saved.new_zeros(b, h) if dh_last is None else dh_last
    dc = saved.new_zeros(b, h) if dc_last is None else dc_last
    dpre = saved.new_empty(b, s, 4 * h)
    for t in reversed(range(s)):
        i, f, g, o, c = saved[:, t].chunk(5, dim=-1)
        c_prev = saved[:, t - 1, 4 * h:] if t > 0 else c0
        gh = dy[:, t] + dh
        tc = torch.tanh(c)
        dc = dc + gh * o * (1.0 - tc * tc)
        dpre[:, t] = torch.cat([dc * g * (i * (1.0 - i)), dc * c_prev * (f * (1.0 - f)), dc * i * (1.0 - g * g),
                                gh * tc * (o * (1.0 - o))], dim=-1)
        dh = dpre[:, t] @ w_hh
        dc = dc * f
    return dpre, dh, dc


def _check_gated(name, cell, b, h, states, w_hh, b_hh=None):
    """The (B, H) states (h0, c0, dcarry: None allowed), W_hh (G H, H) and
    b_hh (G H) of a gated layer of B rows and H columns, before their
    pointers are passed."""
    g = GATES[cell]
    kernels.require_cuda_tensor("w_hh", w_hh, torch.float32, 2)
    if b_hh is not None:
        kernels.require_cuda_tensor("b_hh", b_hh, torch.float32, 1)
    for i, state in enumerate(states):
        if state is not None:
            kernels.require_cuda_tensor(f"state {i}", state, torch.float32, 2)
    if (w_hh.shape != (g * h, h) or (b_hh is not None and b_hh.shape != (g * h,))
            or any(s is not None and s.shape != (b, h) for s in states)):
        raise ValueError(f"{name}: w_hh {tuple(w_hh.shape)}, b_hh {None if b_hh is None else tuple(b_hh.shape)}, "
                         f"states {[None if s is None else tuple(s.shape) for s in states]} do not fit (B, H) = "
                         f"{(b, h)} of a {cell} layer")


def rnn_gru_fwd_kernel(xp, h0, w_hh, b_hh, save: bool = False):
    """B.11's forward on CUDA tensors: (y (B, S, H), h_last (B, H), the saved
    gates (B, S, 4H) when ``save``, else None)."""
    b, s, gh = xp.shape
    h = gh // 3
    kernels.require_cuda_tensor("xp", xp, torch.float32, 3)
    _check_gated("rnn_gru_fwd", "gru", b, h, (h0,), w_hh, b_hh)
    if gh != 3 * h:
        raise ValueError(f"rnn_gru_fwd: xp {tuple(xp.shape)} is not (B, S, 3H)")
    plan = gated_device_plan("gru", h, b, s, _index(xp.device), False, save)
    y = xp.new_empty(b, s, h)
    h_last = xp.new_empty(b, h)
    saved = xp.new_empty(b, s, SAVED["gru"] * h) if save else None
    kernels.RNN_GRU_FWD(xp.device, xp.data_ptr(), h0.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), y.data_ptr(),
                        h_last.data_ptr(), _ptr(saved), b, s, h, *plan.c_args())
    return y, h_last, saved


def rnn_lstm_fwd_kernel(xp, h0, c0, w_hh, b_hh, save: bool = False):
    """B.12's forward on CUDA tensors: (y (B, S, H), h_last, c_last (B, H),
    the saved gates and c (B, S, 5H) when ``save``, else None)."""
    b, s, gh = xp.shape
    h = gh // 4
    kernels.require_cuda_tensor("xp", xp, torch.float32, 3)
    _check_gated("rnn_lstm_fwd", "lstm", b, h, (h0, c0), w_hh, b_hh)
    if gh != 4 * h:
        raise ValueError(f"rnn_lstm_fwd: xp {tuple(xp.shape)} is not (B, S, 4H)")
    plan = gated_device_plan("lstm", h, b, s, _index(xp.device), False, save)
    y = xp.new_empty(b, s, h)
    h_last, c_last = xp.new_empty(b, h), xp.new_empty(b, h)
    saved = xp.new_empty(b, s, SAVED["lstm"] * h) if save else None
    kernels.RNN_LSTM_FWD(xp.device, xp.data_ptr(), h0.data_ptr(), c0.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                         y.data_ptr(), h_last.data_ptr(), c_last.data_ptr(), _ptr(saved), b, s, h, *plan.c_args())
    return y, h_last, c_last, saved


def rnn_gru_fwd(xp, h0, w_hh, b_hh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``hulc::rnn_gru_fwd`` op: (y (B, S, H), the final state (B, H));
    B.11's inference forward on CUDA tensors, the plain loop on CPU tensors."""
    return torch.ops.hulc.rnn_gru_fwd(xp, h0, w_hh, b_hh)


def rnn_lstm_fwd(xp, h0, c0, w_hh, b_hh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``hulc::rnn_lstm_fwd`` op: (y, h_last, c_last); B.12's inference
    forward on CUDA tensors, the plain loop on CPU tensors."""
    return torch.ops.hulc.rnn_lstm_fwd(xp, h0, c0, w_hh, b_hh)


def _w_t_scratch(w_hh: torch.Tensor) -> torch.Tensor:
    """The (H, G H) scratch the dh chain's launch writes W_hh^T into
    (csrc/rnn_gates.cu ``gated_transpose_kernel``)."""
    return w_hh.new_empty(w_hh.shape[1], w_hh.shape[0])


def rnn_gru_bwd(dy, dh_last, y, h0, saved, w_hh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B.11's dh-chain kernel (the plain chain on CPU tensors): (dxp, dhp,
    dh0)."""
    if y.device.type == "cpu":
        return dh_chain_gru_plain(dy, dh_last, y, h0, saved, w_hh)
    b, s, h = y.shape
    dy = dy.contiguous()
    dh_last = None if dh_last is None else dh_last.contiguous()
    for name, t, width in (("dy", dy, h), ("y", y, h), ("saved", saved, SAVED["gru"] * h)):
        kernels.require_cuda_tensor(name, t, torch.float32, 3)
        if t.shape != (b, s, width):
            raise ValueError(f"rnn_gru_bwd: {name} {tuple(t.shape)} is not {(b, s, width)}")
    _check_gated("rnn_gru_bwd", "gru", b, h, (h0, dh_last), w_hh)
    plan = gated_device_plan("gru", h, b, s, _index(y.device), True, False)
    dxp, dhp = y.new_empty(b, s, 3 * h), y.new_empty(b, s, 3 * h)
    dh0, w_t = y.new_empty(b, h), _w_t_scratch(w_hh)
    kernels.RNN_GRU_BWD(y.device, dy.data_ptr(), _ptr(dh_last), y.data_ptr(), h0.data_ptr(), saved.data_ptr(),
                        w_hh.data_ptr(), w_t.data_ptr(), dxp.data_ptr(), dhp.data_ptr(), dh0.data_ptr(), b, s, h,
                        *plan.c_args())
    return dxp, dhp, dh0


def rnn_lstm_bwd(dy, dh_last, dc_last, saved, c0, w_hh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B.12's dh / dc chain kernel (the plain chain on CPU tensors): (dpre,
    dh0, dc0)."""
    if saved.device.type == "cpu":
        return dh_chain_lstm_plain(dy, dh_last, dc_last, saved, c0, w_hh)
    b, s, h5 = saved.shape
    h = h5 // SAVED["lstm"]
    dy = dy.contiguous()
    dh_last = None if dh_last is None else dh_last.contiguous()
    dc_last = None if dc_last is None else dc_last.contiguous()
    for name, t, width in (("dy", dy, h), ("saved", saved, SAVED["lstm"] * h)):
        kernels.require_cuda_tensor(name, t, torch.float32, 3)
        if t.shape != (b, s, width):
            raise ValueError(f"rnn_lstm_bwd: {name} {tuple(t.shape)} is not {(b, s, width)}")
    _check_gated("rnn_lstm_bwd", "lstm", b, h, (c0, dh_last, dc_last), w_hh)
    plan = gated_device_plan("lstm", h, b, s, _index(saved.device), True, False)
    dpre = saved.new_empty(b, s, 4 * h)
    dh0, dc0, w_t = saved.new_empty(b, h), saved.new_empty(b, h), _w_t_scratch(w_hh)
    kernels.RNN_LSTM_BWD(saved.device, dy.data_ptr(), _ptr(dh_last), _ptr(dc_last), saved.data_ptr(), c0.data_ptr(),
                         w_hh.data_ptr(), w_t.data_ptr(), dpre.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), b, s, h,
                         *plan.c_args())
    return dpre, dh0, dc0


def _gru_train_fwd(xp, h0, w_hh, b_hh):
    """(y, h_last, saved): B.11's training forward, or the loop on CPU tensors."""
    if xp.device.type == "cpu":
        y, _, saved = _gated_loop("gru", xp, h0, None, w_hh, b_hh, True)
        return y, y[:, -1].clone(), saved
    return rnn_gru_fwd_kernel(xp, h0, w_hh, b_hh, save=True)


def _lstm_train_fwd(xp, h0, c0, w_hh, b_hh):
    """(y, h_last, c_last, saved): B.12's training forward, or the loop on CPU tensors."""
    if xp.device.type == "cpu":
        y, c, saved = _gated_loop("lstm", xp, h0, c0, w_hh, b_hh, True)
        return y, y[:, -1].clone(), c.clone(), saved
    return rnn_lstm_fwd_kernel(xp, h0, c0, w_hh, b_hh, save=True)


class _GruRecurrence(torch.autograd.Function):
    """Forward: B.11's training forward (it saves r, z, n, hn). Backward:
    its dh chain, then dW_hh and db_hh as one product and one sum."""

    @staticmethod
    def forward(ctx, xp, h0, w_hh, b_hh):
        with record_function(SPANS["forward"]):
            y, h_last, saved = _gru_train_fwd(xp, h0, w_hh, b_hh)
        ctx.save_for_backward(y, h0, saved, w_hh)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        y, h0, saved, w_hh = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        with record_function(SPANS["backward"]):
            dxp, dhp, dh0 = rnn_gru_bwd(dy, dh_last, y, h0, saved, w_hh)
        dw, db = recurrence_weight_grads(dhp, h0, y)
        return dxp, dh0, dw, db


class _LstmRecurrence(torch.autograd.Function):
    """Forward: B.12's training forward (it saves i, f, g, o, c). Backward:
    its dh / dc chain, then dW_hh and db_hh as one product and one sum."""

    @staticmethod
    def forward(ctx, xp, h0, c0, w_hh, b_hh):
        with record_function(SPANS["forward"]):
            y, h_last, c_last, saved = _lstm_train_fwd(xp, h0, c0, w_hh, b_hh)
        ctx.save_for_backward(y, h0, c0, saved, w_hh)
        ctx.set_materialize_grads(False)
        return y, h_last, c_last

    @staticmethod
    def backward(ctx, dy, dh_last, dc_last):
        y, h0, c0, saved, w_hh = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        with record_function(SPANS["backward"]):
            dpre, dh0, dc0 = rnn_lstm_bwd(dy, dh_last, dc_last, saved, c0, w_hh)
        dw, db = recurrence_weight_grads(dpre, h0, y)
        return dpre, dh0, dc0, dw, db


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def rnn_gru(xp, h0, w_hh, b_hh) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gru layer: (y (B, S, H), final state (B, H)). Where a gradient is
    wanted, through ``_GruRecurrence`` (differentiable in all four inputs);
    else the inference forward, the ``hulc::rnn_gru_fwd`` op, which saves no
    gates and takes the one-step launch at a serving lane."""
    if _needs_grad(xp, h0, w_hh, b_hh):
        return _GruRecurrence.apply(xp, h0, w_hh, b_hh)
    with record_function(SPANS["forward"]):
        return rnn_gru_fwd(xp, h0, w_hh, b_hh)


def rnn_lstm(xp, h0, c0, w_hh, b_hh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One lstm layer: (y (B, S, H), h_last, c_last), through
    ``_LstmRecurrence`` where a gradient is wanted, else the
    ``hulc::rnn_lstm_fwd`` op, as ``rnn_gru``."""
    if _needs_grad(xp, h0, c0, w_hh, b_hh):
        return _LstmRecurrence.apply(xp, h0, c0, w_hh, b_hh)
    with record_function(SPANS["forward"]):
        return rnn_lstm_fwd(xp, h0, c0, w_hh, b_hh)


# --------------------------------------------------------------------------
# B.9 and B.13: one bidirectional layer of the tanh, relu or gru cell
# --------------------------------------------------------------------------

BIRNN_CELLS = ("rnn_tanh", "rnn", "gru")
_PLAIN_LOOPS = {"rnn_tanh": rnn_tanh_fwd_plain, "rnn": rnn_relu_fwd_plain, "gru": rnn_gru_fwd_plain}


def _birnn_cell(cell: str) -> str:
    if cell not in BIRNN_CELLS:
        raise ValueError(f"bidirectional rnn cell {cell!r} is not ported yet; only {list(BIRNN_CELLS)} are")
    return cell


def birnn_layer_plain(
    xp_f: torch.Tensor, xp_b: torch.Tensor, h0s: torch.Tensor, w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
    b_hh_f: torch.Tensor, b_hh_b: torch.Tensor, cell: str = "rnn_tanh",
) -> torch.Tensor:
    """JAX's definition (layers.py:305-310): the forward chain over xp_f,
    the reverse chain over the time-flipped xp_b flipped back, concatenated
    to (B, S, 2H); ``h0s`` (2, B, H) their initial states; each chain the
    cell's plain loop (xp (B, S, G H), W_hh (G H, H))."""
    loop = _PLAIN_LOOPS[_birnn_cell(cell)]
    y_f = loop(xp_f, h0s[0], w_hh_f, b_hh_f)
    y_b = loop(xp_b.flip(1), h0s[1], w_hh_b, b_hh_b).flip(1)
    return torch.cat([y_f, y_b], dim=-1)


def birnn_layer_bwd_plain(
    dy: torch.Tensor, y: torch.Tensor, w_hh_f: torch.Tensor, w_hh_b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What B.9's backward computes: (dpre_f, dpre_b (B, S, H) in xp's time
    order, dh0s (2, B, H)), each chain's dh chain over its flipped halves."""
    h = w_hh_f.shape[0]
    dpre_f, dh0_f = dh_chain_tanh_plain(dy[..., :h], y[..., :h], None, w_hh_f)
    dpre_b, dh0_b = dh_chain_tanh_plain(dy[..., h:].flip(1), y[..., h:].flip(1), None, w_hh_b)
    return dpre_f, dpre_b.flip(1), torch.stack([dh0_f, dh0_b])


def _gru_chain_fwd_launch(xp, h0, w_hh, b_hh, y, offset: int, reverse: bool, saved) -> None:
    """One launch of B.13's gru chain forward: the chain's columns [offset,
    offset + H) of y (B, S, W), run from the last step down when
    ``reverse``; its gates into ``saved`` (B, S, 4H) unless None."""
    b, s, gh = xp.shape
    h = gh // 3
    kernels.require_cuda_tensor("xp", xp, torch.float32, 3)
    kernels.require_cuda_tensor("y", y, torch.float32, 3)
    _check_gated("gru chain forward", "gru", b, h, (h0,), w_hh, b_hh)
    if saved is not None:
        kernels.require_cuda_tensor("saved", saved, torch.float32, 3)
    if gh != 3 * h or y.shape[:2] != (b, s) or offset + h > y.shape[2] or (
            saved is not None and saved.shape != (b, s, SAVED["gru"] * h)):
        raise ValueError(f"gru chain forward: xp {tuple(xp.shape)}, y {tuple(y.shape)} (columns [{offset}, "
                         f"{offset + h})), saved {None if saved is None else tuple(saved.shape)} do not fit")
    plan = gated_device_plan("gru", h, b, s, _index(xp.device), False, saved is not None, True)
    kernels.RNN_GRU_CHAIN_FWD(xp.device, xp.data_ptr(), h0.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                              y.data_ptr(), None, _ptr(saved), b, s, h, int(reverse), y.shape[2], offset,
                              *plan.c_args())


def _gru_chain_bwd_launch(dy, y, h0, saved, w_hh, dxp, dhp, dh0, offset: int, reverse: bool) -> None:
    """One launch of B.13's gru dh chain over the chain's columns [offset,
    offset + H) of dy and y (B, S, W); dxp, dhp (B, S, 3H) and dh0 its own."""
    b, s, h4 = saved.shape
    h = h4 // SAVED["gru"]
    for name, t in (("dy", dy), ("y", y), ("saved", saved)):
        kernels.require_cuda_tensor(name, t, torch.float32, 3)
    _check_gated("gru chain dh chain", "gru", b, h, (h0,), w_hh)
    if dy.shape != y.shape or y.shape[:2] != (b, s) or offset + h > y.shape[2]:
        raise ValueError(f"gru chain dh chain: dy {tuple(dy.shape)}, y {tuple(y.shape)} have no columns "
                         f"[{offset}, {offset + h}) for saved {tuple(saved.shape)}")
    plan = gated_device_plan("gru", h, b, s, _index(y.device), True, False, True)
    kernels.RNN_GRU_CHAIN_BWD(y.device, dy.data_ptr(), None, y.data_ptr(), h0.data_ptr(), saved.data_ptr(),
                              w_hh.data_ptr(), _w_t_scratch(w_hh).data_ptr(), dxp.data_ptr(), dhp.data_ptr(),
                              dh0.data_ptr(), b, s, h, int(reverse), y.shape[2], offset, *plan.c_args())


def birnn_layer_fwd(xp_f, xp_b, h0s, w_hh_f, w_hh_b, b_hh_f, b_hh_b, cell: str = "rnn_tanh",
                    saved: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One bidirectional layer's forward, y (B, S, 2H): the forward chain
    into columns [0, H) and the reverse chain into [H, 2H); on CUDA tensors
    two launches of the cell's chain kernel (B.8's for tanh, B.13's for relu
    and gru), on CPU tensors their plain versions (``tanh_chain_fwd_plain``,
    ``relu_chain_fwd_plain``, ``gru_chain_fwd_plain``). A gru layer writes
    each chain's gates into ``saved`` (2, B, S, 4H) when it is given."""
    b, s = xp_f.shape[:2]
    h = w_hh_f.shape[1]
    if _birnn_cell(cell) != "gru" and saved is not None:
        raise ValueError(f"a {cell} layer saves no gates")
    y = torch.empty((b, s, 2 * h), dtype=xp_f.dtype, device=xp_f.device)
    chains = ((xp_f, h0s[0], w_hh_f, b_hh_f, 0, False), (xp_b, h0s[1], w_hh_b, b_hh_b, h, True))
    for d, (xp, h0, w_hh, b_hh, offset, reverse) in enumerate(chains):
        sv = None if saved is None else saved[d]
        if y.device.type == "cpu":
            if cell == "gru":
                gru_chain_fwd_plain(xp, h0, w_hh, b_hh, y, offset, reverse, sv)
            else:
                _act_chain_fwd(torch.tanh if cell == "rnn_tanh" else torch.relu, xp, h0, w_hh, b_hh, y, offset,
                               reverse)
        elif cell == "gru":
            _gru_chain_fwd_launch(xp, h0, w_hh, b_hh, y, offset, reverse, sv)
        else:
            _chain_fwd_launch(xp, h0, w_hh, b_hh, y, offset, reverse, None, cell)
    if y.device.type != "cpu" and cell == "rnn_tanh":
        kernels.BIRNN_TANH_FWD.launches += 1
    return y


def birnn_layer_bwd(dy, y, w_hh_f, w_hh_b, cell: str = "rnn_tanh", h0s=None, saved=None):
    """One bidirectional layer's backward, each chain's dh chain reading its
    half of dy and y: (dxp_f, dxp_b (B, S, G H) in xp's time order, dh0s
    (2, B, H), dhp_f, dhp_b), dhp the gradient of hp = h W_hh^T + b_hh (the
    relu and tanh cells' dxp; the gru's from ``h0s`` and the forward's
    ``saved`` gates). On CUDA tensors two launches of the cell's dh chain
    kernel, on CPU tensors their plain versions."""
    b, s, h2 = y.shape
    h = h2 // 2
    if _birnn_cell(cell) == "gru" and (h0s is None or saved is None):
        raise ValueError("a gru layer's backward needs h0s and the forward's saved gates")
    dy = dy.contiguous()
    g = GATES.get(cell, 1)
    dxp = torch.empty((2, b, s, g * h), dtype=y.dtype, device=y.device)
    dhp = torch.empty_like(dxp) if cell == "gru" else dxp
    dh0s = torch.empty((2, b, h), dtype=y.dtype, device=y.device)
    for d, w_hh in enumerate((w_hh_f, w_hh_b)):
        offset, reverse = d * h, d == 1
        if y.device.type == "cpu":
            if cell == "gru":
                dxp[d], dhp[d], dh0s[d] = gru_chain_bwd_plain(dy, None, y, h0s[d], saved[d], w_hh, offset, reverse)
            else:
                grad = _tanh_grad if cell == "rnn_tanh" else _relu_grad
                dxp[d], dh0s[d] = _dh_chain(dy, y, None, w_hh, grad, offset, reverse)
        elif cell == "gru":
            _gru_chain_bwd_launch(dy, y, h0s[d], saved[d], w_hh, dxp[d], dhp[d], dh0s[d], offset, reverse)
        else:
            _chain_bwd_launch(dy, y, None, w_hh, dxp[d], dh0s[d], offset, reverse, cell)
    if y.device.type != "cpu" and cell == "rnn_tanh":
        kernels.BIRNN_TANH_BWD.launches += 1
    return dxp[0], dxp[1], dh0s, dhp[0], dhp[1]


class _BiRnnLayer(torch.autograd.Function):
    """Forward: ``birnn_layer_fwd`` (a gru layer saving its gates).
    Backward: ``birnn_layer_bwd``, then each chain's weight and bias
    gradients as one product and one sum."""

    @staticmethod
    def forward(ctx, xp_f, xp_b, h0s, w_hh_f, w_hh_b, b_hh_f, b_hh_b, cell):
        b, s = xp_f.shape[:2]
        h = w_hh_f.shape[1]
        saved = xp_f.new_empty(2, b, s, SAVED["gru"] * h) if cell == "gru" else None
        with record_function(BIRNN_SPANS["forward"]):
            y = birnn_layer_fwd(xp_f, xp_b, h0s, w_hh_f, w_hh_b, b_hh_f, b_hh_b, cell, saved)
        ctx.cell = cell
        ctx.save_for_backward(y, h0s, w_hh_f, w_hh_b, saved)
        return y

    @staticmethod
    def backward(ctx, dy):
        y, h0s, w_hh_f, w_hh_b, saved = ctx.saved_tensors
        h = w_hh_f.shape[1]
        with record_function(BIRNN_SPANS["backward"]):
            dxp_f, dxp_b, dh0s, dhp_f, dhp_b = birnn_layer_bwd(dy, y, w_hh_f, w_hh_b, ctx.cell, h0s, saved)
        dw_f, db_f = recurrence_weight_grads(dhp_f, h0s[0], y[..., :h], spans=BIRNN_SPANS)
        dw_b, db_b = recurrence_weight_grads(dhp_b, h0s[1], y[..., h:], reverse=True, spans=BIRNN_SPANS)
        return dxp_f, dxp_b, dh0s, dw_f, dw_b, db_f, db_b, None


def birnn_layer(
    xp_f: torch.Tensor, xp_b: torch.Tensor, h0s: torch.Tensor, w_hh_f: torch.Tensor, w_hh_b: torch.Tensor,
    b_hh_f: torch.Tensor, b_hh_b: torch.Tensor, cell: str = "rnn_tanh",
) -> torch.Tensor:
    """One bidirectional layer of the tanh (B.9), relu or gru (B.13) cell:
    (B, S, 2H), through ``_BiRnnLayer`` where a gradient is wanted
    (differentiable in all seven inputs), else ``birnn_layer_fwd``, which
    saves no gates."""
    if _needs_grad(xp_f, xp_b, h0s, w_hh_f, w_hh_b, b_hh_f, b_hh_b):
        return _BiRnnLayer.apply(xp_f, xp_b, h0s, w_hh_f, w_hh_b, b_hh_f, b_hh_b, _birnn_cell(cell))
    with record_function(BIRNN_SPANS["forward"]):
        return birnn_layer_fwd(xp_f, xp_b, h0s, w_hh_f, w_hh_b, b_hh_f, b_hh_b, cell)
