"""The decoder RNN's relu recurrence (port of hulc_tpu/models/layers.py:233-267).

One layer, with the input projection ``xp`` (B, S, H) computed before the
loop (``b_ih`` in it) and ``w_hh`` in torch ``nn.RNN`` layout (H_out, H_in):
``y_t = relu(xp_t + h_{t-1} w_hh^T + b_hh)`` from ``h_{-1} = h0``. The
relu's gradient is the JAX package's custom VJP, ``g * (y > 0)``: 0 at
exactly 0.

``rnn_relu`` is a ``torch.autograd.Function`` whose forward is the
``hulc::rnn_relu_fwd`` op (``ops.library``): on CUDA tensors
``csrc/rnn_relu.cu``'s forward (one launch a layer: the split-K cluster
kernel over the sequence, or the one-step GEMV at a serving lane). Its
backward is that file's dh-chain kernel, then dW_hh as ONE matrix product
over all S * B rows, ``dpre^T [h0, y_{:-1}]``, and db_hh as dpre's sum
(``recurrence_weight_grads``). ``recurrence_plan`` chooses each launch's
kernel, cluster size, k-split, columns and shared memory, once per shape
(``device_plan``, cached), and csrc/rnn_relu.cu checks it against the card
then. Each part runs inside a
``record_function`` span (``SPANS``) so a profile can find it. On CPU
tensors the forward and the dh chain take the plain versions below:
``rnn_relu_fwd_plain`` is the loop, ``rnn_relu_bwd_plain`` the closed form
the backward computes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from hulc_tpu_torch import kernels

# csrc/rnn_relu.cu's geometry
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
    """One launch of ``csrc/rnn_relu.cu``, in the order its entry points take
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
    """csrc/rnn_relu.cu ``sequence_smem_bytes``: the W slice (whole chunks
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
def device_plan(hidden: int, batch: int, seq: int, index: int, backward: bool) -> RecurrencePlan:
    """``recurrence_plan`` for CUDA device ``index``, from what the runtime
    reports, checked by csrc/rnn_relu.cu against the card. Made once per
    shape: a launch only looks it up."""
    plan = recurrence_plan(hidden, batch, seq, *kernels.device_limits(index),
                           kernels.cluster_limits(index, CLUSTERS), backward)
    kernels.check_rnn_relu_plan(index, backward, batch, seq, hidden, plan.c_args())
    return plan


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


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
