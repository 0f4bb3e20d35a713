"""Shared building blocks (port of hulc_tpu/models/layers.py:25-142, 161-281).

``MLP`` builds the Linear/activation stacks under the reference's
``nn.Sequential`` indices, so state_dict keys such as ``mlp.0`` or
``fc_model.2`` line up with the reference checkpoints. ``ScanRNN`` is a
multi-layer relu (the decoder), tanh, gru or lstm RNN with an explicit
carry, (num_layers, B, H), or for lstm the pair (h, c) of that shape: the
input projection of every time step (G H wide, G the cell's gates) runs as
one matmul before the recurrence (``act(x_t W_ih + b_ih + h W_hh + b_hh)``,
or the gated cells' gate math). Each layer's recurrence is
``ops.recurrence.rnn_relu`` / ``rnn_tanh`` / ``rnn_gru`` / ``rnn_lstm``: on
CUDA tensors one launch of a hand-written kernel, forward and backward; on
CPU tensors the plain loop forward and the closed-form backward. With
``use_kernels=False`` it is the plain loop of one fp32 ``addmm`` per step,
differentiated by autograd. ``ScanBiRNN`` is MCIL's bidirectional tanh,
relu or gru RNN (port of layers.py:284-313): per layer both input
projections as plain matmuls, then ``ops.recurrence.birnn_layer``, the two
chains into one (B, S, 2H) output, which feeds the next layer. Both RNNs
take JAX's ``dropout`` between layers (not after the last), eagerly,
outside the recurrence. ``TransformerEncoder`` is the plan recognition
network's post-LN encoder, under torch ``nn.TransformerEncoder``'s
parameter names, with JAX's optional final LayerNorm.

Compute dtype (``HulcConfig.compute_dtype``): parameters stay fp32, and
``Linear`` / ``Conv2d`` compute as flax's ``nn.Dense`` / ``nn.Conv`` with
``dtype=``: input, weight and bias cast to the compute dtype at use, the
product rounded to it, then the bias added in it (two roundings: a bias
fused into the product, rounded once, is measurably another result). A
layer whose output goes straight into fp32 arithmetic (a LayerNorm, a
residual add, a mean or loss taken in fp32) adds its bias in fp32,
unrounded (``fp32_out``): XLA fuses that bias add into the fp32 consumer,
so the JAX package keeps no bf16 rounding there. Every bf16 product
(``lowp_product``) accumulates in fp32 and rounds once: on CUDA the bf16
kernels do; on the CPU it is taken in fp32 on the rounded operands, since
PyTorch's CPU bf16 convolution rounds partial sums. Each module takes
``dtype`` where its JAX counterpart does; LayerNorms run on fp32 input,
and the recurrences on the input projection cast back to fp32 (JAX's
``ScanRNN`` scans ``x_proj.astype(float32)`` with fp32 weights and
carry). In fp32 nothing is cast, so the fp32 path is the same code as
before.

``Dropout`` draws its mask from an explicit ``torch.Generator`` (set with
``set_dropout_generator``), as every random draw of the port does, and
keeps flax's semantics: ``where(keep, x / keep_prob, 0)``, with a mask of
``x``'s shape unless ``broadcast_dims`` names axes that share it. Its masks
can also be given as tensors, site by site (``feed_dropout_masks``: a
module name and the masks of its calls, in order), so that a test can
hand the port the masks JAX is given. The decoder's ``mlp`` cell is no
RNN: ``ScanRNN`` refuses it, as JAX's does, and the decoder builds an
``MLP`` for it (``models.decoders``). The bidirectional lstm cell waits
for a later slice.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from hulc_tpu_torch.ops.recurrence import (
    BIRNN_CELLS,
    GATES,
    birnn_layer,
    birnn_layer_plain,
    rnn_gru,
    rnn_gru_fwd_plain,
    rnn_lstm,
    rnn_lstm_fwd_plain,
    rnn_relu,
    rnn_relu_fwd_plain,
    rnn_tanh,
    rnn_tanh_fwd_plain,
)
from hulc_tpu_torch.parallel import mesh

# cell: (the layer through the kernels, the plain loop)
RECURRENCES = {"rnn": (rnn_relu, rnn_relu_fwd_plain), "rnn_tanh": (rnn_tanh, rnn_tanh_fwd_plain),
               "gru": (rnn_gru, rnn_gru_fwd_plain), "lstm": (rnn_lstm, rnn_lstm_fwd_plain)}
GATE_MULTIPLE = {"rnn": 1, "rnn_tanh": 1, **GATES}
# a carry: (L, B, H), or lstm's pair (h, c) of that shape
Carry = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]

ACTIVATIONS = {
    "relu": nn.ReLU,
    "elu": nn.ELU,
    "gelu": lambda: nn.GELU(approximate="tanh"),  # flax's nn.gelu default
    "tanh": nn.Tanh,
}


class Dropout(nn.Module):
    """Dropout with an explicit generator; a no-op in eval mode or at p=0.
    While ``masks`` holds tensors (``feed_dropout_masks``), each training-mode
    call takes the next of them as its keep mask (True: kept), of the shape
    it would draw, instead of drawing one."""

    def __init__(self, p: float, broadcast_dims: Tuple[int, ...] = ()):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = p
        self.broadcast_dims = broadcast_dims
        self.generator: Optional[torch.Generator] = None
        self.masks: Optional[List[torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = [1 if d in self.broadcast_dims else n for d, n in enumerate(x.shape)]
        keep_prob = 1.0 - self.p
        # a mask of the batch's rows is the global batch's, cut to this rank's
        # rows under parallel.mesh.sharded_rows; one shared over the batch is used whole
        per_row = 0 not in self.broadcast_dims
        if self.masks is not None:
            if not self.masks:
                raise RuntimeError("this dropout site was fed fewer masks than it was called")
            keep = self.masks.pop(0).to(x.device)
            keep = mesh.local_rows(keep) if per_row else keep
            if list(keep.shape) != shape:
                raise ValueError(f"a fed dropout mask has shape {tuple(keep.shape)}, not {tuple(shape)}")
        elif self.generator is None:
            raise RuntimeError("training-mode dropout needs a generator: call set_dropout_generator")
        else:
            def draw(s):
                return torch.empty(s, device=x.device).bernoulli_(keep_prob, generator=self.generator)

            keep = mesh.draw_rows(draw, shape) if per_row else draw(shape)
        # flax divides by keep_prob in x's type: a bf16 x by bf16(keep_prob)
        scale = keep_prob if x.dtype == torch.float32 else float(torch.tensor(keep_prob, dtype=x.dtype))
        return torch.where(keep.bool(), x / scale, torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def cast(dtype: torch.dtype, *tensors: Optional[torch.Tensor]) -> Tuple[Optional[torch.Tensor], ...]:
    """Each tensor in ``dtype`` (a tensor already in it, or None, as it is)."""
    return tuple(t if t is None or t.dtype == dtype else t.to(dtype) for t in tensors)


def lowp_product(fn, a: torch.Tensor, b: torch.Tensor, **kwargs) -> torch.Tensor:
    """``fn(a, b, **kwargs)`` (``F.linear``, ``F.conv2d``, ``torch.matmul``)
    of two bf16 operands, accumulated in fp32 and rounded once to bf16: on a
    CUDA tensor the bf16 kernel itself; on a CPU tensor ``fn`` in fp32 of
    the same values, which is that arithmetic exactly (PyTorch's CPU bf16
    convolution rounds partial sums; XLA's does not)."""
    if a.device.type == "cpu":
        return fn(a.float(), b.float(), **kwargs).to(a.dtype)
    return fn(a, b, **kwargs)


def dense(dtype: torch.dtype, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x W^T + b`` as flax's ``nn.Dense(dtype=)``: in fp32 one fused
    call; in another dtype the product rounded to it, then the bias added."""
    x, weight, bias = cast(dtype, x, weight, bias)
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    return lowp_product(F.linear, x, weight) + bias


def dense_to_fp32(dtype: torch.dtype, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``dense`` whose result goes straight into fp32 arithmetic (a residual
    add, a mean taken in fp32): the product rounded to ``dtype``, the bias
    added in fp32, unrounded, as XLA fuses that bias add into its fp32
    consumer. In fp32, ``dense``."""
    if dtype == torch.float32:
        return dense(dtype, x, weight, bias)
    x, weight, bias = cast(dtype, x, weight, bias)
    return lowp_product(F.linear, x, weight).float() + bias.float()


class Linear(nn.Linear):
    """``nn.Linear`` computed in ``dtype`` as flax's ``nn.Dense(dtype=)``
    (``dense``; with ``fp32_out``, ``dense_to_fp32``), fp32 parameters (the
    state_dict's names and types are ``nn.Linear``'s)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32,
                 fp32_out: bool = False):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.fp32_out = fp32_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (dense_to_fp32 if self.fp32_out else dense)(self.compute_dtype, x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (VALID) computed in ``dtype`` as flax's ``nn.Conv(dtype=)``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = cast(self.compute_dtype, x, self.weight, self.bias)
        if self.compute_dtype == torch.float32:
            return self._conv_forward(x, weight, bias)
        return lowp_product(F.conv2d, x, weight, stride=self.stride) + bias[:, None, None]


def l2_normalized(x: torch.Tensor) -> torch.Tensor:
    """``x`` over its fp32 L2 norm along the last axis (JAX's ``x /
    jnp.linalg.norm(x.astype(float32), axis=-1, keepdims=True)``), fp32."""
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every ``Dropout`` under ``module`` the generator it draws from."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def feed_dropout_masks(module: nn.Module, masks: Optional[Dict[str, Sequence[torch.Tensor]]]) -> None:
    """Give each ``Dropout`` under ``module`` named in ``masks`` (its name in
    ``module.named_modules()``) the keep masks of its next calls, in call
    order; every other site draws from its generator. ``None`` takes every
    fed mask back. Raises on a name that is no Dropout site."""
    sites = {name: m for name, m in module.named_modules() if isinstance(m, Dropout)}
    unknown = sorted(set(masks or ()) - set(sites))
    if unknown:
        raise KeyError(f"no dropout site {unknown}; the sites are {sorted(sites)}")
    for name, m in sites.items():
        m.masks = None if masks is None or name not in masks else [torch.as_tensor(k).bool() for k in masks[name]]


def MLP(
    in_features: int,
    features: Sequence[int],
    activation: str = "relu",
    final_activation: bool = False,
    input_dropout: Optional[float] = None,
    dtype: torch.dtype = torch.float32,
    fp32_out: bool = False,
) -> nn.Sequential:
    """Linear layers (in ``dtype``) with an activation after each but the
    last (unless ``final_activation``); ``input_dropout`` puts a Dropout at
    index 0, as the reference's language heads have; ``fp32_out``: the last
    layer's output goes into fp32 arithmetic (``Linear``)."""
    layers = [] if input_dropout is None else [Dropout(input_dropout)]
    for i, feat in enumerate(features):
        layers.append(Linear(in_features, feat, dtype, fp32_out and i == len(features) - 1))
        if i < len(features) - 1 or final_activation:
            layers.append(ACTIVATIONS[activation]())
        in_features = feat
    return nn.Sequential(*layers)


def _rnn_params(module: nn.Module, k: int, suffix: str, input_size: int, hidden_size: int, gates: int = 1) -> None:
    """Layer k's parameters under torch ``nn.RNN`` / ``nn.GRU`` / ``nn.LSTM``'s
    names, ``gates`` gate blocks of ``hidden_size`` rows each."""
    rows = gates * hidden_size
    module.register_parameter(f"weight_ih_l{k}{suffix}", nn.Parameter(torch.empty(rows, input_size)))
    module.register_parameter(f"weight_hh_l{k}{suffix}", nn.Parameter(torch.empty(rows, hidden_size)))
    module.register_parameter(f"bias_ih_l{k}{suffix}", nn.Parameter(torch.empty(rows)))
    module.register_parameter(f"bias_hh_l{k}{suffix}", nn.Parameter(torch.empty(rows)))


def input_projection(dtype: torch.dtype, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A recurrence's input projection, computed in ``dtype`` and scanned in
    fp32 (JAX's ``x_proj.astype(float32)``)."""
    return dense(dtype, x, weight, bias).float()


class ScanRNN(nn.Module):
    """Multi-layer relu (``cell="rnn"``), tanh (``"rnn_tanh"``), gru or lstm
    RNN over (B, S, F) with an explicit carry: (L, B, H), or for lstm the
    pair (h, c) of that shape.

    Parameters carry torch ``nn.RNN`` / ``nn.GRU`` / ``nn.LSTM``'s names and
    shapes (``weight_ih_l{k}`` (G H, F), ``weight_hh_l{k}`` (G H, H),
    ``bias_ih_l{k}``, ``bias_hh_l{k}`` (G H), G the cell's gates: r z n,
    i f g o, JAX's order and torch's). ``use_kernels=False`` runs the plain
    loop on any device; it exists to hold the kernels against it on the
    card. The decoder's ``mlp`` cell is refused, as JAX's ``ScanRNN``
    refuses it: the decoder builds an ``MLP`` for it. The input projection runs in ``dtype`` and is cast to fp32
    before the recurrence, which is fp32 whatever ``dtype`` is. ``dropout``
    acts on each layer's output but the last (``dropouts.{k}``).
    """

    def __init__(
        self, input_size: int, hidden_size: int, num_layers: int = 2, cell: str = "rnn", use_kernels: bool = True,
        dtype: torch.dtype = torch.float32, dropout: float = 0.0,
    ):
        super().__init__()
        if cell == "mlp":
            raise ValueError("use MLP module for the mlp decoder variant")
        if cell not in RECURRENCES:
            raise ValueError(f"rnn cell {cell!r} is not ported yet; only {sorted(RECURRENCES)} are")
        self.cell = cell
        self.use_kernels = use_kernels
        self.dtype = dtype
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        for k in range(num_layers):
            _rnn_params(self, k, "", input_size if k == 0 else hidden_size, hidden_size, GATE_MULTIPLE[cell])
        self.dropouts = nn.ModuleList(Dropout(dropout) for _ in range(num_layers - 1))

    def init_carry(self, batch_size: int, device=None) -> Carry:
        """The zero carry: (L, B, H), or lstm's pair of them."""
        h = torch.zeros(self.num_layers, batch_size, self.hidden_size, device=device)
        return (h, torch.zeros_like(h)) if self.cell == "lstm" else h

    def forward(self, x: torch.Tensor, carry: Optional[Carry] = None) -> Tuple[torch.Tensor, Carry]:
        """x (B, S, F), carry or None (zeros) -> (outputs (B, S, H), carry)."""
        if carry is None:
            carry = self.init_carry(x.shape[0], x.device)
        lstm = self.cell == "lstm"
        recurrence, plain = RECURRENCES[self.cell]
        out = x
        finals, cells = [], []
        for k in range(self.num_layers):
            w_hh = getattr(self, f"weight_hh_l{k}")
            b_hh = getattr(self, f"bias_hh_l{k}")
            w_ih, b_ih = getattr(self, f"weight_ih_l{k}"), getattr(self, f"bias_ih_l{k}")
            x_proj = input_projection(self.dtype, out, w_ih, b_ih)
            state = (carry[0][k], carry[1][k]) if lstm else (carry[k],)
            if self.use_kernels:
                out, h, *c = recurrence(x_proj, *(s.contiguous() for s in state), w_hh, b_hh)
            else:
                out, *c = plain(x_proj, *state, w_hh, b_hh) if lstm else (plain(x_proj, *state, w_hh, b_hh),)
                h = out[:, -1]
            if k < self.num_layers - 1:
                out = self.dropouts[k](out)
            finals.append(h)
            cells.extend(c)
        return out, (torch.stack(finals), torch.stack(cells)) if lstm else torch.stack(finals)


class ScanBiRNN(nn.Module):
    """Multi-layer bidirectional tanh (``cell="rnn_tanh"``), relu (``"rnn"``)
    or gru RNN over (B, S, F) -> (B, S, 2H), from zero states: each layer a
    forward chain and a time-reversed chain, concatenated, the next layer's
    input (torch ``nn.RNN`` / ``nn.GRU(bidirectional=True)`` semantics and
    parameter names, the reverse chain's with ``_reverse``). ``dropout``
    acts on each layer's output but the last (``dropouts.{k}``).
    ``use_kernels=False`` runs JAX's flip-and-concatenate definition
    (``birnn_layer_plain``) on any device; it exists to hold the kernels
    against it on the card. The input projections run in ``dtype``, the
    chains in fp32, as ``ScanRNN``'s. The lstm cell, which JAX's
    ``ScanBiRNN`` would take but its config does not name, is refused
    (ROADMAP.md, section C)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2, cell: str = "rnn_tanh",
                 use_kernels: bool = True, dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        if cell not in BIRNN_CELLS:
            raise ValueError(f"bidirectional rnn cell {cell!r} is not ported yet; only {list(BIRNN_CELLS)} are "
                             f"(ROADMAP.md, section C)")
        self.cell = cell
        self.use_kernels = use_kernels
        self.dtype = dtype
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        for k in range(num_layers):
            for suffix in ("", "_reverse"):
                _rnn_params(self, k, suffix, input_size if k == 0 else 2 * hidden_size, hidden_size,
                            GATE_MULTIPLE[cell])
        self.dropouts = nn.ModuleList(Dropout(dropout) for _ in range(num_layers - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = birnn_layer if self.use_kernels else birnn_layer_plain
        h0s = x.new_zeros(2, x.shape[0], self.hidden_size, dtype=torch.float32)
        out = x
        for k in range(self.num_layers):
            p = {name: getattr(self, f"{name}_l{k}") for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
            r = {name: getattr(self, f"{name}_l{k}_reverse") for name in p}
            out = layer(input_projection(self.dtype, out, p["weight_ih"], p["bias_ih"]),
                        input_projection(self.dtype, out, r["weight_ih"], r["bias_ih"]),
                        h0s, p["weight_hh"], r["weight_hh"], p["bias_hh"], r["bias_hh"], self.cell)
            if k < self.num_layers - 1:
                out = self.dropouts[k](out)
        return out


def softmax(scores: torch.Tensor) -> torch.Tensor:
    """The softmax over the last axis in ``scores``' type. In fp32 one
    call; in bf16 as the JAX package computes ``jax.nn.softmax`` of a bf16
    array: ``x - max(x)`` rounded, its exp in fp32, the sum of those fp32
    exps rounded, and the exps rounded, then divided by the sum."""
    if scores.dtype == torch.float32:
        return torch.softmax(scores, dim=-1)
    e = torch.exp((scores - scores.amax(dim=-1, keepdim=True)).float())
    return e.to(scores.dtype) / e.sum(dim=-1, keepdim=True).to(scores.dtype)


class MultiheadSelfAttention(nn.Module):
    """Self-attention under torch ``nn.MultiheadAttention``'s parameter names
    (``in_proj_weight`` (3d, d), ``in_proj_bias``, ``out_proj``), computed as
    flax's ``MultiHeadDotProductAttention``: queries scaled by 1/sqrt(head
    dim), a softmax, and dropout on the attention weights with one mask
    shared over the batch and the heads (flax's ``broadcast_dropout``).
    Everything runs in ``dtype``, the softmax too (flax's
    ``force_fp32_for_softmax`` is False), as the JAX package computes it:
    in bf16 the queries are multiplied by the fp32 reciprocal of bf16's
    sqrt(head dim) (XLA's rewrite of the divide), the softmax is
    ``softmax``'s, and the output projection adds its bias in fp32
    (``fp32_out``): the output is fp32, which the residual add reads."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype, fp32_out=True)
        self.dropout = Dropout(dropout, broadcast_dims=(0, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        q, k, v = dense(self.dtype, x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, s, h, d // h).transpose(1, 2) for t in (q, k, v))
        if self.dtype == torch.float32:
            q = q / math.sqrt(d // h)
        else:  # XLA multiplies by the fp32 reciprocal of the bf16 divisor
            q = q * float(1.0 / torch.tensor(math.sqrt(d // h), dtype=self.dtype).float())
        mm = torch.matmul if self.dtype == torch.float32 else functools.partial(lowp_product, torch.matmul)
        scores = mm(q, k.transpose(-1, -2))  # (B, h, S, S)
        weights = self.dropout(softmax(scores))
        out = mm(weights, v).transpose(1, 2).reshape(b, s, d)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer (torch ``nn.TransformerEncoderLayer``):
    x -> LN(x + Dropout(SelfAttn(x))) -> LN(x + Dropout(FF(x))), relu FF with
    dropout after the activation, LayerNorm eps 1e-5. Attention and FF run
    in ``dtype``, their last bias adds in fp32 (``fp32_out``) on the way
    into the fp32 residual stream, so the LayerNorms run in fp32, as
    flax's ``LayerNorm(dtype=float32)``."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, num_heads, dropout, dtype)
        self.linear1 = Linear(d_model, dim_feedforward, dtype)
        self.dropout = Dropout(dropout)
        self.linear2 = Linear(dim_feedforward, d_model, dtype, fp32_out=True)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.dropout1(self.self_attn(x)))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(x))))
        return self.norm2(x + self.dropout2(ff))


class TransformerEncoder(nn.Module):
    """A stack of post-LN encoder layers under the key ``layers.{i}``, and
    with ``final_norm`` a LayerNorm after them (``final_norm``, JAX's
    ``encoder_normalize``)."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int, dim_feedforward: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, final_norm: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, dim_feedforward, dropout, dtype) for _ in range(num_layers)
        )
        self.final_norm = nn.LayerNorm(d_model, eps=1e-5) if final_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x if self.final_norm is None else self.final_norm(x)
