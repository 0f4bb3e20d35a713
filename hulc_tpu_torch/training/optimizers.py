"""The optimizers of the JAX trainer (hulc_tpu/training/trainer.py:183-194)
and the global gradient norm (hulc_tpu/training/trainer.py:258).

Each is an optax chain ending in ``scale_by_learning_rate(lr)``, as a
``torch.optim.Optimizer`` whose ``step()`` returns ``optax.global_norm`` of
the gradients it applied (0-d fp32 on the parameters' device):

* ``AdamLowp``: ``scale_by_adam_lowp()`` (hulc_tpu/training/optimizers.py:24-87),
  Adam with its two moments stored in bfloat16, the JAX trainer's default;
* ``Adam``: ``optax.adam``, the same with fp32 moments (``adam_mv_dtype=float32``);
* ``AdamW``: ``optax.adamw(lr, weight_decay=1e-6)``: ``scale_by_adam``, then
  ``add_decayed_weights`` (every tensor decays), then the learning rate;
* ``SGD``: ``optax.sgd(lr, momentum=0.9)``: ``trace(decay=0.9)``, then the
  learning rate.

Every update is computed in fp32, in the optax order

    adam:  m' = m * b1 + (1 - b1) * g        v' = v * b2 + (1 - b2) * (g * g)
           p' = p + (-lr) * ((m' / c1) / (sqrt(v' / c2) + eps))
    adamw: p' = p + (-lr) * ((m' / c1) / (sqrt(v' / c2) + eps) + wd * p)
    sgd:   t' = g + momentum * t              p' = p + (-lr) * t'

with c1 = 1 - b1^t, c2 = 1 - b2^t at step t (from 1) and lr the schedule's
value at t - 1 (optax's ``scale_by_schedule`` reads the count before the
step); AdamLowp rounds m' and v' to bf16 on write-back. On CUDA parameters
one launch of the hand-written kernel ``csrc/adam_lowp.cu`` (an instance of
its template per optimizer: B.5 for AdamLowp, B.5' for the others) updates
every tensor of a parameter group and writes per-block sums of g^2, which a
second, one-block launch reduces to the norm. The update launch reads a
device table of the parameters' and moments' addresses that is built, and
uploaded from pinned memory, only when one of them or a size changes
(``PointerTable``), and takes the gradients' addresses, which autograd
changes every step, by value. On CPU parameters (or with
``use_kernels=False``) the plain versions below run tensor by tensor. A
parameter without a gradient is updated with a zero gradient, as optax
updates every leaf. ``checkpoint_state()`` names the optimizer's kind, and
``load_checkpoint_state`` refuses the state of another kind.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch.profiler import record_function

from hulc_tpu_torch import kernels
from hulc_tpu_torch.parallel import mesh

Schedule = Union[float, Callable[[int], float]]
ELEMS_PER_BLOCK = 8192  # elements of one tensor per block of the kernel's grid
MAX_GRADS_PER_LAUNCH = 448  # gradient addresses one launch takes by value (csrc/adam_lowp.cu kMaxGrads)
FINISH_THREADS = 1024  # threads of the one-block finish launch (csrc/adam_lowp.cu kFinishThreads)
# the record_function span around every optimizer's step, so a profile can find the optimizer tail
OPTIMIZER_SPAN = "hulc::adam_lowp_step"
ADAMW_WEIGHT_DECAY = 1e-6  # the JAX trainer's optax.adamw(weight_decay=1e-6)
SGD_MOMENTUM = 0.9  # the JAX trainer's optax.sgd(momentum=0.9)


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """(1 - b1^count, 1 - b2^count), each computed in fp32 and returned as
    the Python float of that fp32 value."""
    t = torch.tensor(float(count), dtype=torch.float32)

    def c(b):
        return float(1.0 - torch.pow(torch.tensor(b, dtype=torch.float32), t))

    return c(b1), c(b2)


def adam_update_plain(
    p: torch.Tensor, g: Optional[torch.Tensor], m: torch.Tensor, v: torch.Tensor,
    b1: float, b2: float, eps: float, neg_lr: float, c1: float, c2: float, weight_decay: Optional[float] = None,
) -> None:
    """Plain PyTorch version of one tensor's Adam update (AdamW's with
    ``weight_decay``), in place; the moments are stored back in their own
    dtype (bf16 for AdamLowp, fp32 for Adam and AdamW); a ``None`` gradient
    is zeros. The bias corrections divide as device tensors: dividing by a
    Python scalar may run as a multiply by its reciprocal, which is not the
    optax division."""
    c1_t = torch.tensor(c1, dtype=torch.float32, device=p.device)
    c2_t = torch.tensor(c2, dtype=torch.float32, device=p.device)
    g32 = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
    m32 = m.float() * b1 + (1.0 - b1) * g32
    v32 = v.float() * b2 + (1.0 - b2) * (g32 * g32)
    u = (m32 / c1_t) / (torch.sqrt(v32 / c2_t) + eps)
    if weight_decay is not None:
        u = u + weight_decay * p
    p.add_(u * neg_lr)
    m.copy_(m32.to(m.dtype))
    v.copy_(v32.to(v.dtype))


def sgd_update_plain(p: torch.Tensor, g: Optional[torch.Tensor], t: torch.Tensor, momentum: float, neg_lr: float) -> None:
    """Plain PyTorch version of one tensor's SGD-with-momentum update, in
    place (``optax.trace`` without Nesterov, then the learning rate); a
    ``None`` gradient is zeros."""
    g32 = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
    t32 = g32 + momentum * t
    p.add_(t32 * neg_lr)
    t.copy_(t32)


def global_norm(tensors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm); a
    ``None`` counts as zeros. Eager: three launches per tensor on CUDA."""
    present = [t for t in tensors if t is not None]
    if not present:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in present))


# ---------------------------------------------------------------------------
# the kernel's table and block plan
# ---------------------------------------------------------------------------


def vector_head(address: int, numel: int) -> int:
    """The scalar elements the kernel takes before a tensor's 4-element
    groups, from its p array's address: all four arrays sit at p's phase
    modulo 4 elements (the wrapper refuses others), so after ``head`` every
    group of each is aligned for one 16-byte (fp32) or 8-byte (bf16) access."""
    return min((4 - (address // 4) % 4) % 4, numel)


def blocks_of(numel: int, head: int) -> int:
    """Blocks of the kernel's grid a tensor takes: one per ``ELEMS_PER_BLOCK``
    elements of its 4-element groups after the head, at least one."""
    body = (numel - head) // 4 * 4
    return max(1, -(-body // ELEMS_PER_BLOCK))


def block_ranges(numel: int, head: int) -> List[Tuple[int, int]]:
    """The element range [begin, end) of each of a tensor's blocks: block 0
    also takes the head, the last block the tail (csrc/adam_lowp.cu)."""
    nb = blocks_of(numel, head)
    return [(0 if j == 0 else head + j * ELEMS_PER_BLOCK, numel if j == nb - 1 else head + (j + 1) * ELEMS_PER_BLOCK)
            for j in range(nb)]


def _address(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def phase(t: torch.Tensor) -> int:
    """A tensor's start modulo the kernel's 4-element groups."""
    return (t.data_ptr() // t.element_size()) % 4


def empty_at_phase(like: torch.Tensor, at: int, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An uninitialized contiguous tensor of ``like``'s shape (in ``dtype``)
    that starts at phase ``at``: a view into a buffer 4 elements longer."""
    dtype = like.dtype if dtype is None else dtype
    buf = torch.empty(like.numel() + 4, dtype=dtype, device=like.device)
    off = (at - phase(buf)) % 4
    return buf[off:off + like.numel()].view(like.shape)


def pointer_table_rows(
    params: List[torch.Tensor], ms: List[torch.Tensor], vs: List[Optional[torch.Tensor]]
) -> Tuple[List[List[int]], int]:
    """The kernel's table, one row per tensor with elements, (p, m, v
    addresses, numel, head, first block; v 0 where there is none, as for
    SGD), the head from p's address (``vector_head``) and the first block
    counting the blocks of the rows before it; and the number of blocks of
    all of them."""
    rows, first_block = [], 0
    for p, m, v in zip(params, ms, vs):
        n = p.numel()
        if n == 0:
            continue
        head = vector_head(p.data_ptr(), n)
        rows.append([p.data_ptr(), m.data_ptr(), _address(v), n, head, first_block])
        first_block += blocks_of(n, head)
    return rows, first_block


class PointerTable:
    """The kernel's table on the device: the rows, then each block's row
    index. Built, and uploaded from pinned memory without a host wait, only
    when the device, a parameter's or a moment's address, or a size differs
    from the last call's (``builds`` counts the builds); the gradients'
    addresses are not in it."""

    def __init__(self):
        self.key = None
        self.table: Optional[torch.Tensor] = None
        self.first_blocks: List[int] = []
        self.n_tensors = self.n_blocks = self.builds = 0

    def get(self, params, ms, vs) -> torch.Tensor:
        dev = params[0].device
        key = (dev, *((p.data_ptr(), m.data_ptr(), _address(v), p.numel()) for p, m, v in zip(params, ms, vs)))
        if key != self.key:
            rows, n_blocks = pointer_table_rows(params, ms, vs)
            blocks = [i for i, row in enumerate(rows) for _ in range(blocks_of(row[3], row[4]))]
            host = torch.tensor([x for row in rows for x in row] + blocks, dtype=torch.int64)
            # PyTorch's pinned-memory allocator keeps the source until the copy has run
            self.table = host.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else host
            self.key, self.n_tensors, self.n_blocks = key, len(rows), n_blocks
            self.first_blocks = [row[5] for row in rows] + [n_blocks]
            self.builds += 1
        return self.table


def grad_norm_partials_plain(params: List[torch.Tensor], grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """Plain version of the kernel's per-block sums of g^2 (fp64), in block
    order, for the tensors as they lie (p's address sets each tensor's head
    and so its blocks' ranges)."""
    out = []
    for p, g in zip(params, grads):
        n = p.numel()
        if n == 0:
            continue
        flat = None if g is None else g.detach().reshape(-1).double()
        for begin, end in block_ranges(n, vector_head(p.data_ptr(), n)):
            out.append(torch.zeros((), dtype=torch.float64) if flat is None
                       else (flat[begin:end] * flat[begin:end]).sum().cpu())
    return torch.stack(out) if out else torch.zeros(0, dtype=torch.float64)


def fixed_order_sum(partials: torch.Tensor) -> torch.Tensor:
    """The sum of the fp64 ``partials`` in ``hulc_grad_norm_finish``'s order:
    thread t of FINISH_THREADS adds its contiguous share of
    ceil(n / FINISH_THREADS) in index order, each warp's 32 sums go by
    shuffles down 16, 8, 4, 2, 1, and the warps' sums are added in index
    order."""
    n = partials.numel()
    share = -(-n // FINISH_THREADS)
    padded = torch.zeros(FINISH_THREADS * share, dtype=torch.float64)
    padded[:n] = partials.detach().double().cpu()
    by_thread = padded.reshape(FINISH_THREADS, share)
    acc = torch.zeros(FINISH_THREADS, dtype=torch.float64)
    for c in range(share):
        acc = acc + by_thread[:, c]
    lanes = acc.reshape(FINISH_THREADS // 32, 32)
    for offset in (16, 8, 4, 2, 1):
        lanes = torch.cat([lanes[:, :32 - offset] + lanes[:, offset:], lanes[:, 32 - offset:]], dim=1)
    total = torch.zeros((), dtype=torch.float64)
    for warp_sum in lanes[:, 0]:
        total = total + warp_sum
    return total


def grad_norm_finish_plain(partials: torch.Tensor) -> torch.Tensor:
    """Plain version of ``hulc_grad_norm_finish``: sqrt of the partials'
    ``fixed_order_sum``, rounded to a 0-d fp32 tensor."""
    return torch.sqrt(fixed_order_sum(partials)).float()


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------


def _check_tensors(params, grads, ms, vs, moment_dtype: torch.dtype) -> torch.device:
    dev = params[0].device
    for p, g, m, v in zip(params, grads, ms, vs):
        if p.numel() == 0:  # a rank's empty shard: no row of the table
            continue
        kernels.require_cuda_tensor("param", p, torch.float32)
        if g is not None:
            kernels.require_cuda_tensor("grad", g, torch.float32)
        kernels.require_cuda_tensor("exp_avg", m, moment_dtype)
        if v is not None:
            kernels.require_cuda_tensor("exp_avg_sq", v, moment_dtype)
        if not all(t.shape == p.shape and t.device == dev for t in (m, v, g) if t is not None):
            raise ValueError("param, grad and moments must share a shape and a device")
        for name, t in (("param", p), ("grad", g), ("exp_avg", m), ("exp_avg_sq", v)):
            if t is not None and t.data_ptr() % t.element_size():
                raise ValueError(f"{name} does not start at a multiple of its element size")
        if len({(t.data_ptr() // t.element_size()) % 4 for t in (p, g, m, v) if t is not None}) != 1:
            raise ValueError("param, grad and moments must start at one phase modulo 4 elements "
                             "(the kernel's 4-element groups)")
    return dev


def _launch(
    kernel: kernels.Kernel, consts: Sequence[float], params: List[torch.Tensor], grads: List[Optional[torch.Tensor]],
    ms: List[torch.Tensor], vs: List[Optional[torch.Tensor]], moment_dtype: torch.dtype, table: Optional[PointerTable],
) -> torch.Tensor:
    """``kernel`` (an instance of csrc/adam_lowp.cu's template) over all the
    tensors (CUDA, fp32 params and grads, moments of ``moment_dtype``, each
    contiguous and all at one phase modulo 4 elements; a ``None`` grad is
    zeros), in place: one launch per MAX_GRADS_PER_LAUNCH tensors, each
    taking ``consts`` after the gradients' addresses. Returns the per-block
    sums of g^2 (fp64, one per block of ``table``'s plan). ``table`` caches
    the pointer table across calls."""
    dev = _check_tensors(params, grads, ms, vs, moment_dtype)
    table = PointerTable() if table is None else table
    buf = table.get(params, ms, vs)
    partials = torch.empty(table.n_blocks, dtype=torch.float64, device=dev)
    grad_ptrs = [_address(g) for p, g in zip(params, grads) if p.numel()]
    for r0 in range(0, table.n_tensors, MAX_GRADS_PER_LAUNCH):
        r1 = min(r0 + MAX_GRADS_PER_LAUNCH, table.n_tensors)
        blk0, blk1 = table.first_blocks[r0], table.first_blocks[r1]
        kernel(dev, buf.data_ptr(), table.n_tensors, r0, r1 - r0, blk0, blk1 - blk0, ELEMS_PER_BLOCK,
               partials.data_ptr(), (ctypes.c_longlong * (r1 - r0))(*grad_ptrs[r0:r1]), *consts)
    return partials


def _adam_consts(b1, b2, eps, neg_lr, c1, c2) -> Tuple[float, ...]:
    return (b1, 1.0 - b1, b2, 1.0 - b2, eps, neg_lr, c1, c2)


def adam_lowp_launch(
    params: List[torch.Tensor], grads: List[Optional[torch.Tensor]], ms: List[torch.Tensor], vs: List[torch.Tensor],
    b1: float, b2: float, eps: float, neg_lr: float, c1: float, c2: float, table: Optional[PointerTable] = None,
) -> torch.Tensor:
    """``hulc_adam_lowp`` (B.5: Adam, bf16 moments) over all the tensors, in
    place; returns the per-block sums of g^2 (``_launch``)."""
    return _launch(kernels.ADAM_LOWP, _adam_consts(b1, b2, eps, neg_lr, c1, c2), params, grads, ms, vs,
                   torch.bfloat16, table)


def adam_launch(
    params: List[torch.Tensor], grads: List[Optional[torch.Tensor]], ms: List[torch.Tensor], vs: List[torch.Tensor],
    b1: float, b2: float, eps: float, neg_lr: float, c1: float, c2: float, table: Optional[PointerTable] = None,
    weight_decay: Optional[float] = None,
) -> torch.Tensor:
    """``hulc_adam_fp32`` (Adam, fp32 moments) or, with ``weight_decay``,
    ``hulc_adamw`` over all the tensors, in place; returns the per-block
    sums of g^2 (``_launch``)."""
    consts = _adam_consts(b1, b2, eps, neg_lr, c1, c2)
    if weight_decay is None:
        return _launch(kernels.ADAM_FP32, consts, params, grads, ms, vs, torch.float32, table)
    return _launch(kernels.ADAMW, (*consts, weight_decay), params, grads, ms, vs, torch.float32, table)


def sgd_launch(
    params: List[torch.Tensor], grads: List[Optional[torch.Tensor]], ts: List[torch.Tensor], momentum: float,
    neg_lr: float, table: Optional[PointerTable] = None,
) -> torch.Tensor:
    """``hulc_sgd`` (fp32 trace) over all the tensors, in place; returns the
    per-block sums of g^2 (``_launch``)."""
    return _launch(kernels.SGD, (momentum, neg_lr), params, grads, ts, [None] * len(ts), torch.float32, table)


def grad_norm_finish(partials: torch.Tensor) -> torch.Tensor:
    """One launch of ``hulc_grad_norm_finish``: sqrt of the sum of the fp64
    ``partials``, as a 0-d fp32 CUDA tensor."""
    kernels.require_cuda_tensor("partials", partials, torch.float64, 1)
    out = torch.empty((), dtype=torch.float32, device=partials.device)
    kernels.GRAD_NORM_FINISH(partials.device, partials.data_ptr(), partials.numel(), out.data_ptr())
    return out


def adam_lowp_update(
    params: List[torch.Tensor], grads: List[Optional[torch.Tensor]], ms: List[torch.Tensor], vs: List[torch.Tensor],
    b1: float, b2: float, eps: float, neg_lr: float, c1: float, c2: float, table: Optional[PointerTable] = None,
) -> torch.Tensor:
    """The update of all the tensors and the global norm of ``grads`` (0-d
    fp32): the two kernel launches, no host wait."""
    return grad_norm_finish(adam_lowp_launch(params, grads, ms, vs, b1, b2, eps, neg_lr, c1, c2, table))


def adam_update(
    params: List[torch.Tensor], grads: List[Optional[torch.Tensor]], ms: List[torch.Tensor], vs: List[torch.Tensor],
    b1: float, b2: float, eps: float, neg_lr: float, c1: float, c2: float, table: Optional[PointerTable] = None,
    weight_decay: Optional[float] = None,
) -> torch.Tensor:
    """``adam_launch`` and the finish: the update and the global norm."""
    return grad_norm_finish(adam_launch(params, grads, ms, vs, b1, b2, eps, neg_lr, c1, c2, table, weight_decay))


def sgd_update(
    params: List[torch.Tensor], grads: List[Optional[torch.Tensor]], ts: List[torch.Tensor], momentum: float,
    neg_lr: float, table: Optional[PointerTable] = None,
) -> torch.Tensor:
    """``sgd_launch`` and the finish: the update and the global norm."""
    return grad_norm_finish(sgd_launch(params, grads, ts, momentum, neg_lr, table))


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------


class _KernelOptimizer(torch.optim.Optimizer):
    """What the four optimizers share: the step count, the schedule read at
    the count before the step, one kernel update (and the finish) per
    parameter group on CUDA or the plain version tensor by tensor, the
    pointer tables, and the checkpointed state. A subclass names its
    ``KIND``, its ``MOMENTS`` (state keys, stored in ``MOMENT_DTYPE``) and
    the kernel launch over a group (``_kernel_launch``, which returns the
    per-block sums of g^2) and the update of one tensor (``_plain_update``).

    Sharded parameters (``parallel.mesh.fsdp_shard``: DTensors) are updated
    on their local shards: the moments are allocated per shard, the pointer
    table holds the shards' addresses, and a gradient shard that starts at
    another phase modulo 4 elements than its parameter (a view into FSDP's
    reduce-scatter output may) is copied once into a buffer at the
    parameter's phase (``grad_copies`` counts the copies). A parameter FSDP
    leaves whole (0-d) is updated on every rank alike. The norm is global:
    every rank's per-block partials (a whole parameter's counted on rank 0
    only), each padded with zeros to the longest any rank can have, are
    gathered in rank order and finished by one ``hulc_grad_norm_finish``
    launch, so every rank gets the same norm (on the CPU, the sum of the
    ranks' sums of squares). The checkpointed moments are full tensors, as
    one device holds them."""

    KIND: str
    MOMENTS: Tuple[str, ...]
    MOMENT_DTYPE: torch.dtype

    def __init__(self, params: Iterable, defaults: dict, use_kernels: bool):
        super().__init__(params, defaults)
        self.use_kernels = use_kernels
        self.count = 0
        self.tables: Dict[int, PointerTable] = {}  # by param group index
        self.grad_copies = 0  # gradient shards copied to their parameter's phase
        self.grad_copy_bytes = 0  # and their bytes
        self._padded: Dict[int, int] = {}  # by param group index: the gathered partials' length per rank

    def _moments(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            shard = mesh.local(p)
            at = phase(shard) if shard.numel() else 0
            for name in self.MOMENTS:
                state[name] = (torch.zeros_like(shard, dtype=self.MOMENT_DTYPE, memory_format=torch.contiguous_format)
                               if at == 0 else empty_at_phase(shard, at, self.MOMENT_DTYPE).zero_())
        return state

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def checkpoint_state(self) -> dict:
        """What a checkpoint keeps: the optimizer's kind, the step count (the
        learning rate is a schedule of it) and each parameter's moments, in
        parameter order (None before the first step), as full tensors (every
        rank takes part for sharded parameters)."""
        params = self._params()

        def full(p, name):
            m = self.state[p].get(name)
            return None if m is None else mesh.full_tensor(m, p)

        return {"kind": self.KIND, "count": self.count,
                **{name: [full(p, name) for p in params] for name in self.MOMENTS}}

    def load_checkpoint_state(self, state: dict) -> None:
        """Restore ``checkpoint_state()``'s result, copying the moments (this
        rank's shard of each, for sharded parameters) into the buffers in
        place (their addresses, and so the kernel's pointer table, stay). The
        state of another kind of optimizer is refused (a state saved before
        states named their kind is AdamLowp's, the only optimizer then)."""
        kind = state.get("kind", AdamLowp.KIND)
        if kind != self.KIND:
            raise ValueError(f"the checkpoint holds the state of a {kind!r} optimizer, not of {self.KIND!r}: "
                             f"resume with the optimizer it was trained with")
        params = self._params()
        for name in self.MOMENTS:
            if len(state[name]) != len(params):
                raise ValueError(f"the checkpoint has moments for {len(state[name])} parameters, expected {len(params)}")
        self.count = int(state["count"])
        for i, p in enumerate(params):
            if state[self.MOMENTS[0]][i] is None:
                self.state[p].clear()
                continue
            moments = self._moments(p)
            for name in self.MOMENTS:
                moments[name].copy_(mesh.local_shard(state[name][i], p))

    def _kernel_launch(self, group, params, grads, moments, neg_lr, table) -> torch.Tensor:
        raise NotImplementedError

    def _plain_update(self, group, p, g, moments, neg_lr) -> None:
        raise NotImplementedError

    def _at_param_phase(self, g: Optional[torch.Tensor], p: torch.Tensor) -> Optional[torch.Tensor]:
        """``g``, or its copy at ``p``'s phase when it starts at another."""
        if g is None or g.numel() == 0 or phase(g) == phase(p):
            return g
        self.grad_copies += 1
        self.grad_copy_bytes += g.numel() * g.element_size()
        return empty_at_phase(g, phase(p)).copy_(g)

    def _padded_partials(self, i: int, params: List[torch.Tensor]) -> int:
        """The most per-block partials any rank's shards of the group can
        give (a head only takes blocks away), from the parameters' global
        shapes: the length every rank pads its partials to."""
        if i not in self._padded:
            n = mesh.world()
            most = 0
            for r in range(n):
                total = 0
                for p in params:
                    numel = p.numel()
                    if mesh.is_sharded(p):  # rank r's torch.chunk of the global dimension 0
                        rows = p.shape[0]
                        chunk = -(-rows // n)
                        numel = max(0, min(chunk, rows - r * chunk)) * (numel // max(rows, 1))
                    total += blocks_of(numel, 0) if numel else 0
                most = max(most, total)
            self._padded[i] = most
        return self._padded[i]

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        """One update of every parameter; returns the global norm of the
        gradients applied."""
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        with record_function(OPTIMIZER_SPAN):
            lr_count = self.count  # optax's scale_by_schedule reads the count before the step
            self.count += 1
            norms = []
            for i, group in enumerate(self.param_groups):
                lr = group["lr"](lr_count) if callable(group["lr"]) else group["lr"]
                neg_lr = float(torch.tensor(-lr, dtype=torch.float32))
                if not group["params"]:
                    continue
                sharded = any(mesh.is_sharded(p) for p in group["params"])
                params = [mesh.local(p) for p in group["params"]]
                grads = [None if p.grad is None else mesh.local(p.grad).contiguous() for p in group["params"]]
                moments = [[self._moments(p)[name] for p in group["params"]] for name in self.MOMENTS]
                if self.use_kernels and params[0].device.type == "cuda":
                    grads = [self._at_param_phase(g, p) for p, g in zip(params, grads)]
                    table = self.tables.setdefault(i, PointerTable())
                    partials = self._kernel_launch(group, params, grads, moments, neg_lr, table)
                    if sharded:
                        if mesh.rank():  # a whole parameter's gradient counts once, in rank 0's partials
                            rows = [j for j, p in enumerate(params) if p.numel()]
                            for row, j in enumerate(rows):
                                if not mesh.is_sharded(group["params"][j]):
                                    partials[table.first_blocks[row]:table.first_blocks[row + 1]] = 0
                        partials = mesh.gather_padded(partials, self._padded_partials(i, group["params"]))
                    norms.append(grad_norm_finish(partials))
                else:
                    norms.append((_sharded_norm(grads, group["params"]) if sharded else global_norm(grads))
                                 .to(params[0].device))
                    for j, (p, g) in enumerate(zip(params, grads)):
                        self._plain_update(group, p, g, [m[j] for m in moments], neg_lr)
            if len(norms) == 1:
                return norms[0]
            return torch.sqrt(sum(n * n for n in norms)) if norms else torch.zeros((), dtype=torch.float32)


def _sharded_norm(grads: Sequence[Optional[torch.Tensor]], params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global norm of every rank's gradient shards: the sum over ranks of
    each rank's sum of squares (fp64; a whole parameter's on rank 0 only),
    then the root, in fp32."""
    present = [g for g, p in zip(grads, params) if g is not None and (mesh.rank() == 0 or mesh.is_sharded(p))]
    device = present[0].device if present else torch.device("cpu")
    local_sq = sum(((g.double() * g.double()).sum() for g in present), torch.zeros((), dtype=torch.float64, device=device))
    return torch.sqrt(mesh.sum_across_ranks(local_sq)).float()


class AdamLowp(_KernelOptimizer):
    """Adam with bf16-stored moments and fp32 math; ``lr`` is a float or a
    schedule (step count -> float), as optax takes it. The kernel is B.5."""

    KIND = "adam_lowp"
    MOMENTS = ("exp_avg", "exp_avg_sq")
    MOMENT_DTYPE = torch.bfloat16

    def __init__(self, params: Iterable, lr: Schedule = 2e-4, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, use_kernels: bool = True):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps), use_kernels)

    def _consts(self, group):
        b1, b2 = group["betas"]
        return (b1, b2, group["eps"], *bias_corrections(b1, b2, self.count))

    def _kernel_launch(self, group, params, grads, moments, neg_lr, table):
        b1, b2, eps, c1, c2 = self._consts(group)
        return adam_lowp_launch(params, grads, *moments, b1, b2, eps, neg_lr, c1, c2, table)

    def _plain_update(self, group, p, g, moments, neg_lr):
        b1, b2, eps, c1, c2 = self._consts(group)
        adam_update_plain(p, g, *moments, b1, b2, eps, neg_lr, c1, c2)


class Adam(AdamLowp):
    """``optax.adam``: Adam with fp32 moments (the JAX trainer's
    ``adam_mv_dtype="float32"``). The kernel is B.5's fp32 instance."""

    KIND = "adam"
    MOMENT_DTYPE = torch.float32

    def _kernel_launch(self, group, params, grads, moments, neg_lr, table):
        b1, b2, eps, c1, c2 = self._consts(group)
        return adam_launch(params, grads, *moments, b1, b2, eps, neg_lr, c1, c2, table)


class AdamW(Adam):
    """``optax.adamw(lr, weight_decay=1e-6)``: Adam's fp32 update plus
    ``ADAMW_WEIGHT_DECAY * p``, then the learning rate, on every tensor
    (optax's default mask is none). The kernel is B.5's adamw instance."""

    KIND = "adamw"

    def _kernel_launch(self, group, params, grads, moments, neg_lr, table):
        b1, b2, eps, c1, c2 = self._consts(group)
        return adam_launch(params, grads, *moments, b1, b2, eps, neg_lr, c1, c2, table, ADAMW_WEIGHT_DECAY)

    def _plain_update(self, group, p, g, moments, neg_lr):
        b1, b2, eps, c1, c2 = self._consts(group)
        adam_update_plain(p, g, *moments, b1, b2, eps, neg_lr, c1, c2, ADAMW_WEIGHT_DECAY)


class SGD(_KernelOptimizer):
    """``optax.sgd(lr, momentum=0.9)``: an fp32 trace ``t' = g +
    SGD_MOMENTUM * t`` (no Nesterov), then the learning rate. The kernel is
    B.5's sgd instance."""

    KIND = "sgd"
    MOMENTS = ("momentum_buffer",)
    MOMENT_DTYPE = torch.float32

    def __init__(self, params: Iterable, lr: Schedule = 2e-4, use_kernels: bool = True):
        super().__init__(params, dict(lr=lr), use_kernels)

    def _kernel_launch(self, group, params, grads, moments, neg_lr, table):
        return sgd_launch(params, grads, moments[0], SGD_MOMENTUM, neg_lr, table)

    def _plain_update(self, group, p, g, moments, neg_lr):
        sgd_update_plain(p, g, moments[0], SGD_MOMENTUM, neg_lr)
