"""Adam with bf16-stored moments (port of hulc_tpu/training/optimizers.py:24-87),
and the global gradient norm (hulc_tpu/training/trainer.py:258).

``AdamLowp`` is ``optax.chain(scale_by_adam_lowp(), scale_by_learning_rate(lr))``
as a ``torch.optim.Optimizer``: the two moment buffers are stored in
bfloat16 while every update is computed in fp32, in the optax order

    m' = m * b1 + (1 - b1) * g           v' = v * b2 + (1 - b2) * (g * g)
    p' = p + (-lr) * ((m' / c1) / (sqrt(v' / c2) + eps))

with c1 = 1 - b1^t, c2 = 1 - b2^t at step t (from 1) and lr the schedule's
value at t - 1; m' and v' are rounded to bf16 on write-back. ``step()``
returns ``optax.global_norm`` of the gradients it applied (0-d fp32 on the
parameters' device). On CUDA parameters one launch of the hand-written
kernel ``csrc/adam_lowp.cu`` updates every tensor of a parameter group and
writes per-block sums of g^2, which a second, one-block launch reduces to
the norm. The Adam launch reads a device table of the parameters' and
moments' addresses that is built, and uploaded from pinned memory, only
when one of them or a size changes (``PointerTable``), and takes the
gradients' addresses, which autograd changes every step, by value. On CPU
parameters (or with ``use_kernels=False``) the plain versions below run
tensor by tensor. A parameter without a gradient is updated with a zero
gradient, as optax updates every leaf.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch.profiler import record_function

from hulc_tpu_torch import kernels

Schedule = Union[float, Callable[[int], float]]
ELEMS_PER_BLOCK = 8192  # elements of one tensor per block of the kernel's grid
MAX_GRADS_PER_LAUNCH = 448  # gradient addresses one launch takes by value (csrc/adam_lowp.cu kMaxGrads)
FINISH_THREADS = 1024  # threads of the one-block finish launch (csrc/adam_lowp.cu kFinishThreads)
# the record_function span around AdamLowp.step, so a profile can find the optimizer tail
OPTIMIZER_SPAN = "hulc::adam_lowp_step"


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """(1 - b1^count, 1 - b2^count), each computed in fp32 and returned as
    the Python float of that fp32 value."""
    t = torch.tensor(float(count), dtype=torch.float32)

    def c(b):
        return float(1.0 - torch.pow(torch.tensor(b, dtype=torch.float32), t))

    return c(b1), c(b2)


def adam_lowp_update_plain(
    p: torch.Tensor, g: Optional[torch.Tensor], m: torch.Tensor, v: torch.Tensor,
    b1: float, b2: float, eps: float, neg_lr: float, c1: float, c2: float,
) -> None:
    """Plain PyTorch version of one tensor's update, in place; a ``None``
    gradient is zeros. The bias corrections divide as device tensors:
    dividing by a Python scalar may run as a multiply by its reciprocal,
    which is not the optax division."""
    c1_t = torch.tensor(c1, dtype=torch.float32, device=p.device)
    c2_t = torch.tensor(c2, dtype=torch.float32, device=p.device)
    g32 = torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
    m32 = m.float() * b1 + (1.0 - b1) * g32
    v32 = v.float() * b2 + (1.0 - b2) * (g32 * g32)
    u = (m32 / c1_t) / (torch.sqrt(v32 / c2_t) + eps)
    p.add_(u * neg_lr)
    m.copy_(m32.to(m.dtype))
    v.copy_(v32.to(v.dtype))


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


def pointer_table_rows(
    params: List[torch.Tensor], ms: List[torch.Tensor], vs: List[torch.Tensor]
) -> Tuple[List[List[int]], int]:
    """The kernel's table, one row per tensor with elements, (p, m, v
    addresses, numel, head, first block), the head from p's address
    (``vector_head``) and the first block counting the blocks of the rows
    before it; and the number of blocks of all of them."""
    rows, first_block = [], 0
    for p, m, v in zip(params, ms, vs):
        n = p.numel()
        if n == 0:
            continue
        head = vector_head(p.data_ptr(), n)
        rows.append([p.data_ptr(), m.data_ptr(), v.data_ptr(), n, head, first_block])
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
        key = (dev, *((p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel()) for p, m, v in zip(params, ms, vs)))
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


def _check_tensors(params, grads, ms, vs) -> torch.device:
    dev = params[0].device
    for p, g, m, v in zip(params, grads, ms, vs):
        kernels.require_cuda_tensor("param", p, torch.float32)
        if g is not None:
            kernels.require_cuda_tensor("grad", g, torch.float32)
        kernels.require_cuda_tensor("exp_avg", m, torch.bfloat16)
        kernels.require_cuda_tensor("exp_avg_sq", v, torch.bfloat16)
        if not all(t.shape == p.shape and t.device == dev for t in (m, v) + (() if g is None else (g,))):
            raise ValueError("param, grad and moments must share a shape and a device")
        for name, t in (("param", p), ("grad", g), ("exp_avg", m), ("exp_avg_sq", v)):
            if t is not None and t.data_ptr() % t.element_size():
                raise ValueError(f"{name} does not start at a multiple of its element size")
        if len({(t.data_ptr() // t.element_size()) % 4 for t in (p, g, m, v) if t is not None}) != 1:
            raise ValueError("param, grad and moments must start at one phase modulo 4 elements "
                             "(the kernel's 4-element groups)")
    return dev


def adam_lowp_launch(
    params: List[torch.Tensor], grads: List[Optional[torch.Tensor]], ms: List[torch.Tensor], vs: List[torch.Tensor],
    b1: float, b2: float, eps: float, neg_lr: float, c1: float, c2: float, table: Optional[PointerTable] = None,
) -> torch.Tensor:
    """``hulc_adam_lowp`` over all the tensors (CUDA, fp32 params and grads,
    bf16 moments, each contiguous and the four at one phase modulo 4
    elements; a ``None`` grad is zeros), in place: one launch per
    MAX_GRADS_PER_LAUNCH tensors. Returns the per-block sums of g^2 (fp64,
    one per block of ``table``'s plan). ``table`` caches the pointer table
    across calls."""
    dev = _check_tensors(params, grads, ms, vs)
    table = PointerTable() if table is None else table
    buf = table.get(params, ms, vs)
    partials = torch.empty(table.n_blocks, dtype=torch.float64, device=dev)
    grad_ptrs = [0 if g is None else g.data_ptr() for p, g in zip(params, grads) if p.numel()]
    for r0 in range(0, table.n_tensors, MAX_GRADS_PER_LAUNCH):
        r1 = min(r0 + MAX_GRADS_PER_LAUNCH, table.n_tensors)
        blk0, blk1 = table.first_blocks[r0], table.first_blocks[r1]
        kernels.ADAM_LOWP(dev, buf.data_ptr(), table.n_tensors, r0, r1 - r0, blk0, blk1 - blk0, ELEMS_PER_BLOCK,
                          partials.data_ptr(), (ctypes.c_longlong * (r1 - r0))(*grad_ptrs[r0:r1]),
                          b1, 1.0 - b1, b2, 1.0 - b2, eps, neg_lr, c1, c2)
    return partials


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


class AdamLowp(torch.optim.Optimizer):
    """Adam with bf16-stored moments and fp32 math; ``lr`` is a float or a
    schedule (step count -> float), as optax takes it."""

    def __init__(
        self,
        params: Iterable,
        lr: Schedule = 2e-4,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        use_kernels: bool = True,
    ):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        self.use_kernels = use_kernels
        self.count = 0
        self.tables = {}  # PointerTable by param group index

    def _moments(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16, memory_format=torch.contiguous_format)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.bfloat16, memory_format=torch.contiguous_format)
        return state

    def checkpoint_state(self) -> dict:
        """What a checkpoint keeps: the step count (the learning rate is a
        schedule of it) and each parameter's moments, in parameter order
        (None before the first step)."""
        params = [p for g in self.param_groups for p in g["params"]]
        return {
            "count": self.count,
            "exp_avg": [self.state[p].get("exp_avg") for p in params],
            "exp_avg_sq": [self.state[p].get("exp_avg_sq") for p in params],
        }

    def load_checkpoint_state(self, state: dict) -> None:
        """Restore ``checkpoint_state()``'s result, copying the moments into
        the buffers in place (their addresses, and so the kernel's pointer
        table, stay)."""
        params = [p for g in self.param_groups for p in g["params"]]
        if len(state["exp_avg"]) != len(params) or len(state["exp_avg_sq"]) != len(params):
            raise ValueError(f"the checkpoint has moments for {len(state['exp_avg'])} parameters, expected {len(params)}")
        self.count = int(state["count"])
        for p, m, v in zip(params, state["exp_avg"], state["exp_avg_sq"]):
            if m is None:
                self.state[p].clear()
                continue
            moments = self._moments(p)
            moments["exp_avg"].copy_(m)
            moments["exp_avg_sq"].copy_(v)

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        """One update of every parameter; returns the global norm of the
        gradients applied."""
        if closure is not None:
            raise ValueError("AdamLowp.step takes no closure")
        with record_function(OPTIMIZER_SPAN):
            lr_count = self.count  # optax's scale_by_schedule reads the count before the step
            self.count += 1
            norms = []
            for i, group in enumerate(self.param_groups):
                b1, b2 = group["betas"]
                c1, c2 = bias_corrections(b1, b2, self.count)
                lr = group["lr"](lr_count) if callable(group["lr"]) else group["lr"]
                neg_lr = float(torch.tensor(-lr, dtype=torch.float32))
                params, grads, ms, vs = [], [], [], []
                for p in group["params"]:
                    state = self._moments(p)
                    params.append(p)
                    grads.append(None if p.grad is None else p.grad.contiguous())
                    ms.append(state["exp_avg"])
                    vs.append(state["exp_avg_sq"])
                if not params:
                    continue
                if self.use_kernels and params[0].device.type == "cuda":
                    table = self.tables.setdefault(i, PointerTable())
                    norms.append(adam_lowp_update(params, grads, ms, vs, b1, b2, group["eps"], neg_lr, c1, c2, table))
                else:
                    norms.append(global_norm(grads).to(params[0].device))
                    for p, g, m, v in zip(params, grads, ms, vs):
                        adam_lowp_update_plain(p, g, m, v, b1, b2, group["eps"], neg_lr, c1, c2)
            if len(norms) == 1:
                return norms[0]
            return torch.sqrt(sum(n * n for n in norms)) if norms else torch.zeros((), dtype=torch.float32)
