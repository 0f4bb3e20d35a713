"""Adam with bf16-stored moments (port of hulc_tpu/training/optimizers.py:24-87).

``AdamLowp`` is ``optax.chain(scale_by_adam_lowp(), scale_by_learning_rate(lr))``
as a ``torch.optim.Optimizer``: the two moment buffers are stored in
bfloat16 while every update is computed in fp32, in the optax order

    m' = m * b1 + (1 - b1) * g           v' = v * b2 + (1 - b2) * (g * g)
    p' = p + (-lr) * ((m' / c1) / (sqrt(v' / c2) + eps))

with c1 = 1 - b1^t, c2 = 1 - b2^t at step t (from 1) and lr the schedule's
value at t - 1; m' and v' are rounded to bf16 on write-back. On CUDA
parameters one launch of the hand-written kernel ``csrc/adam_lowp.cu``
updates every tensor of a parameter group, through a device table of the
tensors' addresses uploaded from pinned memory; on CPU parameters (or
with ``use_kernels=False``) the plain version below runs tensor by tensor.
A parameter without a gradient is updated with a zero gradient, as optax
updates every leaf.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple, Union

import torch

from hulc_tpu_torch import kernels

Schedule = Union[float, Callable[[int], float]]
CHUNK = 16384  # elements per block of the kernel's grid


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """(1 - b1^count, 1 - b2^count), each computed in fp32 and returned as
    the Python float of that fp32 value."""
    t = torch.tensor(float(count), dtype=torch.float32)

    def c(b):
        return float(1.0 - torch.pow(torch.tensor(b, dtype=torch.float32), t))

    return c(b1), c(b2)


def adam_lowp_update_plain(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    b1: float, b2: float, eps: float, neg_lr: float, c1: float, c2: float,
) -> None:
    """Plain PyTorch version of one tensor's update, in place. The bias
    corrections divide as device tensors: dividing by a Python scalar may
    run as a multiply by its reciprocal, which is not the optax division."""
    c1_t = torch.tensor(c1, dtype=torch.float32, device=p.device)
    c2_t = torch.tensor(c2, dtype=torch.float32, device=p.device)
    g32 = g.float()
    m32 = m.float() * b1 + (1.0 - b1) * g32
    v32 = v.float() * b2 + (1.0 - b2) * (g32 * g32)
    u = (m32 / c1_t) / (torch.sqrt(v32 / c2_t) + eps)
    p.add_(u * neg_lr)
    m.copy_(m32.to(m.dtype))
    v.copy_(v32.to(v.dtype))


def pointer_table_rows(
    params: List[torch.Tensor], grads: List[torch.Tensor], ms: List[torch.Tensor], vs: List[torch.Tensor]
) -> Tuple[List[List[int]], int]:
    """The kernel's table, one row per tensor, (p, g, m, v addresses, numel,
    first chunk), where the first chunk counts the ``CHUNK``-element chunks
    of the tensors before it; and the number of chunks of all of them."""
    rows, first_chunk = [], 0
    for p, g, m, v in zip(params, grads, ms, vs):
        rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(), first_chunk])
        first_chunk += -(-p.numel() // CHUNK)
    return rows, first_chunk


def adam_lowp_update(
    params: List[torch.Tensor], grads: List[torch.Tensor], ms: List[torch.Tensor], vs: List[torch.Tensor],
    b1: float, b2: float, eps: float, neg_lr: float, c1: float, c2: float,
) -> None:
    """One kernel launch over all the tensors (CUDA, fp32 params and grads,
    bf16 moments, each contiguous)."""
    dev = params[0].device
    for p, g, m, v in zip(params, grads, ms, vs):
        kernels.require_cuda_tensor("param", p, torch.float32)
        kernels.require_cuda_tensor("grad", g, torch.float32)
        kernels.require_cuda_tensor("exp_avg", m, torch.bfloat16)
        kernels.require_cuda_tensor("exp_avg_sq", v, torch.bfloat16)
        if not p.shape == g.shape == m.shape == v.shape or p.device != dev:
            raise ValueError("param, grad and moments must share a shape and a device")
    rows, n_chunks = pointer_table_rows(params, grads, ms, vs)
    # from pinned memory, so the host does not wait for the stream; PyTorch's
    # pinned-memory allocator keeps the source until the copy has run
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    kernels.ADAM_LOWP(
        dev, table.data_ptr(), len(rows), n_chunks, CHUNK, b1, 1.0 - b1, b2, 1.0 - b2, eps, neg_lr, c1, c2
    )


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

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamLowp.step takes no closure")
        lr_count = self.count  # optax's scale_by_schedule reads the count before the step
        self.count += 1
        for group in self.param_groups:
            b1, b2 = group["betas"]
            c1, c2 = bias_corrections(b1, b2, self.count)
            lr = group["lr"](lr_count) if callable(group["lr"]) else group["lr"]
            neg_lr = float(torch.tensor(-lr, dtype=torch.float32))
            params, grads, ms, vs = [], [], [], []
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16, memory_format=torch.contiguous_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.bfloat16, memory_format=torch.contiguous_format)
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                params.append(p)
                grads.append(g.contiguous())
                ms.append(state["exp_avg"])
                vs.append(state["exp_avg_sq"])
            if not params:
                continue
            if self.use_kernels and params[0].device.type == "cuda":
                adam_lowp_update(params, grads, ms, vs, b1, b2, group["eps"], neg_lr, c1, c2)
            else:
                for p, g, m, v in zip(params, grads, ms, vs):
                    adam_lowp_update_plain(p, g, m, v, b1, b2, group["eps"], neg_lr, c1, c2)
