"""Process groups, row sharding and ZeRO-3 (port of hulc_tpu/parallel/mesh.py).

The JAX package runs one program over a ``data`` mesh axis: the batch is
sharded over it and GSPMD computes on the shards what one device computes
on the whole batch. The port runs one process per GPU (``torchrun``): NCCL
between CUDA devices, gloo when the caller asks for the CPU. Each rank holds
its rows of every per-modality batch (``shard_rows``), and everything that
mixes rows or draws noise is made to give the one-device result:

* ``gather_rows``: the rows of every rank, in rank order (the CLIP loss's
  logit matrix needs them); its backward sums the ranks' gradients of this
  rank's rows, since every rank computes the whole loss.
* ``draw_rows`` / ``local_rows``: inside ``sharded_rows()`` (the trainer's
  steps enter it when a group of more than one rank exists), a draw is made
  at the global batch's shape from the shared generator state and this
  rank's rows are kept, and an injected global tensor is cut to them. A
  tensor whose leading dimension stacks ``blocks`` equal modality blocks
  (the fused ``[vis; lang]`` batch is 2: rank r holds ``[vis_r; lang_r]``,
  the one-device batch ``[vis; lang]``) keeps its rows of each block
  (``row_blocks``).
* ``mean_across_ranks``: logged scalars, each rank's mean over its rows
  averaged (every mean of the step is over equal row counts).
* ``fsdp_shard``: FSDP2's ``fully_shard`` on each encoder tower, the goal
  encoders, the plan nets, the decoder, the CLIP head and the root, the
  counterpart of ``fsdp_param_sharding`` (every parameter sharded on its
  first dimension over the data axis); ``full_tensor`` / ``local_shard``
  move between a sharded parameter's local shard and the one-device tensor.

With no process group every function here is the identity (one rank).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hulc_tpu_torch.device import resolve_device

# the collectives' timeout: a rank waits this long at a barrier while rank 0
# saves a checkpoint or runs the rollout callback
TIMEOUT = datetime.timedelta(minutes=60)


def active() -> bool:
    """Whether a process group exists."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def initialize_distributed(device="cuda", init_method: Optional[str] = None, rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT``
    unless ``init_method`` names a rendezvous; ``rank`` and ``world_size``
    given take the place of the variables) and return this rank's device:
    ``cuda:LOCAL_RANK`` over NCCL, or the CPU over gloo when the caller
    passes ``device="cpu"``. Without a world size (no launcher) it starts
    no group and returns ``resolve_device(device)``. A failed NCCL start
    raises: it never falls back to gloo or the CPU."""
    dev = resolve_device(device)
    if active():
        return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return dev
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    else:
        local_rank = rank
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for device {dev}")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    return dev


def initialize_single(device="cuda") -> torch.device:
    """A group of one rank (a rendezvous at a free localhost port), for ZeRO-3
    in one process started without torchrun."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return initialize_distributed(device, f"tcp://localhost:{port}", rank=0, world_size=1)


class Ranks:
    """``fn(*args)`` started in ``world_size`` new processes, each a rank of
    one new group (``initialize_distributed`` on ``device``; a ``file://``
    rendezvous in a temporary directory unless ``init_method`` names one),
    as torchrun would start them; ``results()`` waits for them. Results come
    back pickled through a file: give CPU tensors."""

    def __init__(self, fn: Callable, world_size: int, device: str = "cuda", args: tuple = (),
                 init_method: Optional[str] = None):
        import tempfile

        import torch.multiprocessing as mp

        self._tmp = tempfile.TemporaryDirectory(prefix="hulc_ranks_")
        self.world_size = world_size
        init = init_method or f"file://{self._tmp.name}/rendezvous"
        self._context = mp.start_processes(_rank_main, args=(fn, world_size, device, init, self._tmp.name, args),
                                           nprocs=world_size, start_method="spawn", join=False)

    def results(self) -> list:
        """Each rank's result, in rank order; raises if a rank failed (the
        others are then terminated)."""
        try:
            while not self._context.join():
                pass
            return [torch.load(os.path.join(self._tmp.name, f"result_{r}.pt"), weights_only=False)
                    for r in range(self.world_size)]
        finally:
            self._tmp.cleanup()


def spawn_ranks(fn: Callable, world_size: int, device: str = "cuda", args: tuple = (),
                init_method: Optional[str] = None) -> list:
    """``Ranks`` and wait: each rank's result, in rank order. A rank that
    fails raises here."""
    return Ranks(fn, world_size, device, args, init_method).results()


def _rank_main(r: int, fn: Callable, world_size: int, device: str, init: str, out: str, args: tuple) -> None:
    initialize_distributed(device, init, rank=r, world_size=world_size)
    try:
        torch.save(fn(*args), os.path.join(out, f"result_{r}.pt"))
    finally:
        destroy()


def destroy() -> None:
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


class _Rows:
    on = False  # inside sharded_rows() with more than one rank
    blocks = 1


@contextlib.contextmanager
def sharded_rows() -> Iterator[None]:
    """Inside, draws and injected tensors are cut to this rank's rows (a no-op
    with one rank)."""
    prev = _Rows.on
    _Rows.on = world() > 1
    try:
        yield
    finally:
        _Rows.on = prev


@contextlib.contextmanager
def row_blocks(blocks: int) -> Iterator[None]:
    """Inside, a batch's leading dimension stacks ``blocks`` equal modality
    blocks (2 for the fused ``[vis; lang]`` batch)."""
    prev = _Rows.blocks
    _Rows.blocks = blocks
    try:
        yield
    finally:
        _Rows.blocks = prev


def rows_of(x, blocks: int, n: int, r: int):
    """Rank ``r`` of ``n``'s rows of a global array, tensor or list whose
    leading dimension stacks ``blocks`` equal blocks: its share of each
    block, in block order."""
    lead = len(x)
    if lead % (blocks * n):
        raise ValueError(f"{lead} rows in {blocks} block(s) do not split over {n} ranks")
    per = lead // (blocks * n)
    parts = [x[(k * n + r) * per:(k * n + r + 1) * per] for k in range(blocks)]
    if blocks == 1:
        return parts[0]
    return torch.cat(parts) if isinstance(x, torch.Tensor) else np.concatenate(parts)


def local_rows(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's rows of an injected global tensor inside ``sharded_rows``;
    the tensor itself elsewhere."""
    if x is None or not _Rows.on:
        return x
    return rows_of(x, _Rows.blocks, world(), rank())


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)``; inside ``sharded_rows``, ``draw`` at the global batch's
    shape (the leading dimension times the ranks), so every rank's generator
    moves as the one-device step's does, and this rank's rows of it."""
    if not _Rows.on:
        return draw(shape)
    shape = tuple(shape)
    return local_rows(draw((shape[0] * world(), *shape[1:])))


def shard_rows(batch: Dict[str, "ModalityBatch"]) -> Dict[str, "ModalityBatch"]:  # noqa: F821
    """This rank's rows of a global ``{scope: ModalityBatch}`` (numpy arrays
    or tensors): ``batch_sharding`` / ``host_local_batch_to_global``'s
    counterpart. A ``"fused"`` batch keeps ``[vis_r; lang_r]`` (its
    language-only fields hold the language rows alone). A per-modality batch
    the world size does not divide is refused."""
    n, r = world(), rank()
    if n == 1:
        return batch
    out = {}
    for scope, mod in batch.items():
        blocks = 2 if scope == "fused" else 1
        fields = {}
        for name, x in zip(mod._fields, mod):
            if x is None:
                fields[name] = None
                continue
            k = 1 if name in mod.LANG_ONLY_FIELDS else blocks
            if x.shape[0] % (k * n):
                raise ValueError(f"{scope}.{name}: a batch of {x.shape[0] // k} rows per modality does not "
                                 f"split over {n} ranks")
            fields[name] = rows_of(x, k, n, r)
        out[scope] = type(mod)(**fields)
    return out


class _GatherRows(torch.autograd.Function):
    """All ranks' rows in rank order; the backward sums every rank's gradient
    of the gathered tensor and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(world())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad[rank() * ctx.rows:(rank() + 1) * ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x``, in rank order (``x`` itself with one rank).
    Differentiable; a bool tensor is gathered as uint8 and given back as
    bool, without a gradient."""
    if world() == 1:
        return x
    if x.dtype == torch.bool:
        return _GatherRows.apply(x.to(torch.uint8)).bool()
    return _GatherRows.apply(x)


def mean_across_ranks(values: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of a tensor of logged scalars (one all-reduce)."""
    return values if world() == 1 else sum_across_ranks(values) / world()


def sum_across_ranks(value: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a tensor (one all-reduce)."""
    if world() == 1:
        return value
    out = value.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def gather_padded(x: torch.Tensor, length: int) -> torch.Tensor:
    """Every rank's 1-D ``x``, each padded with zeros to ``length`` entries
    (the same on every rank), concatenated in rank order: one all-gather,
    no host wait."""
    if world() == 1:
        return x
    padded = torch.zeros(length, dtype=x.dtype, device=x.device)
    padded[:x.numel()] = x
    parts = [torch.empty_like(padded) for _ in range(world())]
    dist.all_gather(parts, padded)
    return torch.cat(parts)


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# ---------------------------------------------------------------------------
# ZeRO-3
# ---------------------------------------------------------------------------


def is_sharded(t) -> bool:
    """Whether ``t`` is a sharded parameter (a DTensor)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A sharded parameter's (or gradient's) local shard; any other tensor
    itself."""
    return t.to_local() if t is not None and is_sharded(t) else t


def full_tensor(local_t: torch.Tensor, like) -> torch.Tensor:
    """The one-device tensor of which ``local_t`` is this rank's shard, laid
    out as the sharded parameter ``like`` (every rank takes part); a tensor
    of an unsharded parameter as it is."""
    if not is_sharded(like):
        return local_t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_t, like.device_mesh, like.placements, shape=like.shape,
                              stride=like.stride()).full_tensor()


def local_shard(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's shard of the one-device tensor ``full``, as the sharded
    parameter ``like`` holds it: FSDP2's ``torch.chunk`` of dimension 0
    (ranks past the last chunk hold none)."""
    if not is_sharded(like):
        return full
    from torch.distributed.tensor import Shard

    if tuple(like.placements) != (Shard(0),):
        raise ValueError(f"a parameter laid out as {like.placements}: the port shards dimension 0 only")
    chunks = torch.chunk(full, world(), dim=0)
    out = chunks[rank()] if rank() < len(chunks) else full[:0]
    if out.shape != like.to_local().shape:
        raise ValueError(f"shard {tuple(out.shape)} of {tuple(full.shape)} is not the local {tuple(like.to_local().shape)}")
    return out


def fsdp_shard(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """ZeRO-3 over every rank (a 1-D mesh, the data axis): ``fully_shard`` on
    each encoder tower, the goal encoders, the plan nets, the decoder, the
    CLIP head, then the root, whose forward methods ``train_losses`` and
    ``val_metrics`` gather its own parameters. Every parameter but a 0-d one
    is a DTensor sharded on its first dimension; each group is gathered before its
    forward and its backward and freed after, and its gradients are
    reduce-scattered (averaged). In place; returns ``model``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    mesh = init_device_mesh(device.type, (world(),))
    pe = model.perceptual_encoder
    groups = [getattr(pe, f"{name}_encoder") for name in ("rgb_static", "rgb_gripper", "depth_static", "depth_gripper")]
    groups += [model.visual_goal, model.language_goal, model.plan_proposal, model.plan_recognition,
               model.action_decoder, getattr(model, "proj_vis_lang", None)]
    for module in groups:
        if module is not None:
            fully_shard(module, mesh=mesh)
    # FSDP shards no 0-d parameter (the CLIP logit scale): it stays whole on
    # every rank, and every rank computes the same gradient for it, since
    # every rank computes the whole CLIP loss
    fully_shard(model, mesh=mesh, ignored_params={p for p in model.parameters() if p.dim() == 0})
    for method in ("train_losses", "val_metrics"):
        register_fsdp_forward_method(model, method)
    return model


def reshard(model: torch.nn.Module) -> None:
    """Free every gathered parameter of a sharded model (the root keeps its
    own after a forward without a backward, as after validation)."""
    from torch.distributed.fsdp import FSDPModule

    for m in model.modules():
        if isinstance(m, FSDPModule):
            m.reshard()


@contextlib.contextmanager
def unsharded_root(model: torch.nn.Module) -> Iterator[None]:
    """The root's own parameters gathered (every rank takes part), for code
    that reads them outside the root's forward methods; the sub-modules
    gather theirs when called. A no-op on an unsharded model."""
    from torch.distributed.fsdp import FSDPModule

    if not isinstance(model, FSDPModule):
        yield
        return
    model.unshard()
    try:
        yield
    finally:
        model.reshard()
