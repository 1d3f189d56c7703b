"""Ray-data-parallel training over ``torch.distributed``.

Counterpart of ``envidr_tpu/parallel/mesh.py``.  There a 1-D ``data`` mesh
shards the ray axis and GSPMD inserts the gradient all-reduce, so that the
sharded step *is* the single-device step.  Here each process is one rank
of a process group, the model, the occupancy grid and the optimizer state
are replicated on every rank, and the trainer
(``Trainer(..., mesh=group)``) makes the P-rank step equal the 1-rank step
on the same global batch:

  * every rank draws the global batch from the same generator and keeps its
    slice of the ray axis (:func:`shard_rays`);
  * the loss's ray sums and counts are formed across ranks
    (:func:`global_sum`), so that each rank computes the global loss and
    its own share of the gradient;
  * the gradients are summed across ranks before the optimizer
    (:func:`all_reduce_grads`), which then updates every rank alike;
  * per-ray results that every rank needs (the error map's update, an eval
    render) are all-gathered (:func:`global_from_local`).

Backend: ``nccl`` when each rank has a card of its own, ``gloo`` otherwise:
two ranks on one card (NCCL refuses a duplicate device) and every CPU run.
Gloo stages CUDA tensors through host memory.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from envidr_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of the data axis: the stand-in for JAX's ``Mesh``."""

    rank: int
    world: int
    backend: str
    device: torch.device

    @property
    def sharded(self) -> bool:
        return self.world > 1


def choose_backend(world: int, device) -> str:
    """``nccl`` when the ranks are CUDA ranks with a card each (one host),
    else ``gloo``."""
    device = torch.device(device)
    if (device.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator: str, num_processes: int, process_id: int, *,
                         device=None, backend: Optional[str] = None,
                         timeout_s: float = 600.0) -> "Group":
    """Join the process group at ``coordinator`` (``host:port``, or a
    ``tcp://`` URL) as rank ``process_id`` of ``num_processes``, then
    return :func:`make_mesh`.  ``device`` as ``resolve_device`` reads it
    (the card unless ``cpu``); under ``nccl`` rank ``r`` takes card ``r``."""
    device = resolve_device(device)
    backend = backend or choose_backend(num_processes, device)
    if backend == "nccl":
        device = torch.device("cuda", process_id)
        torch.cuda.set_device(device)
    url = coordinator if coordinator.startswith("tcp://") else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return make_mesh(device)


def make_mesh(device=None) -> "Group":
    """The initialised process group as a :class:`Group` on ``device`` (as
    ``resolve_device`` reads it); world 1 when ``torch.distributed`` is not
    initialised."""
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        return Group(dist.get_rank(), dist.get_world_size(), dist.get_backend(), device)
    return Group(0, 1, "none", device)


def shutdown():
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def ray_sharded(group: Optional[Group], n: int) -> slice:
    """This rank's rows of a leading axis of ``n`` (which the world divides)."""
    if group is None or not group.sharded:
        return slice(0, n)
    if n % group.world:
        raise ValueError(f"{n} rays do not split over {group.world} ranks")
    per = n // group.world
    return slice(group.rank * per, (group.rank + 1) * per)


def shard_rays(group: Optional[Group], *tensors):
    """This rank's slice of each tensor's leading (ray) axis; None stays None."""
    if group is None or not group.sharded:
        return tensors if len(tensors) > 1 else tensors[0]
    out = tuple(None if t is None else t[ray_sharded(group, t.shape[0])] for t in tensors)
    return out if len(out) > 1 else out[0]


def replicate_tree(group: Optional[Group], tensors: Iterable[torch.Tensor]):
    """Broadcast ``tensors`` (a module's parameters and buffers, when given a
    module) from rank 0, in place."""
    if group is None or not group.sharded:
        return
    if isinstance(tensors, torch.nn.Module):
        tensors = [*tensors.parameters(), *tensors.buffers()]
    with torch.no_grad():
        for t in tensors:
            if t.dtype == torch.bool:           # gloo broadcasts no bool
                u = t.to(torch.uint8)
                dist.broadcast(u, 0)
                t.copy_(u.bool())
            else:
                dist.broadcast(t.data, 0)


def global_from_local(group: Optional[Group], *tensors):
    """The ranks' slices of each tensor, all-gathered in rank order along
    the leading axis (every rank's slice of equal shape)."""
    if group is None or not group.sharded:
        return tensors if len(tensors) > 1 else tensors[0]
    out = []
    for t in tensors:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(group.world)]
        dist.all_gather(parts, t)
        out.append(torch.cat(parts))
    return tuple(out) if len(out) > 1 else out[0]


class _GlobalSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks; its gradient is the incoming one,
    unchanged: each rank computes the same global loss, so the upstream
    gradient is the same on every rank and is this rank's share of the
    derivative, which :func:`all_reduce_grads` then sums."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


def global_sum(group: Optional[Group], x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable (:class:`_GlobalSum`)."""
    if group is None or not group.sharded:
        return x
    return _GlobalSum.apply(x)


@torch.no_grad()
def all_reduce_grads(group: Optional[Group], params) -> None:
    """Sum every parameter's gradient over the ranks, in one flat buffer; a
    missing gradient counts as zero (and becomes one)."""
    if group is None or not group.sharded:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1).float() for p in params])
    dist.all_reduce(flat)
    pos = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[pos:pos + n].view_as(p.grad))
        pos += n
