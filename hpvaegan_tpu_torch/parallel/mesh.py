"""The data axis of the JAX package's `parallel/mesh.py`, over ranks.

In the JAX package a batch sharded over a ('data', 'sp') mesh is still ONE
global batch under pjit: BatchNorm statistics, loss means, the gradient
penalty and every draw are the whole batch's, so N devices compute what one
device computes at the same batch. The port runs one device per rank, so
the data axis is the set of ranks, a `DataGroup`, and the port makes the
same global batch by hand:
  * BatchNorm's batch statistics are summed over the group: ops/norm.py
    gets `all_reduce_sum` from `data_parallel` (differentiable twice: the
    gradient penalty's double backward runs through D's BatchNorm);
  * every batched draw is the global batch's, sliced to the rank's rows
    (utils/noise.py::NoiseSource), and K1's per-sample seed is offset by
    the rank's first global row;
  * the gradients are averaged over the group before the optimizer's
    per-tensor clip, all of them in one collective (`mean_`,
    training/steps.py), and so are the logged metrics and the amp
    calibration's MSE.
Every loss is a mean over equal shards, so these means are the global
ones. `--mesh-data` must equal the number of ranks; without it a
multi-process run trains a replicated program on every rank (the JAX
trainer's mesh None) and evaluation still shards its samples over all
ranks (`eval_group`).

The group in force is set by `data_parallel(group)` for the extent of a
run, and every helper here, the draws (utils/noise.py) and BatchNorm read
that one; outside it, the trivial group (no process group), where every
helper is the identity and issues no collective. A group of one rank in a
process group runs its collectives (NCCL's one-rank path on the card).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops import norm
from . import multihost

SPATIAL = "spatial mesh training"


class DataGroup(NamedTuple):
    """This rank's place on the data axis: rows [rank * b, (rank + 1) * b)
    of a global batch of size * b."""
    rank: int = 0
    size: int = 1
    group: Optional[object] = None  # the process group; None: one rank


_ACTIVE = DataGroup()
# seconds spent in the group's collectives while `timing` is on (the
# device is synchronized before each, so that queued work is not counted)
COLLECTIVE_SECONDS = [0.0]
timing = False


def make_data_group(mesh_data: int = 1, mesh_sp: int = 1) -> DataGroup:
    """The data group of --mesh-data over the ranks: all of them when
    mesh_data > 1 (it must equal the number of ranks), the trivial group
    (a replicated program) when mesh_data is 1."""
    if mesh_sp > 1:
        raise NotImplementedError(f"--mesh-sp {mesh_sp}: not ported yet "
                                  f"(ROADMAP.md queue 1: {SPATIAL})")
    world = multihost.process_count()
    if mesh_data <= 1:
        return DataGroup()
    if world == 1:
        raise ValueError(
            f"--mesh-data {mesh_data} runs one rank per device: launch "
            f"{mesh_data} processes with --dist-coordinator host:port "
            f"--dist-nprocs {mesh_data} --dist-procid <i> (or --dist-"
            "coordinator auto under torchrun); a single process never "
            "runs a data axis on its own")
    if mesh_data != world:
        raise ValueError(f"--mesh-data {mesh_data} must equal the number of "
                         f"ranks ({world}): one device per rank")
    return DataGroup(dist.get_rank(), world, dist.group.WORLD)


def eval_group(mesh_data: int = 1) -> DataGroup:
    """Evaluation's group: --mesh-data's, and in a multi-process run every
    rank even without it (the JAX package's eval_mesh)."""
    if mesh_data <= 1 and multihost.is_multiprocess():
        return make_data_group(multihost.process_count())
    return make_data_group(mesh_data)


def active() -> DataGroup:
    return _ACTIVE


@contextlib.contextmanager
def data_parallel(group: DataGroup):
    """Run the body with `group` as the data group in force, and hand
    BatchNorm its sum over the group's ranks."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, group
    norm_before = norm.set_group_sum(
        (all_reduce_sum, group.size) if group.group is not None else None)
    try:
        yield group
    finally:
        _ACTIVE = before
        norm.set_group_sum(norm_before)


def select_device(kind: str = "cuda", device_id: int = 0) -> torch.device:
    """The rank's device: cuda:<device_id> (under torchrun, cuda:LOCAL_RANK
    when --device-id is 0), made current so that NCCL finds it; or the
    CPU."""
    from ..utils.device import resolve_device

    if kind != "cuda":
        return resolve_device("cpu")
    index = device_id or int(os.environ.get("LOCAL_RANK", 0))
    device = resolve_device(f"cuda:{index}")
    torch.cuda.set_device(device)
    return device


def local_rows(n: int) -> int:
    """This rank's share of a global batch of n."""
    if n % _ACTIVE.size:
        raise ValueError(f"a batch of {n} does not split over the "
                         f"{_ACTIVE.size} ranks of the data axis")
    return n // _ACTIVE.size



class _Timed:
    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        if timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if timing:
            COLLECTIVE_SECONDS[0] += time.perf_counter() - self.t0


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward is the same all-reduce of the
    incoming gradients, recorded when the backward builds a graph."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the group, differentiable twice (the gradient
    penalty's double backward runs through it). Under gloo a CUDA tensor
    is copied to the host and back."""
    if _ACTIVE.group is None:
        return t
    comm = multihost.comm_device(_ACTIVE.group)
    with _Timed(t.device):
        out = _AllReduceSum.apply(t.to(comm), _ACTIVE.group).to(t.device)
    return out


@torch.no_grad()
def mean_(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The group means of `tensors` (one all-reduce of one flat buffer),
    written into them in place; returned for convenience."""
    tensors = list(tensors)
    if _ACTIVE.group is None or not tensors:
        return tensors
    comm = multihost.comm_device(_ACTIVE.group)
    with _Timed(tensors[0].device):
        flat = torch.cat([t.reshape(-1).float() for t in tensors]).to(comm)
        dist.all_reduce(flat, group=_ACTIVE.group)
        flat = flat.div_(_ACTIVE.size).to(tensors[0].device)
    for t, m in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(m.view_as(t))
    return tensors


def mean_metrics(metrics: dict) -> dict:
    """The group means of a dict of scalar tensors, in one collective."""
    if _ACTIVE.group is None or not metrics:
        return metrics
    vals = mean_([torch.stack([v.float() for v in metrics.values()])])[0]
    return dict(zip(metrics, vals.unbind()))
