"""The ('data', 'sp') mesh of the JAX package's `parallel/mesh.py`, over
ranks.

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
ones. `--mesh-data` x `--mesh-sp` must equal the number of ranks; without
them a
multi-process run trains a replicated program on every rank (the JAX
trainer's mesh None) and evaluation still shards its samples over all
ranks (`eval_group`).

The spatial axis (--mesh-sp S, the JAX mesh's 'sp'): the ranks form a
D x S grid, rank d * S + s (JAX's `reshape(dp, n // dp)`), and
`DataGroup.sp` is the rank's row of S ranks, over which H is split
(parallel/spatial.py holds its exchanges). Each data rank of the JAX
package's batch is then S ranks here: the data group is the rank's column
of D ranks (its place s on the spatial axis fixed), and the sums that span
both axes (the gradients, the metrics, the statistics of an H-sharded
activation) run over all D x S ranks in one collective (`sum_all`,
`mean_`). Each rank's losses are means over its own shard, and shards are
equal (H is split only where it divides by S), so the mean over all ranks
is the global mean; the baselines' padded layouts, whose edge ranks hold
more rows, weigh their means (parallel/spatial.py::mean).

The group in force is set by `data_parallel(group)` for the extent of a
run, and every helper here, the draws (utils/noise.py), BatchNorm and the
spatial exchanges read that one; outside it, the trivial group (no process
group), where every helper is the identity and issues no collective. A
group of one rank in a process group runs its collectives (NCCL's one-rank
path on the card).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops import norm
from . import multihost

class Axis(NamedTuple):
    """This rank's place on one axis of the mesh: index `rank` of `size`
    ranks, whose collectives run over `group` (None: one rank, none)."""
    rank: int = 0
    size: int = 1
    group: Optional[object] = None


class DataGroup(NamedTuple):
    """This rank's place on the data axis: rows [rank * b, (rank + 1) * b)
    of a global batch of size * b; and `sp`, its place on the spatial
    axis."""
    rank: int = 0
    size: int = 1
    group: Optional[object] = None  # the process group; None: one rank
    sp: Axis = Axis()


_ACTIVE = DataGroup()
# the kinds of collective the program issues: the gradients' mean
# (training/steps.py::_set_grads), the metrics' and the calibration's
# means, BatchNorm's group sums (forward and backward, `group_sum`), and the
# spatial axis' exchanges (parallel/spatial.py: its all-gathers and sums)
KINDS = ("grad", "metric", "bn", "halo")
# [calls, bytes] of each kind issued: the bytes of the buffer the rank hands
# to the collective (one rank's part of an all-gather); a captured
# collective counts once, at its capture, not at the replays
_COLLECTIVES = {kind: [0, 0] for kind in KINDS}


def check_mesh(mesh_data: int = 1, mesh_sp: int = 1) -> None:
    """Refuse a mesh that the ranks of this run cannot form: more than one
    rank in one process, or D x S other than the number of ranks."""
    if mesh_data <= 1 and mesh_sp <= 1:
        return
    world = multihost.process_count()
    flags = " ".join(f"{flag} {n}" for flag, n in (
        ("--mesh-data", mesh_data), ("--mesh-sp", mesh_sp)) if n > 1)
    n = max(mesh_data, 1) * max(mesh_sp, 1)
    if world == 1:
        raise ValueError(
            f"{flags} runs one rank per device: launch {n} processes with "
            f"--dist-coordinator host:port --dist-nprocs {n} --dist-procid "
            "<i> (or --dist-coordinator auto under torchrun); a single "
            "process never runs a mesh axis on its own")
    if n != world:
        raise ValueError(f"--mesh-data {mesh_data} x --mesh-sp {mesh_sp} = "
                         f"{n} must equal the number of ranks ({world}): one "
                         "device per rank")


def make_data_group(mesh_data: int = 1, mesh_sp: int = 1) -> DataGroup:
    """The mesh of --mesh-data D x --mesh-sp S over the ranks, as the
    rank's DataGroup: the trivial group (a replicated program) when both
    are 1. Every rank makes every process group, in the same order: the
    S data columns of D ranks, then the D spatial rows of S ranks."""
    check_mesh(mesh_data, mesh_sp)
    d, s = max(mesh_data, 1), max(mesh_sp, 1)
    if d * s == 1:
        return DataGroup()
    rank = dist.get_rank()
    if s == 1:
        return DataGroup(rank, d, dist.group.WORLD)
    if d == 1:
        return DataGroup(sp=Axis(rank, s, dist.group.WORLD))
    columns = [dist.new_group([i * s + j for i in range(d)])
               for j in range(s)]
    rows = [dist.new_group([i * s + j for j in range(s)]) for i in range(d)]
    return DataGroup(rank // s, d, columns[rank % s],
                     Axis(rank % s, s, rows[rank // s]))


def eval_group(mesh_data: int = 1) -> DataGroup:
    """Evaluation's group: --mesh-data's, and in a multi-process run every
    rank even without it (the JAX package's eval_mesh)."""
    if mesh_data <= 1 and multihost.is_multiprocess():
        return make_data_group(multihost.process_count())
    return make_data_group(mesh_data)


def active() -> DataGroup:
    return _ACTIVE


def everyone():
    """(the process group of all D x S ranks in force, None without one;
    their number)."""
    return _everyone(_ACTIVE)


def _everyone(group: DataGroup):
    """(the process group of all D x S ranks, their number)."""
    if group.sp.group is None:
        return group.group, group.size
    if group.group is None:
        return group.sp.group, group.sp.size
    return dist.group.WORLD, group.size * group.sp.size


@contextlib.contextmanager
def data_parallel(group: DataGroup):
    """Run the body with `group` (both of its axes) in force, and hand
    BatchNorm its sums: over the data axis for a replicated activation,
    over all ranks for an H-sharded one."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, group
    norm_before = norm.set_group_sum(
        (all_reduce_sum, group.size) if group.group is not None else None)
    sharded_before = norm.set_sharded_sum(
        (sum_all, _everyone(group)[1]) if group.sp.group is not None
        else None)
    try:
        yield group
    finally:
        _ACTIVE = before
        norm.set_group_sum(norm_before)
        norm.set_sharded_sum(sharded_before)


def select_device(kind: str = "cuda", device_id: int = 0,
                  rank: int = -1) -> torch.device:
    """The rank's device, made current so that NCCL finds it: cuda:<device_id>
    where --device-id is given (not 0); else cuda:LOCAL_RANK under
    torchrun; else, under the explicit bootstrap (`rank`, --dist-procid,
    >= 0), card rank % the cards this host has, so that the consecutive
    ranks of one host take a card each (NCCL refuses two ranks on one
    card); else cuda:0. Or the CPU."""
    from ..utils.device import resolve_device

    if kind != "cuda":
        return resolve_device("cpu")
    if device_id:
        index = device_id
    elif "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    elif rank >= 0 and torch.cuda.is_available():
        index = rank % torch.cuda.device_count()
    else:
        index = 0
    device = resolve_device(f"cuda:{index}")
    torch.cuda.set_device(device)
    return device


def local_rows(n: int) -> int:
    """This rank's share of a global batch of n."""
    if n % _ACTIVE.size:
        raise ValueError(f"a batch of {n} does not split over the "
                         f"{_ACTIVE.size} ranks of the data axis")
    return n // _ACTIVE.size


def collectives() -> Dict[str, List[int]]:
    """{kind: [calls, bytes]} of the collectives issued so far in this
    process (KINDS), a copy."""
    return {kind: list(v) for kind, v in _COLLECTIVES.items()}


def count(kind: str, t: torch.Tensor) -> None:
    """Count one collective of `kind` on the rank's buffer `t`, where it is
    issued."""
    c = _COLLECTIVES[kind]
    c[0] += 1
    c[1] += t.numel() * t.element_size()


class _AllReduceSum(torch.autograd.Function):
    """Sum over `group`; the backward is the same all-reduce of the
    incoming gradients, recorded when the backward builds a graph. The
    copies to and from the collective's device (the host under gloo) are
    inside, so that the node's gradients stay on the tensor's device and
    the backward runs every exchange on that device's one autograd thread,
    in the same order on every rank."""

    @staticmethod
    def forward(ctx, t, group, kind):
        ctx.group, ctx.kind = group, kind
        comm = multihost.comm_device(group)
        out = t.to(comm, memory_format=torch.contiguous_format, copy=True)
        count(kind, out)
        dist.all_reduce(out, group=group)
        return out.to(t.device)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group, ctx.kind), None, None


def group_sum(t: torch.Tensor, group, kind: str = "bn") -> torch.Tensor:
    """The sum of `t` over the ranks of `group` (None: `t`), differentiable
    twice (the gradient penalty's double backward runs through it), counted
    as a collective of `kind` (its backward's too); a bfloat16 tensor is
    summed in float32 and rounded back once."""
    if group is None:
        return t
    if t.dtype == torch.bfloat16:
        return _AllReduceSum.apply(t.float(), group, kind).to(t.dtype)
    return _AllReduceSum.apply(t, group, kind)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the data axis in force. Under gloo a CUDA
    tensor is copied to the host and back."""
    return group_sum(t, _ACTIVE.group)


def sum_all(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over all D x S ranks in force."""
    return group_sum(t, _everyone(_ACTIVE)[0])


@torch.no_grad()
def mean_(tensors: Sequence[torch.Tensor], kind: str = "grad"
          ) -> List[torch.Tensor]:
    """The means of `tensors` over all D x S ranks in force (one
    all-reduce of one flat buffer, counted as `kind`), written into them
    in place; returned for convenience."""
    tensors = list(tensors)
    group, n = _everyone(_ACTIVE)
    if group is None or not tensors:
        return tensors
    comm = multihost.comm_device(group)
    flat = torch.cat([t.reshape(-1).float() for t in tensors]).to(comm)
    count(kind, flat)
    dist.all_reduce(flat, group=group)
    flat = flat.div_(n).to(tensors[0].device)
    for t, m in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(m.view_as(t))
    return tensors


def mean_metrics(metrics: dict) -> dict:
    """The means over all ranks of a dict of scalar tensors, in one
    collective."""
    if _everyone(_ACTIVE)[0] is None or not metrics:
        return metrics
    vals = mean_([torch.stack([v.float() for v in metrics.values()])],
                 "metric")[0]
    return dict(zip(metrics, vals.unbind()))
