"""The spatial axis of the ('data', 'sp') mesh: H split over ranks, and the
exchanges that the split needs, written by hand.

The JAX package has no counterpart of this module. There, `--mesh-sp S`
constrains the training step's inputs to be H-sharded over the mesh's 'sp'
axis wherever H divides by S (training/steps.py::_mesh_shard_fn there),
and XLA's SPMD partitioner writes every exchange that the sharding needs:
the halo rows of each 3x3 convolution, the gathers of the align-corners
resizes between stages, the sums of BatchNorm and of the loss means. N
devices then compute what one device computes. The port runs one device
per rank and no partitioner, so these are the exchanges XLA wrote.

Layout. Rank s of the spatial axis (parallel/mesh.py::DataGroup.sp, S
ranks) holds rows [s * H / S, (s + 1) * H / S) of every activation whose
global height H divides by S (`sharded`), and all of H of every other one
(replicated). H is axis -2 of NCHW and NCDHW tensors; T is never split.
A module learns whether its activation is sharded from its pyramid height
(utils/pyramid.py::scale_height): a rank's shape alone cannot tell 9 rows
of 18 from a whole 9.

Padded layouts (the CSG/SG baselines, models/networks_3d.py). A baseline
stage zero-pads its input by p rows on every side and runs padding-0
convolutions, each of which takes a row off the top and the bottom of the
global tensor; the baselines' critic pads by num_layer + 2. An activation
of unpadded height H that carries p pad rows on each side is held in the
layout (H, p) (`Padded`): rank s holds its H / S rows, and rank 0 the p
rows above them, rank S - 1 the p rows below (`rows(h, p)`). The shards
are unequal for p > 0 and S > 2: the edge ranks hold H / S + p rows, the
middle ones H / S. The zero pad is local (`edge_pads`). A padding-0
convolution takes the same 1-row halo as a padding-1 one, less the zero
row past the global edge on rank 0 and on rank S - 1 (`drop_edges`, a
local slice: every rank still exchanges), and pads H no further, so that
its output, one row shorter a side on the edge ranks, is in the layout
(H, p - 1); a padding-1 convolution keeps the layout (`conv_layout`).
(H, 0) is the equal split.

The exchanges, each a `torch.autograd.Function` whose backward is its
exact adjoint, itself built from these functions, so that the gradient
penalty's double backward runs through them:
  shard_rows   the rank's rows of a whole tensor; adjoint: the rows placed
               in zeros (`_Pad`), whose adjoint is the slice again
  gather_rows  every rank's rows, all-gathered; adjoint: the rank's rows
               of the gradient summed over the axis
  halo         the rank's rows with k rows of each neighbour above and
               below, zeros past the global edges; adjoint: `_HaloAdjoint`,
               each halo row's gradient sent back to the neighbour it came
               from and added there, whose adjoint is the halo again
  sum_sp       the sum over the axis; its own adjoint
Every rank issues the same collectives in the same order, in the forward,
the backward and the double backward: an edge rank exchanges too, and
takes zeros for the rows past the edge. The exchanges are all-gathers (of
each rank's edge rows for a halo), which need no ordering of sends and
receives. The copies to the collective's device (the host under gloo) are
inside each function, so that the backward runs every exchange on the
tensor's device's one autograd thread; bfloat16 travels as its bytes. The
collectives take dense NCHW / NCDHW copies; what a function hands on is
in the port's memory layout (ops/layout.py: channels-last in 3D).

Gradients (training/steps.py, losses.py): each rank's losses are means
over its own rows, and the gradients are averaged over all D x S ranks,
which is the global mean's gradient because the shards are equal and a
replicated term is the same on every rank; a mean over a padded layout's
unequal shards is weighted to make it so (`mean`), and BatchNorm counts a
padded layout's elements globally (ops/norm.py). Parameters are
replicated.
"""

from __future__ import annotations

import collections
from typing import List, NamedTuple, Tuple, Union

import torch
import torch.distributed as dist

from ..ops.layout import memory_format, to_port
from . import mesh, multihost

# the heights of the inputs the H-sharded convolutions ran on (the rank's
# rows plus the halos), by height, until a caller clears it
conv_rows: collections.Counter = collections.Counter()


def axis() -> mesh.Axis:
    """The spatial axis in force."""
    return mesh.active().sp


def sharded(h: int) -> bool:
    """Whether an activation of global height h is split over the spatial
    axis in force: where it has several ranks and h divides by them."""
    s = axis().size
    return s > 1 and h % s == 0


class Padded(NamedTuple):
    """The layout (h, p): an activation of unpadded global height h, split
    over the axis, with p pad rows above and below it held by the edge
    ranks (module docstring). Padded(h, 0) is the equal split."""
    h: int
    p: int


# what a module's `sharded` argument holds: False (all of H on every
# rank), True (the equal split of its height) or a Padded layout
Layout = Union[bool, Padded]


def layout(h: int, p: int) -> Layout:
    """The layout (h, p) where the axis splits h, else False."""
    return Padded(h, p) if sharded(h) else False


def rows(h: int, p: int = 0) -> Tuple[int, int]:
    """(first row, number of rows) of this rank's share of the global
    height h + 2p of the layout (h, p): its h / S rows, with the p rows
    above them on rank 0 and the p rows below on rank S - 1; (0, h + 2p)
    where h is not split."""
    if not sharded(h):
        return 0, h + 2 * p
    ax = axis()
    n = h // ax.size
    first, last = ax.rank == 0, ax.rank == ax.size - 1
    return (0 if first else p + ax.rank * n), n + p * first + p * last


def edge_pads(p: int) -> Tuple[int, int]:
    """(rows above, rows below) of this rank's share of a zero pad of p
    rows on each side of a split height: p and 0 on rank 0, 0 and p on
    rank S - 1, none on the others."""
    ax = axis()
    return p * (ax.rank == 0), p * (ax.rank == ax.size - 1)


def drop_edges(x: torch.Tensor, k: int) -> torch.Tensor:
    """x without its first k rows on rank 0 and its last k rows on rank
    S - 1: a halo's zero rows past the global edges, which a padding-0
    convolution does not read; a 5-D x's rows dense in the port's
    layout (ops/layout.py), the copy the convolution would make."""
    top, bottom = edge_pads(k)
    return to_port(x.narrow(-2, top, x.shape[-2] - top - bottom))


def conv_layout(sharded: Layout, ker: int, padding: int) -> Layout:
    """The layout of a stride-1 convolution's output from its input's: a
    padded layout loses (ker - 1) / 2 - padding pad rows a side; the other
    layouts are kept."""
    if isinstance(sharded, Padded):
        return sharded._replace(p=sharded.p + padding - (ker - 1) // 2)
    return sharded


def mean(t: torch.Tensor, sharded: Layout) -> torch.Tensor:
    """torch.mean(t) of the rank's share of a tensor in layout `sharded`,
    weighted by S * n / N (n the rank's rows, N = h + 2p the global ones)
    where the shards are unequal, so that the mean over the axis's ranks
    is the global mean; the plain mean otherwise."""
    if not isinstance(sharded, Padded) or not sharded.p:
        return torch.mean(t)
    n, total = t.shape[-2], sharded.h + 2 * sharded.p
    return torch.mean(t) * (axis().size * n / total)


def local_h(h: int) -> int:
    """This rank's rows of global height h."""
    return rows(h)[1]


def _all_gather(t: torch.Tensor, ax: mesh.Axis) -> List[torch.Tensor]:
    """Every rank's `t` over `ax`, in rank order, on t's device; bfloat16
    travels as its bytes (gloo has no bfloat16 gather everywhere)."""
    comm = multihost.comm_device(ax.group)
    src = t.to(comm, memory_format=torch.contiguous_format)
    if src.dtype == torch.bfloat16:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    mesh.count("halo", src)
    dist.all_gather(parts, src, group=ax.group)
    return [p.view(t.dtype).to(t.device) for p in parts]


def _neighbour_rows(top: torch.Tensor, bottom: torch.Tensor, ax: mesh.Axis
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank hands over (top, bottom), k rows each; returns the rank
    above's `bottom` and the rank below's `top`, zeros past the edges."""
    k = top.shape[-2]
    parts = _all_gather(torch.cat([top, bottom], -2), ax)
    above = parts[ax.rank - 1].narrow(-2, k, k) if ax.rank > 0 \
        else torch.zeros_like(bottom)
    below = parts[ax.rank + 1].narrow(-2, 0, k) if ax.rank < ax.size - 1 \
        else torch.zeros_like(top)
    return above, below


class _Narrow(torch.autograd.Function):
    """Rows [start, start + n) of axis -2."""

    @staticmethod
    def forward(ctx, x, start, n):
        ctx.start, ctx.h = start, x.shape[-2]
        return x.narrow(-2, start, n).clone(
            memory_format=memory_format(x.ndim))

    @staticmethod
    def backward(ctx, grad):
        return _Pad.apply(grad, ctx.start, ctx.h), None, None


class _Pad(torch.autograd.Function):
    """x as rows [start, start + n) of h rows of zeros."""

    @staticmethod
    def forward(ctx, x, start, h):
        ctx.start, ctx.n = start, x.shape[-2]
        out = torch.zeros(tuple(x.shape[:-2]) + (h, x.shape[-1]),
                          dtype=x.dtype, device=x.device,
                          memory_format=memory_format(x.ndim))
        out.narrow(-2, start, ctx.n).copy_(x)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Narrow.apply(grad, ctx.start, ctx.n), None, None


class _GatherRows(torch.autograd.Function):
    """All of H from every rank's rows of it."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.n = ax, x.shape[-2]
        return torch.cat(_all_gather(x, ax), -2)

    @staticmethod
    def backward(ctx, grad):
        summed = mesh.group_sum(grad, ctx.ax.group, "halo")
        return _Narrow.apply(summed, ctx.ax.rank * ctx.n, ctx.n), None


class _Halo(torch.autograd.Function):
    """The rank's rows with k rows of each neighbour above and below."""

    @staticmethod
    def forward(ctx, x, k, ax):
        ctx.k, ctx.ax = k, ax
        above, below = _neighbour_rows(x.narrow(-2, 0, k),
                                       x.narrow(-2, x.shape[-2] - k, k), ax)
        return torch.cat([to_port(above), x, to_port(below)], -2)

    @staticmethod
    def backward(ctx, grad):
        return _HaloAdjoint.apply(grad, ctx.k, ctx.ax), None, None


class _HaloAdjoint(torch.autograd.Function):
    """The adjoint of _Halo: the middle rows of the gradient, plus the
    rank above's bottom halo rows on the first k rows and the rank below's
    top halo rows on the last k."""

    @staticmethod
    def forward(ctx, grad, k, ax):
        ctx.k, ctx.ax = k, ax
        n = grad.shape[-2] - 2 * k
        above, below = _neighbour_rows(grad.narrow(-2, 0, k),
                                       grad.narrow(-2, n + k, k), ax)
        out = grad.narrow(-2, k, n).clone(
            memory_format=memory_format(grad.ndim))
        out.narrow(-2, 0, k).add_(above)
        out.narrow(-2, n - k, k).add_(below)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Halo.apply(grad, ctx.k, ctx.ax), None, None


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole tensor `x` (its H is the global
    height); `x` itself where that height is not split."""
    start, n = rows(x.shape[-2])
    if n == x.shape[-2]:
        return x
    return _Narrow.apply(x, start, n)


def gather_rows(x: torch.Tensor, h: int) -> torch.Tensor:
    """All h rows of `x`, which holds this rank's rows of global height h
    where h is split (gathered from every rank), and all of them where it
    is not (`x` itself)."""
    if not sharded(h):
        return x
    if x.shape[-2] != local_h(h):
        raise ValueError(f"{x.shape[-2]} rows of a height {h} split over "
                         f"{axis().size} ranks")
    return _GatherRows.apply(x, axis())


def halo(x: torch.Tensor, k: int) -> torch.Tensor:
    """This rank's rows of `x` (an H-sharded activation) with k rows of
    each neighbour above and below, zeros past the global edges: the input
    of a convolution that pads H by k, cut to the rows the rank's output
    rows read."""
    if x.shape[-2] < k:
        raise ValueError(f"a halo of {k} rows around {x.shape[-2]}")
    return _Halo.apply(x, k, axis())


def sum_sp(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the spatial axis in force (differentiable
    twice)."""
    return mesh.group_sum(t, axis().group, "halo")
