"""BatchNorm as a function of explicit (mean, var) state, on NCHW or NCDHW
tensors.

The port of the JAX package's `ops/norm.py`. MindSpore semantics, which the JAX
package keeps and `nn.BatchNorm2d` does not: the moving statistics fold the
BIASED batch variance, as `moving = 0.9 * moving + 0.1 * batch`, and eps is
1e-5.

Three modes:
  * "batch":  statistics of the whole batch, over (0, 2, ...); returns the
    folded moving stats. With `groups` > 1 the batch splits into that many
    equal contiguous parts, each normalised by its own statistics, and the
    moving stats fold them in order, part 0 first: one forward of width
    G * B equals G forwards of width B (the paired G step's).
  * "moving": the carried moving statistics; state unchanged.
  * "sample": statistics over the spatial (and time) axes (2, ...) of each
    sample on its own. One batched forward in this mode equals the JAX
    sampler's vmap of batch-1 train-mode forwards (parallel/sampling.py:73-82
    there); the moving stats those forwards would fold are discarded, so
    state is unchanged.

In "batch" mode under a data group of several ranks the statistics are the
global batch's: each part's sums are summed over the ranks
(`_group_batch_stats`, with the sum that parallel/mesh.py::data_parallel
hands over through `set_group_sum`), so N ranks normalise as one process at
the global batch does. An activation whose H is split over the spatial
axis (`sharded`, parallel/spatial.py) sums over the spatial ranks too,
with the sum handed over through `set_sharded_sum`; a replicated one holds
all of H on every spatial rank and sums over the data axis alone, so its
rows count once. The sums are divided by the global number of elements:
the rank's count times the number of ranks for the equal split, and for
a padded layout (spatial.Padded (h, p), whose edge ranks hold p more rows)
the rows of one column, h + 2p, times the rest of the rank's count, times
the data ranks (`_elements`). "moving" needs no collective; "sample"
(sampling only) refuses a sharded activation.

Statistics are reduced in float32 whatever the activations' dtype, and the
normalisation runs in the activations' dtype (bfloat16 under
`--compute-dtype bfloat16`, ops/norm.py:40-75 there).

A channels-last 5-D activation (ops/layout.py) comes out channels-last.
In "batch" mode with one group its statistics and normalisation run on
its memory as the matrix of rows (B * D * H, W * C) (`layout.rows`, a
view): PyTorch's reductions over the axes (0, 2, 3, 4) of a channels-last
tensor, C outputs, run at a half to a third of the bandwidth of those
over the W * C columns, and so do the sums of the normalisation's
backward. On the card the statistics are then each column's, combined
per channel; elsewhere (the CPU, where the tests hold the port to the JAX
package) they are taken of an NCDHW copy, as in the NCDHW layout to the
bit: the CPU sums a channels-last tensor in another order, and the
critic's gradients move by more than those tests' bounds where that
rounding puts a LeakyReLU input on the other side of 0.
Otherwise the elementwise ops keep the strides of x, their first operand;
with `groups` > 1 they run on the split of the batch, a view, whose
result `to_port` gives a batch stride that PyTorch's layout test reads as
channels-last again.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .layout import from_rows, ndhwc, rows, to_port

BN_MODES = ("batch", "moving", "sample")

# (the differentiable sum over the data group's ranks, their number) while
# a group of several ranks is in force; None on one rank
GroupSum = Optional[Tuple[Callable[[torch.Tensor], torch.Tensor], int]]
_GROUP_SUM: GroupSum = None
# the same over every rank of the mesh (data and spatial axes), for an
# H-sharded activation, while the spatial axis has several ranks
_SHARDED_SUM: GroupSum = None


def set_group_sum(group_sum: GroupSum) -> GroupSum:
    """Make `group_sum` the one batch statistics are reduced with; returns
    the one it replaces."""
    global _GROUP_SUM
    before, _GROUP_SUM = _GROUP_SUM, group_sum
    return before


def set_sharded_sum(sharded_sum: GroupSum) -> GroupSum:
    """Make `sharded_sum` the one an H-sharded activation's statistics are
    reduced with; returns the one it replaces."""
    global _SHARDED_SUM
    before, _SHARDED_SUM = _SHARDED_SUM, sharded_sum
    return before


def batch_stats(x: torch.Tensor, groups: int = 1, sharded=False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 mean and biased variance over (0, 2, ...) of each of `groups`
    equal parts of the batch: two (groups, C) tensors. Under a data group
    of several ranks, x is this rank's rows of each part and the statistics
    are the global batch's; `sharded` (True or a spatial.Padded layout): x
    holds the rank's rows of H, and the statistics are those of all of
    H."""
    xf = x.float()
    group_sum = _SHARDED_SUM if sharded else _GROUP_SUM
    if group_sum is not None:
        fn, ranks = group_sum
        return _group_batch_stats(xf, groups, fn,
                                  _elements(xf, groups, ranks, sharded))
    if groups == 1:
        if xf.ndim == 5 and ndhwc(xf):
            if xf.is_cuda:
                return _row_stats(xf)
            xf = xf.contiguous()
        dims = (0,) + tuple(range(2, x.ndim))
        return (xf.mean(dim=dims).unsqueeze(0),
                xf.var(dim=dims, unbiased=False).unsqueeze(0))
    xg = xf.reshape((groups, -1) + tuple(x.shape[1:]))
    dims = (1,) + tuple(range(3, xg.ndim))
    return xg.mean(dim=dims), xg.var(dim=dims, unbiased=False)


def _row_stats(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch_stats of a dense NDHWC xf, groups 1, from its rows
    (ops/layout.py): each of the W * C columns' own mean and biased
    variance in one pass, then each channel's W columns combined, which
    their equal counts make exact (the variance: the columns' mean
    variance plus the variance of their means)."""
    w, c = xf.shape[4], xf.shape[1]
    var, mean = torch.var_mean(rows(xf), 0, correction=0)
    mean, var = mean.view(w, c), var.view(w, c)
    b_mean = mean.mean(0)
    b_var = var.mean(0) + ((mean - b_mean) ** 2).mean(0)
    return b_mean.unsqueeze(0), b_var.unsqueeze(0)


def _elements(xf: torch.Tensor, groups: int, ranks: int, sharded) -> int:
    """The global number of elements of each channel of each part of the
    batch, over `ranks` ranks that each hold xf's share: xf's count times
    `ranks` where the shares are equal; for a padded layout (h, p) with
    p > 0, the global rows h + 2p times the count of one of xf's rows,
    times the data ranks."""
    n = xf.numel() // (groups * xf.shape[1])
    padded = getattr(sharded, "p", 0)
    if not padded:
        return n * ranks
    data = _GROUP_SUM[1] if _GROUP_SUM is not None else 1
    return n // xf.shape[-2] * (sharded.h + 2 * padded) * data


def _group_batch_stats(xf: torch.Tensor, groups: int, group_sum, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch_stats over the data group, in two passes as the float32 JAX
    reduction: the global mean, then the global mean squared deviation
    from it, each a `group_sum` of the ranks' sums divided by the global
    count n."""
    xg = xf.reshape((groups, -1) + tuple(xf.shape[1:]))
    dims = (1,) + tuple(range(3, xg.ndim))
    mean = group_sum(xg.sum(dim=dims)) / n
    shape = (groups, 1, -1) + (1,) * (xg.ndim - 3)
    dev = (xg - mean.reshape(shape)) ** 2
    return mean, group_sum(dev.sum(dim=dims)) / n


def fold(mean: torch.Tensor, var: torch.Tensor, b_mean: torch.Tensor,
         b_var: torch.Tensor, momentum: float = 0.9
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The moving stats after folding each row of (b_mean, b_var), row 0
    first."""
    for i in range(b_mean.shape[0]):
        mean = momentum * mean + (1 - momentum) * b_mean[i]
        var = momentum * var + (1 - momentum) * b_var[i]
    return mean, var


def normalize_batch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    b_mean: torch.Tensor, b_var: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """x normalised by batch_stats' (groups, C) statistics, in x's dtype."""
    groups = b_mean.shape[0]
    inv = torch.rsqrt(b_var + eps) * gamma
    if groups == 1 and x.ndim == 5 and ndhwc(x):  # by rows, as _row_stats
        w = x.shape[4]
        y = (rows(x) - b_mean[0].repeat(w).to(x.dtype)) \
            * inv[0].repeat(w).to(x.dtype) + beta.repeat(w).to(x.dtype)
        return from_rows(y, x.shape)
    if groups == 1:  # on x itself, whose strides the result then keeps
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - b_mean.reshape(shape).to(x.dtype)) \
            * inv.reshape(shape).to(x.dtype) + beta.reshape(shape).to(x.dtype)
    shape = (groups, 1, -1) + (1,) * (x.ndim - 2)
    xg = x.reshape((groups, -1) + tuple(x.shape[1:]))
    y = (xg - b_mean.reshape(shape).to(x.dtype)) \
        * inv.reshape(shape).to(x.dtype) + beta.reshape(shape[1:]).to(x.dtype)
    return to_port(y.reshape(x.shape))


def batchnorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              mean: torch.Tensor, var: torch.Tensor, mode: str,
              momentum: float = 0.9, eps: float = 1e-5, groups: int = 1,
              sharded=False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, C, H, W) or (B, C, T, H, W), the rank's rows of H when
    `sharded` (True or a spatial.Padded layout). Returns (y, new_mean,
    new_var)."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    spatial = tuple(range(2, x.ndim))
    if mode == "batch":
        b_mean, b_var = batch_stats(x, groups, sharded)
        new_mean, new_var = fold(mean, var, b_mean, b_var, momentum)
        return normalize_batch(x, gamma, beta, b_mean, b_var, eps), \
            new_mean, new_var
    if groups != 1:
        raise ValueError(f"groups={groups} needs batch mode, not {mode!r}")
    if mode == "moving":
        inv = torch.rsqrt(var + eps) * gamma
        y = (x - mean.reshape(shape).to(x.dtype)) \
            * inv.reshape(shape).to(x.dtype) + beta.reshape(shape).to(x.dtype)
        return y, mean, var
    if mode == "sample":
        if sharded:
            raise NotImplementedError("per-sample BatchNorm of an H-sharded "
                                      "activation: sampling never shards H")
        s_mean = x.mean(dim=spatial, keepdim=True)  # (B, C, 1, 1[, 1])
        s_var = x.var(dim=spatial, unbiased=False, keepdim=True)
        inv = torch.rsqrt(s_var + eps) * gamma.reshape(shape)
        y = (x - s_mean) * inv + beta.reshape(shape)
        return y, mean, var
    raise ValueError(f"unknown batchnorm mode {mode!r} (have {BN_MODES})")
