"""The memory layout the port keeps its tensors in, by their rank.

A 5-D tensor of the 3D path (an NCDHW activation, an OIDHW weight) is kept
channels-last: `torch.channels_last_3d`, NDHWC strides (ODHWI for a
weight) under the same NCDHW shape. cuDNN's convolution engines on the
card are NHWC kernels; handed NCDHW operands, they wrap every forward,
dgrad and wgrad in layout transforms of the operands and the result. A
4-D tensor of the 2D path stays NCHW, as PyTorch makes it.

The layout is set where a tensor enters the 3D path: the convolution
weights when they are made (models/blocks.py; loading copies into them),
the clips of a batch (data/video.py), and the generators' noise inputs
(models/networks_3d.py). Every op between two convolutions keeps its
input's layout (ops/resize.py, ops/norm.py, parallel/spatial.py); the
convolutions count which layout their operands arrive in
(ops/conv.py). A sum over every axis but the channels runs over the
tensor's memory as rows of W * C (`rows`, `channel_sum`), where
PyTorch's reduction over the axes would have C outputs. Values do not
depend on the layout: the noise is drawn in NCDHW order as before, and a
conversion copies.

A dense channels-last tensor whose batch is 1 may carry a batch stride
smaller than a sample (an elementwise op on a view of the batch split in
groups leaves one). `is_contiguous(memory_format=torch.channels_last_3d)` ignores the
stride of a size-1 dim, but PyTorch's layout test (`suggest_memory_format`)
reads it, and cuDNN's weight gradient, which asks it of its two
activations, then copies both to NCDHW. `to_port` gives such a tensor
the strides of its sizes, as a view.
"""

from __future__ import annotations

import torch

# the layout of 5-D tensors
FORMAT_5D = torch.channels_last_3d


def memory_format(ndim: int) -> torch.memory_format:
    """The layout of a tensor of rank `ndim`."""
    return FORMAT_5D if ndim == 5 else torch.contiguous_format


def ndhwc(t: torch.Tensor) -> bool:
    """Whether 5-D `t` is dense channels-last with the strides of its
    sizes, which cuDNN's wrapper takes as NDHWC whatever its batch."""
    b, c, d, h, w = t.shape
    return t.stride() == (c * d * h * w, 1, h * w * c, w * c, c) \
        or t.numel() == 0


def to_port(t: torch.Tensor) -> torch.Tensor:
    """`t` in the layout of its rank: a 5-D tensor channels-last (`t`
    itself where it is dense so, else a copy), with the strides PyTorch's
    layout test reads as channels-last (a view where a size-1 dim's stride
    reads otherwise); a tensor of another rank as it is."""
    if t.ndim != 5:
        return t
    t = t.contiguous(memory_format=FORMAT_5D)
    if FORMAT_5D != torch.channels_last_3d or ndhwc(t):
        return t
    # dense NDHWC: the same memory, viewed with every stride from the sizes
    b, c, d, h, w = t.shape
    return t.movedim(1, -1).reshape(-1).view(b, d, h, w, c).movedim(-1, 1)


def rows(t: torch.Tensor) -> torch.Tensor:
    """A dense NDHWC 5-D `t` (`ndhwc`) as the (B * D * H, W * C) matrix its
    memory is, a view. A reduction over its rows has W * C outputs, where
    one over t's axes (0, 2, 3, 4) has C, which PyTorch's reduction
    kernels run at half the bandwidth or less on a channels-last tensor."""
    b, c, d, h, w = t.shape
    return t.movedim(1, -1).reshape(b * d * h, w * c)


def from_rows(r: torch.Tensor, shape) -> torch.Tensor:
    """`rows`' inverse: the NDHWC tensor of `shape` whose rows `r` are."""
    b, c, d, h, w = shape
    return r.view(b, d, h, w, c).movedim(-1, 1)


def channel_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over every axis but the channels (axis 1): by
    `rows` where t is dense NDHWC."""
    if t.ndim == 5 and ndhwc(t):
        return rows(t).sum(0).view(t.shape[4], t.shape[1]).sum(0)
    return t.sum([0] + list(range(2, t.ndim)))
