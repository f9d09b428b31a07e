"""Convolution helpers on NCHW / NCDHW tensors with OIHW / OIDHW weights.

The port of the JAX package's `ops/conv.py`. The JAX package keeps HWIO /
DHWIO weights and channels-last activations; the port keeps PyTorch's
shapes, and tools/convert.py carries weights across. The convolutions
themselves are `F.conv2d` / `F.conv3d` (cuDNN on the card), as XLA ran them
outside any Pallas kernel in the JAX package.

In memory (ops/layout.py) a 2D tensor is NCHW; a 3D activation is
channels-last (NDHWC strides under the NCDHW shape) and a 3D weight ODHWI,
so that cuDNN's NHWC engines take them without layout transforms. Each 3D
convolution this module issues (forward, dgrad, wgrad, and the
second-order wgrad and forward of `_ConvInputGrad.backward`) adds 1 to the
counter `conv.ndhwc` where its activation operand (the forward's and the
wgrads' input, the dgrad's output gradient) is dense channels-last with
the strides of its sizes (`layout.ndhwc`), else to `conv.ncdhw`, when
Python issues it: eagerly, or once at a capture. The forward's input is
counted as the model hands it, then given the strides of its sizes
(`to_port`: a view where a batch of 1 has another batch stride, which
cuDNN's weight gradient would read as NCDHW). An incoming gradient is
taken into the layout before it is counted: autograd hands it in
whatever layout the op after the convolution gave it (a mean's backward
a dense NCDHW one, a sum's a broadcast), and one copy then serves the
dgrad and the wgrad, where PyTorch's wrapper would copy it for each.
Every result is in the layout: cuDNN writes it so, and where the CPU's
kernels write NCDHW (a batch of 1) `to_port` copies it. The bias
gradient sums by rows (`layout.channel_sum`).

`compute_dtype` (bfloat16 under `--compute-dtype bfloat16`) is the JAX
package's flow-through, not autocast: the input and the weight are cast to
it, the output stays in it, and the bias is added in the output's dtype
(ops/conv.py:40-75 there). Without it the conv runs in the input's dtype.

`sharded` (the input holds this rank's rows of an H split over the spatial
axis, parallel/spatial.py): H is padded with the neighbours' rows
(`spatial.halo`, k = padding) instead of zeros, the other axes with zeros
as always, so the rank's output is exactly its rows of the global output;
the height each such convolution ran on is counted in
`spatial.conv_rows`. An input in a padded layout (`spatial.Padded`, the
baselines' stages and critic) also takes a padding-0 convolution: the
same halo of (ker - 1) / 2 rows, less the rows past the global edges
(`spatial.drop_edges`), and no padding of H, so that the output is the
rank's rows of the layout with (ker - 1) / 2 fewer pad rows a side
(`spatial.conv_layout`).

Where autograd records the convolution (grad enabled, and the input or the
weight requires grad), it runs as `_Conv`, whose input gradient is
`_ConvInputGrad`. The two issue the same cuDNN forward, dgrad and wgrad as
autograd's own node; what differs is the second derivative that the
gradient penalty's double backward (losses.py) takes of the input
gradient. PyTorch's `_convolution_double_backward` computes its weight
part as a forward convolution whose filter is the whole incoming gradient
image, which cuDNN runs as a long serial reduction over batch x space on
a handful of blocks; `_ConvInputGrad.backward` asks for the same weight
gradient as an ordinary wgrad, with the input gradient's own gradient in
the input's place. A Function cannot see which gradients the caller asked
for, so `_Conv.backward` computes the weight and bias gradients whenever
they require grad, also inside the penalty's inner gradient, where nothing
reads them (the G step runs the critic with its parameters out of
autograd, training/steps.py). `_Conv` keeps its input only where the
weight takes a gradient: the dgrad needs the input's shape alone. Under
no_grad (the samplers, eval, torch.export) the convolution is the plain
`F.conv*` call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..parallel import spatial
from ..utils import profiling
from .layout import channel_sum, ndhwc, to_port


def _count(t: torch.Tensor) -> None:
    """Count a 3D convolution on the activation operand `t` by its layout
    (module docstring); a 2D one counts nowhere."""
    if t.ndim == 5:
        profiling.count("conv.ndhwc" if ndhwc(t) else "conv.ncdhw", 1)


def _halo(x: torch.Tensor, weight: torch.Tensor, stride: int, padding: int,
          sharded: spatial.Layout):
    """An H-sharded input with its halo rows, and the padding left to do:
    none on H, `padding` on the other spatial axes."""
    k = (weight.shape[-2] - 1) // 2
    shrinks = (padding == 0 and isinstance(sharded, spatial.Padded)
               and sharded.p >= k)
    if stride != 1 or 2 * k + 1 != weight.shape[-2] \
            or (padding != k and not shrinks):
        raise NotImplementedError(
            f"an H-sharded convolution keeps the height (stride 1, padding "
            f"(ker - 1) / 2) or, in a padded layout of at least (ker - 1) "
            f"/ 2 pad rows, has padding 0; not ker {weight.shape[-2]} "
            f"stride {stride} padding {padding} in {sharded}")
    x = spatial.halo(x, k)
    if shrinks:
        x = spatial.drop_edges(x, k)
    spatial.conv_rows[x.shape[-2]] += 1
    pads = [padding] * (x.ndim - 2)
    pads[-2] = 0
    return x, tuple(pads)


def _per_axis(v, d: int) -> list:
    return list(v) if isinstance(v, (tuple, list)) else [v] * d


def _dgrad(gy: torch.Tensor, weight: torch.Tensor, shape, stride,
           padding) -> torch.Tensor:
    """cuDNN's dgrad of a convolution by `weight` at `gy`, for an input of
    `shape`: the transposed convolution (cuDNN's backward-data, as
    autograd's own node runs it), whose output padding gives back the
    rows a stride dropped; it needs no input tensor."""
    d = weight.ndim - 2
    _count(gy)
    stride, padding = _per_axis(stride, d), _per_axis(padding, d)
    out_pad = [shape[2 + i] - (gy.shape[2 + i] - 1) * stride[i]
               + 2 * padding[i] - weight.shape[2 + i] for i in range(d)]
    fn = F.conv_transpose2d if d == 2 else F.conv_transpose3d
    return to_port(fn(gy, weight, None, stride, padding, out_pad))


def _wgrad(gy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
           stride, padding) -> torch.Tensor:
    """cuDNN's wgrad of a convolution of `x` by `weight` at `gy`."""
    d = weight.ndim - 2
    _count(x)
    return to_port(torch.ops.aten.convolution_backward(
        gy, x, weight, None, _per_axis(stride, d), _per_axis(padding, d),
        [1] * d, False, [0] * d, 1, [False, True, False])[1])


class _Conv(torch.autograd.Function):
    """fn(x, weight, bias): a convolution whose input gradient is
    `_ConvInputGrad` (module docstring). It keeps x only where the weight
    takes a gradient, which is what reads it."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, fn):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, weight)
        ctx.shape, ctx.stride, ctx.padding, ctx.fn = (x.shape, stride,
                                                      padding, fn)
        return to_port(fn(x, weight, bias, stride=stride, padding=padding))

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        gy = to_port(gy)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = _ConvInputGrad.apply(gy, weight, ctx.shape, ctx.stride,
                                      ctx.padding, ctx.fn)
        if ctx.needs_input_grad[1]:
            gw = _wgrad(gy, x, weight, ctx.stride, ctx.padding)
        if ctx.needs_input_grad[2]:
            gb = channel_sum(gy)
        return gx, gw, gb, None, None, None


class _ConvInputGrad(torch.autograd.Function):
    """The input gradient (cuDNN's dgrad) of fn(x, weight) at gy, for an x
    of `shape`. Its own gradient at ggx: fn(ggx, weight) for gy, and for
    the weight the wgrad of gy with ggx as the input, which `conv.wgrad2`
    counts."""

    @staticmethod
    def forward(ctx, gy, weight, shape, stride, padding, fn):
        ctx.save_for_backward(gy, weight)
        ctx.stride, ctx.padding, ctx.fn = stride, padding, fn
        return _dgrad(gy, weight, shape, stride, padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, ggx):
        gy, weight = ctx.saved_tensors
        ggx = to_port(ggx)
        profiling.count("conv.wgrad2", 1)
        g_gy = g_w = None
        if ctx.needs_input_grad[0]:
            _count(ggx)
            g_gy = to_port(ctx.fn(ggx, weight, None, stride=ctx.stride,
                                  padding=ctx.padding))
        if ctx.needs_input_grad[1]:
            g_w = _wgrad(gy, ggx, weight, ctx.stride, ctx.padding)
        return g_gy, g_w, None, None, None, None


def _apply(fn, x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], stride, padding) -> torch.Tensor:
    _count(x)
    x = to_port(x)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _Conv.apply(x, weight, bias, stride, padding, fn)
    return to_port(fn(x, weight, bias, stride=stride, padding=padding))


def _conv(fn, x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], stride: int, padding: int,
          compute_dtype: Optional[torch.dtype],
          sharded: spatial.Layout = False) -> torch.Tensor:
    if sharded:
        x, padding = _halo(x, weight, stride, padding, sharded)
    if compute_dtype is None:
        return _apply(fn, x, weight, bias, stride, padding)
    out = _apply(fn, x.to(compute_dtype), weight.to(compute_dtype), None,
                 stride, padding)
    if bias is None:
        return out
    return out + bias.to(out.dtype).reshape((-1,) + (1,) * (out.ndim - 2))


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0,
           compute_dtype: Optional[torch.dtype] = None,
           sharded: spatial.Layout = False) -> torch.Tensor:
    """Plain 2D convolution, zero padding (reference networks_2d.py:47-49)."""
    return _conv(F.conv2d, x, weight, bias, stride, padding, compute_dtype,
                 sharded)


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0,
           compute_dtype: Optional[torch.dtype] = None,
           sharded: spatial.Layout = False) -> torch.Tensor:
    """Plain 3D convolution, zero padding (reference networks_3d.py:48-50)."""
    return _conv(F.conv3d, x, weight, bias, stride, padding, compute_dtype,
                 sharded)


def conv(x: torch.Tensor, weight: torch.Tensor,
         bias: Optional[torch.Tensor] = None, stride: int = 1,
         padding: int = 0,
         compute_dtype: Optional[torch.dtype] = None,
         sharded: spatial.Layout = False) -> torch.Tensor:
    """conv2d or conv3d, by the weight's rank (OIHW or OIDHW)."""
    fn = conv2d if weight.ndim == 4 else conv3d
    return fn(x, weight, bias, stride=stride, padding=padding,
              compute_dtype=compute_dtype, sharded=sharded)


# 0.2 rounded to bfloat16: the slope JAX's weakly typed 0.2 takes there
_BF16_SLOPE = 0.2001953125


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with MindSpore's default slope 0.2 (reference
    networks_2d.py:16-24), the activation of every block of the port; in
    bfloat16 the slope is 0.2 rounded to bfloat16, as in the JAX package."""
    return F.leaky_relu(x, _BF16_SLOPE if x.dtype == torch.bfloat16 else 0.2)
