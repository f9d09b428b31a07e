"""Convolution helpers on NCHW / NCDHW tensors with OIHW / OIDHW weights.

The port of the JAX package's `ops/conv.py`. The JAX package keeps HWIO /
DHWIO weights and channels-last activations; the port keeps PyTorch's
layouts, and tools/convert.py carries weights across. The convolutions
themselves are `F.conv2d` / `F.conv3d` (cuDNN on the card), as XLA ran them
outside any Pallas kernel in the JAX package.

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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel import spatial


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


def _conv(fn, x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], stride: int, padding: int,
          compute_dtype: Optional[torch.dtype],
          sharded: spatial.Layout = False) -> torch.Tensor:
    if sharded:
        x, padding = _halo(x, weight, stride, padding, sharded)
    if compute_dtype is None:
        return fn(x, weight, bias, stride=stride, padding=padding)
    out = fn(x.to(compute_dtype), weight.to(compute_dtype), None,
             stride=stride, padding=padding)
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
