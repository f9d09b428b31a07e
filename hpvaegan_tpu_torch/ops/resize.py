"""Separable linear resize as per-axis 2-tap gather + lerp, on NCHW tensors.

The port of the JAX package's `ops/resize.py`. The reference needs two
interpolation semantics:
  * align_corners=True bilinear inside the model
    (reference: src/utils/images.py:40-61)
  * half-pixel bilinear (cv2.INTER_LINEAR, no antialias) in the data
    pipeline (reference: src/datasets/image.py:75)

Each output sample touches exactly 2 inputs. The index and fraction tables
are computed on the host by `_interp_gather`, whose arithmetic (float64
source position, float32 fraction) is the JAX package's, so the two
packages gather the same taps with the same weights. The fused kernel of
ops/fused_upscale_noise.py reads the same tables.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..utils import pyramid


@functools.lru_cache(maxsize=None)
def _interp_gather(n_in: int, n_out: int, align_corners: bool):
    """(lo_idx, hi_idx, frac) arrays for 2-tap linear interpolation."""
    lo = np.zeros((n_out,), np.int32)
    hi = np.zeros((n_out,), np.int32)
    frac = np.zeros((n_out,), np.float32)
    for i in range(n_out):
        if n_in == 1:
            continue
        if align_corners:
            src = i * (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
        else:
            src = (i + 0.5) * n_in / n_out - 0.5
        src = min(max(src, 0.0), n_in - 1)
        lo[i] = int(np.floor(src))
        hi[i] = min(lo[i] + 1, n_in - 1)
        frac[i] = src - lo[i]
    return lo, hi, frac


@functools.lru_cache(maxsize=None)
def interp_tables(n_in: int, n_out: int, align_corners: bool,
                  device: torch.device):
    """`_interp_gather`'s tables as tensors on `device` (int32, int32, f32),
    made once per shape and device."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in _interp_gather(n_in, n_out, align_corners))


def _resize_axis(x: torch.Tensor, axis: int, n_out: int,
                 align_corners: bool) -> torch.Tensor:
    """2-tap gather + lerp along one axis, in the JAX package's op order."""
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    lo, hi, frac = interp_tables(n_in, n_out, align_corners, x.device)
    x_lo = torch.index_select(x, axis, lo)
    x_hi = torch.index_select(x, axis, hi)
    fshape = [1] * x.ndim
    fshape[axis] = n_out
    f = frac.to(x.dtype).reshape(fshape)
    return x_lo + (x_hi - x_lo) * f


def resize_linear(x: torch.Tensor, axes: Sequence[int], sizes: Sequence[int],
                  align_corners: bool = True) -> torch.Tensor:
    """Resize `x` along `axes` to `sizes` with separable linear interpolation."""
    if len(axes) != len(sizes):
        raise ValueError(f"{len(axes)} axes but {len(sizes)} sizes")
    for axis, n_out in zip(axes, sizes):
        x = _resize_axis(x, axis, int(n_out), align_corners)
    return x


def resize_bilinear(x: torch.Tensor, size_hw: Sequence[int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) tensors, H then W."""
    if x.ndim != 4:
        raise ValueError(f"resize_bilinear expects rank 4 NCHW, got {x.ndim}")
    return resize_linear(x, (2, 3), size_hw, align_corners)


def upscale_2d(x: torch.Tensor, index: int, scale_factor: float,
               stop_scale: int, img_size: int, ar: float) -> torch.Tensor:
    """Upscale (B, C, H, W) to the size of pyramid scale `index`
    (reference: src/utils/images.py:110-117, align_corners=True)."""
    if index <= 0:
        raise ValueError(f"upscale_2d needs index > 0, got {index}")
    h, w = pyramid.scale_size_2d(index, scale_factor, stop_scale, img_size, ar)
    return resize_bilinear(x, (h, w), align_corners=True)
