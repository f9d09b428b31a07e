"""Separable linear resize as per-axis 2-tap gather + lerp, on NCHW and
NCDHW tensors.

The port of the JAX package's `ops/resize.py`. The reference needs two
interpolation semantics:
  * align_corners=True bilinear / trilinear inside the model
    (reference: src/utils/images.py:40-61, src/tools/trilinear.py:171-254)
  * half-pixel bilinear (cv2.INTER_LINEAR, no antialias) in the data
    pipeline (reference: src/datasets/image.py:75,
    src/datasets/generate_frames.py:44-46)

Each output sample touches exactly 2 inputs. The index and fraction tables
are computed on the host by `_interp_gather`, whose arithmetic (float64
source position, float32 fraction) is the JAX package's, so the two
packages gather the same taps with the same weights. The fused kernel of
ops/fused_upscale_noise.py reads the same tables.

A 5-D result is channels-last, as the 3D path keeps its activations
(ops/layout.py); the gather and lerp are the same per element.

The upscales between pyramid stages take an H split over the spatial axis
(parallel/spatial.py) in and out, in all four combinations: a sharded
input is gathered whole (the 3-channel stage output, `h_in` its global
height), and a sharded output computes only the rank's rows, from the
global tables cut to them. Each output element is the same gather and
lerp as in one process, so the result is its rows bit for bit. The
baselines' random-mode stage input (`resize_trilinear_padded`) is a resize
to a stage's size padded by p on every side, cut the same way to the
rank's rows of the padded layout (h, p) (parallel/spatial.py::rows).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..parallel import spatial
from ..utils import pyramid
from . import layout


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
    return _lerp(x, axis, *interp_tables(n_in, n_out, align_corners,
                                         x.device))


def _resize_rows(x: torch.Tensor, h_in: int, h_out: int,
                 pad: int = 0) -> torch.Tensor:
    """Align-corners resize of axis -2 (H) from global height h_in to
    h_out + 2 pad: `x` holds the rank's rows of h_in where the spatial
    axis splits it, and the result the rank's rows of the layout (h_out,
    pad) where it splits h_out."""
    total = h_out + 2 * pad
    if h_in == h_out and not pad:
        return x
    x = spatial.gather_rows(x, h_in)
    tables = interp_tables(h_in, total, True, x.device)
    start, n = spatial.rows(h_out, pad)
    if n != total:
        tables = tuple(t[start:start + n] for t in tables)
    return _lerp(x, x.ndim - 2, *tables)


def _lerp(x: torch.Tensor, axis: int, lo: torch.Tensor, hi: torch.Tensor,
          frac: torch.Tensor) -> torch.Tensor:
    """The gather and lerp along `axis`; a 5-D result is in the port's
    layout (ops/layout.py), gathered on the NDHWC view, whose output
    index_select makes dense."""
    if x.ndim == 5 and layout.FORMAT_5D == torch.channels_last_3d:
        y = _gather_lerp(x.movedim(1, -1), axis - (axis > 1), lo, hi, frac)
        return y.movedim(-1, 1)
    return _gather_lerp(x, axis, lo, hi, frac)


def _gather_lerp(x: torch.Tensor, axis: int, lo: torch.Tensor,
                 hi: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    n_out = lo.shape[0]
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
    """Bilinear resize of (B, C, H, W) or (B, C, T, H, W) tensors, H then W;
    rank-5 inputs are resized frame by frame."""
    if x.ndim not in (4, 5):
        raise ValueError(f"resize_bilinear expects rank 4 NCHW or 5 NCDHW, "
                         f"got {x.ndim}")
    return resize_linear(x, (x.ndim - 2, x.ndim - 1), size_hw, align_corners)


def resize_trilinear(x: torch.Tensor, size_thw: Sequence[int],
                     align_corners: bool = True) -> torch.Tensor:
    """Trilinear resize of (B, C, T, H, W) tensors, T then H then W."""
    if x.ndim != 5:
        raise ValueError(f"resize_trilinear expects rank 5 NCDHW, got {x.ndim}")
    return resize_linear(x, (2, 3, 4), size_thw, align_corners)


def resize_trilinear_padded(x: torch.Tensor, size_thw: Sequence[int],
                            pad: int, h_in: int) -> torch.Tensor:
    """resize_trilinear (align_corners=True) of `x` to (t + 2 pad, h + 2
    pad, w + 2 pad), size_thw = (t, h, w): `x` holds the rank's rows of
    its global height h_in where the spatial axis splits it, and the
    result is the rank's rows of the layout (h, pad) where the axis splits
    h, the whole resize cut to them bit for bit."""
    if x.ndim != 5:
        raise ValueError(f"resize_trilinear_padded expects rank 5 NCDHW, "
                         f"got {x.ndim}")
    t, h, w = (int(s) for s in size_thw)
    x = _resize_axis(x, 2, t + 2 * pad, True)
    x = _resize_rows(x, h_in, h, pad)
    return _resize_axis(x, 4, w + 2 * pad, True)


def upscale_2d(x: torch.Tensor, index: int, scale_factor: float,
               stop_scale: int, img_size: int, ar: float,
               h_in: Optional[int] = None) -> torch.Tensor:
    """Upscale (B, C, H, W) to the size of pyramid scale `index`
    (reference: src/utils/images.py:110-117, align_corners=True). `h_in`:
    x's global height, where x may be the rank's rows of it (default: x's
    own height, x whole); the output is the rank's rows of the scale's."""
    if index <= 0:
        raise ValueError(f"upscale_2d needs index > 0, got {index}")
    h, w = pyramid.scale_size_2d(index, scale_factor, stop_scale, img_size, ar)
    if x.ndim not in (4, 5):
        raise ValueError(f"upscale_2d expects rank 4 NCHW or 5 NCDHW, got "
                         f"{x.ndim}")
    x = _resize_rows(x, x.shape[-2] if h_in is None else h_in, h)
    return _resize_axis(x, x.ndim - 1, w, True)


def upscale_3d(x: torch.Tensor, index: int, scale_factor: float,
               stop_scale: int, img_size: int, stop_scale_time: int,
               sampling_rates: Sequence[int], org_fps: float, fps_lcm: int,
               ar: float, h_in: Optional[int] = None) -> torch.Tensor:
    """Upscale (B, C, T, H, W) to pyramid scale `index`, time depth included
    (reference: src/utils/images.py:96-107, align_corners=True); `h_in` as
    in upscale_2d."""
    if index <= 0:
        raise ValueError(f"upscale_3d needs index > 0, got {index}")
    t, h, w = pyramid.scale_size_3d(index, scale_factor, stop_scale, img_size,
                                    stop_scale_time, sampling_rates, org_fps,
                                    fps_lcm, ar)
    if x.ndim != 5:
        raise ValueError(f"upscale_3d expects rank 5 NCDHW, got {x.ndim}")
    x = _resize_axis(x, 2, t, True)
    x = _resize_rows(x, x.shape[-2] if h_in is None else h_in, h)
    return _resize_axis(x, 4, w, True)
