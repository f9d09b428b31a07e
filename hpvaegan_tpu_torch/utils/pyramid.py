"""Pure pyramid scale math — the numeric heart of the multi-scale schedule.

The port's copy of the JAX package's `utils/pyramid.py` (reference
src/utils/images.py:64-117):
  * 256px image, min 32, factor 0.75  ->  stop_scale 9, factor ~0.79370
  * sampling_rates [4,3,2,1], fps_lcm 12 -> time-depths 4, 5, 7, 13
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple


def get_scales_by_index(index: int, scale_factor: float, stop_scale: int,
                        img_size: int) -> int:
    """Spatial size (short side) of pyramid scale `index`.

    Reference: src/utils/images.py:74-77 (ceil(factor^(stop-i) * img_size)).
    """
    scale = math.pow(scale_factor, stop_scale - index) + 1e-6
    return int(math.ceil(scale * img_size))


def get_fps_by_index(index: int, stop_scale_time: int,
                     sampling_rates: Sequence[int],
                     org_fps: float) -> Tuple[float, int]:
    """Linear fps interpolation by divisors (reference: images.py:80-84)."""
    fps_index = int((index / stop_scale_time) * (len(sampling_rates) - 1))
    return org_fps / sampling_rates[fps_index], fps_index


def get_fps_td_by_index(index: int, stop_scale_time: int,
                        sampling_rates: Sequence[int], org_fps: float,
                        fps_lcm: int) -> Tuple[float, int, int]:
    """(fps, time_depth, rate_index) for scale `index` (reference: images.py:87-93)."""
    fps, fps_index = get_fps_by_index(index, stop_scale_time, sampling_rates, org_fps)
    every = sampling_rates[fps_index]
    time_depth = fps_lcm // every + 1
    return fps, time_depth, fps_index


def scale_size_2d(index: int, scale_factor: float, stop_scale: int,
                  img_size: int, ar: float) -> List[int]:
    """[H, W] of scale `index` (reference: images.py:110-117)."""
    base = get_scales_by_index(index, scale_factor, stop_scale, img_size)
    return [int(base * ar), base]


def scale_size_3d(index: int, scale_factor: float, stop_scale: int, img_size: int,
                  stop_scale_time: int, sampling_rates: Sequence[int],
                  org_fps: float, fps_lcm: int, ar: float) -> List[int]:
    """[T, H, W] of scale `index` (reference: images.py:96-107)."""
    base = get_scales_by_index(index, scale_factor, stop_scale, img_size)
    _, td, _ = get_fps_td_by_index(index, stop_scale_time, sampling_rates,
                                   org_fps, fps_lcm)
    return [td, int(base * ar), base]
