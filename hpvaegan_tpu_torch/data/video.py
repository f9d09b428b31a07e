"""Single-video data: decode once, resize per scale on the device.

The port of the JAX package's `data/video.py:27-68` (reference
src/datasets/video.py:13-96): one host decode at full resolution
(data/frames.py), then per scale a half-pixel bilinear resize of every
frame (cv2 INTER_LINEAR, no antialias) on the device, cached. Tensors are
NCDHW. The training batch former (temporal windows, flips, z_init) is not
ported yet.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..ops.resize import resize_bilinear
from ..utils import pyramid
from .frames import video_metadata, video_to_frames


class SingleVideoDataset:
    """Sets cfg.org_fps, cfg.ar = H / W and cfg.fps_lcm (the lcm of the
    sampling rates) from the clip, and serves each pyramid level as a
    (1, C, T, H_s, W_s) tensor in [0, 1] on `device`."""

    def __init__(self, cfg, device):
        if not os.path.exists(cfg.video_path):
            raise FileNotFoundError(f"invalid path: {cfg.video_path}")
        cfg.org_fps, h, w = video_metadata(cfg.video_path)
        cfg.ar = h / w
        cfg.fps_lcm = int(np.lcm.reduce(np.asarray(cfg.sampling_rates)))
        self.cfg = cfg
        frames = video_to_frames(cfg.video_path, cfg.start_frame,
                                 cfg.max_frames)
        if frames.shape[0] < cfg.fps_lcm + 1:
            raise ValueError(
                f"video provides {frames.shape[0]} frames from "
                f"--start-frame {cfg.start_frame} / --max-frames "
                f"{cfg.max_frames}, but the sampling rates "
                f"{cfg.sampling_rates} need lcm+1 = {cfg.fps_lcm + 1} "
                "frames per temporal window")
        # (1, C, T, H, W) in [0, 1], on the device
        frames01 = frames.astype(np.float32) / 255.0
        self.frames_full_scale = torch.from_numpy(np.ascontiguousarray(
            frames01.transpose(3, 0, 1, 2)))[None].to(device)
        self.num_frames = frames.shape[0]
        self._cache = {}

    def scale_size(self, scale_idx: int) -> Tuple[int, int]:
        h, w = pyramid.scale_size_2d(scale_idx, self.cfg.scale_factor,
                                     self.cfg.stop_scale, self.cfg.img_size,
                                     self.cfg.ar)
        return h, w

    def scale_frames(self, scale_idx: int) -> torch.Tensor:
        """(1, C, T_full, H_s, W_s) in [0, 1]: every decoded frame at the
        spatial size of scale `scale_idx`."""
        if scale_idx not in self._cache:
            self._cache[scale_idx] = resize_bilinear(
                self.frames_full_scale, self.scale_size(scale_idx),
                align_corners=False)
        return self._cache[scale_idx]
