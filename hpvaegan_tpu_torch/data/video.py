"""Single-video data: decode once, resize per scale on the device.

The port of the JAX package's `data/video.py:27-68` (reference
src/datasets/video.py:13-96): one host decode at full resolution
(data/frames.py), then per scale a half-pixel bilinear resize of every
frame (cv2 INTER_LINEAR, no antialias) on the device, cached. Tensors are
NCDHW, channels-last in memory (ops/layout.py). `make_video_batch` forms a
training batch on the device (the port of `make_video_batch_body`,
data/video.py:71-115 there): random temporal windows at the scale's
sampling rate, per-sample flips, z_init; `make_baseline_batch` the
baselines' (JAX training/baselines_trainer.py:71-84), whose noise has
nc_im channels. Under a spatial axis
(parallel/spatial.py) a batch holds the rank's rows of H of each tensor
whose height is split.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.layout import to_port
from ..ops.resize import resize_bilinear
from ..parallel import mesh, spatial
from ..utils import pyramid
from ..utils.noise import NoiseSource
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


def make_video_batch(cfg, scale_frames: torch.Tensor,
                     zero_frames: torch.Tensor, noise: NoiseSource,
                     scale_idx: int, noise_channels: Optional[int] = None):
    """(real, real_zero, noise_init) for scale `scale_idx`, the first two in
    [-1, 1].

    Draws, in the order of the JAX package's key split (k_start, k_flip,
    k_noise): B window starts in [0, max(T_full - fps_lcm, 1)), the hflip
    flags (under cfg.hflip), then noise_init (B, noise_channels, td0, h0,
    w0) at scale 0's time depth (reference train_video.py:43-46);
    noise_channels defaults to cfg.latent_dim. Each window is
    frames[s : s + fps_lcm + 1 : every], `every` = the scale's sampling rate
    for `real` and sampling_rates[0] for `real_zero`, from the same starts
    (reference video.py:50-63). The frames are gathered with device index
    arithmetic, so forming a batch never waits on the device. B is this
    rank's share of cfg.batch_size: a data-parallel rank forms its rows of
    the global batch, from the global batch's draws; and the three are the
    rank's rows of H where the spatial axis splits their height.
    """
    batch = mesh.local_rows(cfg.batch_size)
    _, _, fps_index = pyramid.get_fps_td_by_index(
        scale_idx, cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
        cfg.fps_lcm)
    t_full = scale_frames.shape[2]
    starts = noise.randint(max(t_full - cfg.fps_lcm, 1), (batch,))

    def take(frames, every):
        idx = starts[:, None] + torch.arange(0, cfg.fps_lcm + 1, every,
                                             device=starts.device)
        # gathered on the (T, H, W, C) view: channels-last windows
        win = frames[0].movedim(0, -1).index_select(0, idx.reshape(-1))
        return to_port(win.reshape((batch, idx.shape[1])
                                   + tuple(win.shape[1:])).movedim(-1, 1))

    real = take(spatial.shard_rows(scale_frames),
                cfg.sampling_rates[fps_index])
    real_zero = take(spatial.shard_rows(zero_frames), cfg.sampling_rates[0])
    if cfg.hflip:
        flips = noise.bernoulli((batch,)).reshape(batch, 1, 1, 1, 1)
        real = torch.where(flips, real.flip(-1), real)
        real_zero = torch.where(flips, real_zero.flip(-1), real_zero)
    real = real * 2.0 - 1.0
    real_zero = real_zero * 2.0 - 1.0
    h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                   cfg.img_size, cfg.ar)
    _, td0, _ = pyramid.get_fps_td_by_index(0, cfg.stop_scale_time,
                                            cfg.sampling_rates, cfg.org_fps,
                                            cfg.fps_lcm)
    channels = cfg.latent_dim if noise_channels is None else noise_channels
    noise_init = noise.draw_rows(h0, "normal", (
        batch, channels, td0, spatial.local_h(h0), w0))
    return real, real_zero, noise_init


def make_baseline_batch(cfg, scale_frames: torch.Tensor,
                        zero_frames: torch.Tensor, noise: NoiseSource,
                        scale_idx: int):
    """A baseline run's (real, real_zero, noise_init): make_video_batch's
    window starts, flips and windows, then noise_init (B, nc_im, td0, h0,
    w0), Z_init's shape. The JAX former also draws make_video_batch_body's
    latent noise, from a key of its own, and throws it away; it is not
    drawn here, so the draws that follow are the same."""
    return make_video_batch(cfg, scale_frames, zero_frames, noise, scale_idx,
                            noise_channels=cfg.nc_im)
