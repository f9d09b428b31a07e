"""Single-image data: decode once, resize per scale on the device, form
batches there.

The port of the JAX package's `data/image.py` (reference
src/datasets/image.py:36-76). The image is decoded once with Pillow at full
resolution; each pyramid level is a half-pixel bilinear resize (cv2
INTER_LINEAR, no antialias) on the device, cached. A batch is B copies of
the level, each flipped on its own Bernoulli(0.5) draw under cfg.hflip,
mapped to [-1, 1], plus the scale-0 noise_init. All tensors are NCHW.
Under a spatial axis (parallel/spatial.py) the batch holds the rank's rows
of H of each tensor whose height is split.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..ops.resize import resize_bilinear
from ..parallel import mesh, spatial
from ..utils import pyramid
from ..utils.noise import NoiseSource


def load_image01(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) float32 in [0, 1]."""
    from PIL import Image

    if not os.path.exists(path):
        raise FileNotFoundError(f"invalid path: {path}")
    with Image.open(path) as im:
        if im.mode not in ("L", "RGB", "RGBA"):
            im = im.convert("RGB")
        img = np.asarray(im)
    if img.ndim == 2:
        # grayscale: promote to 3 channels (the reference's cv2.imread
        # always yields BGR, so single-channel inputs train there)
        img = np.stack([img] * 3, axis=-1)
    img = img[:, :, :3]
    return img.astype(np.float32) / 255.0


class SingleImageDataset:
    """Sets cfg.ar = H / W (reference image.py:29) and serves each pyramid
    level as a (1, C, H_s, W_s) tensor in [0, 1] on `device`."""

    def __init__(self, cfg, device):
        img01 = load_image01(cfg.image_path)
        self.org_size = [img01.shape[0], img01.shape[1]]
        cfg.ar = img01.shape[0] / img01.shape[1]
        self.cfg = cfg
        self.image_full_scale = torch.from_numpy(
            np.ascontiguousarray(img01.transpose(2, 0, 1)))[None].to(device)
        self._cache = {}

    def scale_size(self, scale_idx: int) -> Tuple[int, int]:
        h, w = pyramid.scale_size_2d(scale_idx, self.cfg.scale_factor,
                                     self.cfg.stop_scale, self.cfg.img_size,
                                     self.cfg.ar)
        return h, w

    def scale_image(self, scale_idx: int) -> torch.Tensor:
        if scale_idx not in self._cache:
            self._cache[scale_idx] = resize_bilinear(
                self.image_full_scale, self.scale_size(scale_idx),
                align_corners=False)
        return self._cache[scale_idx]


def make_image_batch(cfg, scale_img: torch.Tensor, zero_img: torch.Tensor,
                     noise: NoiseSource):
    """(real, real_zero, noise_init), the first two in [-1, 1]: draws the
    hflip flags (under cfg.hflip), then noise_init (B, latent, h0, w0). B
    is this rank's share of cfg.batch_size: a data-parallel rank forms its
    rows of the global batch, from the global batch's draws; and the three
    are the rank's rows of H where the spatial axis splits their
    height."""
    batch = mesh.local_rows(cfg.batch_size)
    real = spatial.shard_rows(scale_img).expand(batch, -1, -1, -1)
    real_zero = spatial.shard_rows(zero_img).expand(batch, -1, -1, -1)
    if cfg.hflip:
        flips = noise.bernoulli((batch,)).reshape(batch, 1, 1, 1)
        real = torch.where(flips, real.flip(-1), real)
        real_zero = torch.where(flips, real_zero.flip(-1), real_zero)
    # Normalize([0.5], [0.5]) (reference image.py:66)
    real = real * 2.0 - 1.0
    real_zero = real_zero * 2.0 - 1.0
    h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                   cfg.img_size, cfg.ar)
    noise_init = noise.draw_rows(h0, "normal", (
        batch, cfg.latent_dim, spatial.local_h(h0), w0))
    return real, real_zero, noise_init
