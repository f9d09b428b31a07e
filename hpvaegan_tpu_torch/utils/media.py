"""Media export: saved .npy samples -> PNGs.

The port of the JAX package's `utils/media.py::generate_images` (reference
src/utils/extract.py:28-41). random_samples.npy is (N, C, H, W) in [-1, 1].
Images are written with Pillow (the JAX package uses imageio); PNG is
lossless, so both packages' files hold the same pixels.
"""

from __future__ import annotations

import os

import numpy as np


def generate_images(cfg, saver) -> None:
    """random_samples.npy -> fake_<i>.png, the first cfg.max_samples."""
    from PIL import Image

    samples = np.load(os.path.join(saver.eval_dir, "random_samples.npy"))
    out_dir = os.path.join(saver.eval_dir, cfg.save_path)
    os.makedirs(out_dir, exist_ok=True)
    samples = samples.transpose(0, 2, 3, 1)[:cfg.max_samples]
    samples = (samples + 1) / 2
    samples = (samples * 255).astype(np.uint8)
    for i, sample in enumerate(samples):
        Image.fromarray(sample).save(os.path.join(out_dir, f"fake_{i}.png"))
