"""Media export: saved .npy samples -> PNGs, GIFs and unfold grids.

The port of the JAX package's `utils/media.py` (reference
src/utils/extract.py:13-83). random_samples.npy is (N, C, H, W) for images
and (N, C, T, H, W) for videos, in [-1, 1]; real_full_scale.npy is
(T, H, W, C) uint8. Files are written with Pillow, grids are numpy
concatenations (the JAX package uses imageio and cv2). PNG is lossless, so
both packages' PNGs hold the same pixels; GIF palettes may differ.
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


def make_video(array, fps: float, filename: str) -> None:
    """GIF from (T, H, W, C) uint8 frames, looping forever (reference
    extract.py:13-25)."""
    from PIL import Image

    frames = [Image.fromarray(np.asarray(f).astype(np.uint8)) for f in array]
    frames[0].save(filename, save_all=True, append_images=frames[1:],
                   duration=1000.0 / fps, loop=0)


def generate_gifs(cfg, saver) -> None:
    """real.gif, real_unfold.png, fake.gif and fake_unfold.png at 4 fps
    (reference extract.py:44-83)."""
    from PIL import Image

    out_dir = os.path.join(saver.eval_dir, cfg.save_path)
    os.makedirs(out_dir, exist_ok=True)

    real = np.load(os.path.join(saver.eval_dir, "real_full_scale.npy"))
    make_video(real, 4, os.path.join(out_dir, "real.gif"))
    Image.fromarray(np.concatenate(list(real), axis=1)).save(
        os.path.join(out_dir, "real_unfold.png"))

    # (N, C, T, H, W) in [-1, 1] -> (N, T, H, W, C) uint8
    samples = np.load(os.path.join(saver.eval_dir, "random_samples.npy"))
    samples = samples.transpose(0, 2, 3, 4, 1)[:cfg.max_samples]
    fakes = (((samples + 1) / 2) * 255).astype(np.uint8)
    # one row per video (at most 10), every other frame
    rows = [np.concatenate(list(vid), axis=1) for vid in fakes[:10, ::2]]
    Image.fromarray(np.concatenate(rows, axis=0)).save(
        os.path.join(out_dir, "fake_unfold.png"))

    # the videos side by side, 10-px white spacers between them
    spacer = np.full(fakes.shape[1:3] + (10, 3), 255, np.uint8)
    strips = []
    for i, vid in enumerate(fakes):
        strips += [vid, spacer] if i < len(fakes) - 1 else [vid]
    make_video(np.concatenate(strips, axis=2), 4,
               os.path.join(out_dir, "fake.gif"))
