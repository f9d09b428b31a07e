"""Batched sample generation on one device.

The port of the JAX package's `parallel/sampling.py::sharded_sampler` for one
device (the mesh-sharded and multi-process forms come later). BASELINE
config 5 is batched diverse-sample generation at 64 samples a batch; the
reference generates one sample per generator call (eval_image.py:54-61).

A batch whose widest activation would hold 2^31 elements (8.6 GB of
float32) or more runs as equal sub-batches, one forward each, to bound the
peak memory: one full-width video sample's last stage holds 64 channels x
13 x 192 x 257 = 41M elements, so 64 samples make 10.5 GB activations, about
four of them alive at once. On an H100 two sub-batches of 32 peak at 22 GB
where one forward of 64 peaks at 44 GB and is no faster (PERF.md). A CSG/SG
baseline's widest activation is at its last stage's size padded by
num_layer + 1 per side, 64 x 25 x 204 x 269 = 87.8M elements at full
width, so 64 samples run as 21 / 21 / 22. The split is exact in both
sampler modes (neither reads batch statistics); it changes only the order
of the refinement noise draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import pyramid
from ..utils.noise import NoiseSource

MAX_ELEMENTS = 2 ** 31 - 1  # per activation tensor of one forward


def _sample_elements(cfg, ndim: int, scale: int, z_tail, pad: int = 0
                     ) -> int:
    """Elements of one sample's widest activation: nfc channels at the size
    of pyramid scale `scale` (the last stage's) padded by `pad` per side,
    or at z's size when that is larger."""
    sizes = [math.prod(z_tail[:-1])]
    if scale or pad:
        if ndim == 2:
            size = pyramid.scale_size_2d(scale, cfg.scale_factor,
                                         cfg.stop_scale, cfg.img_size, cfg.ar)
        else:
            size = pyramid.scale_size_3d(
                scale, cfg.scale_factor, cfg.stop_scale, cfg.img_size,
                cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
                cfg.fps_lcm, cfg.ar)
        sizes.append(math.prod(s + 2 * pad for s in size))
    return int(cfg.nfc) * max(sizes)


def generator_elements(cfg, generator, ndim: int, z_tail) -> int:
    """_sample_elements of `generator` at its stage count."""
    return _sample_elements(cfg, ndim,
                            len(generator.body) - generator.body_offset,
                            z_tail, generator.widest_pad)


def sub_batches(num_samples: int, per_sample: int) -> list:
    """Equal [start, stop) ranges that keep each forward's widest activation
    under MAX_ELEMENTS."""
    most = max(1, MAX_ELEMENTS // per_sample)
    n = -(-num_samples // most)
    bounds = [num_samples * i // n for i in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def sharded_sampler(cfg, generator, ndim: int = 2, train: bool = True,
                    z_tail=None):
    """Returns sample(num_samples, noise) -> (N, C, H, W) tensor (in 3D
    (N, C, T, H, W)) in [-1, 1] on the generator's device.

    train=True (default) normalises with per-sample statistics (BatchNorm
    mode "sample"): one batched forward equal to the JAX sampler's vmap of
    batch-1 train-mode forwards, which matches the reference's eval — it
    never leaves the training phase and generates one sample per call.
    train=False is the plain batched forward on the moving statistics; with
    cfg.pallas_fused_sampling its 2D refinement stages run the fused
    upscale+noise kernel (3D has none).

    z_tail: the per-sample latent shape, channels-last as the JAX package
    gives it: (h0, w0, latent_dim) by default in 2D, (td0, h0, w0,
    latent_dim) in 3D (a baseline's: evaluation.eval_z_tail); z is drawn
    channels-first.
    """
    if ndim not in (2, 3):
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    if z_tail is None:
        h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                       cfg.img_size, cfg.ar)
        z_tail = (h0, w0, cfg.latent_dim)
        if ndim == 3:
            _, td0, _ = pyramid.get_fps_td_by_index(
                0, cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
                cfg.fps_lcm)
            z_tail = (td0,) + z_tail
    z_tail = tuple(z_tail)
    per_sample = generator_elements(cfg, generator, ndim, z_tail)

    amps = np.zeros((cfg.stop_scale + 2,), np.float32)
    amps[:len(cfg.Noise_Amps)] = cfg.Noise_Amps
    bn = "sample" if train else "moving"

    def sample(num_samples: int, noise: NoiseSource) -> torch.Tensor:
        z = noise.normal((num_samples, z_tail[-1]) + z_tail[:-1])
        with torch.no_grad():
            outs = [generator(z[a:b], amps, noise, bn=bn)[0]
                    for a, b in sub_batches(num_samples, per_sample)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    return sample
