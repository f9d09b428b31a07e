"""Batched sample generation on one device.

The port of the JAX package's `parallel/sampling.py::sharded_sampler` for one
device (the mesh-sharded and multi-process forms come later). BASELINE
config 5 is batched diverse-sample generation at 64 samples a batch; the
reference generates one sample per generator call (eval_image.py:54-61).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import pyramid
from ..utils.noise import NoiseSource


def sharded_sampler(cfg, generator, ndim: int = 2, train: bool = True,
                    z_tail=None):
    """Returns sample(num_samples, noise) -> (N, C, H, W) tensor in [-1, 1]
    on the generator's device.

    train=True (default) normalises with per-sample statistics (BatchNorm
    mode "sample"): one batched forward equal to the JAX sampler's vmap of
    batch-1 train-mode forwards, which matches the reference's eval — it
    never leaves the training phase and generates one sample per call.
    train=False is the plain batched forward on the moving statistics; with
    cfg.pallas_fused_sampling its refinement stages run the fused
    upscale+noise kernel.

    z_tail: the per-sample latent shape, channels-last as the JAX package
    gives it, (h0, w0, latent_dim) by default; z is drawn as NCHW.
    """
    if ndim != 2:
        raise NotImplementedError("video sampling is not ported yet")
    if z_tail is None:
        h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                       cfg.img_size, cfg.ar)
        z_tail = (h0, w0, cfg.latent_dim)
    h, w, c = z_tail

    amps = np.zeros((cfg.stop_scale + 2,), np.float32)
    amps[:len(cfg.Noise_Amps)] = cfg.Noise_Amps
    bn = "sample" if train else "moving"

    def sample(num_samples: int, noise: NoiseSource) -> torch.Tensor:
        z = noise.normal((num_samples, c, h, w))
        with torch.no_grad():
            x, _ = generator(z, amps, noise, bn=bn)
        return x

    return sample
