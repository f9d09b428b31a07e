"""3D networks as `nn.Module`s: the video VAE encoder, the WGAN critic
WDiscriminator3D and the hierarchical generator GeneratorHPVAEGAN.

The port of the JAX package's `models/networks_3d.py:44-66, 126-150,
186-282` (reference src/modules/networks_3d.py:89-112, 170-193, 354-451).
All are the 2D classes of networks_2d.py with 3D convolutions (OIDHW
weights, NCDHW tensors), and the generator has one difference in the
refinement chain: noise is added only at
stages with vae_levels <= idx + 1 (networks_3d.py:227-228 there, reference
networks_3d.py:443), so the VAE stages below vae_levels refine without it.
Each upscale grows the time depth with the pyramid (trilinear,
align_corners=True, ops/resize.py::upscale_3d). There is no fused kernel on
this path: `cfg.pallas_fused_sampling` is ignored, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.resize import upscale_3d
from ..utils.noise import NoiseSource
from . import networks_2d


class Encode3DVAE(networks_2d.Encode2DVAE):
    """Encode3DVAE (networks_3d.py:44-66): enc_blocks + 1 spectral-norm 3D
    conv blocks, then the mu and logvar 3D convs."""

    ndim = 3


def refinement_layers_3d(cfg, body: Sequence[nn.Module], x: torch.Tensor,
                         amps, noise: NoiseSource, *, is_random: bool,
                         bn: str, commit: bool = True) -> torch.Tensor:
    """Residual refinement chain (networks_3d.py:214-240 of the JAX
    package). amps: (stop_scale + 2,) per-scale noise amplitudes."""
    for idx in range(len(body)):
        if cfg.vae_levels == idx + 1 and not cfg.train_all:
            x = x.detach()  # the VAE boundary (networks_3d.py:224-225)
        x_up = upscale_3d(x, idx + 1, cfg.scale_factor, cfg.stop_scale,
                          cfg.img_size, cfg.stop_scale_time,
                          cfg.sampling_rates, cfg.org_fps, cfg.fps_lcm, cfg.ar)
        if is_random and cfg.vae_levels <= idx + 1:
            x_in = x_up + noise.normal(x_up.shape) * float(amps[idx + 1])
        else:
            x_in = x_up
        y = body[idx](x_in, bn, commit)
        x = torch.tanh(y + x_up)
    return x


class WDiscriminator3D(networks_2d.WDiscriminator2D):
    """WDiscriminator3D (networks_3d.py:126-150): the 2D critic with 3D SN
    blocks; the tail conv keeps padding 1, hard-coded as in 2D."""

    ndim = 3


class GeneratorHPVAEGAN(networks_2d.GeneratorHPVAEGAN):
    """GeneratorHPVAEGAN 3D (networks_3d.py:191-282): z (B, latent_dim, td,
    h0, w0) through the 3D decoder, then the refinement stages."""

    ndim = 3
    encoder_cls = Encode3DVAE

    def _refine(self, x: torch.Tensor, amps, noise: NoiseSource, *,
                is_random: bool, bn: str, commit: bool) -> torch.Tensor:
        return refinement_layers_3d(self.cfg, self.body, x, amps, noise,
                                    is_random=is_random, bn=bn, commit=commit)
