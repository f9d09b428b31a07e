"""The 2D hierarchical generator, GeneratorHPVAEGAN, as an `nn.Module`.

The port of the JAX package's `models/networks_2d.py:142-272` for sampling
(reference src/modules/networks_2d.py:190-282). The "growing network" is a
ModuleList of refinement stages: `init_next_stage` appends a fresh stage
first and a deep copy of the last one after that. Tensors are NCHW.

Random mode (the sampling path): z = noise_init through the decoder, then
per refinement stage k = 1..len(body)
    x_up = upscale(x) to scale k;  x_in = x_up + amp_k * noise
    x = tanh(stage_k(x_in) + x_up)
with every draw taken from a `NoiseSource` (utils/noise.py).

The encoder's parameters are carried so that checkpoints load whole. Its
forward (spectral-norm power step, reparametrisation) and reconstruction
mode belong to the training path and are not ported yet.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.fused_upscale_noise import fused_upscale_noise_2d
from ..ops.resize import upscale_2d
from ..utils.noise import NoiseSource
from ..utils.pyramid import scale_size_2d
from .blocks import Conv2d, ConvStack, SNConv2d, init_weights_


class _SNBlock(nn.Module):
    def __init__(self, cin: int, cout: int, ker: int):
        super().__init__()
        self.conv = SNConv2d(cin, cout, ker)


class _ConvHead(nn.Module):
    def __init__(self, cin: int, cout: int, ker: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, ker, ker // 2)


class Encode2DVAE(nn.Module):
    """Parameters of the VAE encoder (networks_2d.py:31-52): enc_blocks + 1
    spectral-norm conv blocks, then the mu and logvar convs."""

    def __init__(self, cfg, out_dim: int, num_blocks: int):
        super().__init__()
        self.features = nn.Module()
        chans = [cfg.nc_im] + [cfg.nfc] * (num_blocks + 1)
        for i in range(num_blocks + 1):
            setattr(self.features, f"conv_block_{i}",
                    _SNBlock(chans[i], chans[i + 1], cfg.ker_size))
        self.mu = _ConvHead(cfg.nfc, out_dim, cfg.ker_size)
        self.logvar = _ConvHead(cfg.nfc, out_dim, cfg.ker_size)


def refinement_layers(cfg, body: Sequence[nn.Module], x: torch.Tensor, amps,
                      noise: NoiseSource, *, is_random: bool,
                      bn: str) -> torch.Tensor:
    """Residual refinement chain (networks_2d.py:177-229 of the JAX package).

    amps: (stop_scale + 2,) per-scale noise amplitudes. The fused kernel
    runs where the JAX package runs its Pallas kernel: with
    `cfg.pallas_fused_sampling`, in random mode, on moving-stat BatchNorm
    (networks_2d.py:193-194 there); one seed per stage.
    """
    use_fused = bool(getattr(cfg, "pallas_fused_sampling", False)) \
        and is_random and bn == "moving"
    for idx in range(len(body)):
        amp = float(amps[idx + 1])
        if use_fused:
            seed = noise.seed()
            hw = scale_size_2d(idx + 1, cfg.scale_factor, cfg.stop_scale,
                               cfg.img_size, cfg.ar)
            bits = noise.kernel_bits((x.shape[0], x.shape[1], hw[0], hw[1]))
            x_up, x_in = fused_upscale_noise_2d(
                x.contiguous(), hw, amp, seed, bits=bits)
        else:
            x_up = upscale_2d(x, idx + 1, cfg.scale_factor, cfg.stop_scale,
                              cfg.img_size, cfg.ar)
            x_in = x_up + noise.normal(x_up.shape) * amp if is_random else x_up
        y = body[idx](x_in, bn)
        x = torch.tanh(y + x_up)
    return x


class GeneratorHPVAEGAN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.encode = Encode2DVAE(cfg, cfg.latent_dim, cfg.enc_blocks)
        self.decoder = ConvStack(cfg.latent_dim, int(cfg.nfc), cfg.nc_im,
                                 cfg.ker_size, cfg.padd_size, cfg.num_layer)
        self.body = nn.ModuleList()

    def init_next_stage(self, gen: Optional[torch.Generator] = None) -> None:
        """Grow the refinement body by one stage (networks_2d.py:224-235):
        the first stage is fresh (initialised from `gen` when given), later
        ones deep-copy the previous stage."""
        if len(self.body) == 0:
            cfg = self.cfg
            param = self.decoder.tail.weight
            stage = ConvStack(cfg.nc_im, int(cfg.nfc), cfg.nc_im, cfg.ker_size,
                              cfg.padd_size, cfg.num_layer)
            if gen is not None:
                init_weights_(stage, gen)
            stage = stage.to(device=param.device, dtype=param.dtype)
        else:
            stage = copy.deepcopy(self.body[-1])
        self.body.append(stage)

    def forward(self, noise_init: torch.Tensor, amps, noise: NoiseSource, *,
                bn: str = "batch") -> Tuple[torch.Tensor, torch.Tensor]:
        """Random-mode forward from z = noise_init (B, latent_dim, h0, w0).
        Returns (x, vae_out). bn: "batch", "moving" or "sample"
        (ops/norm.py)."""
        vae_out = torch.tanh(self.decoder(noise_init, bn))
        x = refinement_layers(self.cfg, self.body, vae_out, amps, noise,
                              is_random=True, bn=bn)
        return x, vae_out
