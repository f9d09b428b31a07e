"""3D networks as `nn.Module`s: the video VAE encoder, the WGAN critics
WDiscriminator3D and WDiscriminatorBaselines, the hierarchical generator
GeneratorHPVAEGAN and the SinGAN-style baselines GeneratorCSG and
GeneratorSG.

The port of the JAX package's `models/networks_3d.py:44-66, 126-282,
345-480` (reference src/modules/networks_3d.py:89-112, 170-351, 354-451).
All are the 2D classes of networks_2d.py with 3D convolutions (OIDHW
weights, NCDHW tensors), and the generator has one difference in the
refinement chain: noise is added only at
stages with vae_levels <= idx + 1 (networks_3d.py:227-228 there, reference
networks_3d.py:443), so the VAE stages below vae_levels refine without it.
Each upscale grows the time depth with the pyramid (trilinear,
align_corners=True, ops/resize.py::upscale_3d). There is no fused kernel on
this path: `cfg.pallas_fused_sampling` is ignored, as in the JAX package.

The baselines (see `_Baseline`) are a GAN at every scale: no encoder, a
growing body of padding-0 stages fed through explicit zero pads, and a
fixed reconstruction noise Z_init that the baselines trainer sets.

Under a compute dtype the 3D networks flow in it as the 2D ones do: the
refinement noise (the baselines' random-mode stage input too) is drawn in
float32 and cast before the add (JAX :232, :420, :472).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import lrelu
from ..ops.resize import resize_trilinear, upscale_3d
from ..utils.noise import NoiseSource
from . import networks_2d
from .blocks import Commit, Conv, ConvBlock, SNBlock, sn_blocks_apply


class Encode3DVAE(networks_2d.Encode2DVAE):
    """Encode3DVAE (networks_3d.py:44-66): enc_blocks + 1 spectral-norm 3D
    conv blocks, then the mu and logvar 3D convs."""

    ndim = 3


def refinement_layers_3d(cfg, body: Sequence[nn.Module], x: torch.Tensor,
                         amps, noise: NoiseSource, *, is_random: bool,
                         bn: str, commit: Commit = True) -> torch.Tensor:
    """Residual refinement chain (networks_3d.py:214-240 of the JAX
    package). amps: (stop_scale + 2,) per-scale noise amplitudes."""
    for idx in range(len(body)):
        if cfg.vae_levels == idx + 1 and not cfg.train_all:
            x = x.detach()  # the VAE boundary (networks_3d.py:224-225)
        x_up = upscale_3d(x, idx + 1, cfg.scale_factor, cfg.stop_scale,
                          cfg.img_size, cfg.stop_scale_time,
                          cfg.sampling_rates, cfg.org_fps, cfg.fps_lcm, cfg.ar)
        if is_random and cfg.vae_levels <= idx + 1:
            z = noise.normal(x_up.shape) * networks_2d.stage_amp(amps, idx + 1)
            x_in = x_up + z.to(x_up.dtype)  # float32 noise, cast (JAX :232)
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
    reconstruct_pair = None  # the JAX package pairs the 2D model only

    def _refine(self, x: torch.Tensor, amps, noise: NoiseSource, *,
                is_random: bool, bn: str, commit: Commit) -> torch.Tensor:
        return refinement_layers_3d(self.cfg, self.body, x, amps, noise,
                                    is_random=is_random, bn=bn, commit=commit)


class WDiscriminatorBaselines(nn.Module):
    """The baselines' critic (networks_3d.py:153-181 there): the input
    zero-padded by num_layer + 2, a plain conv head with LeakyReLU and no
    BatchNorm (padding padd_size), num_layer SN blocks (padding ker // 2)
    and a tail conv to one channel (padding padd_size)."""

    ndim = 3

    def __init__(self, cfg):
        super().__init__()
        n = int(cfg.nfc)
        self.head = nn.Module()
        self.head.conv = Conv(cfg.nc_im, n, cfg.ker_size, cfg.padd_size, 3)
        self.body = nn.Module()
        for i in range(cfg.num_layer):
            setattr(self.body, f"block{i}", SNBlock(n, n, cfg.ker_size, 3))
        self.num_layer = cfg.num_layer
        self.tail = Conv(n, 1, cfg.ker_size, cfg.padd_size, 3)
        self.pad = cfg.num_layer + 2

    def forward(self, x: torch.Tensor):
        """Returns (scores (B, 1, T + 2p, H + 2p, W + 2p), the new (u, v) of
        the body's SN convs); the buffers are not written."""
        y = lrelu(self.head.conv(F.pad(x, (self.pad,) * 6)))
        y, state = sn_blocks_apply([getattr(self.body, f"block{i}")
                                    for i in range(self.num_layer)], y)
        return self.tail(y), state


class BaselineStage(nn.Module):
    """n_blocks padding-0 ConvBlocks (cin -> nfc, then nfc -> nfc) and an
    optional padding-0 tail conv to cout_tail (networks_3d.py:347-376
    there): each conv takes 2 off every axis."""

    def __init__(self, cin: int, nfc: int, ker: int, n_blocks: int,
                 cout_tail: Optional[int] = None, tail_bias: bool = True):
        super().__init__()
        self.blocks = nn.ModuleList(
            ConvBlock(cin if i == 0 else nfc, nfc, ker, 0, 3)
            for i in range(n_blocks))
        if cout_tail is not None:
            self.tail = Conv(nfc, cout_tail, ker, 0, 3, bias=tail_bias)

    def forward(self, x: torch.Tensor, bn: str,
                commit: Commit = True) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, bn, commit)
        return self.tail(x) if hasattr(self, "tail") else x


def _zero_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad,) * 6)


class _Baseline(nn.Module):
    """What GeneratorCSG and GeneratorSG share.

    Stage idx = 1 .. len(body) - 1 refines the previous stage's output
    x_prev_out at pyramid scale idx:
        x_up = upscale(x_prev_out) to scale idx
        random mode:          x_in = resize(x_prev_out) to the padded size
                                     (T + 2p, H + 2p, W + 2p) of scale idx,
                                     plus amps[idx] * N(0, 1) of that shape
        reconstruction mode:  x_in = x_up zero-padded by p
        x_prev_out = stage_idx(x_in) + x_up
    (networks_3d.py:412-427, 463-479 there), so netG_<k> carries k + 1
    stages and its output is at scale k. Random mode starts from the noise
    it is given; reconstruction from the fixed `z_init` (1, nc_im, td0, h0,
    w0), broadcast to the batch: a buffer kept out of the state_dict, so
    that netG converts to the JAX package's tree. Growth deep-copies the
    last stage and draws nothing."""

    ndim = 3
    body_offset = 1  # netG_<k> carries k + 1 stages
    pad: int

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.body = nn.ModuleList()
        self.register_buffer("z_init", None, persistent=False)

    @property
    def widest_pad(self) -> int:
        """The widest activation, nfc channels at the last stage's size
        padded by num_layer + 1 per side: CSG's stage input, SG's first
        block output."""
        return self.cfg.num_layer + 1

    def init_next_stage(self, gen: Optional[torch.Generator] = None) -> None:
        """Grow by a deep copy of the last stage (networks_3d.py:391-395,
        446-450 there); `gen` is not drawn from."""
        self.body.append(copy.deepcopy(self.body[-1]))

    def _refine(self, idx: int, x_prev_out: torch.Tensor, amps,
                noise: NoiseSource, is_random: bool, bn: str,
                commit: Commit) -> torch.Tensor:
        cfg, p = self.cfg, self.pad
        x_up = upscale_3d(x_prev_out, idx, cfg.scale_factor, cfg.stop_scale,
                          cfg.img_size, cfg.stop_scale_time,
                          cfg.sampling_rates, cfg.org_fps, cfg.fps_lcm, cfg.ar)
        if is_random:
            t, h, w = x_up.shape[2:]
            x2 = resize_trilinear(x_prev_out, (t + 2 * p, h + 2 * p, w + 2 * p))
            z = noise.normal(x2.shape) * float(amps[idx])
            x_in = x2 + z.to(x2.dtype)  # float32 noise, cast (JAX :420, :472)
        else:
            x_in = _zero_pad(x_up, p)
        return self.body[idx](x_in, bn, commit) + x_up

    def forward(self, noise_init: torch.Tensor, amps, noise: NoiseSource, *,
                bn: str = "batch", commit: Commit = True
                ) -> Tuple[torch.Tensor]:
        """Random mode from noise_init (B, nc_im, td0, h0, w0); returns
        (x,). bn: "batch", "moving" or "sample" (ops/norm.py)."""
        return (self._run(noise_init, amps, noise, True, bn, commit),)

    def reconstruct(self, video: torch.Tensor, amps, noise: NoiseSource, *,
                    commit: bool = True):
        """The reconstruction from z_init with batch-statistics BatchNorm,
        at the batch size of `video` (whose content is not read; JAX
        baselines_trainer.py:49-68). Returns (x, x, None, None), the
        call surface of GeneratorHPVAEGAN.reconstruct."""
        if self.z_init is None:
            raise RuntimeError("the baseline generator has no z_init; the "
                               "baselines trainer sets it")
        z = self.z_init.expand((video.shape[0],) + tuple(self.z_init.shape[1:]))
        x = self._run(z, amps, noise, False, "batch", commit)
        return x, x, None, None


class GeneratorCSG(_Baseline):
    """GeneratorCSG (networks_3d.py:379-431 there): a head ConvBlock on z
    zero-padded by 1, a body of stages of num_layer + 1 ConvBlocks, each fed
    zero-padded by p = num_layer + 1 (the JAX package's shape-consistent
    pad), and a tail conv with bias on the output zero-padded by 1, then
    tanh."""

    def __init__(self, cfg):
        super().__init__(cfg)
        n = int(cfg.nfc)
        self.pad = cfg.num_layer + 1
        self.head = ConvBlock(cfg.nc_im, n, cfg.ker_size, 0, 3)
        self.body.append(BaselineStage(n, n, cfg.ker_size, cfg.num_layer + 1))
        self.tail = Conv(n, cfg.nc_im, cfg.ker_size, 0, 3)

    def _run(self, z, amps, noise, is_random, bn, commit):
        x = self.head(_zero_pad(z, 1), bn, commit)
        x = self.body[0](_zero_pad(x, self.pad), bn, commit)
        for idx in range(1, len(self.body)):
            x = self._refine(idx, x, amps, noise, is_random, bn, commit)
        return torch.tanh(self.tail(_zero_pad(x, 1)))


class GeneratorSG(_Baseline):
    """GeneratorSG (networks_3d.py:434-480 there): every stage is num_layer
    + 1 ConvBlocks and a tail conv to nc_im WITHOUT bias, fed zero-padded by
    p = num_layer + 2; tanh at the top of every refinement pass and once at
    the end."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.pad = cfg.num_layer + 2
        self.body.append(BaselineStage(cfg.nc_im, int(cfg.nfc), cfg.ker_size,
                                       cfg.num_layer + 1, cout_tail=cfg.nc_im,
                                       tail_bias=False))

    def _run(self, z, amps, noise, is_random, bn, commit):
        x = self.body[0](_zero_pad(z, self.pad), bn, commit)
        for idx in range(1, len(self.body)):
            x = self._refine(idx, torch.tanh(x), amps, noise, is_random, bn,
                             commit)
        return torch.tanh(x)
