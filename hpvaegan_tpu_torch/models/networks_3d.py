"""3D networks as `nn.Module`s: the video VAE encoders, the WGAN critics
WDiscriminator3D and WDiscriminatorBaselines, the hierarchical generators
GeneratorHPVAEGAN and GeneratorVAE_nb, and the SinGAN-style baselines
GeneratorCSG and GeneratorSG.

The port of the JAX package's `models/networks_3d.py` (reference
src/modules/networks_3d.py:89-144, 170-551). The HP-VAE-GAN classes are
the 2D classes of networks_2d.py with 3D convolutions (OIDHW weights,
NCDHW tensors), and GeneratorHPVAEGAN has one difference in the
refinement chain: noise is added only at stages with vae_levels <= idx +
1 (networks_3d.py:227-228 there, reference networks_3d.py:443), so the
VAE stages below vae_levels refine without it. GeneratorVAE_nb adds it at
every stage and, as in 2D, stops the gradient at the VAE boundary
whatever cfg.train_all says (`refinement_layers_3d`'s two flags). Each
upscale grows the time depth with the pyramid (trilinear,
align_corners=True, ops/resize.py::upscale_3d). There is no fused kernel
on this path: `cfg.pallas_fused_sampling` is ignored, as in the JAX
package.

The baselines (see `_Baseline`) are a GAN at every scale: no encoder, a
growing body of padding-0 stages fed through explicit zero pads, and a
fixed reconstruction noise Z_init that the baselines trainer sets.

Under a compute dtype the 3D networks flow in it as the 2D ones do: the
refinement noise (the baselines' random-mode stage input too) is drawn in
float32 and cast before the add (JAX :232, :420, :472).

Under a spatial axis (--mesh-sp, parallel/spatial.py) H, axis 3 of NCDHW,
is split wherever a scale's height divides by the axis's ranks, and T is
never split. The HP-VAE-GAN classes run as the 2D ones do. The baselines'
stages take rows off H: each zero pad of p rows puts the activation in the
padded layout (H, p) (spatial.Padded: the edge ranks hold the pad rows,
`_zero_pad`), and each padding-0 convolution of the stage brings it one
row a side closer to the equal split, which the stage's output is in. A
stage learns its layout from its pyramid height (`_Baseline._layout`); the
random-mode input is the resize and the draw cut to the rank's rows of
the layout, and the critic's scores are in the layout (H, num_layer + 2)
(`WDiscriminatorBaselines.score_pad`), whose mean training/steps.py
weighs.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import lrelu
from ..ops.resize import resize_trilinear_padded, upscale_3d
from ..parallel import spatial
from ..utils.noise import NoiseSource
from ..utils.pyramid import scale_height
from . import networks_2d
from .blocks import Commit, Conv, ConvBlock, SNBlock, sn_blocks_apply


class Encode3DVAE(networks_2d.Encode2DVAE):
    """Encode3DVAE (networks_3d.py:44-66): enc_blocks + 1 spectral-norm 3D
    conv blocks, then the mu and logvar 3D convs."""

    ndim = 3


class Encode3DVAE_nb(networks_2d.Encode2DVAE_nb):
    """Encode3DVAE_nb (networks_3d.py:69-100): Encode3DVAE with the
    Bernoulli gate's head, mu and logvar averaged over (T, H, W)."""

    ndim = 3


def refinement_layers_3d(cfg, body: Sequence[nn.Module], x: torch.Tensor,
                         amps, noise: NoiseSource, *, is_random: bool,
                         bn: str, commit: Commit = True,
                         gate_noise_on_vae_levels: bool = True,
                         train_all_escape: bool = True) -> torch.Tensor:
    """Residual refinement chain (networks_3d.py:214-240 of the JAX
    package). amps: (stop_scale + 2,) per-scale noise amplitudes.
    gate_noise_on_vae_levels: random mode adds noise only from stage
    vae_levels - 1 on (GeneratorHPVAEGAN); GeneratorVAE_nb passes False and
    adds it at every stage (:217, :227-228). train_all_escape: as
    networks_2d.refinement_layers'. Under a spatial axis, each activation
    as in networks_2d.refinement_layers."""
    h_in = scale_height(cfg, 0)
    for idx in range(len(body)):
        if cfg.vae_levels == idx + 1 \
                and not (cfg.train_all and train_all_escape):
            x = x.detach()  # the VAE boundary (networks_3d.py:224-225)
        h = scale_height(cfg, idx + 1)
        x_up = upscale_3d(x, idx + 1, cfg.scale_factor, cfg.stop_scale,
                          cfg.img_size, cfg.stop_scale_time,
                          cfg.sampling_rates, cfg.org_fps, cfg.fps_lcm, cfg.ar,
                          h_in=h_in)
        if is_random and (not gate_noise_on_vae_levels
                          or cfg.vae_levels <= idx + 1):
            z = noise.draw_rows(h, "normal", x_up.shape) \
                * networks_2d.stage_amp(amps, idx + 1)
            x_in = x_up + z.to(x_up.dtype)  # float32 noise, cast (JAX :232)
        else:
            x_in = x_up
        y = body[idx](x_in, bn, commit, sharded=spatial.sharded(h))
        x = torch.tanh(y + x_up)
        h_in = h
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


class GeneratorVAE_nb(networks_2d.GeneratorVAE_nb):
    """GeneratorVAE_nb 3D (networks_3d.py:285-342): the 2D class's gate and
    Gumbel latent (`_random_z`, `_latent`: the gate (B, 1, td, h0, w0),
    drawn before the refinement noise; eps, then u) on the 3D encoder,
    decoder and refinement chain, with noise at every stage and the
    VAE-boundary detach whatever cfg.train_all says. No paired forward."""

    ndim = 3
    encoder_cls = Encode3DVAE_nb

    def _refine(self, x: torch.Tensor, amps, noise: NoiseSource, *,
                is_random: bool, bn: str, commit: Commit) -> torch.Tensor:
        return refinement_layers_3d(self.cfg, self.body, x, amps, noise,
                                    is_random=is_random, bn=bn, commit=commit,
                                    gate_noise_on_vae_levels=False,
                                    train_all_escape=False)


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
        # the scores' pad rows a side: the head and the tail keep the
        # input's pad unless padd_size differs from ker // 2
        self.score_pad = self.pad + 2 * (cfg.padd_size - cfg.ker_size // 2)

    def forward(self, x: torch.Tensor, sharded: bool = False):
        """Returns (scores (B, 1, T + 2p, H + 2p, W + 2p), the new (u, v) of
        the body's SN convs); the buffers are not written. `sharded`: x
        holds the rank's rows of an H split over the spatial axis, and the
        scores are the rank's rows of the layout (H, score_pad)."""
        layout = spatial.Padded(x.shape[-2] * spatial.axis().size,
                                self.pad) if sharded else False
        y = lrelu(self.head.conv(_zero_pad(x, self.pad, layout), layout))
        layout = self.head.conv.layout_after(layout)
        y, state = sn_blocks_apply([getattr(self.body, f"block{i}")
                                    for i in range(self.num_layer)], y,
                                   layout)
        return self.tail(y, layout), state


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

    def forward(self, x: torch.Tensor, bn: str, commit: Commit = True,
                sharded: spatial.Layout = False) -> torch.Tensor:
        """`sharded`: x's padded layout (spatial.Padded) where the spatial
        axis splits its height; each conv takes a row off it a side."""
        for block in self.blocks:
            x = block(x, bn, commit, sharded=sharded)
            sharded = block.conv.layout_after(sharded)
        return self.tail(x, sharded) if hasattr(self, "tail") else x


def _zero_pad(x: torch.Tensor, pad: int,
              sharded: spatial.Layout = False) -> torch.Tensor:
    """x zero-padded by `pad` on T, H and W; where `sharded` (x the rank's
    rows of a split H), H only at the global edges, into the layout (H,
    pad)."""
    top, bottom = spatial.edge_pads(pad) if sharded else (pad, pad)
    return F.pad(x, (pad, pad, top, bottom, pad, pad))


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

    def _layout(self, idx: int, p: int) -> spatial.Layout:
        """The layout (H, p) of scale idx's height H where the spatial axis
        splits it, else False."""
        return spatial.layout(scale_height(self.cfg, idx), p)

    def _refine(self, idx: int, x_prev_out: torch.Tensor, amps,
                noise: NoiseSource, is_random: bool, bn: str,
                commit: Commit) -> torch.Tensor:
        cfg, p = self.cfg, self.pad
        h_in, h = scale_height(cfg, idx - 1), scale_height(cfg, idx)
        x_up = upscale_3d(x_prev_out, idx, cfg.scale_factor, cfg.stop_scale,
                          cfg.img_size, cfg.stop_scale_time,
                          cfg.sampling_rates, cfg.org_fps, cfg.fps_lcm, cfg.ar,
                          h_in=h_in)
        layout = self._layout(idx, p)
        if is_random:
            t, w = x_up.shape[2], x_up.shape[4]
            x2 = resize_trilinear_padded(x_prev_out, (t, h, w), p, h_in)
            z = noise.draw_rows(h, "normal", x2.shape, pad=p) \
                * float(amps[idx])
            x_in = x2 + z.to(x2.dtype)  # float32 noise, cast (JAX :420, :472)
        else:
            x_in = _zero_pad(x_up, p, layout)
        return self.body[idx](x_in, bn, commit, layout) + x_up

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
        z = spatial.shard_rows(self.z_init)  # the rank's rows of h0
        z = z.expand((video.shape[0],) + tuple(z.shape[1:]))
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
        head = self._layout(0, 1)
        x = self.head(_zero_pad(z, 1, head), bn, commit, sharded=head)
        stage = self._layout(0, self.pad)
        x = self.body[0](_zero_pad(x, self.pad, stage), bn, commit, stage)
        for idx in range(1, len(self.body)):
            x = self._refine(idx, x, amps, noise, is_random, bn, commit)
        tail = self._layout(len(self.body) - 1, 1)
        return torch.tanh(self.tail(_zero_pad(x, 1, tail), tail))


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
        stage = self._layout(0, self.pad)
        x = self.body[0](_zero_pad(z, self.pad, stage), bn, commit, stage)
        for idx in range(1, len(self.body)):
            x = self._refine(idx, torch.tanh(x), amps, noise, is_random, bn,
                             commit)
        return torch.tanh(x)
