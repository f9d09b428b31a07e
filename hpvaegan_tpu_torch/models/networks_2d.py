"""2D networks as `nn.Module`s: the VAE encoders, the WGAN discriminator and
the hierarchical generators GeneratorHPVAEGAN and GeneratorVAE_nb.

The port of the JAX package's `models/networks_2d.py` for GeneratorHPVAEGAN,
GeneratorVAE_nb and WDiscriminator2D (reference
src/modules/networks_2d.py:85-384). The
"growing network" is a ModuleList of refinement stages: `init_next_stage`
appends a fresh stage first and a deep copy of the last one after that.
Tensors are NCHW.

Random mode (sampling, and the training step's fakes): z = noise_init
through the decoder, then per refinement stage k = 1..len(body)
    x_up = upscale(x) to scale k;  x_in = x_up + amp_k * noise
    x = tanh(stage_k(x_in) + x_up)
Reconstruction mode (training, `reconstruct`): z = eps * exp(logvar / 2)
+ mu from the encoder, and no refinement noise. In both, the gradient stops
at the VAE boundary (stage vae_levels - 1) unless cfg.train_all. Every draw
comes from a `NoiseSource` (utils/noise.py). GeneratorVAE_nb multiplies the
decoder's input by a Bernoulli gate (see the class) and stops the gradient
at the VAE boundary whatever cfg.train_all says.

State: BatchNorm folds its batch statistics unless a forward runs with
commit=False; spectral-norm forwards return their new (u, v) and the
caller keeps them (models/blocks.py). The encoder's pairs are kept by
`reconstruct(commit=True)`; the discriminator's by the D step.

Under a compute dtype (models/blocks.py::set_compute_dtype) activations
flow in it from the first conv on; the latents (mu, logvar, the gate) are
float32, and the refinement noise is cast to the activations' dtype before
the add. `reconstruct_pair` is the paired G step's forward
(`--paired-g`), GeneratorHPVAEGAN's only.

Under a spatial axis (--mesh-sp, parallel/spatial.py) every activation of
a pyramid height that divides by the axis's ranks holds the rank's rows of
H: the encoder, the decoder and each refinement stage run `sharded` by
their scale's height (`_sharded`), the upscales between stages move
between the two layouts (ops/resize.py), every draw is the rank's rows of
the global draw (NoiseSource.draw_rows) and Encode2DVAE_nb's spatial mean
is the global one. The discriminator takes `sharded` from its caller.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.fused_upscale_noise import fused_upscale_noise_2d
from ..ops.resize import upscale_2d
from ..parallel import spatial
from ..utils.noise import NoiseSource
from ..utils.pyramid import scale_height, scale_size_2d
from .blocks import (Commit, Conv, ConvStack, SNBlock, SNState,
                     assign_sn_state, init_weights_, sn_blocks_apply)


class _ConvHead(nn.Module):
    def __init__(self, cin: int, cout: int, ker: int, ndim: int):
        super().__init__()
        self.conv = Conv(cin, cout, ker, ker // 2, ndim)


class Encode2DVAE(nn.Module):
    """The VAE encoder (networks_2d.py:31-52): enc_blocks + 1 spectral-norm
    conv blocks, then the mu and logvar convs."""

    ndim = 2

    def __init__(self, cfg, out_dim: int, num_blocks: int):
        super().__init__()
        self.features = nn.Module()
        chans = [cfg.nc_im] + [cfg.nfc] * (num_blocks + 1)
        for i in range(num_blocks + 1):
            setattr(self.features, f"conv_block_{i}",
                    SNBlock(chans[i], chans[i + 1], cfg.ker_size, self.ndim))
        self.num_blocks = num_blocks + 1
        self.mu = _ConvHead(cfg.nfc, out_dim, cfg.ker_size, self.ndim)
        self.logvar = _ConvHead(cfg.nfc, out_dim, cfg.ker_size, self.ndim)

    def features_apply(self, x: torch.Tensor, sharded: bool = False
                       ) -> Tuple[torch.Tensor, SNState]:
        """The SN blocks' output and their new (u, v)."""
        return sn_blocks_apply([getattr(self.features, f"conv_block_{i}")
                                for i in range(self.num_blocks)], x, sharded)

    def forward(self, x: torch.Tensor, sharded: bool = False
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], SNState]:
        """Returns ((mu, logvar), the SN blocks' new (u, v))."""
        feats, state = self.features_apply(x, sharded)
        # the latents stay float32 under a compute dtype (JAX :51-52)
        return (self.mu.conv(feats, sharded).float(),
                self.logvar.conv(feats, sharded).float()), state


class Encode2DVAE_nb(Encode2DVAE):
    """Encode2DVAE_nb (JAX networks_2d.py:55-86): the encoder with a third
    head, a Bernoulli gate bern = sigmoid(conv(feats)) that scales the
    features, and mu and logvar averaged over space. models/networks_3d.py
    subclasses it for video (`ndim`; the mean is then over (T, H, W))."""

    def __init__(self, cfg, out_dim: int, num_blocks: int):
        super().__init__(cfg, out_dim, num_blocks)
        self.bern = _ConvHead(cfg.nfc, 1, cfg.ker_size, self.ndim)

    def forward(self, x: torch.Tensor, sharded: bool = False):
        """Returns ((mu, logvar, bern), the SN blocks' new (u, v)): mu and
        logvar (B, out_dim, 1, 1), bern (B, 1, H', W'); in 3D (B, out_dim,
        1, 1, 1) and (B, 1, T', H', W')."""
        feats, state = self.features_apply(x, sharded)
        bern = torch.sigmoid(self.bern.conv(feats, sharded))
        feats = bern * feats
        mu = _spatial_mean(self.mu.conv(feats, sharded), sharded)
        logvar = _spatial_mean(self.logvar.conv(feats, sharded), sharded)
        return (mu.float(), logvar.float(), bern.float()), state


def _spatial_mean(t: torch.Tensor, sharded: bool) -> torch.Tensor:
    """The mean over every axis after the channels, (H, W) or (T, H, W),
    keeping them as size 1; of all of H (axis -2) where t holds the rank's
    rows of it (in float32, then t's dtype)."""
    dims = tuple(range(2, t.ndim))
    if not sharded:
        return t.mean(dim=dims, keepdim=True)
    total = spatial.sum_sp(t.float().sum(dim=dims, keepdim=True))
    return (total / (t[0, 0].numel() * spatial.axis().size)).to(t.dtype)


class WDiscriminator2D(nn.Module):
    """WGAN critic (networks_2d.py:112-137): an SN head block, num_layer SN
    body blocks and a plain tail conv to one channel with padding 1 (the
    reference hard-codes it, networks_2d.py:178). models/networks_3d.py
    subclasses it for video (`ndim` is what differs)."""

    ndim = 2

    def __init__(self, cfg):
        super().__init__()
        n = int(cfg.nfc)
        self.head = SNBlock(cfg.nc_im, n, cfg.ker_size, self.ndim)
        self.body = nn.Module()
        for i in range(cfg.num_layer):
            setattr(self.body, f"block{i}",
                    SNBlock(n, n, cfg.ker_size, self.ndim))
        self.num_layer = cfg.num_layer
        self.tail = Conv(n, 1, cfg.ker_size, 1, self.ndim)

    def forward(self, x: torch.Tensor, sharded: bool = False
                ) -> Tuple[torch.Tensor, SNState]:
        """Returns (scores, the new (u, v) of every SN conv, head first);
        scores are (B, 1, H', W'), in 3D (B, 1, T', H', W'). The buffers
        are not written. `sharded`: x holds the rank's rows of H."""
        blocks = [self.head] + [getattr(self.body, f"block{i}")
                                for i in range(self.num_layer)]
        y, state = sn_blocks_apply(blocks, x, sharded)
        return self.tail(y, sharded), state


def stage_amp(amps, index: int):
    """amps[index]: a 0-d tensor where amps is a tensor (the exported
    sampler's input, which float() would freeze into the graph), else a
    float."""
    return amps[index] if torch.is_tensor(amps) else float(amps[index])


def refinement_layers(cfg, body: Sequence[nn.Module], x: torch.Tensor, amps,
                      noise: NoiseSource, *, is_random: bool, bn: str,
                      commit: Commit = True,
                      train_all_escape: bool = True, groups: int = 1,
                      noise_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Residual refinement chain (networks_2d.py:177-229 of the JAX package).

    amps: (stop_scale + 2,) per-scale noise amplitudes. train_all_escape:
    cfg.train_all lifts the VAE-boundary detach (GeneratorHPVAEGAN);
    GeneratorVAE_nb passes False and detaches always (JAX :185-187). The
    refinement noise is drawn in float32 and cast to the activations' dtype
    before the add (JAX :220); `noise_mask` (the paired forward's) zeroes it
    on the reconstruction rows, and `groups` goes to BatchNorm. The fused
    kernel runs where the JAX package runs its Pallas kernel: with
    `cfg.pallas_fused_sampling`, in random mode, on moving-stat BatchNorm,
    without a noise mask (networks_2d.py:189-195 there); one seed per
    stage. Training forwards run batch statistics and never reach it.
    Under a spatial axis x is the rank's rows of the decoder's output
    where scale 0's height is split, and each stage's where its is.
    """
    use_fused = bool(getattr(cfg, "pallas_fused_sampling", False)) \
        and is_random and bn == "moving" and noise_mask is None
    h_in = scale_height(cfg, 0)
    for idx in range(len(body)):
        if cfg.vae_levels == idx + 1 \
                and not (cfg.train_all and train_all_escape):
            x = x.detach()  # the VAE boundary (networks_2d.py:202-204)
        amp = stage_amp(amps, idx + 1)
        hw = scale_size_2d(idx + 1, cfg.scale_factor, cfg.stop_scale,
                           cfg.img_size, cfg.ar)
        if use_fused:
            seed = noise.batch_seed(x.shape[0])
            bits = noise.kernel_bits((x.shape[0], x.shape[1], hw[0], hw[1]))
            x_up, x_in = fused_upscale_noise_2d(
                x.contiguous(), hw, float(amp), seed, bits=bits)
        else:
            x_up = upscale_2d(x, idx + 1, cfg.scale_factor, cfg.stop_scale,
                              cfg.img_size, cfg.ar, h_in=h_in)
            x_in = x_up
            if is_random:
                z = noise.draw_rows(hw[0], "grouped_normal", x_up.shape,
                                    groups) if groups > 1 \
                    else noise.draw_rows(hw[0], "normal", x_up.shape)
                if noise_mask is not None:
                    z = z * noise_mask
                x_in = x_up + (z * amp).to(x_up.dtype)
        y = body[idx](x_in, bn, commit, groups, spatial.sharded(hw[0]))
        x = torch.tanh(y + x_up)
        h_in = hw[0]
    return x


class GeneratorHPVAEGAN(nn.Module):
    """The 2D generator; models/networks_3d.py subclasses it for video
    (`ndim`, `encoder_cls` and `_refine` are what differ)."""

    ndim = 2
    encoder_cls = Encode2DVAE
    body_offset = 0  # netG_<k> carries k refinement stages
    widest_pad = 0  # the widest activation: nfc channels at the last stage

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.encode = self.encoder_cls(cfg, cfg.latent_dim, cfg.enc_blocks)
        self.decoder = ConvStack(cfg.latent_dim, int(cfg.nfc), cfg.nc_im,
                                 cfg.ker_size, cfg.padd_size, cfg.num_layer,
                                 self.ndim)
        self.body = nn.ModuleList()

    def _refine(self, x: torch.Tensor, amps, noise: NoiseSource, *,
                is_random: bool, bn: str, commit: Commit) -> torch.Tensor:
        return refinement_layers(self.cfg, self.body, x, amps, noise,
                                 is_random=is_random, bn=bn, commit=commit)

    def init_next_stage(self, gen: Optional[torch.Generator] = None) -> None:
        """Grow the refinement body by one stage (networks_2d.py:224-235):
        the first stage is fresh (initialised from `gen` when given), later
        ones deep-copy the previous stage."""
        if len(self.body) == 0:
            cfg = self.cfg
            param = self.decoder.tail.weight
            stage = ConvStack(cfg.nc_im, int(cfg.nfc), cfg.nc_im, cfg.ker_size,
                              cfg.padd_size, cfg.num_layer, self.ndim)
            if gen is not None:
                init_weights_(stage, gen)
            stage = stage.to(device=param.device, dtype=param.dtype)
        else:
            stage = copy.deepcopy(self.body[-1])
        self.body.append(stage)

    def _sharded(self, index: int) -> bool:
        """Whether pyramid scale `index`'s activations hold the rank's rows
        of H (parallel/spatial.py)."""
        return spatial.sharded(scale_height(self.cfg, index))

    def _random_z(self, noise_init: torch.Tensor,
                  noise: NoiseSource) -> torch.Tensor:
        """The decoder's input in random mode."""
        return noise_init

    def _latent(self, video: torch.Tensor, noise: NoiseSource):
        """The decoder's input in reconstruction mode, mu, logvar and the
        encoder's new (u, v): z = eps * exp(logvar / 2) + mu."""
        (mu, logvar), enc_state = self.encode(video, self._sharded(0))
        std = torch.exp(logvar * 0.5)
        eps = noise.draw_rows(scale_height(self.cfg, 0), "normal", std.shape)
        return eps * std + mu, mu, logvar, enc_state

    def forward(self, noise_init: torch.Tensor, amps, noise: NoiseSource, *,
                bn: str = "batch", commit: Commit = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Random-mode forward from z = noise_init (B, latent_dim, h0, w0;
        in 3D (B, latent_dim, td, h0, w0)). Returns (x, vae_out). bn:
        "batch", "moving" or "sample" (ops/norm.py)."""
        z = self._random_z(noise_init, noise)
        vae_out = torch.tanh(self.decoder(z, bn, commit,
                                          sharded=self._sharded(0)))
        x = self._refine(vae_out, amps, noise, is_random=True, bn=bn,
                         commit=commit)
        return x, vae_out

    def reconstruct(self, video: torch.Tensor, amps, noise: NoiseSource, *,
                    commit: bool = True):
        """Training-mode reconstruction of `video` (the scale-0 image, B, C,
        h0, w0; in 3D the scale-0 clip, B, C, T, h0, w0) with
        batch-statistics BatchNorm (networks_2d.py:240-250), from
        `_latent`. Returns (x, vae_out, mu, logvar). With commit, BatchNorm
        folds and the encoder keeps its new (u, v)."""
        z, mu, logvar, enc_state = self._latent(video, noise)
        vae_out = torch.tanh(self.decoder(z, "batch", commit,
                                          sharded=self._sharded(0)))
        x = self._refine(vae_out, amps, noise, is_random=False, bn="batch",
                         commit=commit)
        if commit:
            assign_sn_state(self.encode, enc_state)
        return x, vae_out, mu, logvar

    def reconstruct_pair(self, video: torch.Tensor, noise_init: torch.Tensor,
                         amps, noise: NoiseSource):
        """The GAN-phase G step's reconstruction of `video` and random-mode
        fake from `noise_init` as one forward of width 2B (JAX
        generator_hpvaegan_apply_pair, networks_2d.py:275-323 there):
        decoder input concat(z, noise_init), BatchNorm on each half's own
        statistics, folded reconstruction half first, and the refinement
        noise drawn at the 2B shape and masked to the fake half. Folds
        BatchNorm and keeps the encoder's new (u, v), as reconstruct() and
        then forward() do. Returns (gen, fake, vae_out, mu, logvar).
        `None` on the classes the JAX package has no pair for."""
        z, mu, logvar, enc_state = self._latent(video, noise)
        b = z.shape[0]
        if noise_init.shape[0] != b:
            raise ValueError(f"the paired forward needs equal batches, got "
                             f"{b} and {noise_init.shape[0]}")
        z_all = torch.cat([z, noise_init.to(z.dtype)])
        vae_all = torch.tanh(self.decoder(z_all, "batch", True, groups=2,
                                          sharded=self._sharded(0)))
        # made on the device: a host tensor's copy would wait for the queue
        mask = torch.cat([torch.zeros(b, device=z.device),
                          torch.ones(b, device=z.device)])
        x = refinement_layers(self.cfg, self.body, vae_all, amps, noise,
                              is_random=True, bn="batch", groups=2,
                              noise_mask=mask.reshape(-1, 1, 1, 1))
        assign_sn_state(self.encode, enc_state)
        return x[:b], x[b:], vae_all[:b], mu, logvar


class GeneratorVAE_nb(GeneratorHPVAEGAN):
    """GeneratorVAE_nb (JAX networks_2d.py:328-384): the decoder's input is
    z times a gate. Random mode draws the gate Bernoulli(0.5), (B, 1, h0,
    w0), before the refinement noise; reconstruction draws eps (normal) and
    then u (uniform, the gate's shape) for a Gumbel relaxation of the
    encoder's bern:
        z_bern = log(bern + 1e-20) - log(-log(u + 1e-20) + 1e-20).
    Growth deep-copies the last stage, as GeneratorHPVAEGAN's does (the
    reference shares one stage object between scales; the JAX package
    copies). models/networks_3d.py subclasses it for video (the gate is
    then (B, 1, td, h0, w0))."""

    encoder_cls = Encode2DVAE_nb
    reconstruct_pair = None  # the JAX package pairs GeneratorHPVAEGAN only

    def _refine(self, x: torch.Tensor, amps, noise: NoiseSource, *,
                is_random: bool, bn: str, commit: Commit) -> torch.Tensor:
        return refinement_layers(self.cfg, self.body, x, amps, noise,
                                 is_random=is_random, bn=bn, commit=commit,
                                 train_all_escape=False)

    def _random_z(self, noise_init: torch.Tensor,
                  noise: NoiseSource) -> torch.Tensor:
        gate_shape = (noise_init.shape[0], 1) + tuple(noise_init.shape[2:])
        gate = noise.draw_rows(scale_height(self.cfg, 0), "bernoulli",
                               gate_shape)
        return noise_init * gate.to(noise_init.dtype)

    def _latent(self, video: torch.Tensor, noise: NoiseSource):
        """z_norm * z_bern; the encoder's bern is
        `self.encode(video)[0][2]`."""
        (mu, logvar, bern), enc_state = self.encode(video, self._sharded(0))
        std = torch.exp(logvar * 0.5)
        z_norm = noise.normal(std.shape) * std + mu
        u = noise.draw_rows(scale_height(self.cfg, 0), "uniform", bern.shape)
        z_bern = torch.log(bern + 1e-20) \
            - torch.log(-torch.log(u + 1e-20) + 1e-20)
        return z_norm * z_bern, mu, logvar, enc_state
