"""Plain float32 PyTorch reference of the CSG video baseline: ConSinGAN
(Hinz, Fisher, Wang, Wermter, "Improved Techniques for Training
Single-Image GANs", arXiv:2003.11512) in 3D, as the HP-VAE-GAN code ships
it for its video comparison (github.com/shirgur/hp-vae-gan
train_video_baselines.py; src/modules/networks_3d.py GeneratorCSG and
WDiscriminatorBaselines): the generator in random and reconstruction
mode, the critic, and one training iteration of a scale, with no kernel,
no cache and no batching tricks.

It imports nothing of the program under test and nothing of JAX; the
pyramid, the layers, spectral norm, Adam and the draws are those of
reference/hpvaegan.py. It takes the weights, the reconstruction's fixed
input z_init and the real data that the benchmark made from the seed,
and draws its own noise from a generator seeded as the program's is, in
the order the iteration draws it: the batch's window starts and its
nc_im-channel noise; the fake's noise at each stage's padded size; the
GP's alpha; the fake's noise again (the reconstruction starts from z_init
and draws nothing). The caller turns TF32 off (`plain_math`).

The generator: a head ConvBlock on the noise zero-padded by 1; stage 0
on the head's output zero-padded by p = num_layer + 1; at each stage idx
>= 1, x_up = the previous output upscaled to scale idx (trilinear,
align_corners=True), the stage input the previous output resized to the
padded size of scale idx plus amps[idx] times N(0, 1) of that shape
(random mode) or x_up zero-padded by p (reconstruction), and the output
stage(input) + x_up; each stage is num_layer + 1 padding-0 ConvBlocks of
nfc channels, each taking 2 off every axis; then a padding-0 tail conv
with bias on the output zero-padded by 1, and tanh. The critic: its input
zero-padded by num_layer + 2, a plain conv head with LeakyReLU (padding
padd_size), num_layer spectral-norm blocks (padding ker // 2) and a tail
conv to one channel (padding padd_size), so that its scores keep the
padded size, whose mean the losses take.

Departures from the published code:
  * each stage's input is zero-padded by num_layer + 1, not num_layer: the
    published pad leaves a stage of num_layer + 1 padding-0 convolutions a
    voxel a side short of its residual's shape, and cannot run;
  * BatchNorm normalises by the batch's biased variance, eps 1e-5, and
    keeps no running statistics (batch-statistics BatchNorm reads none);
  * spectral norm takes one power step from the kept (u, v) at each
    application, and the D step keeps its real pass's new pair, the G
    step none (PyTorch's spectral_norm advances u in place at every
    training forward);
  * the fake's gradient reaches G through the adversarial term (the
    published loss detaches nothing there either; the HP-VAE-GAN
    reference's bug switch is off).

Tensor names are the program's state_dict names (`head.conv.weight`,
`body.9.blocks.5.norm.bias`, `tail.weight`; the critic's
`head.conv.weight`, `body.block0.conv.weight_orig`, `tail.bias`), which is
how the benchmark hands the same weights to both sides.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .hpvaegan import (Adam, Draws, _conv_spec, conv, lrelu, norm_batch,
                       pyramid, scale_shape, sn_conv, sn_names, upscale)

Tensor = torch.Tensor
Params = Dict[str, Tensor]


# ------------------------------------------------------------- parameters

def _block_spec(name: str, cin: int, cout: int, k: int
                ) -> List[Tuple[str, tuple, str]]:
    return _conv_spec(f"{name}.conv", cin, cout, k, 3) + [
        (f"{name}.norm.weight", (cout,), "gamma"),
        (f"{name}.norm.bias", (cout,), "zeros"),
        (f"{name}.norm.running_mean", (cout,), "zeros"),
        (f"{name}.norm.running_var", (cout,), "ones")]


def generator_spec(cfg: dict, stages: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, law) of every tensor of GeneratorCSG with `stages`
    stages (reference/hpvaegan.py's laws)."""
    nfc, k = cfg["nfc"], cfg["ker_size"]
    spec = _block_spec("head", cfg["nc_im"], nfc, k)
    for s in range(stages):
        for j in range(cfg["num_layer"] + 1):
            spec += _block_spec(f"body.{s}.blocks.{j}", nfc, nfc, k)
    return spec + _conv_spec("tail", nfc, cfg["nc_im"], k, 3)


def discriminator_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    nfc, k = cfg["nfc"], cfg["ker_size"]
    spec = _conv_spec("head.conv", cfg["nc_im"], nfc, k, 3)
    for i in range(cfg["num_layer"]):
        spec += _conv_spec(f"body.block{i}.conv", nfc, nfc, k, 3, sn=True)
    return spec + _conv_spec("tail", nfc, 1, k, 3)


# ------------------------------------------------------------------ model

def _pad(x: Tensor, p: int) -> Tensor:
    return F.pad(x, (p,) * 6)


def _block(P: Params, name: str, x: Tensor) -> Tensor:
    """A padding-0 ConvBlock: conv, batch-statistics BatchNorm, LeakyReLU."""
    x = conv(x, P[f"{name}.conv.weight"], P[f"{name}.conv.bias"], 0)
    return lrelu(norm_batch(x, P[f"{name}.norm.weight"],
                            P[f"{name}.norm.bias"]))


def _stage(P: Params, cfg: dict, idx: int, x: Tensor) -> Tensor:
    for j in range(cfg["num_layer"] + 1):
        x = _block(P, f"body.{idx}.blocks.{j}", x)
    return x


def generate(P: Params, cfg: dict, z: Tensor, amps: Sequence[float],
             draws: Draws, stages: int, random: bool = True) -> Tensor:
    """The generator with `stages` stages on z (B, nc_im, td0, h0, w0):
    random mode (a draw a stage from stage 1 on) or reconstruction."""
    p = cfg["num_layer"] + 1
    x = _block(P, "head", _pad(z, 1))
    x = _stage(P, cfg, 0, _pad(x, p))
    for idx in range(1, stages):
        shape = scale_shape(cfg, idx)
        x_up = upscale(x, shape)
        if random:
            x2 = upscale(x, [s + 2 * p for s in shape])
            x_in = x2 + draws.normal(x2.shape) * amps[idx]
        else:
            x_in = _pad(x_up, p)
        x = _stage(P, cfg, idx, x_in) + x_up
    return torch.tanh(conv(_pad(x, 1), P["tail.weight"], P["tail.bias"], 0))


def critic(P: Params, uv, cfg: dict, x: Tensor):
    """WDiscriminatorBaselines; returns the scores at the padded size and
    every SN conv's new (u, v)."""
    x = conv(_pad(x, cfg["num_layer"] + 2), P["head.conv.weight"],
             P["head.conv.bias"], cfg["padd_size"])
    x, new = lrelu(x), {}
    for i in range(cfg["num_layer"]):
        name = f"body.block{i}.conv"
        x, new[name] = sn_conv(P, uv, name, x)
        x = lrelu(x)
    return conv(x, P["tail.weight"], P["tail.bias"], cfg["padd_size"]), new


# --------------------------------------------------------------- training

def trainable(cfg: dict, stages: int) -> Dict[str, float]:
    """G's trainable parts at scale cfg["scale_idx"] of a generator with
    `stages` stages and their learning rates, the baselines trainer's plan:
    the last train_depth stages, the top at lr_g, each lower one lr_scale
    times the one above; the head while scale_idx < train_depth, at lr_g
    times lr_scale ** scale_idx; the tail at lr_g."""
    depth, lr, ls = min(cfg["train_depth"], stages), cfg["lr_g"], \
        cfg["lr_scale"]
    out = {f"body.{stages - depth + i}.": lr * ls ** (depth - 1 - i)
           for i in range(depth)}
    if cfg["scale_idx"] < cfg["train_depth"]:
        out["head."] = lr * ls ** cfg["scale_idx"]
    out["tail."] = lr
    return out


class Trainer:
    """One scale's training, D then G each iteration, from the given
    weights and draws.

    `G`, `D`: name -> tensor (copies are made); `z_init`: (1, nc_im, td0,
    h0, w0); `data`: (the scale's clip, scale 0's), (1, C, T, H, W) in
    [0, 1]; `amps`: amps[k] for stage k; `batch`: the batch."""

    def __init__(self, cfg: dict, G: Params, D: Params, z_init: Tensor,
                 data, amps, batch: int, seed: int, device):
        self.cfg, self.amps, self.batch = cfg, list(amps), batch
        self.stages = cfg["scale_idx"] + 1  # netG_<k> carries k + 1 stages
        self.G = {k: v.detach().clone().to(device) for k, v in G.items()}
        self.D = {k: v.detach().clone().to(device) for k, v in D.items()}
        self.z_init = z_init.to(device)
        self.D_uv = {n: (self.D[f"{n}.weight_u"], self.D[f"{n}.weight_v"])
                     for n in sn_names(self.D)}
        lrs = trainable(cfg, self.stages)
        self.g_train = {k: v for k, v in self.G.items()
                        if any(k.startswith(s) for s in lrs)
                        and not k.endswith(("running_mean", "running_var"))}
        self.d_train = {k: v for k, v in self.D.items()
                        if not k.endswith(("weight_u", "weight_v"))}
        # G's Adam clips nothing (the baselines trainer)
        self.opt_g = Adam(self.g_train, {k: lrs[next(
            s for s in lrs if k.startswith(s))] for k in self.g_train},
            cfg["beta1"])
        self.opt_d = Adam(self.d_train, {k: cfg["lr_d"] for k in self.d_train},
                          cfg["beta1"])
        self.data = [d.to(device) for d in data]
        self.draws = Draws(seed, device)

    def _batch(self):
        """The clips' windows from the same starts (every scale's sampling
        rate for the scale, the first rate for scale 0), in [-1, 1], and
        the noise (B, nc_im, td0, h0, w0)."""
        cfg, B = self.cfg, self.batch
        p = pyramid(cfg)
        real, zero = self.data
        starts = self.draws.randint(max(real.shape[2] - p["fps_lcm"], 1),
                                    (B,))

        def window(frames, every):
            idx = starts[:, None] + torch.arange(
                0, p["fps_lcm"] + 1, every, device=starts.device)
            return torch.stack([frames[0][:, i] for i in idx])

        real = window(real, p["every"][cfg["scale_idx"]]) * 2 - 1
        zero = window(zero, p["every"][0]) * 2 - 1
        noise = self.draws.normal((B, cfg["nc_im"])
                                  + tuple(scale_shape(cfg, 0)))
        return real, zero, noise

    def iteration(self) -> Dict[str, float]:
        """One D step then one G step against the updated D; returns the
        losses and their terms, and leaves the gradients each optimizer
        took in self.taken."""
        cfg, n = self.cfg, self.stages
        real, _, noise = self._batch()
        with torch.no_grad():
            fake = generate(self.G, cfg, noise, self.amps, self.draws, n)
        alpha = self.draws.uniform()
        with torch.enable_grad():
            d_params = {k: v.requires_grad_(True) for k, v in
                        self.d_train.items()}
            s_real, kept = critic(self.D, self.D_uv, cfg, real)
            s_fake, _ = critic(self.D, self.D_uv, cfg, fake)
            interp = (alpha * real + (1 - alpha) * fake).requires_grad_(True)
            s_int, _ = critic(self.D, self.D_uv, cfg, interp)
            g, = torch.autograd.grad(s_int.sum(), interp, create_graph=True)
            gp = torch.mean((torch.sqrt(torch.sum(g ** 2, dim=1) + 1e-12)
                             - 1) ** 2) * cfg["lambda_grad"]
            d_real, d_fake = torch.mean(s_real), torch.mean(s_fake)
            d_loss = -d_real + d_fake + gp
            grads = torch.autograd.grad(d_loss, list(d_params.values()))
        for p in d_params.values():
            p.requires_grad_(False)
        taken_d = self.opt_d.step(dict(zip(d_params, grads)))
        self.D_uv = kept

        with torch.enable_grad():
            g_params = {k: v.requires_grad_(True) for k, v in
                        self.g_train.items()}
            z = self.z_init.expand((self.batch,)
                                   + tuple(self.z_init.shape[1:]))
            gen = generate(self.G, cfg, z, self.amps, self.draws, n,
                           random=False)
            fake = generate(self.G, cfg, noise, self.amps, self.draws, n)
            rec = torch.mean((gen - real) ** 2)
            adv = -torch.mean(critic(self.D, self.D_uv, cfg, fake)[0]) \
                * cfg["disc_loss_weight"]
            g_loss = cfg["rec_weight"] * rec + adv
            grads = torch.autograd.grad(g_loss, list(g_params.values()))
        for p in g_params.values():
            p.requires_grad_(False)
        taken_g = self.opt_g.step(dict(zip(g_params, grads)))
        self.taken = {"G": taken_g, "D": taken_d}
        return {k: float(v.detach()) for k, v in (
            ("d_loss", d_loss), ("d_real", d_real), ("d_fake", d_fake),
            ("gp", gp), ("g_loss", g_loss), ("rec", rec), ("adv", adv))}
