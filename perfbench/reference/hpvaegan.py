"""Plain float32 PyTorch reference of HP-VAE-GAN (github.com/shirgur/hp-vae-gan):
the generator, the WGAN-GP critic, one GAN-scale training iteration and the
sampler, written from the paper's code with no kernel, no cache and no
batching tricks.

It imports nothing of the program under test and nothing of JAX: it takes
the weights and the real data that the benchmark made from the seed, and
draws its own noise from a generator on the card seeded as the program's
is, in the order the published iteration draws it (the batch's noise and,
for video, the clip's window start; the fake's per-stage noise; the GP's
alpha; the reconstruction's eps; the fake's per-stage noise again), so
that the two see the same draws. The caller turns TF32 off
(`plain_math`).

Module and tensor names follow the original state_dict (`decoder.head.conv
.weight`, `body.8.block2.norm.bias`, `head.conv.weight_orig`, ...), which
is how the benchmark hands the same weights to both sides. Batch-statistics
BatchNorm reads no running statistics, so the reference keeps none; the
spectral-norm vectors (u, v) it does keep, as the iteration does: the D
step keeps the real pass's, the G step the encoder's.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@contextlib.contextmanager
def plain_math():
    """Float32 convolutions and matmuls without TF32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------- pyramid

def pyramid(cfg: dict) -> dict:
    """The published pyramid schedule (hp-vae-gan src/utils/images.py): the
    number of scales, the effective scale factor, and each scale's [H, W]
    and, for video, its time depth."""
    size, lo = cfg["img_size"], cfg["min_size"]
    num_scales = math.ceil(math.log(lo / size, cfg["scale_factor"])) + 1
    stop = num_scales - math.ceil(math.log(min(cfg["max_size"], size) / size,
                                           cfg["scale_factor"]))
    factor = math.pow(lo / size, 1 / stop)
    ar = cfg["ar"]
    hw = []
    for k in range(stop + 1):
        base = int(math.ceil((math.pow(factor, stop - k) + 1e-6) * size))
        hw.append((int(base * ar), base))
    out = {"stop_scale": stop, "hw": hw}
    if cfg.get("ndim", 2) == 3:
        rates = cfg["sampling_rates"]
        lcm = math.lcm(*rates)
        out["fps_lcm"] = lcm
        out["td"] = [lcm // rates[int(k / stop * (len(rates) - 1))] + 1
                     for k in range(stop + 1)]
        out["every"] = [rates[int(k / stop * (len(rates) - 1))]
                        for k in range(stop + 1)]
    return out


def scale_shape(cfg: dict, k: int) -> Tuple[int, ...]:
    """The spatial shape of scale k: (H, W), or (T, H, W) for video."""
    p = pyramid(cfg)
    if cfg.get("ndim", 2) == 3:
        return (p["td"][k],) + p["hw"][k]
    return p["hw"][k]


# ------------------------------------------------------------- parameters

def _conv_spec(name: str, cin: int, cout: int, k: int, ndim: int,
               sn: bool = False) -> List[Tuple[str, tuple, str]]:
    kshape = (cout, cin) + (k,) * ndim
    if sn:
        return [(f"{name}.weight_orig", kshape, "conv"),
                (f"{name}.bias", (cout,), "zeros"),
                (f"{name}.weight_u", (cout,), "unit"),
                (f"{name}.weight_v", (cin * k ** ndim,), "unit")]
    return [(f"{name}.weight", kshape, "conv"), (f"{name}.bias", (cout,),
                                                 "zeros")]


def _stack_spec(prefix: str, cin: int, mid: int, cout: int, cfg: dict
                ) -> List[Tuple[str, tuple, str]]:
    k, nd = cfg["ker_size"], cfg["ndim"]
    spec = []
    for i, name in enumerate(["head"] + [f"block{j}" for j in
                                         range(cfg["num_layer"])]):
        spec += _conv_spec(f"{prefix}.{name}.conv", cin if i == 0 else mid,
                           mid, k, nd)
        spec += [(f"{prefix}.{name}.norm.weight", (mid,), "gamma"),
                 (f"{prefix}.{name}.norm.bias", (mid,), "zeros"),
                 (f"{prefix}.{name}.norm.running_mean", (mid,), "zeros"),
                 (f"{prefix}.{name}.norm.running_var", (mid,), "ones")]
    return spec + _conv_spec(f"{prefix}.tail", mid, cout, k, nd)


def generator_spec(cfg: dict, stages: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, law) of every tensor of GeneratorHPVAEGAN with
    `stages` refinement stages. Laws: "conv" N(0, 0.02), "gamma"
    N(1, 0.02), "zeros", "ones", "unit" (a random unit vector)."""
    nfc, k, nd = cfg["nfc"], cfg["ker_size"], cfg["ndim"]
    spec = []
    chans = [cfg["nc_im"]] + [nfc] * (cfg["enc_blocks"] + 1)
    for i in range(cfg["enc_blocks"] + 1):
        spec += _conv_spec(f"encode.features.conv_block_{i}.conv", chans[i],
                           chans[i + 1], k, nd, sn=True)
    spec += _conv_spec("encode.mu.conv", nfc, cfg["latent_dim"], k, nd)
    spec += _conv_spec("encode.logvar.conv", nfc, cfg["latent_dim"], k, nd)
    spec += _stack_spec("decoder", cfg["latent_dim"], nfc, cfg["nc_im"], cfg)
    for s in range(stages):
        spec += _stack_spec(f"body.{s}", cfg["nc_im"], nfc, cfg["nc_im"], cfg)
    return spec


def discriminator_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    nfc, k, nd = cfg["nfc"], cfg["ker_size"], cfg["ndim"]
    spec = _conv_spec("head.conv", cfg["nc_im"], nfc, k, nd, sn=True)
    for i in range(cfg["num_layer"]):
        spec += _conv_spec(f"body.block{i}.conv", nfc, nfc, k, nd, sn=True)
    return spec + _conv_spec("tail", nfc, 1, k, nd)


# ----------------------------------------------------------------- layers

def conv(x: Tensor, w: Tensor, b: Tensor, pad: int) -> Tensor:
    fn = F.conv2d if w.ndim == 4 else F.conv3d
    return fn(x, w, b, padding=pad)


def lrelu(x: Tensor) -> Tensor:
    return F.leaky_relu(x, 0.2)


def norm_batch(x: Tensor, g: Tensor, b: Tensor) -> Tensor:
    """BatchNorm on the batch's statistics (biased variance, eps 1e-5)."""
    return F.batch_norm(x, None, None, g, b, training=True, eps=1e-5)


def norm_sample(x: Tensor, g: Tensor, b: Tensor) -> Tensor:
    """BatchNorm on each sample's own statistics, as the eval samples."""
    return F.instance_norm(x, weight=g, bias=b, eps=1e-5)


def _unit(x: Tensor) -> Tensor:
    return x / x.norm().clamp_min(1e-12)


def sn_conv(P: Params, uv: Dict[str, Tuple[Tensor, Tensor]], name: str,
            x: Tensor) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """A spectral-norm conv: one power step from uv[name], W / sigma, zero
    padding ker // 2; returns the output and the new (u, v)."""
    w = P[f"{name}.weight_orig"]
    u, v = uv[name]
    mat = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = _unit(mat.t() @ u)
        u = _unit(mat @ v)
    sigma = u @ mat @ v
    return conv(x, w / sigma, P[f"{name}.bias"], w.shape[-1] // 2), (u, v)


def sn_names(P: Params) -> List[str]:
    return [k[:-len(".weight_u")] for k in P if k.endswith(".weight_u")]


def conv_stack(P: Params, prefix: str, x: Tensor, cfg: dict, norm) -> Tensor:
    for name in ["head"] + [f"block{j}" for j in range(cfg["num_layer"])]:
        p = f"{prefix}.{name}"
        x = conv(x, P[f"{p}.conv.weight"], P[f"{p}.conv.bias"],
                 cfg["padd_size"])
        x = lrelu(norm(x, P[f"{p}.norm.weight"], P[f"{p}.norm.bias"]))
    w = P[f"{prefix}.tail.weight"]
    return conv(x, w, P[f"{prefix}.tail.bias"], w.shape[-1] // 2)


def upscale(x: Tensor, shape: Sequence[int]) -> Tensor:
    mode = "bilinear" if x.ndim == 4 else "trilinear"
    return F.interpolate(x, size=tuple(shape), mode=mode, align_corners=True)


# ------------------------------------------------------------------ model

class Draws:
    """The noise of a run, from a generator on `device` seeded `seed`."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.device = device

    def normal(self, shape) -> Tensor:
        return torch.randn(tuple(shape), generator=self.gen,
                           dtype=torch.float32, device=self.device)

    def uniform(self) -> Tensor:
        return torch.rand((), generator=self.gen, dtype=torch.float32,
                          device=self.device)

    def randint(self, high: int, shape) -> Tensor:
        return torch.randint(0, int(high), tuple(shape), generator=self.gen,
                             device=self.device)


def generate(P: Params, cfg: dict, z: Tensor, amps: Sequence[float],
             draws: Draws, norm, stages: int) -> Tensor:
    """Random mode: z through the decoder, then each refinement stage on the
    upscaled image plus amps[k] times fresh noise (in video, only from
    stage vae_levels on), with the residual tanh. The gradient stops at
    the VAE boundary."""
    x = torch.tanh(conv_stack(P, "decoder", z, cfg, norm))
    return _refine(P, cfg, x, amps, draws, norm, stages, random=True)


def _refine(P, cfg, x, amps, draws, norm, stages, random):
    for idx in range(stages):
        if cfg["vae_levels"] == idx + 1:
            x = x.detach()
        x_up = upscale(x, scale_shape(cfg, idx + 1))
        x_in = x_up
        if random and (cfg["ndim"] == 2 or cfg["vae_levels"] <= idx + 1):
            x_in = x_up + (draws.normal(x_up.shape)
                           * amps[idx + 1]).to(x_up.dtype)
        x = torch.tanh(conv_stack(P, f"body.{idx}", x_in, cfg, norm) + x_up)
    return x


def reconstruct(P: Params, uv, cfg: dict, real_zero: Tensor, amps,
                draws: Draws, stages: int):
    """Reconstruction mode: z = eps * exp(logvar / 2) + mu from the
    encoder; returns the output and the encoder's new (u, v)."""
    x, new = real_zero, {}
    for i in range(cfg["enc_blocks"] + 1):
        name = f"encode.features.conv_block_{i}.conv"
        x, new[name] = sn_conv(P, uv, name, x)
        x = lrelu(x)
    k = cfg["ker_size"] // 2
    mu = conv(x, P["encode.mu.conv.weight"], P["encode.mu.conv.bias"], k)
    logvar = conv(x, P["encode.logvar.conv.weight"],
                  P["encode.logvar.conv.bias"], k)
    std = torch.exp(logvar * 0.5)
    z = draws.normal(std.shape) * std + mu
    x = torch.tanh(conv_stack(P, "decoder", z, cfg, norm_batch))
    return _refine(P, cfg, x, amps, draws, norm_batch, stages,
                   random=False), new


def critic(P: Params, uv, cfg: dict, x: Tensor):
    """The WGAN critic: SN head, num_layer SN blocks, plain tail (padding
    1); returns the scores and every SN conv's new (u, v)."""
    new = {}
    for name in ["head.conv"] + [f"body.block{i}.conv"
                                 for i in range(cfg["num_layer"])]:
        x, new[name] = sn_conv(P, uv, name, x)
        x = lrelu(x)
    return conv(x, P["tail.weight"], P["tail.bias"], 1), new


# --------------------------------------------------------------- training

class Adam:
    """torch.optim.Adam's update, written out; `clip` scales each gradient
    to norm at most clip first (the generator's per-tensor clip)."""

    def __init__(self, params: Dict[str, Tensor], lrs: Dict[str, float],
                 beta1: float, clip: float = math.inf):
        self.params, self.lrs, self.beta1, self.clip = params, lrs, beta1, clip
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Applies one update; returns the gradients as it took them."""
        self.t += 1
        b1, b2, eps = self.beta1, 0.999, 1e-8
        taken = {}
        for k, p in self.params.items():
            g = grads[k]
            if math.isfinite(self.clip):
                g = g * torch.clamp(self.clip / g.norm().clamp_min(1e-12),
                                    max=1.0)
            taken[k] = g
            self.m[k].lerp_(g, 1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t) + eps
            p.addcdiv_(self.m[k], denom, value=-self.lrs[k] / (1 - b1 ** self.t))
        return taken


def trainable(cfg: dict, stages: int) -> Dict[str, float]:
    """G's trainable stages at a GAN scale and their learning rates: the
    last train_depth stages, the top at lr_g, each lower one lr_scale
    times the one above (hp-vae-gan train_image.py)."""
    depth = max(min(cfg["train_depth"], stages - cfg["vae_levels"] + 1), 0)
    return {f"body.{stages - depth + i}.":
            cfg["lr_g"] * cfg["lr_scale"] ** (depth - 1 - i)
            for i in range(depth)}


class Trainer:
    """One GAN scale's training from the given weights and draws.

    `G`, `D`: name -> tensor (copies are made); `data`: (the scale's clip
    or image, scale 0's), (1, C, [T,] H, W) in [0, 1]; `amps`: the
    per-scale noise amplitudes, amps[k] for stage k; `batch`: the global
    batch."""

    def __init__(self, cfg: dict, G: Params, D: Params, data, amps,
                 batch: int, seed: int, device):
        self.cfg, self.amps, self.batch = cfg, list(amps), batch
        self.stages = cfg["scale_idx"]
        if cfg["vae_levels"] >= self.stages + 1:
            raise ValueError("the reference trains GAN scales only")
        self.G = {k: v.detach().clone().to(device) for k, v in G.items()}
        self.D = {k: v.detach().clone().to(device) for k, v in D.items()}
        self.G_uv = {n: (self.G[f"{n}.weight_u"], self.G[f"{n}.weight_v"])
                     for n in sn_names(self.G)}
        self.D_uv = {n: (self.D[f"{n}.weight_u"], self.D[f"{n}.weight_v"])
                     for n in sn_names(self.D)}
        lrs = trainable(cfg, self.stages)
        self.g_train = {k: v for k, v in self.G.items()
                        if any(k.startswith(s) for s in lrs)
                        and not k.endswith(("running_mean", "running_var"))}
        self.d_train = {k: v for k, v in self.D.items()
                        if not k.endswith(("weight_u", "weight_v"))}
        self.opt_g = Adam(self.g_train, {k: lrs[next(
            s for s in lrs if k.startswith(s))] for k in self.g_train},
            cfg["beta1"], cfg["grad_clip"])
        self.opt_d = Adam(self.d_train, {k: cfg["lr_d"] for k in self.d_train},
                          cfg["beta1"])
        self.data = [d.to(device) for d in data]
        self.draws = Draws(seed, device)

    def _batch(self):
        cfg, B = self.cfg, self.batch
        real, zero = self.data
        if cfg["ndim"] == 3:
            p = pyramid(cfg)
            starts = self.draws.randint(max(real.shape[2] - p["fps_lcm"], 1),
                                        (B,))

            def window(frames, every):
                idx = starts[:, None] + torch.arange(
                    0, p["fps_lcm"] + 1, every, device=starts.device)
                return torch.stack([frames[0][:, i] for i in idx])

            real = window(real, p["every"][self.stages])
            zero = window(zero, p["every"][0])
        else:
            real, zero = real.expand(B, -1, -1, -1), zero.expand(B, -1, -1, -1)
        real, zero = real * 2 - 1, zero * 2 - 1
        noise = self.draws.normal((B, cfg["latent_dim"])
                                  + tuple(scale_shape(cfg, 0)))
        return real, zero, noise

    def iteration(self) -> Dict[str, float]:
        """One D step then one G step against the updated D; returns the
        losses and their terms, and leaves the gradients each optimizer
        took in self.taken."""
        cfg = self.cfg
        real, zero, noise = self._batch()
        with torch.no_grad():
            fake = generate(self.G, cfg, noise, self.amps, self.draws,
                            norm_batch, self.stages)
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
            gen, enc_uv = reconstruct(self.G, self.G_uv, cfg, zero, self.amps,
                                      self.draws, self.stages)
            fake = generate(self.G, cfg, noise, self.amps, self.draws,
                            norm_batch, self.stages)
            rec = torch.mean((gen - real) ** 2)
            adv = -torch.mean(critic(self.D, self.D_uv, cfg, fake)[0]) \
                * cfg["disc_loss_weight"]
            g_loss = cfg["rec_weight"] * rec + adv
            grads = torch.autograd.grad(g_loss, list(g_params.values()))
        for p in g_params.values():
            p.requires_grad_(False)
        taken_g = self.opt_g.step(dict(zip(g_params, grads)))
        self.G_uv.update(enc_uv)
        self.taken = {"G": taken_g, "D": taken_d}
        return {k: float(v.detach()) for k, v in (
            ("d_loss", d_loss), ("d_real", d_real), ("d_fake", d_fake),
            ("gp", gp), ("g_loss", g_loss), ("rec", rec), ("adv", adv))}


# --------------------------------------------------------------- sampling

@torch.no_grad()
def sample(P: Params, cfg: dict, n: int, amps, seed: int, device,
           stages: int, dtype=torch.float32) -> Tensor:
    """n random samples with per-sample BatchNorm statistics, (n, C, [T,]
    H, W): z drawn first, then each stage's noise (drawn in float32).
    `dtype`: the weights' and activations' (bfloat16 for the control)."""
    P = {k: v.to(dtype) for k, v in P.items()}
    draws = Draws(seed, device)
    tail = scale_shape(cfg, 0)
    if cfg["ndim"] == 3:  # the eval scale's time depth
        tail = (pyramid(cfg)["td"][stages],) + tail[1:]
    z = draws.normal((n, cfg["latent_dim"]) + tuple(tail)).to(dtype)
    return generate(P, cfg, z, amps, draws, norm_sample, stages).float()
