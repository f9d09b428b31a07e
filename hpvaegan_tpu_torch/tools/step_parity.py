"""One training iteration, or one sampler batch, on two devices, from the
same weights and the same draws, compared.

`run_iteration` builds a small training state at one scale from a seed
(He-normal weights, so that activations keep unit scale, and random
BatchNorm statistics) of the named generator and discriminator, 2D or 3D
per `ndim` (a CSG/SG baseline: its plan, its batch former, a random
Z_init, every scale a GAN scale), runs
training/steps.py::train_iteration once (D then G on a GAN scale) on
random data (an image, or a clip of cfg.max_frames frames whose batch is
random temporal windows), and returns its metrics, every gradient and every
BatchNorm and spectral-norm buffer as numpy. The first run records its
draws (`RecordingNoise`); the second replays them (`ReplayedNoise`), so
the two see the same batch (window starts, flips, z_init), refinement
noise, eps and GP alpha.

The training flags come with the config: cfg.compute_dtype,
cfg.fused_dg, cfg.paired_g and cfg.flat_opt act in the iteration as in the
trainer (the state is the trainer's `scale_state` minus D's warm start).

`compare_devices` runs the iteration on the card and on the CPU with TF32
off and returns the largest differences; `compare_sampler_devices` does
the same for one `generate_samples` call of a given generator.
tests/test_torch_cuda.py calls them (its `*_matches_cpu` tests); they
need a card.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..models import BASELINES, get_discriminator, get_generator
from ..models.blocks import (BatchNorm, Conv, SNConv, cfg_compute_dtype,
                             set_compute_dtype)
from ..training.baselines_trainer import z_init_shape
from ..training.partition import make_baseline_lr_plan, make_lr_plan
from ..training.state import ScaleTrainState
from ..training.steps import batch_former, train_iteration
from ..training.trainer import make_optimizers
from ..utils.noise import NoiseSource
from ..utils.pyramid import scale_size_2d


class RecordingNoise(NoiseSource):
    """A NoiseSource that keeps every tensor it hands out, in order."""

    def __init__(self, seed: int, device):
        super().__init__(seed, device)
        self.drawn: List[torch.Tensor] = []

    def _keep(self, t: torch.Tensor) -> torch.Tensor:
        self.drawn.append(t)
        return t

    def normal(self, shape):
        return self._keep(super().normal(shape))

    def uniform(self, shape=()):
        return self._keep(super().uniform(shape))

    def bernoulli(self, shape):
        return self._keep(super().bernoulli(shape))

    def randint(self, high, shape):
        return self._keep(super().randint(high, shape))


class ReplayedNoise(NoiseSource):
    """Hands out another run's draws, in call order, on `device`."""

    def __init__(self, drawn: Sequence[torch.Tensor], device):
        super().__init__(0, device)
        self.drawn = [t.to(self.device) for t in drawn]

    def _next(self, shape) -> torch.Tensor:
        t = self.drawn.pop(0)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"replayed draw {tuple(t.shape)} for {shape}")
        return t

    def normal(self, shape):
        return self._next(shape)

    def uniform(self, shape=()):
        return self._next(shape)

    def bernoulli(self, shape):
        return self._next(shape)

    def randint(self, high, shape):
        t = self._next(shape)
        if t.numel() and not 0 <= int(t.min()) <= int(t.max()) < high:
            raise ValueError(f"replayed draw outside [0, {high})")
        return t.long()


def he_init_(module: torch.nn.Module, gen: torch.Generator) -> None:
    """He-normal conv weights, small random biases, random BatchNorm
    affine and moving statistics, unit-norm SN vectors, all from `gen`."""
    def randn(t):
        return torch.randn(t.shape, generator=gen)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, SNConv)):
                w = m.weight if isinstance(m, Conv) else m.weight_orig
                w.copy_(randn(w) * math.sqrt(2.0 / w[0].numel()))
                if m.bias is not None:
                    m.bias.copy_(0.1 * randn(m.bias))
            if isinstance(m, SNConv):
                for buf in (m.weight_u, m.weight_v):
                    v = randn(buf)
                    buf.copy_(v / v.norm())
            elif isinstance(m, BatchNorm):
                m.weight.copy_(1.0 + 0.1 * randn(m.weight))
                m.bias.copy_(0.1 * randn(m.bias))
                m.running_mean.copy_(0.1 * randn(m.running_mean))
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=gen) + 0.5)


def build_state(cfg, scale_idx: int, seed: int, device, ndim: int = 2,
                generator: str = "GeneratorHPVAEGAN",
                discriminator: str = "") -> ScaleTrainState:
    """`generator` grown to scale `scale_idx`'s stages and a D
    (`discriminator`, default WDiscriminator<ndim>D; 2D or 3D per `ndim`),
    both from `seed`, with the scale's optimizers (a baseline also gets a
    Z_init from `seed`) and convolutions in cfg.compute_dtype; the noise
    source is left to the caller."""
    gen = torch.Generator().manual_seed(seed)
    G = get_generator(generator, ndim)(cfg)
    while len(G.body) < scale_idx + G.body_offset:
        G.init_next_stage()
    D = get_discriminator(discriminator or f"WDiscriminator{ndim}D",
                          ndim)(cfg)
    he_init_(G, gen)
    he_init_(D, gen)
    if generator in BASELINES:
        G.z_init = torch.randn(z_init_shape(cfg), generator=gen)
        plan = make_baseline_lr_plan(cfg, scale_idx, len(G.body),
                                     has_head=hasattr(G, "head"),
                                     has_tail=hasattr(G, "tail"))
        clip = float("inf")
    else:
        plan, clip = make_lr_plan(cfg, scale_idx, scale_idx), cfg.grad_clip
    G, D = G.to(device), D.to(device)
    for m in (G, D):
        set_compute_dtype(m, cfg_compute_dtype(cfg))
    return ScaleTrainState(G, D, *make_optimizers(cfg, G, D, plan, clip),
                           None)


def run_iteration(cfg, scale_idx: int, seed: int, device,
                  noise: NoiseSource, ndim: int = 2,
                  generator: str = "GeneratorHPVAEGAN",
                  discriminator: str = ""
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    """One train_iteration at `scale_idx`; returns {"metrics", "grads",
    "state"} as numpy, keyed by name. In 3D the config must carry the
    clip's org_fps, ar and fps_lcm (SingleVideoDataset sets them)."""
    st = build_state(cfg, scale_idx, seed, device, ndim, generator,
                     discriminator)
    st.noise = noise
    gen = torch.Generator().manual_seed(seed + 1)
    frames = (cfg.max_frames,) if ndim == 3 else ()
    data = [torch.rand((1, cfg.nc_im) + frames + tuple(scale_size_2d(
        k, cfg.scale_factor, cfg.stop_scale, cfg.img_size, cfg.ar)),
        generator=gen).to(device) for k in (scale_idx, 0)]
    amps = [1.0] + [0.5 ** k for k in range(1, cfg.stop_scale + 2)]
    baseline = generator in BASELINES
    metrics = train_iteration(
        cfg, st, data[0], data[1], amps,
        vae_phase=not baseline and cfg.vae_levels >= scale_idx + 1,
        former=batch_former(ndim, scale_idx, baseline))
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {}, "state": {}}
    for prefix, m in (("G.", st.G), ("D.", st.D)):
        for k, p in m.named_parameters():
            if p.grad is not None:
                out["grads"][prefix + k] = p.grad.cpu().numpy()
        for k, b in m.named_buffers():
            out["state"][prefix + k] = b.cpu().numpy()
    return out


def compare_devices(cfg, scale_idx: int, seed: int = 0, device="cuda",
                    ndim: int = 2, generator: str = "GeneratorHPVAEGAN",
                    discriminator: str = "") -> Dict[str, float]:
    """The iteration of `generator` and `discriminator` (2D or 3D per
    `ndim`) on `device` (TF32 off) and on the CPU from the same weights and
    draws: the largest relative metric difference (also relative to
    max(|metric|, 1)) and the largest absolute gradient and state
    differences."""
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    mm_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rec = RecordingNoise(seed, device)
        card = run_iteration(cfg, scale_idx, seed, device, rec, ndim,
                             generator, discriminator)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cuda.matmul.allow_tf32 = mm_tf32
    host = run_iteration(cfg, scale_idx, seed, "cpu",
                         ReplayedNoise(rec.drawn, "cpu"), ndim, generator,
                         discriminator)
    if sorted(card["grads"]) != sorted(host["grads"]):
        raise AssertionError("the two devices trained other parameters")
    errs = {"metrics_rel": max(
        abs(card["metrics"][k] - v) / max(abs(v), 1e-6)
        for k, v in host["metrics"].items()),
        # relative to the metric or 1, whichever is larger: d_loss is a
        # small difference of larger terms
        "metrics_scaled": max(
            abs(card["metrics"][k] - v) / max(abs(v), 1.0)
            for k, v in host["metrics"].items())}
    for part in ("grads", "state"):
        errs[part + "_abs"] = max(
            float(np.abs(card[part][k] - v).max())
            for k, v in host[part].items())
    finite = all(np.isfinite(v).all() for part in ("grads", "state")
                 for v in card[part].values())
    errs["finite"] = bool(finite and all(
        math.isfinite(v) for v in card["metrics"].values()))
    errs["metrics"] = card["metrics"]
    errs["metrics_host"] = host["metrics"]
    return errs


def compare_sampler_devices(cfg, generator, ndim: int, train: bool,
                            seed: int = 0, device="cuda") -> float:
    """One `generate_samples` call of `generator` on `device` (TF32 off)
    and of a CPU copy from the same draws; the largest absolute
    difference of the samples."""
    from ..evaluation import generate_samples

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    mm_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rec = RecordingNoise(seed, device)
        card = generate_samples(cfg, generator.to(device), ndim,
                                train_mode=train, noise=rec)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cuda.matmul.allow_tf32 = mm_tf32
    host = generate_samples(cfg, copy.deepcopy(generator).cpu(), ndim,
                            train_mode=train,
                            noise=ReplayedNoise(rec.drawn, "cpu"))
    return float(np.abs(card - host).max())
