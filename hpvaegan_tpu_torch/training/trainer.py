"""The multi-scale training loop for one image or one video.

The port of the JAX package's `training/trainer.py` (reference
train_image.py:22-210, 385-391, train_video.py:22-212), `mode` "image" (2D)
or "video" (3D). Per scale:
  * grow the generator (`init_next_stage`: a fresh stage first, a deep copy
    of the last one after);
  * in video mode, cfg.fps, cfg.td and cfg.fps_index of the scale's
    sampling rate (trainer.py:548-555 there);
  * a fresh discriminator, warm-started from netD_<k-1>.ckpt when
    vae_levels < k (train_image.py:29-39);
  * fresh optimizers over the plan's trainable subtrees;
  * the noise amp: 1.0 at scale 0 and under const_amp, else
    noise_amp_init * RMSE of a reconstruction (divided by batch_size again
    only under bug_compat, the reference's bug #3);
  * niter iterations of training/steps.py::train_iteration, a logbook line
    every print_interval iterations, and an abort on non-finite metrics;
  * netG_<k>, netD_<k> (GAN scales) and intermediate.json, in crash order.
The video mode differs only in its dataset (data/video.py: all frames per
scale, a batch is random temporal windows), its batch former and its 3D
networks; the steps are the same.

What the JAX trainer adds for XLA and the TPU has no counterpart here: the
scan of `steps_per_call` iterations per dispatch, the compile-ahead
pipeline (training/pipeline.py), the retry of a scale after a runtime
error (`run_scale_with_retry`) and the device mesh. Resume, inflight
checkpoints and visualization are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import List, Optional

import torch

from .. import models
from ..data.image import SingleImageDataset
from ..data.video import SingleVideoDataset
from ..models.blocks import init_weights_
from ..optim import ClippedAdam, adam
from ..tools.convert import (from_jax_discriminator, to_jax,
                             to_jax_discriminator)
from ..utils import pyramid
from ..utils.device import resolve_device
from ..utils.logger import logbook
from ..utils.noise import NoiseSource
from ..utils.progress import Progress
from ..utils.saver import DataSaver
from .partition import apply_lr_plan, make_lr_plan
from .state import ScaleTrainState
from .steps import batch_former, calibrate, train_iteration


def amps_list(noise_amps: List[float], stop_scale: int) -> List[float]:
    """The amps as the forwards index them: stop_scale + 2 entries, zeros
    past the scales trained so far."""
    return [float(a) for a in noise_amps] + \
        [0.0] * (stop_scale + 2 - len(noise_amps))


def make_discriminator(cfg, saver: DataSaver, scale_idx: int,
                       init_gen: torch.Generator, device,
                       ndim: int) -> torch.nn.Module:
    """A fresh D, warm-started from the previous GAN scale's checkpoint when
    vae_levels < scale_idx."""
    D = models.get_discriminator(cfg.discriminator, ndim)(cfg)
    init_weights_(D, init_gen)
    if cfg.vae_levels < scale_idx:
        try:
            ckpt = saver.load_checkpoint(f"netD_{scale_idx - 1}.ckpt")
        except FileNotFoundError:
            logging.warning("no previous netD checkpoint to warm-start from")
        else:
            D.load_state_dict(from_jax_discriminator(ckpt["params"],
                                                     ckpt["state"], ndim))
    return D.to(device)


def train_scale(cfg, G, dataset, saver: DataSaver, noise_amps: List[float],
                noise: NoiseSource, init_gen: torch.Generator) -> List[float]:
    """Train pyramid scale cfg.scale_idx of G (2D or 3D, per G.ndim) on a
    SingleImageDataset or SingleVideoDataset; returns the amps with its
    own."""
    scale_idx = cfg.scale_idx
    ndim = G.ndim
    vae_phase = cfg.vae_levels >= scale_idx + 1
    device = next(G.parameters()).device
    D = make_discriminator(cfg, saver, scale_idx, init_gen, device, ndim)
    plan = make_lr_plan(cfg, scale_idx, len(G.body))
    opt_g = ClippedAdam(apply_lr_plan(G, plan), cfg.beta1,
                        grad_clip=cfg.grad_clip)
    opt_d = adam(D.parameters(), cfg.lr_d, cfg.beta1)
    st = ScaleTrainState(G, D, opt_g, opt_d, noise)
    if ndim == 2:
        data_scale = dataset.scale_image(scale_idx)
        data_zero = dataset.scale_image(0)
    else:
        data_scale = dataset.scale_frames(scale_idx)
        data_zero = dataset.scale_frames(0)
    former = batch_former(ndim, scale_idx)

    noise_amps = list(noise_amps)
    if cfg.const_amp or scale_idx == 0:
        noise_amps.append(1.0)
    else:
        noise_amps.append(0.0)
        real, real_zero, _ = former(cfg, data_scale, data_zero, noise)
        rmse = calibrate(G, real, real_zero,
                         amps_list(noise_amps, cfg.stop_scale), noise)
        denom = cfg.batch_size if cfg.bug_compat else 1
        noise_amps[-1] = cfg.noise_amp_init * float(rmse) / denom
    amps = amps_list(noise_amps, cfg.stop_scale)

    bar = Progress(cfg.niter, "Training scale [{}/{}]".format(
        scale_idx + 1, cfg.stop_scale + 1))
    for done in range(1, cfg.niter + 1):
        metrics = train_iteration(cfg, st, data_scale, data_zero, amps,
                                  vae_phase, former)
        bar.update()
        if done % cfg.print_interval == 0:
            vals = {k: float(v) for k, v in metrics.items()}
            bad = [k for k, v in vals.items() if not math.isfinite(v)]
            if bad:
                raise RuntimeError(
                    f"non-finite training metrics {bad} at scale "
                    f"{scale_idx} iter {done} (amps={noise_amps})")
            logbook("[Scale {}/Iter {}] Noise amp: {:.5f}, {}".format(
                scale_idx + 1, done, noise_amps[-1],
                ", ".join(f"{k}: {v:.5f}" for k, v in sorted(vals.items()))))
    bar.close()

    params, state = to_jax(G.state_dict(), ndim)
    d_tree = None
    if not vae_phase:
        d_params, d_state = to_jax_discriminator(D.state_dict(), ndim)
        d_tree = {"params": d_params, "state": d_state}
    saver.finalize_scale(scale_idx, noise_amps,
                         {"params": params, "state": state}, d_tree)
    return noise_amps


def run_training(cfg, saver: DataSaver, device="cuda",
                 seed: Optional[int] = None, mode: str = "image"):
    """The full multi-scale run (reference train_image.py:385-391) on one
    image (`mode` "image") or one video ("video"). Weights are drawn from a
    host generator seeded `seed` (default cfg.manualSeed), every training
    draw from a NoiseSource on `device`. Returns (G, noise_amps)."""
    if mode not in ("image", "video"):
        raise ValueError(f"mode {mode!r}: 'image' or 'video'")
    if cfg.vae_levels <= 0 or cfg.disc_loss_weight <= 0:
        raise ValueError("training needs vae_levels > 0 and "
                         "disc_loss_weight > 0")
    device = resolve_device(device)
    ndim = 2 if mode == "image" else 3
    if ndim == 2:
        dataset = SingleImageDataset(cfg, device)
    else:
        dataset = SingleVideoDataset(cfg, device)
    # args.txt after the dataset set cfg.ar (and org_fps, fps_lcm in video
    # mode; trainer.py:429-435 there): eval re-hydrates the pyramid
    # geometry from it
    cfg.write_args_txt(os.path.join(saver.experiment_dir, "args.txt"))

    seed = seed if seed is not None else (cfg.manualSeed or 0)
    init_gen = torch.Generator().manual_seed(int(seed))
    noise = NoiseSource(seed, device)
    G = models.get_generator(cfg.generator, ndim)(cfg)
    init_weights_(G, init_gen)
    G = G.to(device)

    noise_amps: List[float] = []
    for scale_idx in range(cfg.stop_scale + 1):
        cfg.scale_idx = scale_idx
        if scale_idx > 0:
            G.init_next_stage(init_gen)
        if ndim == 3:
            cfg.fps, cfg.td, cfg.fps_index = pyramid.get_fps_td_by_index(
                scale_idx, cfg.stop_scale_time, cfg.sampling_rates,
                cfg.org_fps, cfg.fps_lcm)
            logging.info("scale %d: fps %.2f, time-depth %d, rate %d",
                         scale_idx, cfg.fps, cfg.td,
                         cfg.sampling_rates[cfg.fps_index])
        t0 = time.perf_counter()
        noise_amps = train_scale(cfg, G, dataset, saver, noise_amps, noise,
                                 init_gen)
        secs = time.perf_counter() - t0
        logging.info("scale %d done in %.1fs (%.2f it/s)", scale_idx, secs,
                     cfg.niter / max(secs, 1e-9))
    return G, noise_amps
