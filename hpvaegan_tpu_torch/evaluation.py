"""Image evaluation: hydrate an experiment, sample from its generator, score.

The port of the JAX package's `evaluation.py` for images (reference
eval_image.py:24-76): rebuild the config from args.txt, load netG at the
saved scale, generate niter x num_samples random samples in batched
forwards, write random_samples.npy and PNGs, compute SIFID. Experiments are
read in the JAX package's format, so an experiment trained by either
package evaluates here. The on-device SIFID path, video, mesh-sharded and
multi-process evaluation, and .pth/MindSpore checkpoints are not ported yet.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
from typing import Optional

import numpy as np
import torch

from . import models
from .config import Config
from .tools.convert import from_jax
from .utils import pyramid
from .utils.device import resolve_device
from .utils.noise import NoiseSource
from .utils.saver import DataSaver, load_pytree, resolve_finalized_scale


def hydrate_config(exp_dir: str, overrides: dict,
                   exceptions=("niter", "data_rep", "batch_size", "netG",
                               "scale_idx")) -> Config:
    """Rebuild the Config from the experiment's args.txt
    (reference eval_image.py:122-132)."""
    cfg = Config.from_args_txt(os.path.join(exp_dir, "args.txt"),
                               exceptions=list(exceptions))
    for k, v in overrides.items():
        setattr(cfg, k, v)
    cfg.experiment_dir = exp_dir
    return cfg


def load_generator(cfg, exp_dir: str, ndim: int = 2, netG: str = "",
                   device="cuda"):
    """Load netG at the saved scale (reference eval_image.py:154-177).
    Returns (generator on `device`, saver)."""
    device = resolve_device(device)
    saver = DataSaver(cfg)
    inter = saver.load_json("intermediate.json", path=exp_dir)
    if cfg.scale_idx == -1:
        # an inflight marker resolves to the last finalized scale
        cfg.scale_idx = resolve_finalized_scale(inter, what="evaluate")
    cfg.Noise_Amps = inter["noise_amps"][:cfg.scale_idx + 1]

    path = netG or os.path.join(exp_dir, f"netG_{cfg.scale_idx}.ckpt")
    if not os.path.isfile(path):
        raise RuntimeError(f"=> no <G> checkpoint found at '{path}'")
    if path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: PyTorch .pth checkpoints of the original hp-vae-gan are "
            "not ported yet")
    try:
        ckpt = load_pytree(path)
    except pickle.UnpicklingError as e:
        raise NotImplementedError(
            f"{path} is not a pickled (params, state) checkpoint; MindSpore "
            "checkpoints are not ported yet") from e
    _check_body(ckpt["params"], cfg, path)
    generator = models.get_generator(cfg.generator, ndim)(cfg)
    for _ in range(cfg.scale_idx):
        generator.init_next_stage()
    generator.load_state_dict(from_jax(ckpt["params"], ckpt["state"]))
    return generator.to(device).eval(), saver


def _check_body(params, cfg, path: str) -> None:
    """A stage-count/scale mismatch must fail loudly (the reference fails
    at load_param_into_net)."""
    if len(params["body"]) != cfg.scale_idx:
        raise RuntimeError(
            f"checkpoint {path!r} has {len(params['body'])} refinement "
            f"stages but intermediate.json says scale_idx={cfg.scale_idx} "
            f"(expected {cfg.scale_idx} stages — netG_<k>.ckpt carries k)")


def eval_z_tail(cfg, ndim: int = 2):
    """Per-sample latent shape for eval-time generation, channels-last:
    (h0, w0, latent_dim)."""
    if ndim != 2:
        raise NotImplementedError("video evaluation is not ported yet")
    h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                   cfg.img_size, cfg.ar)
    return (h0, w0, cfg.latent_dim)


def generate_samples(cfg, generator, ndim: int = 2, seed: int = 0,
                     train_mode: bool = True,
                     noise: Optional[NoiseSource] = None) -> np.ndarray:
    """niter batches of num_samples random samples; returns channels-last
    (N, H, W, C) numpy in [-1, 1].

    train_mode=True (default) samples with per-sample-statistics BatchNorm,
    as the reference's eval does; train_mode=False is the plain batched
    forward on moving statistics, which runs the fused upscale+noise kernel
    when cfg.pallas_fused_sampling is set. Every draw comes from `noise`
    (default: a NoiseSource seeded `seed` on the generator's device)."""
    from .parallel.sampling import sharded_sampler

    if noise is None:
        noise = NoiseSource(seed, next(generator.parameters()).device)
    sample = sharded_sampler(cfg, generator, ndim=ndim, train=train_mode,
                             z_tail=eval_z_tail(cfg, ndim))
    outs = [sample(cfg.num_samples, noise) for _ in range(cfg.niter)]
    return torch.cat(outs, dim=0).permute(0, 2, 3, 1).cpu().numpy()


def _persist_eval_metrics(saver, cfg, metric: str, value: float) -> None:
    """Record the eval score as eval/metrics.json, next to the samples."""
    saver.save_json({
        "metric": metric,
        "value": value,
        "num_samples": cfg.niter * cfg.num_samples,
        "scale_idx": cfg.scale_idx,
        "netG": getattr(cfg, "netG", "") or "",
        "on_device_fid": False,
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
    }, os.path.join("eval", "metrics.json"))


def eval_image_experiment(cfg, exp_dir: str, seed: int = 0, device="cuda"):
    """One experiment dir: samples -> npy -> PNGs -> SIFID
    (reference eval_image.py:179-190). Returns (sifid, saver)."""
    from .metrics import calculate_SIFID
    from .utils.media import generate_images

    device = resolve_device(device)
    generator, saver = load_generator(cfg, exp_dir, ndim=2, netG=cfg.netG,
                                      device=device)
    samples = generate_samples(cfg, generator, ndim=2, seed=seed)
    # reference artifact layout: (N, C, H, W)
    np.save(os.path.join(saver.eval_dir, "random_samples.npy"),
            samples.transpose(0, 3, 1, 2))
    generate_images(cfg, saver)
    # the trained image FILE, not its directory: sibling images would pair
    # with the fakes
    sifid = calculate_SIFID(os.path.abspath(cfg.image_path),
                            os.path.join(saver.eval_dir, cfg.save_path),
                            device=device)
    _persist_eval_metrics(saver, cfg, "SIFID", sifid)
    logging.info("SIFID: %s", sifid)
    return sifid, saver
