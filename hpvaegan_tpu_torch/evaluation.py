"""Evaluation: hydrate an experiment, sample from its generator, score.

The port of the JAX package's `evaluation.py` (reference eval_image.py:24-76,
eval_video.py:23-85): rebuild the config from args.txt, load netG at the
saved scale, generate niter x num_samples random samples in batched
forwards, write random_samples.npy and PNGs (images) or GIFs and unfold
grids (videos), compute SIFID or SVFID. Experiments are read in the JAX
package's format, so an experiment trained by either package evaluates
here. The on-device SIFID/SVFID paths, mesh-sharded and multi-process
evaluation, and .pth/MindSpore checkpoints are not ported yet.
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
    # k growths: the k stages of netG_<k>, or a baseline's k + 1 (it is
    # built with one)
    for _ in range(cfg.scale_idx):
        generator.init_next_stage()
    generator.load_state_dict(from_jax(ckpt["params"], ckpt["state"], ndim))
    return generator.to(device).eval(), saver


def _check_body(params, cfg, path: str) -> None:
    """A stage-count/scale mismatch must fail loudly (the reference fails
    at load_param_into_net). The HPVAEGAN family only, as in the JAX
    package (evaluation.py:86 there); a baseline's stage count is held by
    load_state_dict."""
    if cfg.generator in models.BASELINES:
        return
    if len(params["body"]) != cfg.scale_idx:
        raise RuntimeError(
            f"checkpoint {path!r} has {len(params['body'])} refinement "
            f"stages but intermediate.json says scale_idx={cfg.scale_idx} "
            f"(expected {cfg.scale_idx} stages — netG_<k>.ckpt carries k)")


def eval_z_tail(cfg, ndim: int = 2):
    """Per-sample latent shape for eval-time generation, channels-last:
    (h0, w0, latent_dim), in 3D (td, h0, w0, latent_dim) with the time
    depth of the EVAL scale, cfg.td (reference eval_video.py:36-39), or of
    cfg.scale_idx where cfg.td is unset. The baselines keep their Z_init's
    shape: nc_im channels at scale 0's time depth (JAX evaluation.py:
    111-131)."""
    h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                   cfg.img_size, cfg.ar)
    baseline = cfg.generator in models.BASELINES
    z_ch = cfg.nc_im if baseline else cfg.latent_dim
    if ndim == 2:
        return (h0, w0, z_ch)
    td = None if baseline else cfg.td
    td = td or pyramid.get_fps_td_by_index(
        0 if baseline else cfg.scale_idx, cfg.stop_scale_time,
        cfg.sampling_rates, cfg.org_fps, cfg.fps_lcm)[1]
    return (td, h0, w0, z_ch)


def generate_samples(cfg, generator, ndim: int = 2, seed: int = 0,
                     train_mode: bool = True,
                     noise: Optional[NoiseSource] = None) -> np.ndarray:
    """niter batches of num_samples random samples; returns channels-last
    (N, H, W, C) numpy in [-1, 1], in 3D (N, T, H, W, C).

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
    return torch.cat(outs, dim=0).movedim(1, -1).cpu().numpy()


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


def eval_video_experiment(cfg, exp_dir: str, seed: int = 0, device="cuda"):
    """One experiment dir: samples -> npy -> GIFs -> SVFID (reference
    eval_video.py:23-85, 185-193). Returns (svfid, saver)."""
    from .data.video import SingleVideoDataset
    from .metrics.fid import svfid_arrays
    from .utils.media import generate_gifs

    device = resolve_device(device)
    dataset = SingleVideoDataset(cfg, device)
    generator, saver = load_generator(cfg, exp_dir, ndim=3, netG=cfg.netG,
                                      device=device)
    cfg.fps, cfg.td, cfg.fps_index = pyramid.get_fps_td_by_index(
        cfg.scale_idx, cfg.stop_scale_time, cfg.sampling_rates, cfg.org_fps,
        cfg.fps_lcm)

    # real_full_scale.npy: every decoded frame at the saved scale,
    # (T, H, W, C) uint8
    frames = dataset.scale_frames(cfg.scale_idx)[0].permute(1, 2, 3, 0)
    frames = frames.cpu().numpy()
    np.save(os.path.join(saver.eval_dir, "real_full_scale.npy"),
            (frames * 255).astype(np.uint8))

    samples = generate_samples(cfg, generator, ndim=3, seed=seed)
    # reference artifact layout: (N, C, T, H, W)
    np.save(os.path.join(saver.eval_dir, "random_samples.npy"),
            samples.transpose(0, 4, 1, 2, 3))
    generate_gifs(cfg, saver)

    # the real side is the window the model trained on at this scale's
    # sampling rate, not the first td full-rate frames
    window = frames[:cfg.fps_lcm + 1:cfg.sampling_rates[cfg.fps_index]]
    reals = window[None]
    fakes = (samples + 1) / 2
    t, h, w = (min(a, b) for a, b in zip(reals.shape[1:4], fakes.shape[1:4]))
    svfid = float(np.mean(svfid_arrays(reals[:, :t, :h, :w],
                                       fakes[:, :t, :h, :w], device=device)))
    _persist_eval_metrics(saver, cfg, "SVFID", svfid)
    logging.info("SVFID: %s", svfid)
    return svfid, saver
