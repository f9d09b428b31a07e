"""Evaluation: hydrate an experiment, sample from its generator, score.

The port of the JAX package's `evaluation.py` (reference eval_image.py:24-76,
eval_video.py:23-85): rebuild the config from args.txt, load netG at the
saved scale, generate niter x num_samples random samples in batched
forwards, write random_samples.npy and PNGs (images) or GIFs and unfold
grids (videos), compute SIFID or SVFID. Experiments are read in the JAX
package's format, so an experiment trained by either package evaluates
here; --netG may also name the original hp-vae-gan's .pth or a MindSpore
checkpoint. With cfg.on_device_fid the samples and their features stay on
the device and only per-sample statistics reach the host
(parallel/sampling.py).

Multi-process evaluation (parallel/multihost.py, the JAX package's
evaluation.py:95-107): the samples shard over every rank (`--mesh-data`
ranks, or all of them in a multi-process run; parallel/mesh.py::
eval_group), each rank drawing its rows of the global draws, and are
gathered to every rank. The primary alone writes the artifacts and
metrics.json; a disk-read score is the primary's, broadcast
(`agree_float`), and the ranks meet at a barrier before returning.
"""

from __future__ import annotations

import datetime
import functools
import itertools
import logging
import os
from typing import Optional

import numpy as np

from . import models
from .config import Config
from .parallel import mesh, multihost
from .tools.convert import load_generator_checkpoint
from .utils import profiling, pyramid
from .utils.device import resolve_device
from .utils.noise import NoiseSource
from .utils.saver import DataSaver, resolve_finalized_scale

# generate_samples' calls in this process: the request number its spans carry
_REQUESTS = itertools.count()


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
    saver = multihost.select_saver(cfg, lambda: DataSaver(cfg))
    inter = saver.load_json("intermediate.json", path=exp_dir)
    if cfg.scale_idx == -1:
        # an inflight marker resolves to the last finalized scale
        cfg.scale_idx = resolve_finalized_scale(inter, what="evaluate")
    cfg.Noise_Amps = inter["noise_amps"][:cfg.scale_idx + 1]

    path = netG or os.path.join(exp_dir, f"netG_{cfg.scale_idx}.ckpt")
    if not os.path.isfile(path):
        raise RuntimeError(f"=> no <G> checkpoint found at '{path}'")
    state_dict, pth_inter = load_generator_checkpoint(path, ndim)
    if pth_inter is not None:
        # an original .pth carries its scale and amps (reference
        # eval_image.py:157-162)
        cfg.scale_idx = pth_inter["scale_idx"]
        cfg.Noise_Amps = pth_inter["noise_amps"][:cfg.scale_idx + 1]
    _check_body(state_dict, cfg, path)
    generator = models.get_generator(cfg.generator, ndim)(cfg)
    # k growths: the k stages of netG_<k>, or a baseline's k + 1 (it is
    # built with one)
    for _ in range(cfg.scale_idx):
        generator.init_next_stage()
    generator.load_state_dict(state_dict)
    return generator.to(device).eval(), saver


def _check_body(state_dict, cfg, path: str) -> None:
    """A stage-count/scale mismatch must fail loudly (the reference fails
    at load_param_into_net). The HPVAEGAN family only, as in the JAX
    package (evaluation.py:86 there); a baseline's stage count is held by
    load_state_dict."""
    if cfg.generator in models.BASELINES:
        return
    stages = len({k.split(".")[1] for k in state_dict
                  if k.startswith("body.")})
    if stages != cfg.scale_idx:
        raise RuntimeError(
            f"checkpoint {path!r} has {stages} refinement "
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
    (default: a NoiseSource seeded `seed` on the generator's device).

    One process copies the niter batches to the host once, each into its
    rows of one array (parallel/sampling.py::_host_copy: from a card, one
    pinned buffer, channels-last already on the device); a data group
    gathers them and joins them on the host.

    With utils/profiling.py on, each call is one request, numbered in the
    process, and its host spans carry the number: "sample.forward" (the
    sub-batches issued), "sample.to_host" (the copy, _host_copy's "d2h"
    phase and byte counters, or the gather) and "sample.assemble" (a data
    group's arrays joined)."""
    from .parallel import sampling

    request = next(_REQUESTS)
    if noise is None:
        noise = NoiseSource(seed, next(generator.parameters()).device)
    with profiling.span("sample.forward", request=request):
        sample = sampling.sharded_sampler(cfg, generator, ndim=ndim,
                                          train=train_mode,
                                          z_tail=eval_z_tail(cfg, ndim))
        outs = [sample(cfg.num_samples, noise).movedim(1, -1)
                for _ in range(cfg.niter)]
    gathered = mesh.active().group is not None
    with profiling.span("sample.to_host", request=request):
        # under a data group: each iteration's rows of every rank, in one
        # gather
        host = multihost.to_host(tuple(outs)) if gathered \
            else sampling._host_copy(*outs)
    with profiling.span("sample.assemble", request=request):
        return np.concatenate(host, axis=0) if gathered else host


def _persist_eval_metrics(saver, cfg, metric: str, value: float) -> None:
    """Record the eval score as eval/metrics.json, next to the samples."""
    saver.save_json({
        "metric": metric,
        "value": value,
        "num_samples": cfg.niter * cfg.num_samples,
        "scale_idx": cfg.scale_idx,
        "netG": getattr(cfg, "netG", "") or "",
        "on_device_fid": bool(getattr(cfg, "on_device_fid", False)),
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
    }, os.path.join("eval", "metrics.json"))


def _eval_in_group(evaluate):
    """Run `evaluate` with evaluation's data group in force."""
    @functools.wraps(evaluate)
    def run(cfg, exp_dir: str, seed: int = 0, device="cuda",
            noise: Optional[NoiseSource] = None):
        with mesh.data_parallel(mesh.eval_group(getattr(cfg, "mesh_data",
                                                        1))):
            return evaluate(cfg, exp_dir, seed, device, noise)
    return run


@_eval_in_group
def eval_image_experiment(cfg, exp_dir: str, seed: int = 0, device="cuda",
                          noise: Optional[NoiseSource] = None):
    """One experiment dir: samples -> npy -> PNGs -> SIFID
    (reference eval_image.py:179-190). Returns (sifid, saver).

    With cfg.on_device_fid, niter x num_samples samples are drawn in one
    sampler call and scored on the device (parallel/sampling.py); only the
    first max_samples reach random_samples.npy and the PNGs (JAX
    evaluation.py:198-222). Every draw comes from `noise` (default: a
    NoiseSource seeded `seed` on `device`)."""
    from .metrics import calculate_SIFID
    from .utils.media import generate_images

    device = resolve_device(device)
    generator, saver = load_generator(cfg, exp_dir, ndim=2, netG=cfg.netG,
                                      device=device)
    noise = noise or NoiseSource(seed, device)
    primary = multihost.is_primary()
    if getattr(cfg, "on_device_fid", False):
        from .data.image import load_image01
        from .parallel.sampling import sampled_sifid

        total = cfg.niter * cfg.num_samples
        vals, firstk = sampled_sifid(
            cfg, generator, load_image01(cfg.image_path), total, noise,
            z_tail=eval_z_tail(cfg, 2),
            return_samples=min(cfg.max_samples, total))
        sifid = float(np.mean(vals))
        if primary:
            np.save(os.path.join(saver.eval_dir, "random_samples.npy"),
                    firstk.transpose(0, 3, 1, 2))  # (N, C, H, W)
            generate_images(cfg, saver)
            _persist_eval_metrics(saver, cfg, "SIFID", sifid)
        logging.info("SIFID (on-device): %s", sifid)
        # the others must not return while the primary still writes
        multihost.sync("eval_image_artifacts")
        return sifid, saver
    samples = generate_samples(cfg, generator, ndim=2, noise=noise)
    sifid = 0.0
    if primary:
        # reference artifact layout: (N, C, H, W)
        np.save(os.path.join(saver.eval_dir, "random_samples.npy"),
                samples.transpose(0, 3, 1, 2))
        generate_images(cfg, saver)
        # the trained image FILE, not its directory: sibling images would
        # pair with the fakes
        sifid = calculate_SIFID(os.path.abspath(cfg.image_path),
                                os.path.join(saver.eval_dir, cfg.save_path),
                                device=device)
        _persist_eval_metrics(saver, cfg, "SIFID", sifid)
    # the primary's disk-read score on every rank (also the barrier)
    sifid = multihost.agree_float(sifid)
    logging.info("SIFID: %s", sifid)
    return sifid, saver


@_eval_in_group
def eval_video_experiment(cfg, exp_dir: str, seed: int = 0, device="cuda",
                          noise: Optional[NoiseSource] = None):
    """One experiment dir: samples -> npy -> GIFs -> SVFID (reference
    eval_video.py:23-85, 185-193). Returns (svfid, saver).

    cfg.on_device_fid and `noise` as in eval_image_experiment (JAX
    evaluation.py:271-296); the real side is the same strided window."""
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
    primary = multihost.is_primary()
    if primary:
        np.save(os.path.join(saver.eval_dir, "real_full_scale.npy"),
                (frames * 255).astype(np.uint8))

    # the real side is the window the model trained on at this scale's
    # sampling rate, not the first td full-rate frames
    window = frames[:cfg.fps_lcm + 1:cfg.sampling_rates[cfg.fps_index]]
    noise = noise or NoiseSource(seed, device)
    if getattr(cfg, "on_device_fid", False):
        from .parallel.sampling import sampled_svfid

        total = cfg.niter * cfg.num_samples
        vals, firstk = sampled_svfid(
            cfg, generator, window, total, noise, z_tail=eval_z_tail(cfg, 3),
            return_samples=min(cfg.max_samples, total))
        svfid = float(np.mean(vals))
        if primary:
            np.save(os.path.join(saver.eval_dir, "random_samples.npy"),
                    firstk.transpose(0, 4, 1, 2, 3))  # (N, C, T, H, W)
            generate_gifs(cfg, saver)
            _persist_eval_metrics(saver, cfg, "SVFID", svfid)
        logging.info("SVFID (on-device): %s", svfid)
        multihost.sync("eval_video_artifacts")
        return svfid, saver

    samples = generate_samples(cfg, generator, ndim=3, noise=noise)
    if primary:
        # reference artifact layout: (N, C, T, H, W)
        np.save(os.path.join(saver.eval_dir, "random_samples.npy"),
                samples.transpose(0, 4, 1, 2, 3))
        generate_gifs(cfg, saver)

    # from the gathered arrays, the same on every rank
    reals = window[None]
    fakes = (samples + 1) / 2
    t, h, w = (min(a, b) for a, b in zip(reals.shape[1:4], fakes.shape[1:4]))
    svfid = float(np.mean(svfid_arrays(reals[:, :t, :h, :w],
                                       fakes[:, :t, :h, :w], device=device)))
    if primary:
        _persist_eval_metrics(saver, cfg, "SVFID", svfid)
    multihost.sync("eval_video_artifacts")
    logging.info("SVFID: %s", svfid)
    return svfid, saver
