"""The multi-scale training loop for one image or one video.

The port of the JAX package's `training/trainer.py` (reference
train_image.py:22-210, 385-391, train_video.py:22-212), `mode` "image" (2D)
or "video" (3D). Per scale:
  * grow the generator (`init_next_stage`: a fresh stage first, a deep copy
    of the last one after);
  * in video mode, cfg.fps, cfg.td and cfg.fps_index of the scale's
    sampling rate (trainer.py:548-555 there);
  * a fresh discriminator, warm-started from netD_<k-1>.ckpt when
    vae_levels < k (train_image.py:29-39), a pickled pytree of either
    package or, found by content, a MindSpore checkpoint (JAX
    trainer.py:52-64);
  * fresh optimizers over the plan's trainable subtrees;
  * the noise amp: 1.0 at scale 0 and under const_amp, else
    noise_amp_init * RMSE of a reconstruction (divided by batch_size again
    only under bug_compat, the reference's bug #3);
  * niter iterations of training/steps.py::train_iteration, a logbook line
    every print_interval iterations, an abort on non-finite metrics, an
    inflight checkpoint every ckpt_interval iterations (not after the last),
    then `step_callback(done, st, metrics)`, in the JAX trainer's order
    (trainer.py:283-294 there);
  * netG_<k>, netD_<k> (GAN scales), torch_rng_<k>.pt and intermediate.json,
    in crash order (utils/saver.py).
The video mode differs only in its dataset (data/video.py: all frames per
scale, a batch is random temporal windows), its batch former and its 3D
networks; the steps are the same. A scale is `scale_state` (D and the
optimizers), `calibrate_amp` and `run_scale` (the iterations and the
checkpoints), and `train_scales` runs the scales; training/
baselines_trainer.py composes the same pieces for the CSG/SG baselines.

Resume (`cfg.netG` and `cfg.intermediate`, the JAX trainer's
trainer.py:448-534) reads the marker in --intermediate's directory:
  (a) an inflight marker whose "inflight" names --netG: G, D, both
      optimizers and the generator states come from the checkpoint, and the
      scale continues at the iteration after the saved one (no D init, no
      calibration): the run ends as the uninterrupted one would;
  (b) a finalized marker with "torch_rng": netG_<k> and the generator
      states at the end of scale k; netD_<k> is copied into the new
      experiment dir and training continues at scale k + 1, as the
      uninterrupted run would (--manualSeed plays no part);
  (c) any other marker (the JAX package's, with or without its "key", or a
      port marker without "torch_rng"): the reference's resume. G keeps
      its trained stages, the amps their first k, D warm-starts from
      netD_<k-1> of --netG's directory, and scale k is recalibrated and
      trained again, from --manualSeed.
In (b) and (c) --netG may also be the original hp-vae-gan's .pth or a
MindSpore checkpoint (JAX trainer.py:459-479), though not for the CSG/SG
baselines, whose JAX trainer resumes from pickled pytrees only.

What the JAX trainer adds for XLA and the TPU has no counterpart here: the
scan of `steps_per_call` iterations per dispatch, the compile-ahead
pipeline (training/pipeline.py), the retry of a scale after a runtime
error (`run_scale_with_retry`) and the device mesh.

The training flags of the JAX trainer: cfg.compute_dtype sets G's and D's
convolutions' dtype for the scale (`scale_state`); cfg.flat_opt builds
FlatAdam optimizers (`make_optimizers`, trainer.py:116-119 there), and an
inflight checkpoint of the other layout is refused; cfg.paired_g and
cfg.fused_dg are the steps' (training/steps.py); cfg.visualize (2D only,
trainer.py:236-240, 277-281 there) writes `visualize`'s images every
image_interval iterations, after the logbook line and before the inflight
checkpoint, whose generator state then holds the images' draws.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import models
from ..data.image import SingleImageDataset
from ..data.video import SingleVideoDataset
from ..models.blocks import (cfg_compute_dtype, init_weights_,
                             set_compute_dtype)
from ..optim import ClippedAdam, FlatAdam, adam, load_optimizer_state
from ..tools.convert import (from_jax_discriminator,
                             load_generator_checkpoint, m2t_WDiscriminator,
                             to_jax, to_jax_discriminator)
from ..tools.ms_ckpt import is_ms_checkpoint, load_ms_checkpoint
from ..utils import pyramid
from ..utils.device import resolve_device
from ..utils.logger import logbook
from ..utils.noise import NoiseSource
from ..utils.progress import Progress
from ..utils.saver import DataSaver, load_inflight, load_pytree
from .partition import apply_lr_plan, make_lr_plan
from .state import ScaleTrainState
from .steps import batch_former, calibrate, train_iteration


def amps_list(noise_amps: List[float], stop_scale: int) -> List[float]:
    """The amps as the forwards index them: stop_scale + 2 entries, zeros
    past the scales trained so far."""
    return [float(a) for a in noise_amps] + \
        [0.0] * (stop_scale + 2 - len(noise_amps))


def make_discriminator(cfg, saver: DataSaver, scale_idx: int,
                       init_gen: torch.Generator, device, ndim: int,
                       warm: bool, warm_dir: Optional[str] = None
                       ) -> torch.nn.Module:
    """A fresh D, warm-started (when `warm`) from netD_<k-1>.ckpt of
    warm_dir (a reference-style resume's --netG directory), or of the run's
    own experiment dir when warm_dir is None: a pickled pytree, or a
    MindSpore checkpoint, which a reference-trained experiment holds."""
    D = models.get_discriminator(cfg.discriminator, ndim)(cfg)
    init_weights_(D, init_gen)
    if not warm:
        return D.to(device)
    name = f"netD_{scale_idx - 1}.ckpt"
    path = os.path.join(warm_dir or saver.experiment_dir, name)
    if os.path.isfile(path) and is_ms_checkpoint(path):
        D.load_state_dict(m2t_WDiscriminator(load_ms_checkpoint(path)))
        return D.to(device)
    try:
        ckpt = saver.load_checkpoint(name, path=warm_dir)
    except FileNotFoundError:
        logging.warning("no previous netD checkpoint to warm-start from")
    else:
        D.load_state_dict(from_jax_discriminator(ckpt["params"],
                                                 ckpt["state"], ndim))
    return D.to(device)


def rng_state(init_gen: torch.Generator,
              noise: NoiseSource) -> Dict[str, Any]:
    """Every generator a run draws from: the weights' and the NoiseSource's
    two."""
    return {"init_gen": init_gen.get_state(), "noise": noise.get_state()}


def set_rng_state(rng: Dict[str, Any], init_gen: torch.Generator,
                  noise: NoiseSource) -> None:
    init_gen.set_state(rng["init_gen"])
    noise.set_state(rng["noise"])


def make_optimizers(cfg, G, D, plan: Dict, grad_clip: float):
    """G's clipped Adam over the plan's trainable subtrees and D's Adam;
    both FlatAdam under cfg.flat_opt."""
    groups = apply_lr_plan(G, plan)
    if cfg.flat_opt:
        return (FlatAdam(groups, cfg.beta1, grad_clip=grad_clip),
                FlatAdam(D.parameters(), cfg.beta1, grad_clip=float("inf"),
                         lr=cfg.lr_d))
    return (ClippedAdam(groups, cfg.beta1, grad_clip=grad_clip),
            adam(D.parameters(), cfg.lr_d, cfg.beta1))


def scale_state(cfg, G, saver: DataSaver, noise: NoiseSource,
                init_gen: torch.Generator, plan: Dict, grad_clip: float,
                inflight: Optional[Dict], warm: bool,
                warm_dir: Optional[str] = None) -> ScaleTrainState:
    """The scale's training state: a D (make_discriminator's, or the
    inflight payload's) and fresh optimizers over the plan's trainable
    subtrees and D (or the payload's); G's and D's convolutions run in
    cfg.compute_dtype."""
    device = next(G.parameters()).device
    if inflight is None:
        D = make_discriminator(cfg, saver, cfg.scale_idx, init_gen, device,
                               G.ndim, warm, warm_dir)
    else:
        D = models.get_discriminator(cfg.discriminator, G.ndim)(cfg)
        D.load_state_dict(inflight["D"])
        D = D.to(device)
    dtype = cfg_compute_dtype(cfg)
    set_compute_dtype(G, dtype)
    set_compute_dtype(D, dtype)
    opt_g, opt_d = make_optimizers(cfg, G, D, plan, grad_clip)
    if inflight is not None:
        load_optimizer_state(opt_g, inflight["opt_g"])
        load_optimizer_state(opt_d, inflight["opt_d"])
    return ScaleTrainState(G, D, opt_g, opt_d, noise)


def calibrate_amp(cfg, G, former, data, noise_amps: List[float],
                  noise: NoiseSource, inflight: Optional[Dict],
                  const_amp: bool) -> List[float]:
    """The amps with scale cfg.scale_idx's: 1.0 at scale 0 and under
    `const_amp`, else noise_amp_init * the RMSE of a reconstruction of a
    batch from `former` (divided by batch_size again only under
    bug_compat, the reference's bug #3). An inflight marker carries it."""
    scale_idx = cfg.scale_idx
    noise_amps = list(noise_amps)
    if inflight is not None:
        if len(noise_amps) != scale_idx + 1:
            raise ValueError(f"an inflight marker of scale {scale_idx} needs "
                             f"{scale_idx + 1} amps, has {len(noise_amps)}")
    elif const_amp or scale_idx == 0:
        noise_amps.append(1.0)
    else:
        noise_amps.append(0.0)
        real, real_zero, _ = former(cfg, data[0], data[1], noise)
        rmse = calibrate(G, real, real_zero,
                         amps_list(noise_amps, cfg.stop_scale), noise)
        denom = cfg.batch_size if cfg.bug_compat else 1
        noise_amps[-1] = cfg.noise_amp_init * float(rmse) / denom
    return noise_amps


def _denorm(x: torch.Tensor):
    """NCHW in [-1, 1] (float32 or bfloat16) -> NHWC float32 numpy in
    [0, 255], as the JAX trainer's numpy denorm computes it."""
    y = torch.clamp((x.float() + 1) * 127.5, 0, 255)
    return y.permute(0, 2, 3, 1).cpu().numpy()


@torch.no_grad()
def visualize(G, saver: DataSaver, real, real_zero, noise_init, amps,
              noise: NoiseSource, done: int) -> None:
    """The JAX trainer's `_visualize` (trainer.py:309-330 there) on a batch
    the caller formed: real_<done+1>.jpg, a batch-statistics
    reconstruction's generated_<done+1>.jpg and generated_vae_<done+1>.jpg,
    then one batch-statistics sample from a fresh noise_init-shaped normal,
    fake_var_<done>.jpg and fake_vae_var<done>.jpg of sample 0. Neither
    forward keeps BatchNorm or spectral-norm state."""
    saver.save_image(_denorm(real), f"real_{done + 1}.jpg")
    gen, gen_vae = G.reconstruct(real_zero, amps, noise, commit=False)[:2]
    saver.save_image(_denorm(gen), f"generated_{done + 1}.jpg")
    saver.save_image(_denorm(gen_vae), f"generated_vae_{done + 1}.jpg")
    z = noise.normal(noise_init.shape)
    fake, fake_vae = G(z, amps, noise, bn="batch", commit=False)[:2]
    saver.save_image(_denorm(fake[:1]), f"fake_var_{done}.jpg")
    saver.save_image(_denorm(fake_vae[:1]), f"fake_vae_var{done}.jpg")


def run_scale(cfg, st: ScaleTrainState, saver: DataSaver, data,
              noise_amps: List[float], vae_phase: bool, former,
              init_gen: torch.Generator, step_callback=None,
              inflight: Optional[Dict] = None) -> None:
    """The scale's iterations (after the inflight payload's, when given),
    the images of cfg.visualize (2D), and the scale's checkpoints: netG,
    netD (GAN scales) and torch_rng_<k>.pt."""
    scale_idx = cfg.scale_idx
    G, D = st.G, st.D
    amps = amps_list(noise_amps, cfg.stop_scale)
    start = int(inflight["iter"]) if inflight is not None else 0
    bar = Progress(cfg.niter, "Training scale [{}/{}]".format(
        scale_idx + 1, cfg.stop_scale + 1), initial=start)
    for done in range(start + 1, cfg.niter + 1):
        metrics = train_iteration(cfg, st, data[0], data[1], amps,
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
        if cfg.visualize and G.ndim == 2 and done % cfg.image_interval == 0:
            real, real_zero, noise_init = former(cfg, data[0], data[1],
                                                 st.noise)
            visualize(G, saver, real, real_zero, noise_init, amps, st.noise,
                      done)
        if cfg.ckpt_interval and done < cfg.niter \
                and done % cfg.ckpt_interval == 0:
            saver.save_inflight(scale_idx, {
                "G": G.state_dict(), "D": D.state_dict(),
                "opt_g": st.opt_g.state_dict(), "opt_d": st.opt_d.state_dict(),
                "rng": rng_state(init_gen, st.noise)}, done, noise_amps)
        if step_callback is not None:
            step_callback(done, st, metrics)
    bar.close()

    params, state = to_jax(G.state_dict(), G.ndim)
    d_tree = None
    if not vae_phase:
        d_params, d_state = to_jax_discriminator(D.state_dict(), G.ndim)
        d_tree = {"params": d_params, "state": d_state}
    saver.finalize_scale(scale_idx, noise_amps,
                         {"params": params, "state": state}, d_tree,
                         rng=rng_state(init_gen, st.noise))


def train_scale(cfg, G, dataset, saver: DataSaver, noise_amps: List[float],
                noise: NoiseSource, init_gen: torch.Generator,
                step_callback=None, inflight: Optional[Dict] = None,
                warm_dir: Optional[str] = None) -> List[float]:
    """Train pyramid scale cfg.scale_idx of G (2D or 3D, per G.ndim) on a
    SingleImageDataset or SingleVideoDataset; returns the amps with its
    own. `inflight`: an inflight checkpoint's payload, whose D, optimizers
    and iteration the scale continues from (G and the generators are the
    caller's to restore); `warm_dir`: a reference-style resume's --netG
    directory, whose netD_<k-1> D starts from."""
    scale_idx = cfg.scale_idx
    vae_phase = cfg.vae_levels >= scale_idx + 1
    warm = not vae_phase and bool(warm_dir or cfg.vae_levels < scale_idx)
    st = scale_state(cfg, G, saver, noise, init_gen,
                     make_lr_plan(cfg, scale_idx, len(G.body)),
                     cfg.grad_clip, inflight, warm, warm_dir)
    if G.ndim == 2:
        data = dataset.scale_image(scale_idx), dataset.scale_image(0)
    else:
        data = dataset.scale_frames(scale_idx), dataset.scale_frames(0)
    former = batch_former(G.ndim, scale_idx)
    noise_amps = calibrate_amp(cfg, G, former, data, noise_amps, noise,
                               inflight, cfg.const_amp)
    run_scale(cfg, st, saver, data, noise_amps, vae_phase, former, init_gen,
              step_callback, inflight)
    return noise_amps


def _load_netg(cfg, path: str, ndim: int) -> Dict[str, torch.Tensor]:
    """A finalized generator as the port's state_dict: a pickled pytree of
    either package, the original .pth or a MindSpore checkpoint; a
    baseline's a pickled pytree only (JAX baselines_trainer.py:313-314)."""
    if cfg.generator in models.BASELINES and (
            path.endswith(".pth") or is_ms_checkpoint(path)):
        raise ValueError(f"{path}: {cfg.generator} resumes from pickled "
                         "(params, state) checkpoints only, as the JAX "
                         "package's baselines trainer does")
    return load_generator_checkpoint(path, ndim)[0]


def resume(cfg, saver: DataSaver, G, init_gen: torch.Generator,
           noise: NoiseSource
           ) -> Tuple[List[float], int, Optional[Dict], Optional[str]]:
    """Load the resumed state into G and the generators (cases (a)-(c) of
    the module docstring); the checkpoint must carry scale k's stage count,
    k + G.body_offset. Returns (noise_amps, the scale to train next, the
    inflight payload or None, the netD warm-start dir or None)."""
    if not (cfg.netG and cfg.intermediate):
        raise ValueError("resume needs both --netG and --intermediate")
    inter_dir = os.path.dirname(cfg.intermediate)
    with open(os.path.join(inter_dir, "intermediate.json")) as f:
        inter = json.load(f)
    amps = [float(a) for a in inter["noise_amps"]]
    k = int(inter["scale_idx"])
    resume_dir = os.path.dirname(cfg.netG)
    inflight = None
    if inter.get("inflight") \
            and os.path.basename(cfg.netG) == inter["inflight"]:
        inflight = load_inflight(cfg.netG)
        state_dict = inflight["G"]
    else:
        state_dict = _load_netg(cfg, cfg.netG, G.ndim)
    n_body = len({key.split(".")[1] for key in state_dict
                  if key.startswith("body.")})
    if n_body != k + G.body_offset:
        raise RuntimeError(f"{cfg.netG} has {n_body} refinement stages but "
                           f"the marker's scale_idx is {k} (netG_<k> of "
                           f"{cfg.generator} carries k + {G.body_offset})")
    while len(G.body) < n_body:
        G.init_next_stage()
    G.load_state_dict(state_dict)

    if inflight is not None:
        set_rng_state(inflight["rng"], init_gen, noise)
        logging.info("resume: scale %d from %s after iteration %d", k,
                     cfg.netG, inflight["iter"])
        return amps, k, inflight, None
    if inter.get("torch_rng"):
        if len(amps) != k + 1:
            raise ValueError(f"a finalized marker of scale {k} needs {k + 1} "
                             f"amps, has {len(amps)}")
        set_rng_state(load_inflight(os.path.join(inter_dir,
                                                 inter["torch_rng"])),
                      init_gen, noise)
        src = os.path.join(resume_dir, f"netD_{k}.ckpt")
        dst = os.path.join(saver.experiment_dir, f"netD_{k}.ckpt")
        if os.path.isfile(src) and not os.path.exists(dst):
            shutil.copy(src, dst)
        logging.info("resume: scale %d complete in %s; continuing at %d", k,
                     inter_dir, k + 1)
        return amps, k + 1, None, None
    logging.info("resume: retraining scale %d from %s (reference-style)", k,
                 cfg.netG)
    return amps[:k], k, None, resume_dir


def run_training(cfg, saver: DataSaver, device="cuda",
                 seed: Optional[int] = None, mode: str = "image",
                 step_callback=None):
    """The full multi-scale run (reference train_image.py:385-391) on one
    image (`mode` "image") or one video ("video"), resumed when cfg.netG is
    set. Weights are drawn from a host generator seeded `seed` (default
    cfg.manualSeed), every training draw from a NoiseSource on `device`.
    `step_callback(done, st, metrics)` runs after every iteration. Returns
    (G, noise_amps)."""
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
    start, inflight, warm_dir = 0, None, None
    if cfg.netG or cfg.intermediate:
        noise_amps, start, inflight, warm_dir = resume(cfg, saver, G,
                                                       init_gen, noise)
    noise_amps = train_scales(cfg, G, dataset, saver, noise_amps, noise,
                              init_gen, start, train_scale, step_callback,
                              inflight, warm_dir)
    return G, noise_amps


def train_scales(cfg, G, dataset, saver: DataSaver, noise_amps: List[float],
                 noise: NoiseSource, init_gen: torch.Generator, start: int,
                 train_fn, step_callback=None, inflight: Optional[Dict] = None,
                 warm_dir: Optional[str] = None) -> List[float]:
    """Scales start..stop_scale through `train_fn` (train_scale's
    signature): G grows to scale k's stage count first (k + G.body_offset),
    and a video run sets cfg.fps, cfg.td and cfg.fps_index of the scale.
    The inflight payload and warm_dir are the first scale's. Returns the
    amps."""
    for scale_idx in range(start, cfg.stop_scale + 1):
        cfg.scale_idx = scale_idx
        if len(G.body) < scale_idx + G.body_offset:
            G.init_next_stage(init_gen)
        if G.ndim == 3:
            cfg.fps, cfg.td, cfg.fps_index = pyramid.get_fps_td_by_index(
                scale_idx, cfg.stop_scale_time, cfg.sampling_rates,
                cfg.org_fps, cfg.fps_lcm)
            logging.info("scale %d: fps %.2f, time-depth %d, rate %d",
                         scale_idx, cfg.fps, cfg.td,
                         cfg.sampling_rates[cfg.fps_index])
        t0 = time.perf_counter()
        noise_amps = train_fn(cfg, G, dataset, saver, noise_amps, noise,
                              init_gen, step_callback, inflight, warm_dir)
        inflight = warm_dir = None
        secs = time.perf_counter() - t0
        logging.info("scale %d done in %.1fs (%.2f it/s)", scale_idx, secs,
                     cfg.niter / max(secs, 1e-9))
    if start > cfg.stop_scale:
        logging.info("resume: all %d scales already complete",
                     cfg.stop_scale + 1)
    return noise_amps
