"""The SinGAN-style video baselines' training loop: GeneratorCSG or
GeneratorSG against WDiscriminatorBaselines on one video.

The port of the JAX package's `training/baselines_trainer.py`
(`_train_baseline_scale`, `run_training`; reference
train_video_baselines.py:21-196). Its scales are training/trainer.py's,
with these differences:
  * every scale is a GAN scale: D then G at every iteration, D
    warm-started from netD_<k-1> at every scale > 0, netD_<k> written at
    every scale;
  * the plan is `make_baseline_lr_plan` (the last train_depth stages, the
    head while scale_idx < train_depth, the tail always), and G's Adam
    clips nothing (JAX :140-143);
  * the amp is 1.0 at scale 0 and noise_amp_init * the reconstruction's
    RMSE after that, whatever cfg.const_amp says (JAX :180-198);
  * the batch former draws nc_im-channel noise (data/video.py::
    make_baseline_batch);
  * the reconstruction feeds a fixed Z_init (1, nc_im, td0, h0, w0): the
    weight generator draws it right after G's weights, on every run, and
    the run writes it to Z_init.npy in the JAX package's layout, (1, td0,
    h0, w0, nc_im), atomically. A resume reloads the resumed run's Z_init.npy
    in its place (JAX :305-366), so either package resumes and evaluates
    the other's run;
  * netG_<k> carries k + 1 stages: G grows by a deep copy of its last stage
    at every scale > 0 except the one a reference-style resume retrains;
  * the logbook lines carry no noise amp: "[Scale k/Iter n] <metrics>"
    (JAX :233-235).
Resume is trainer.resume's cases (a)-(c) at that stage count: the inflight
payload carries G, D, both optimizers and the generators' states; a
finalized port marker continues at k + 1 with netD_<k> copied; any other
marker (the JAX package's) retrains scale k from its k + 1 stages with D
warm from --netG's directory.

Multi-process, data-parallel and spatial-mesh runs (--mesh-data D x
--mesh-sp S ranks, the JAX trainer's ('data', 'sp') mesh, JAX :288-293)
as in training/trainer.py: the warm start's `agree_minmax`
(trainer.make_discriminator, JAX :124), a barrier after each scale's
checkpoints (JAX :258), the primary-only resume netD copy (JAX :337-341),
args.txt and Z_init.npy, and a barrier at the end (JAX :393). Under the
spatial axis H is split wherever a scale's unpadded height divides by S
(the JAX package's rule, steps.py:52 there), the stages run in padded
layouts (models/networks_3d.py), and every rank keeps the whole of the
replicated state, Z_init too, so the checkpoints need no gather. The JAX
trainer's scan chunks are trainer.run_scale's (training/chunk.py), with
its cadence (JAX :201-241); not ported: `run_scale_with_retry`, which
exists for XLA.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import models
from ..data.video import SingleVideoDataset
from ..models.blocks import init_weights_
from ..parallel import mesh, multihost
from ..utils import pyramid
from ..utils.device import resolve_device
from ..utils.noise import NoiseSource
from ..utils.saver import DataSaver
from . import trainer
from .partition import make_baseline_lr_plan
from .steps import batch_former

Z_INIT = "Z_init.npy"


def z_init_shape(cfg):
    """(1, nc_im, td0, h0, w0): Z_init at scale 0's size and time depth."""
    h0, w0 = pyramid.scale_size_2d(0, cfg.scale_factor, cfg.stop_scale,
                                   cfg.img_size, cfg.ar)
    _, td0, _ = pyramid.get_fps_td_by_index(0, cfg.stop_scale_time,
                                            cfg.sampling_rates, cfg.org_fps,
                                            cfg.fps_lcm)
    return (1, cfg.nc_im, td0, h0, w0)


def save_z_init(exp_dir: str, z_init: torch.Tensor) -> None:
    """Z_init.npy in the JAX package's layout, (1, td0, h0, w0, nc_im),
    atomically (tmp + rename): it is the reconstruction target."""
    dst = os.path.join(exp_dir, Z_INIT)
    np.save(dst + ".tmp.npy", z_init.cpu().movedim(1, -1).numpy())
    os.replace(dst + ".tmp.npy", dst)


def load_z_init(exp_dir: str) -> torch.Tensor:
    """An experiment's Z_init.npy (either package's) as (1, nc_im, td0, h0,
    w0) float32."""
    z = np.load(os.path.join(exp_dir, Z_INIT))
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(z.astype(np.float32), -1, 1)))


def train_scale(cfg, G, dataset, saver: DataSaver, noise_amps: List[float],
                noise: NoiseSource, init_gen: torch.Generator,
                step_callback=None, inflight: Optional[Dict] = None,
                warm_dir: Optional[str] = None) -> List[float]:
    """Train scale cfg.scale_idx of a baseline G (trainer.train_scale's
    arguments and return, with the differences of the module docstring)."""
    scale_idx = cfg.scale_idx
    plan = make_baseline_lr_plan(cfg, scale_idx, len(G.body),
                                 has_head=hasattr(G, "head"),
                                 has_tail=hasattr(G, "tail"))
    st = trainer.scale_state(cfg, G, saver, noise, init_gen, plan,
                             float("inf"), inflight, scale_idx > 0, warm_dir)
    data = dataset.scale_frames(scale_idx), dataset.scale_frames(0)
    former = batch_former(3, scale_idx, baseline=True)
    noise_amps = trainer.calibrate_amp(cfg, G, former, data, noise_amps,
                                       noise, inflight, const_amp=False)
    trainer.run_scale(cfg, st, saver, data, noise_amps, False, former,
                      init_gen, step_callback, inflight, log_amp=False)
    return noise_amps


def run_training(cfg, saver: DataSaver, device="cuda",
                 seed: Optional[int] = None, mode: str = "video",
                 step_callback=None):
    """The full multi-scale baseline run on one video (`mode` must be
    "video"; trainer.run_training's arguments), resumed when cfg.netG is
    set. Returns (G, noise_amps)."""
    if mode != "video":
        raise ValueError(f"mode {mode!r}: the baselines train on a video")
    if cfg.generator not in models.BASELINES:
        raise ValueError(f"{cfg.generator} is not a baseline generator "
                         f"({', '.join(models.BASELINES)})")
    device = resolve_device(device)
    group = mesh.make_data_group(cfg.mesh_data, cfg.mesh_sp)
    dataset = SingleVideoDataset(cfg, device)
    if multihost.is_primary():
        cfg.write_args_txt(os.path.join(saver.experiment_dir, "args.txt"))

    seed = seed if seed is not None else (cfg.manualSeed or 0)
    init_gen = torch.Generator().manual_seed(int(seed))
    noise = NoiseSource(seed, device)
    G = models.get_generator(cfg.generator, 3)(cfg)
    init_weights_(G, init_gen)
    z_init = torch.randn(z_init_shape(cfg), generator=init_gen)
    G = G.to(device)

    noise_amps: List[float] = []
    start, inflight, warm_dir = 0, None, None
    if cfg.netG or cfg.intermediate:
        noise_amps, start, inflight, warm_dir = trainer.resume(
            cfg, saver, G, init_gen, noise)
        z_init = load_z_init(os.path.dirname(cfg.netG))
        if tuple(z_init.shape) != z_init_shape(cfg):
            raise ValueError(f"the resumed run's Z_init is "
                             f"{tuple(z_init.shape)}, this config's "
                             f"{z_init_shape(cfg)}")
    # the same on every rank (same seed, same draw): the primary writes it
    if multihost.is_primary():
        save_z_init(saver.experiment_dir, z_init)
    G.z_init = z_init.to(device)
    with mesh.data_parallel(group):
        noise_amps = trainer.train_scales(cfg, G, dataset, saver,
                                          noise_amps, noise, init_gen, start,
                                          train_scale, step_callback,
                                          inflight, warm_dir)
    multihost.sync("baselines_run_training_end")
    return G, noise_amps
