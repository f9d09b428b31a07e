"""What the card tests share: the tiny CLI arguments, the tiny config of the
training-flag cases and a training chunk built from it, and the state of
a chunk's run to compare. The module imports neither JAX nor the JAX
package."""

import dataclasses
import os

import torch

from hpvaegan_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--image-path", os.path.join(REPO, "data", "imgs", "air_balloons.jpg"),
        "--nfc", "8", "--latent-dim", "8", "--num-layer", "1",
        "--enc-blocks", "1", "--img-size", "32", "--min-size", "16",
        "--max-size", "32", "--vae-levels", "2", "--niter", "4",
        "--ckpt-interval", "2", "--manualSeed", "1"]


def flag_cfg(ndim, generator="GeneratorHPVAEGAN", **flags):
    """A tiny config of `generator` in `ndim` dimensions under `flags`;
    in 3D at synthetic.avi's frame rate and aspect."""
    kw = dict(nfc=8, num_layer=2, img_size=32, min_size=16, max_size=32,
              generator=generator, **flags)
    if generator != "GeneratorCSG":
        kw.update(latent_dim=8, enc_blocks=1, vae_levels=2)
    else:
        kw["discriminator"] = "WDiscriminatorBaselines"
    if ndim == 3:
        kw.update(max_frames=5, sampling_rates=[2, 1], hflip=True,
                  batch_size=2)
    cfg = Config(**kw).finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm = 24.0, 0.75, 2  # synthetic.avi's
    return cfg


def make_chunk(cfg, ndim, split, device, generator="GeneratorHPVAEGAN",
               discriminator="", scale_idx=3):
    """A training chunk of `cfg` (flag_cfg) at `scale_idx` (a GAN scale by
    default, a VAE scale below cfg.vae_levels): --split-step (eager) or
    not (a CUDA graph on the card), from seed 0's weights and draws."""
    from hpvaegan_tpu_torch import models
    from hpvaegan_tpu_torch.tools.step_parity import build_state
    from hpvaegan_tpu_torch.training.chunk import TrainChunk
    from hpvaegan_tpu_torch.training.steps import batch_former
    from hpvaegan_tpu_torch.utils.noise import NoiseSource
    from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d

    cfg = dataclasses.replace(cfg, split_step=split, scale_idx=scale_idx)
    st = build_state(cfg, scale_idx, 0, device, ndim, generator,
                     discriminator)
    st.noise = NoiseSource(0, device)
    gen = torch.Generator().manual_seed(1)
    frames = (cfg.max_frames,) if ndim == 3 else ()
    data = [torch.rand((1, cfg.nc_im) + frames + tuple(scale_size_2d(
        k, cfg.scale_factor, cfg.stop_scale, cfg.img_size, cfg.ar)),
        generator=gen).to(device) for k in (scale_idx, 0)]
    former = batch_former(ndim, scale_idx,
                          baseline=generator in models.BASELINES)
    amps = [1.0] + [0.05] * (cfg.stop_scale + 1)
    return st, TrainChunk(cfg, st, data, amps,
                          scale_idx < cfg.vae_levels, former)


def chunk_state(st):
    """G, D, both optimizers' and the NoiseSource's state, by name."""
    out = {f"G.{k}": v for k, v in st.G.state_dict().items()}
    out.update({f"D.{k}": v for k, v in st.D.state_dict().items()})
    for part in ("opt_g", "opt_d"):
        for i, s in getattr(st, part).state_dict()["state"].items():
            out.update({f"{part}.{i}.{k}": v for k, v in s.items()})
    out.update({f"noise.{k}": v for k, v in st.noise.get_state().items()})
    return out
