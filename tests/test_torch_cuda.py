"""Tests of the port's CUDA kernels; they need an NVIDIA card and nvcc and
skip elsewhere. The module imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX's CPU platform.)
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from hpvaegan_tpu_torch.config import Config
from hpvaegan_tpu_torch.evaluation import generate_samples
from hpvaegan_tpu_torch.models import get_generator
from hpvaegan_tpu_torch.models.blocks import init_weights_
from hpvaegan_tpu_torch.models.networks_2d import GeneratorHPVAEGAN
from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
from hpvaegan_tpu_torch.models.networks_3d import (
    GeneratorHPVAEGAN as GeneratorHPVAEGAN3D)
from hpvaegan_tpu_torch.tools.step_parity import (compare_devices,
                                                  compare_sampler_devices)
from hpvaegan_tpu_torch.training import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--image-path", os.path.join(REPO, "data", "imgs", "air_balloons.jpg"),
        "--nfc", "8", "--latent-dim", "8", "--num-layer", "1",
        "--enc-blocks", "1", "--img-size", "32", "--min-size", "16",
        "--max-size", "32", "--vae-levels", "2", "--niter", "4",
        "--ckpt-interval", "2", "--manualSeed", "1"]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def test_k1_matches_plain_version(cuda):
    """The kernel's outputs equal the plain version's on its Philox words,
    bit for bit: at stage shapes, at H_out and W_out both odd and H_out not
    a multiple of the row tile, at 41x41 planes (not 16-byte aligned), at
    one input row, and at a downscale."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for hw_in, hw in (((33, 34), (41, 43)), ((204, 205), (257, 259)),
                      ((7, 8), (30, 32)), ((13, 14), (37, 45)),
                      ((33, 33), (41, 41)), ((1, 5), (9, 12)),
                      ((257, 258), (41, 43))):
        x = torch.randn((4, 3) + hw_in, device=cuda, generator=g)
        before = k1.fused_upscale_noise_2d.launches
        clean, noised = k1.fused_upscale_noise_2d(x, hw, 0.7, 9)
        torch.cuda.synchronize()
        assert k1.fused_upscale_noise_2d.launches == before + 1
        bits = k1.philox_bits(9, (4, 3) + hw, cuda)
        pc, pn = k1.fused_upscale_noise_2d_plain(x, hw, 0.7, bits)
        assert torch.equal(clean, pc), (hw_in, hw)
        assert torch.equal(noised, pn), (hw_in, hw)


def test_k1_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2, 3, 8, 8, device=cuda)
    with pytest.raises(ValueError):
        k1.fused_upscale_noise_2d(x, (16, 16), 1.0, 0, bits=(x, x))
    with pytest.raises(ValueError):
        k1.fused_upscale_noise_2d(x.half(), (16, 16), 1.0, 0)
    with pytest.raises(ValueError):
        k1.fused_upscale_noise_2d(x.transpose(2, 3), (16, 16), 1.0, 0)


def test_fused_sampler_launches_k1_per_stage(cuda):
    cfg = Config(nfc=8, latent_dim=8, num_layer=2, img_size=32, min_size=16,
                 max_size=32, niter=2, num_samples=3,
                 pallas_fused_sampling=True).finalize()
    cfg.Noise_Amps = [1.0] + [0.1] * cfg.stop_scale
    gen = GeneratorHPVAEGAN(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage(torch.Generator().manual_seed(0))
    gen = gen.to(cuda)
    k1.fused_upscale_noise_2d.launches = 0
    out = generate_samples(cfg, gen, train_mode=False)
    assert k1.fused_upscale_noise_2d.launches == 2 * cfg.stop_scale
    assert out.shape == (6, 33, 33, 3) and np.isfinite(out).all()


@pytest.mark.parametrize("scale_idx", [1, 3])
def test_training_iteration_matches_cpu(cuda, scale_idx):
    """One training iteration on the card (TF32 off) equals the same
    iteration on the CPU from the same weights and draws: a VAE-scale G
    step (scale 1), and a GAN-scale D + G iteration whose GP double
    backward runs through cuDNN (scale 3). Metrics to rtol 1e-4, gradients
    and BatchNorm / spectral-norm state to atol 1e-4."""
    cfg = Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
                 min_size=16, max_size=32, vae_levels=2).finalize()
    errs = compare_devices(cfg, scale_idx, seed=0, device=cuda)
    assert errs["finite"], errs
    assert errs["metrics_rel"] <= 1e-4, errs
    assert errs["grads_abs"] <= 1e-4 and errs["state_abs"] <= 1e-4, errs


@pytest.mark.parametrize("train", [True, False])
def test_video_sampler_matches_cpu(cuda, train):
    """The 3D sampler on the card (TF32 off) equals the same samples on the
    CPU from the same weights and draws, in both BatchNorm modes; the video
    path launches no kernel of its own."""
    cfg = Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
                 min_size=16, max_size=32, vae_levels=2, niter=1,
                 num_samples=3, sampling_rates=[2, 1]).finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm, cfg.td = 24.0, 0.75, 2, 3
    cfg.Noise_Amps = [1.0] + [0.3] * cfg.stop_scale
    gen = GeneratorHPVAEGAN3D(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage(torch.Generator().manual_seed(0))
    k1.fused_upscale_noise_2d.launches = 0
    diff = compare_sampler_devices(cfg, gen, 3, train, seed=0, device=cuda)
    assert diff <= 1e-4
    assert k1.fused_upscale_noise_2d.launches == 0


@pytest.mark.parametrize("scale_idx", [1, 3])
def test_video_training_iteration_matches_cpu(cuda, scale_idx):
    """One 3D training iteration on the card (TF32 off) equals the same
    iteration on the CPU from the same weights and draws (window starts,
    flips, z_init, noise, eps, alpha): a VAE-scale G step (scale 1) and a
    GAN-scale D + G iteration whose GP double backward runs through cuDNN's
    3D convolutions (scale 3)."""
    cfg = Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
                 min_size=16, max_size=32, vae_levels=2, max_frames=5,
                 sampling_rates=[2, 1], hflip=True, batch_size=2).finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm = 24.0, 0.75, 2  # synthetic.avi's
    errs = compare_devices(cfg, scale_idx, seed=0, device=cuda, ndim=3)
    assert errs["finite"], errs
    assert errs["metrics_rel"] <= 1e-4, errs
    assert errs["grads_abs"] <= 1e-4 and errs["state_abs"] <= 1e-4, errs


@pytest.mark.parametrize("scale_idx", [1, 3])
def test_vae_nb_iteration_matches_cpu(cuda, scale_idx):
    """test_training_iteration_matches_cpu for GeneratorVAE_nb (its gate,
    eps and Gumbel u come from the same recorded draws)."""
    cfg = Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
                 min_size=16, max_size=32, vae_levels=2,
                 generator="GeneratorVAE_nb").finalize()
    errs = compare_devices(cfg, scale_idx, seed=0, device=cuda,
                           generator="GeneratorVAE_nb")
    assert errs["finite"], errs
    assert errs["metrics_rel"] <= 1e-4, errs
    assert errs["grads_abs"] <= 1e-4 and errs["state_abs"] <= 1e-4, errs


@pytest.mark.parametrize("scale_idx", [1, 3])
def test_video_vae_nb_iteration_matches_cpu(cuda, scale_idx):
    """test_video_training_iteration_matches_cpu for the 3D GeneratorVAE_nb
    (its gate at every fake, eps and the Gumbel u come from the same
    recorded draws; noise at every refinement stage)."""
    cfg = Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
                 min_size=16, max_size=32, vae_levels=2, max_frames=5,
                 sampling_rates=[2, 1], hflip=True, batch_size=2,
                 generator="GeneratorVAE_nb").finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm = 24.0, 0.75, 2  # synthetic.avi's
    k1.fused_upscale_noise_2d.launches = 0
    errs = compare_devices(cfg, scale_idx, seed=0, device=cuda, ndim=3,
                           generator="GeneratorVAE_nb")
    assert errs["finite"], errs
    assert errs["metrics_rel"] <= 1e-4, errs
    assert errs["grads_abs"] <= 1e-4 and errs["state_abs"] <= 1e-4, errs
    assert k1.fused_upscale_noise_2d.launches == 0


@pytest.mark.parametrize("name", ["GeneratorCSG", "GeneratorSG"])
def test_baseline_iteration_matches_cpu(cuda, name):
    """One iteration of a CSG/SG baseline against WDiscriminatorBaselines
    on the card (TF32 off) equals the same iteration on the CPU from the
    same weights, Z_init and draws (chip_smoke.py phase 15 (a))."""
    cfg = Config(nfc=8, num_layer=2, img_size=32, min_size=16, max_size=32,
                 max_frames=5, sampling_rates=[2, 1], hflip=True,
                 batch_size=2, generator=name,
                 discriminator="WDiscriminatorBaselines").finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm = 24.0, 0.75, 2  # synthetic.avi's
    k1.fused_upscale_noise_2d.launches = 0
    errs = compare_devices(cfg, 3, seed=0, device=cuda, ndim=3,
                           generator=name,
                           discriminator="WDiscriminatorBaselines")
    assert errs["finite"], errs
    assert errs["metrics_rel"] <= 1e-4, errs
    assert errs["grads_abs"] <= 1e-4 and errs["state_abs"] <= 1e-4, errs
    assert k1.fused_upscale_noise_2d.launches == 0


@pytest.mark.parametrize("name", ["GeneratorCSG", "GeneratorSG"])
@pytest.mark.parametrize("train", [True, False])
def test_baseline_sampler_matches_cpu(cuda, name, train):
    """A tiny baseline's sampler (z of nc_im channels at scale 0's time
    depth, netG_4's 5 stages) on the card (TF32 off) equals the CPU's from
    the same draws, in both BatchNorm modes."""
    cfg = Config(nfc=8, num_layer=2, img_size=32, min_size=16, max_size=32,
                 niter=1, num_samples=3, sampling_rates=[2, 1],
                 generator=name).finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm = 24.0, 0.75, 2
    cfg.scale_idx = cfg.stop_scale
    cfg.Noise_Amps = [1.0] + [0.3] * cfg.stop_scale
    gen = get_generator(name, 3)(cfg)
    init_weights_(gen, torch.Generator().manual_seed(0))
    for _ in range(cfg.stop_scale):
        gen.init_next_stage()
    diff = compare_sampler_devices(cfg, gen, 3, train, seed=0, device=cuda)
    assert diff <= 1e-4


class _Killed(Exception):
    pass


def _kill_at(scale_idx, at_iter):
    def callback(done, st, metrics):
        if len(st.G.body) == scale_idx and done == at_iter:
            raise _Killed
    return callback


def test_resume_matches_uninterrupted(cuda, tmp_path, monkeypatch):
    """A tiny run on the card killed after the inflight checkpoint of its
    last scale and resumed from it ends as the uninterrupted run (TF32
    off, deterministic cuDNN): netG within 1e-6, the amps equal."""
    from hpvaegan_tpu_torch import train_image

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ref = train_image.main(TINY + ["--run-dir", str(tmp_path / "a")])
    made = []
    run_training = trainer.run_training

    def killed(cfg, saver, *a, **kw):
        made.append(saver.experiment_dir)
        return run_training(cfg, saver, *a, step_callback=_kill_at(4, 3),
                            **kw)

    monkeypatch.setattr(trainer, "run_training", killed)
    with pytest.raises(_Killed):
        train_image.main(TINY + ["--run-dir", str(tmp_path / "b")])
    monkeypatch.setattr(trainer, "run_training", run_training)
    resumed = train_image.main(TINY + [
        "--run-dir", str(tmp_path / "c"),
        "--netG", os.path.join(made[0], "inflight_4.ckpt"),
        "--intermediate", os.path.join(made[0], "intermediate.json")])

    def load(exp, name):
        with open(os.path.join(exp, name), "rb") as f:
            return pickle.load(f) if name.endswith(".ckpt") else json.load(f)

    assert load(ref, "intermediate.json")["noise_amps"] == \
        load(resumed, "intermediate.json")["noise_amps"]
    assert _max_diff(load(ref, "netG_4.ckpt"),
                     load(resumed, "netG_4.ckpt")) <= 1e-6


def _max_diff(a, b) -> float:
    """The largest absolute difference of two pytrees of arrays."""
    if isinstance(a, dict):
        return max(_max_diff(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return max(_max_diff(x, y) for x, y in zip(a, b))
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# the training flags, card against CPU (chip_smoke.py phase 16 (a)); the
# bf16 bound is the card's cuDNN bf16 convolutions against oneDNN's, whose
# one-ulp rounding differences the bf16 chain spreads (as between the port
# and the JAX package on the CPU, tests/test_torch_flags.py): measured on
# an H100 at these seeds, metrics 2.1e-5 of max(|metric|, 1) (d_loss, a
# small difference of larger terms, moves 10% of itself), gradients
# 3.9e-3 (one bf16 ulp at 0.5-1), state 9.5e-6
BF16_CARD_TOL = {"metrics_scaled": 1e-3, "grads_abs": 2e-2,
                 "state_abs": 1e-4}


def _flag_cfg(ndim, generator="GeneratorHPVAEGAN", **flags):
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


@pytest.mark.parametrize("ndim,generator,flags", [
    (2, "GeneratorHPVAEGAN", dict(fused_dg=True)),
    (3, "GeneratorHPVAEGAN", dict(fused_dg=True)),
    (3, "GeneratorCSG", dict(fused_dg=True)),
    (2, "GeneratorHPVAEGAN", dict(paired_g=True)),
    (2, "GeneratorHPVAEGAN", dict(flat_opt=True)),
    (2, "GeneratorHPVAEGAN", dict(compute_dtype="bfloat16")),
    (3, "GeneratorHPVAEGAN", dict(compute_dtype="bfloat16"))])
def test_training_flag_iteration_matches_cpu(cuda, ndim, generator, flags):
    """One GAN-scale iteration under a training flag on the card (TF32 off)
    equals the same iteration on the CPU from the same weights and draws:
    float32 flags at atol 1e-4 as the plain iteration, bfloat16 within
    BF16_CARD_TOL."""
    cfg = _flag_cfg(ndim, generator, **flags)
    errs = compare_devices(
        cfg, 3, seed=0, device=cuda, ndim=ndim, generator=generator,
        discriminator=cfg.discriminator if generator == "GeneratorCSG"
        else "")
    assert errs["finite"], errs
    tol = BF16_CARD_TOL if "compute_dtype" in flags else {
        "metrics_rel": 1e-4, "grads_abs": 1e-4, "state_abs": 1e-4}
    for k, bound in tol.items():
        assert errs[k] <= bound, (k, errs)


@pytest.mark.parametrize("ndim", [2, 3])
def test_sampled_fid_matches_cpu(cuda, ndim):
    """The on-device SIFID / SVFID path (parallel/sampling.py) on the card
    with TF32 off equals the same run on the CPU from the same weights and
    draws: the kept samples within 1e-5, the per-sample distances within
    rtol 1e-3 (sqrtm amplifies the statistics' float32 differences)."""
    import copy

    from hpvaegan_tpu_torch.evaluation import eval_z_tail
    from hpvaegan_tpu_torch.parallel import sampling
    from hpvaegan_tpu_torch.tools.step_parity import (RecordingNoise,
                                                      ReplayedNoise)

    cfg = Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
                 min_size=16, max_size=32, vae_levels=2,
                 sampling_rates=[2, 1]).finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm, cfg.td = 24.0, 0.75, 2, 3
    cfg.Noise_Amps = [1.0] + [0.3] * cfg.stop_scale
    cfg.scale_idx = cfg.stop_scale
    gen = (GeneratorHPVAEGAN if ndim == 2 else GeneratorHPVAEGAN3D)(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    real = rng.rand(*((20, 26, 3) if ndim == 2 else (5, 20, 26, 3))).astype(
        np.float32)
    make = (sampling.make_sampled_sifid if ndim == 2
            else sampling.make_sampled_svfid)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rec = RecordingNoise(0, cuda)
        card = make(cfg, gen.to(cuda), real, z_tail=eval_z_tail(cfg, ndim))(
            4, rec, return_samples=2)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    host = make(cfg, copy.deepcopy(gen).cpu(), real,
                z_tail=eval_z_tail(cfg, ndim))(
        4, ReplayedNoise(rec.drawn, "cpu"), return_samples=2)
    assert np.abs(card[1] - host[1]).max() <= 1e-5
    np.testing.assert_allclose(card[0], host[0], rtol=1e-3)
