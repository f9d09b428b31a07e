"""Tests of the port's CUDA kernels; they need an NVIDIA card and nvcc and
skip elsewhere. The module imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX's CPU platform.)
"""

import numpy as np
import pytest
import torch

from hpvaegan_tpu_torch.config import Config
from hpvaegan_tpu_torch.evaluation import generate_samples
from hpvaegan_tpu_torch.models.networks_2d import GeneratorHPVAEGAN
from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
from hpvaegan_tpu_torch.models.networks_3d import (
    GeneratorHPVAEGAN as GeneratorHPVAEGAN3D)
from hpvaegan_tpu_torch.tools.step_parity import (compare_devices,
                                                  compare_sampler_devices)

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
