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

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def test_k1_matches_plain_version(cuda):
    """The kernel's outputs equal the plain version's on its Philox words."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for h_in, h_out in ((33, 41), (204, 257), (7, 30)):
        x = torch.randn(4, 3, h_in, h_in + 1, device=cuda, generator=g)
        hw = (h_out, h_out + 2)
        before = k1.fused_upscale_noise_2d.launches
        clean, noised = k1.fused_upscale_noise_2d(x, hw, 0.7, 9)
        torch.cuda.synchronize()
        assert k1.fused_upscale_noise_2d.launches == before + 1
        bits = k1.philox_bits(9, (4, 3) + hw, cuda)
        pc, pn = k1.fused_upscale_noise_2d_plain(x, hw, 0.7, bits)
        torch.testing.assert_close(clean, pc, rtol=0, atol=1e-5)
        torch.testing.assert_close(noised, pn, rtol=0, atol=1e-5)


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
