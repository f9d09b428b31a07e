"""Tests of the port's CUDA kernels; they need an NVIDIA card and nvcc and
skip elsewhere. The module imports neither JAX nor the JAX package, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX's CPU platform.)
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from hpvaegan_tpu_torch.config import Config
from hpvaegan_tpu_torch.evaluation import generate_samples
from hpvaegan_tpu_torch.models import get_generator
from hpvaegan_tpu_torch.models.blocks import Conv, SNConv, init_weights_
from hpvaegan_tpu_torch.models.networks_2d import GeneratorHPVAEGAN
from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
from hpvaegan_tpu_torch.models.networks_3d import (
    GeneratorHPVAEGAN as GeneratorHPVAEGAN3D)
from hpvaegan_tpu_torch.tools.step_parity import (compare_devices,
                                                  compare_sampler_devices)
from hpvaegan_tpu_torch.training import trainer
from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d
from torch_card_helpers import TINY, chunk_state, flag_cfg, make_chunk

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
    one input row, and at a downscale; at amp 0 its noised output is its
    clean one. The plain version's noise statistics and streams are held
    on the CPU (tests/test_torch_kernels.py)."""
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
        clean, noised = k1.fused_upscale_noise_2d(x, hw, 0.0, 9)
        assert torch.equal(clean, noised), (hw_in, hw)  # amp 0: no noise


def test_k1_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2, 3, 8, 8, device=cuda)
    with pytest.raises(ValueError):
        k1.fused_upscale_noise_2d(x, (16, 16), 1.0, 0, bits=(x, x))
    with pytest.raises(ValueError):
        k1.fused_upscale_noise_2d(x.half(), (16, 16), 1.0, 0)
    with pytest.raises(ValueError):
        k1.fused_upscale_noise_2d(x.transpose(2, 3), (16, 16), 1.0, 0)


@pytest.mark.parametrize("generator", ["GeneratorHPVAEGAN", "GeneratorVAE_nb"])
def test_fused_sampler_launches_k1_per_stage(cuda, monkeypatch, generator):
    """The moving-stat sampler with pallas_fused_sampling launches K1 once
    at every refinement stage of each batch; at amps 0 (TF32 off) the
    kernel's path gives the plain path's samples within 1e-4."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = Config(nfc=8, latent_dim=8, num_layer=2, img_size=32, min_size=16,
                 max_size=32, niter=2, num_samples=3, generator=generator,
                 pallas_fused_sampling=True).finalize()
    cfg.Noise_Amps = [1.0] + [0.1] * cfg.stop_scale
    gen = get_generator(generator)(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage(torch.Generator().manual_seed(0))
    gen = gen.to(cuda)
    k1.fused_upscale_noise_2d.launches = 0
    out = generate_samples(cfg, gen, train_mode=False)
    assert k1.fused_upscale_noise_2d.launches == 2 * cfg.stop_scale
    assert out.shape == (6, 33, 33, 3) and np.isfinite(out).all()
    cfg.Noise_Amps = [1.0] + [0.0] * cfg.stop_scale
    fused = generate_samples(cfg, gen, train_mode=False, seed=7)
    cfg.pallas_fused_sampling = False
    plain = generate_samples(cfg, gen, train_mode=False, seed=7)
    assert k1.fused_upscale_noise_2d.launches == 4 * cfg.stop_scale
    assert np.abs(fused - plain).max() <= 1e-4


@pytest.mark.parametrize("scale_idx", [1, 3])
def test_training_iteration_matches_cpu(cuda, scale_idx):
    """One training iteration on the card (TF32 off) equals the same
    iteration on the CPU from the same weights and draws: a VAE-scale G
    step (scale 1), and a GAN-scale D + G iteration whose GP double
    backward runs through cuDNN (scale 3). Metrics to rtol 1e-4, gradients
    and BatchNorm / spectral-norm state to atol 1e-4. Training launches
    no K1."""
    cfg = Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
                 min_size=16, max_size=32, vae_levels=2).finalize()
    k1.fused_upscale_noise_2d.launches = 0
    errs = compare_devices(cfg, scale_idx, seed=0, device=cuda)
    assert errs["finite"], errs
    assert errs["metrics_rel"] <= 1e-4, errs
    assert errs["grads_abs"] <= 1e-4 and errs["state_abs"] <= 1e-4, errs
    assert k1.fused_upscale_noise_2d.launches == 0


@pytest.mark.parametrize("generator", ["GeneratorHPVAEGAN", "GeneratorVAE_nb"])
@pytest.mark.parametrize("train", [True, False])
def test_video_sampler_matches_cpu(cuda, train, generator):
    """The 3D sampler of HP-VAE-GAN and of VAE_nb on the card (TF32 off)
    equals the same samples on the CPU from the same weights and draws, in
    both BatchNorm modes; the video path launches no kernel of its own."""
    cfg = Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
                 min_size=16, max_size=32, vae_levels=2, niter=1,
                 num_samples=3, sampling_rates=[2, 1],
                 generator=generator).finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm, cfg.td = 24.0, 0.75, 2, 3
    cfg.Noise_Amps = [1.0] + [0.3] * cfg.stop_scale
    gen = get_generator(generator, 3)(cfg)
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
    k1.fused_upscale_noise_2d.launches = 0
    errs = compare_devices(cfg, scale_idx, seed=0, device=cuda,
                           generator="GeneratorVAE_nb")
    assert errs["finite"], errs
    assert errs["metrics_rel"] <= 1e-4, errs
    assert errs["grads_abs"] <= 1e-4 and errs["state_abs"] <= 1e-4, errs
    assert k1.fused_upscale_noise_2d.launches == 0


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


@pytest.mark.parametrize("scale_idx", [1, 3])
@pytest.mark.parametrize("name", ["GeneratorCSG", "GeneratorSG"])
def test_baseline_iteration_matches_cpu(cuda, name, scale_idx):
    """One iteration of a CSG/SG baseline against WDiscriminatorBaselines
    on the card (TF32 off) equals the same iteration on the CPU from the
    same weights, Z_init and draws, at scales 1 and 3 (a baseline trains
    every scale as a GAN)."""
    cfg = Config(nfc=8, num_layer=2, img_size=32, min_size=16, max_size=32,
                 max_frames=5, sampling_rates=[2, 1], hflip=True,
                 batch_size=2, generator=name,
                 discriminator="WDiscriminatorBaselines").finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm = 24.0, 0.75, 2  # synthetic.avi's
    k1.fused_upscale_noise_2d.launches = 0
    errs = compare_devices(cfg, scale_idx, seed=0, device=cuda, ndim=3,
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
    the same draws, in both BatchNorm modes, and launches no kernel."""
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
    k1.fused_upscale_noise_2d.launches = 0
    diff = compare_sampler_devices(cfg, gen, 3, train, seed=0, device=cuda)
    assert diff <= 1e-4
    assert k1.fused_upscale_noise_2d.launches == 0


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
    off, deterministic cuDNN): netG within 1e-6, the amps equal. Chunks of
    one iteration (the per-iteration cadence, inflight at 2, killed at 3):
    on the card each chunk after the first replays the captured
    iteration once."""
    from hpvaegan_tpu_torch import train_image

    tiny = TINY + ["--steps-per-call", "1"]

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    ref = train_image.main(tiny + ["--run-dir", str(tmp_path / "a")])
    made = []
    run_training = trainer.run_training

    def killed(cfg, saver, *a, **kw):
        made.append(saver.experiment_dir)
        return run_training(cfg, saver, *a, step_callback=_kill_at(4, 3),
                            **kw)

    monkeypatch.setattr(trainer, "run_training", killed)
    with pytest.raises(_Killed):
        train_image.main(tiny + ["--run-dir", str(tmp_path / "b")])
    monkeypatch.setattr(trainer, "run_training", run_training)
    resumed = train_image.main(tiny + [
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


# the training flags, card against CPU; the
# bf16 bound is the card's cuDNN bf16 convolutions against oneDNN's, whose
# one-ulp rounding differences the bf16 chain spreads (as between the port
# and the JAX package on the CPU, tests/test_torch_flags.py): measured on
# an H100 at these seeds, metrics 2.1e-5 of max(|metric|, 1) (d_loss, a
# small difference of larger terms, moves 10% of itself), gradients
# 3.9e-3 (one bf16 ulp at 0.5-1), state 9.5e-6
BF16_CARD_TOL = {"metrics_scaled": 1e-3, "grads_abs": 2e-2,
                 "state_abs": 1e-4}


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
    cfg = flag_cfg(ndim, generator, **flags)
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


@pytest.mark.parametrize("ndim", [2, 3])
def test_samples_reach_the_host_in_pinned_blocks(cuda, ndim):
    """generate_samples on the card (parallel/sampling.py::_host_copy): its
    array equals a plain .cpu() copy of the sampler's niter batches from
    the same draws, bit for bit, and lies in pinned memory; two arrays held
    at once share no memory, and the first is unchanged by the second
    call; over a loop that drops its arrays, every byte goes through the
    pinned path and the host allocator makes no block from the third call
    on."""
    from hpvaegan_tpu_torch.evaluation import eval_z_tail
    from hpvaegan_tpu_torch.parallel import sampling
    from hpvaegan_tpu_torch.utils import profiling
    from hpvaegan_tpu_torch.utils.noise import NoiseSource

    cfg = Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
                 min_size=16, max_size=32, vae_levels=2, niter=2,
                 num_samples=3, sampling_rates=[2, 1]).finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm, cfg.td = 24.0, 0.75, 2, 3
    cfg.Noise_Amps = [1.0] + [0.3] * cfg.stop_scale
    gen = (GeneratorHPVAEGAN if ndim == 2 else GeneratorHPVAEGAN3D)(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage(torch.Generator().manual_seed(0))
    gen = gen.to(cuda)
    sample = sampling.sharded_sampler(cfg, gen, ndim,
                                      z_tail=eval_z_tail(cfg, ndim))
    noise = NoiseSource(5, cuda)
    want = [sample(3, noise).movedim(1, -1).cpu().numpy() for _ in range(2)]
    got = generate_samples(cfg, gen, ndim, noise=NoiseSource(5, cuda))
    np.testing.assert_array_equal(got, np.concatenate(want))
    assert got.flags.c_contiguous
    assert torch.from_numpy(got).is_pinned()

    first = got.copy()
    other = generate_samples(cfg, gen, ndim, noise=NoiseSource(6, cuda))
    assert not np.shares_memory(got, other)
    np.testing.assert_array_equal(got, first)
    assert not np.array_equal(got, other)
    del got, other

    profiling.enable(True)
    try:
        seen = []
        for i in range(5):
            profiling.reset()
            generate_samples(cfg, gen, ndim, noise=NoiseSource(7 + i, cuda))
            seen.append(profiling.counters())
    finally:
        profiling.enable(False)
        profiling.reset()
    for i, c in enumerate(seen):
        assert c["d2h_pinned_bytes"] == c["d2h_bytes"] == first.nbytes, i
        assert c["d2h_host_allocs"] == 0 or i < 2, (i, c)


@pytest.mark.parametrize("ndim,batch", [(2, 2), (3, 1)])
def test_serving_module_matches_cpu(cuda, monkeypatch, ndim, batch):
    """The serving forward (export/serving.py::ServingModule: the keyed
    draws of utils/jax_prng.py, per-sample BatchNorm) on the card (TF32
    off) equals the CPU's from the same weights, noise and seed within
    1e-4, and so does its ExportedProgram on the card."""
    from hpvaegan_tpu_torch.export import serving

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = flag_cfg(ndim)
    gen = get_generator(cfg.generator, ndim)(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage()
    init_weights_(gen, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    specs = serving.serving_input_specs(cfg, ndim, batch)
    z = torch.from_numpy(rng.standard_normal(specs[0].shape)
                         .astype(np.float32))
    amps = torch.from_numpy(rng.uniform(0.1, 1.0, specs[1].shape)
                            .astype(np.float32))
    seed = torch.tensor(7, dtype=torch.int32)
    with torch.no_grad():
        want = serving.ServingModule(gen)(z, amps, seed)
    program = serving.export_sampler(cfg, gen, ndim, batch)
    with torch.no_grad():
        got = serving.ServingModule(gen)(
            z.to(cuda), amps.to(cuda), seed.to(cuda)).cpu()
    exported = serving.run_serialized(program, z, amps, seed).cpu()
    assert float((got - want).abs().max()) <= 1e-4
    assert float((exported - got).abs().max()) <= 1e-4


def test_trace_on_the_card_holds_its_kernels(cuda, tmp_path):
    """utils/profiling.py::trace on the card (the train CLIs'
    --profile-dir) records the profiler's CUDA activity: its trace.json
    holds the block's kernels beside its operators."""
    from hpvaegan_tpu_torch.utils import profiling

    x = torch.randn(2, 3, 16, 16, device=cuda)
    w = torch.randn(4, 3, 3, 3, device=cuda)
    with profiling.trace(str(tmp_path), cuda):
        float(torch.nn.functional.conv2d(x, w).sum())
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::conv2d" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)


# ------------------------------------------------- the training chunk ---

@pytest.mark.parametrize("ndim,generator,flags,scale_idx", [
    (2, "GeneratorHPVAEGAN", {}, 3),
    (3, "GeneratorHPVAEGAN", {}, 3),
    (2, "GeneratorHPVAEGAN", {}, 1),
    (3, "GeneratorHPVAEGAN", {}, 1),
    (3, "GeneratorCSG", {}, 3),
    (2, "GeneratorHPVAEGAN", dict(compute_dtype="bfloat16", fused_dg=True,
                                  flat_opt=True), 3)])
def test_graph_chunk_equals_eager_iterations(cuda, monkeypatch, ndim,
                                             generator, flags, scale_idx):
    """Chunks of 3 and 4 iterations (the first eager on the capture
    stream, then 4 replays of the captured iteration) end bit for bit as
    7 --split-step eager iterations from the same weights and seed (TF32
    off, deterministic cuDNN), at a GAN scale (3) and a VAE scale (1): G's
    and D's parameters and buffers, both optimizers' states (the step
    counts on the card) and the NoiseSource's state, whose device
    generator the replays advance."""
    from hpvaegan_tpu_torch.training import chunk

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = flag_cfg(ndim, generator, **flags)
    disc = cfg.discriminator if generator == "GeneratorCSG" else ""
    graph_st, graph = make_chunk(cfg, ndim, False, cuda, generator, disc,
                             scale_idx)
    eager_st, eager = make_chunk(cfg, ndim, True, cuda, generator, disc,
                             scale_idx)
    assert (graph.mode, eager.mode) == ("graph", "eager (split-step)")
    captures, replays = chunk.captures, chunk.replays
    graph.run(3)
    got = graph.run(4)
    for _ in range(7):
        want = eager.run(1)
    assert (chunk.captures - captures, chunk.replays - replays) == (1, 4)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a, b = chunk_state(graph_st), chunk_state(eager_st)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k
    steps = [s["step"] for s in graph_st.opt_g.state.values()]
    assert steps and all(t.device.type == "cuda" and float(t) == 7
                         for t in steps)
    graph.close()


@pytest.mark.parametrize("ndim", [2, 3])
def test_captured_phases_tile_the_replay(cuda, ndim):
    """With the program's phases on while the chunk captures its
    iteration, every replay records the phases' events again: after a
    replay each phase of training/steps.py::PHASES reads its device ms
    (positive, but for the exchanges, which hold no work without a
    group), and their sum is within 5% of the replay's own event-timed
    length."""
    from hpvaegan_tpu_torch.training.steps import PHASES
    from hpvaegan_tpu_torch.utils import profiling

    profiling.enable(True)
    try:
        _, chunk = make_chunk(flag_cfg(ndim), ndim, False, cuda)
        chunk.run(2)  # eager
        chunk.run(1)  # the capture, then a replay
        assert chunk.graph is not None
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        chunk.graph.replay()
        end.record()
        got = chunk.phase_ms()
        total = start.elapsed_time(end)
    finally:
        profiling.enable(False)
        profiling.reset()
    chunk.close()
    assert list(got) == list(PHASES)
    assert all(v > 0 for k, v in got.items() if not k.endswith("exchange"))
    assert all(v >= 0 for v in got.values()), got
    assert abs(sum(got.values()) - total) <= 0.05 * total, (got, total)


@pytest.mark.parametrize("generator", ["GeneratorHPVAEGAN", "GeneratorCSG"])
def test_captured_3d_iteration_is_channels_last(cuda, monkeypatch,
                                                generator):
    """A captured iteration of the tiny 3D HP-VAE-GAN and CSG hands cuDNN
    channels-last operands only: the capture counts every 3D convolution
    the eager iteration counts under `conv.ndhwc` (ops/conv.py) and none
    under `conv.ncdhw`; and its replays end bit for bit as the eager
    iterations (TF32 off, deterministic cuDNN), as the chunk test above
    holds it."""
    from hpvaegan_tpu_torch.utils import profiling

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = flag_cfg(3, generator)
    disc = cfg.discriminator if generator == "GeneratorCSG" else ""
    counts = []
    profiling.enable(True)
    try:
        graph_st, graph = make_chunk(cfg, 3, False, cuda, generator, disc)
        eager_st, eager = make_chunk(cfg, 3, True, cuda, generator, disc)
        for run in (lambda: graph.run(1), lambda: graph.run(2)):
            profiling.reset()
            got = run()
            counts.append(profiling.counters())
        for _ in range(3):
            want = eager.run(1)
    finally:
        profiling.enable(False)
        profiling.reset()
    assert graph.graph is not None
    eager_counts, capture_counts = counts
    assert "conv.ncdhw" not in eager_counts
    assert "conv.ncdhw" not in capture_counts
    assert capture_counts["conv.ndhwc"] == eager_counts["conv.ndhwc"] > 50
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a, b = chunk_state(graph_st), chunk_state(eager_st)
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k
    graph.close()


def _d_step_on(device, cfg, ndim, real, fake, alpha):
    """Two D steps of a scale-3 state from seed 0 on `device`, the first at
    learning rate 0 (so that the second starts from the built weights; on
    the card it is also the warm-up a capture needs), the second captured
    as a CUDA graph and replayed on the card, eager on the CPU. Returns the
    second step's metrics, D's gradients and buffers, and on the card the
    `conv.wgrad2` count after the capture and after the replay."""
    from hpvaegan_tpu_torch.tools.step_parity import ReplayedNoise, build_state
    from hpvaegan_tpu_torch.training.steps import d_step
    from hpvaegan_tpu_torch.utils import profiling

    st = build_state(cfg, 3, 0, device, ndim)
    st.noise = ReplayedNoise([alpha, alpha], device)
    real, fake = real.to(device), fake.to(device)

    def step():
        return d_step(cfg, st, real, None, None, fake=fake)

    lrs = [g["lr"] for g in st.opt_d.param_groups]
    for g in st.opt_d.param_groups:
        g["lr"] = 0.0
    counts = None
    if device.type == "cuda":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
    else:
        step()
    for g, lr in zip(st.opt_d.param_groups, lrs):
        g["lr"] = lr
    if device.type == "cuda":
        graph = torch.cuda.CUDAGraph()
        profiling.reset()
        profiling.enable(True)
        try:
            with torch.cuda.graph(graph):
                metrics = step()
            captured = profiling.counters().get("conv.wgrad2")
            graph.replay()
            counts = (captured, profiling.counters().get("conv.wgrad2"))
        finally:
            profiling.enable(False)
            profiling.reset()
        torch.cuda.synchronize()
    else:
        metrics = step()
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.cpu() for k, p in st.D.named_parameters()},
            {k: b.cpu() for k, b in st.D.named_buffers()}, counts,
            sum(isinstance(m, (Conv, SNConv)) for m in st.D.modules()))


@pytest.mark.parametrize("ndim", [2, 3])
def test_captured_d_step_matches_cpu(cuda, monkeypatch, ndim):
    """A D step (the gradient penalty's double backward through
    ops/conv.py's `_Conv`) captured as a CUDA graph and replayed on the
    card (TF32 off) equals the same step eager on the CPU from the same
    weights, data and GP alpha, within test_training_iteration_matches_cpu's
    bars; the capture counts one second-order weight gradient
    (`conv.wgrad2`) per critic convolution, and the replay none."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(flag_cfg(ndim), scale_idx=3)
    gen = torch.Generator().manual_seed(1)
    shape = (2, cfg.nc_im) + ((cfg.max_frames,) if ndim == 3 else ()) \
        + tuple(scale_size_2d(3, cfg.scale_factor, cfg.stop_scale,
                              cfg.img_size, cfg.ar))
    real, fake = (torch.rand(shape, generator=gen) * 2 - 1 for _ in "ab")
    alpha = torch.rand((), generator=gen)
    card = _d_step_on(cuda, cfg, ndim, real, fake, alpha)
    host = _d_step_on(torch.device("cpu"), cfg, ndim, real, fake, alpha)
    convs = card[4]
    assert convs == cfg.num_layer + 2 and card[3] == (convs, convs)
    for k, want in host[0].items():
        assert abs(card[0][k] - want) <= 1e-4 * max(abs(want), 1.0), k
    for got, want in ((card[1], host[1]), (card[2], host[2])):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.allclose(got[k], want[k], rtol=0, atol=1e-4), k


def test_graph_run_with_images_equals_eager_run(cuda, tmp_path, monkeypatch):
    """train_image --steps-per-call 2 --visualize --image-interval 2 on the
    card as graph replays ends bit for bit as the same run with every
    chunk an eager loop (TF32 off, deterministic cuDNN): netG_4, the
    generators' states in torch_rng_4.pt and every image. The images are
    drawn eagerly between the replays, so they continue the stream that
    the replays advanced, and the chunks after them draw on from there."""
    from hpvaegan_tpu_torch import train_image
    from hpvaegan_tpu_torch.training import chunk

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    args = TINY + ["--steps-per-call", "2", "--visualize",
                   "--image-interval", "2"]
    captures = chunk.captures
    graph = train_image.main(args + ["--run-dir", str(tmp_path / "g")])
    assert chunk.captures - captures == 5  # one a scale

    def eager(self, k):
        for _ in range(k):
            metrics = self.iteration()
        return metrics

    monkeypatch.setattr(chunk.TrainChunk, "run", eager)
    ref = train_image.main(args + ["--run-dir", str(tmp_path / "e")])

    def load(exp, name):
        with open(os.path.join(exp, name), "rb") as f:
            return pickle.load(f) if name.endswith(".ckpt") else f.read()

    assert _max_diff(load(graph, "netG_4.ckpt"), load(ref, "netG_4.ckpt")) \
        == 0
    rng_g = torch.load(os.path.join(graph, "torch_rng_4.pt"))
    rng_e = torch.load(os.path.join(ref, "torch_rng_4.pt"))
    for k in ("device", "host"):
        assert torch.equal(rng_g["noise"][k], rng_e["noise"][k]), k
    names = sorted(os.listdir(os.path.join(graph, "img")))
    assert names and names == sorted(os.listdir(os.path.join(ref, "img")))
    for name in names:
        assert load(os.path.join(graph, "img"), name) == \
            load(os.path.join(ref, "img"), name), name


@pytest.mark.parametrize("fault", ["host_read", "host_draw"])
def test_failed_capture_raises(cuda, monkeypatch, fault):
    """An iteration that reads a value to the host (which capture cannot
    record) or draws from the host generator (which a replay would not
    draw again) makes the second chunk raise, naming the scale; nothing
    continues eagerly."""
    from hpvaegan_tpu_torch.training import chunk

    iteration = chunk.train_iteration

    def faulty(cfg, st, *a, **kw):
        metrics = iteration(cfg, st, *a, **kw)
        if fault == "host_read":
            float(metrics["g_loss"])
        else:
            st.noise.seed()
        return metrics

    monkeypatch.setattr(chunk, "train_iteration", faulty)
    _, graph = make_chunk(flag_cfg(2), 2, False, cuda)
    graph.run(2)
    with pytest.raises(RuntimeError, match="scale 3: (capturing the "
                       "training iteration|the captured iteration drew)"):
        graph.run(2)
    assert graph.graph is None
    torch.cuda.synchronize()


def test_optimizers_keep_the_step_on_the_card(cuda):
    """On the card every optimizer is capturable, its step count a float32
    tensor on the card, and 5 steps equal the CPU's (host step count) to
    1e-6; a state written with the step on the host loads onto the card."""
    import copy

    from hpvaegan_tpu_torch import optim

    rng = np.random.RandomState(0)
    start = [rng.randn(*s).astype(np.float32)
             for s in ((4, 3, 3, 3), (5,), (2, 6))]
    grads = [[(rng.randn(*a.shape) * 40).astype(np.float32) for a in start]
             for _ in range(5)]

    def build(kind, device):
        p = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(device))
             for a in start]
        if kind == "clipped":
            return p, optim.ClippedAdam([{"params": p, "lr": 5e-4}], 0.5)
        if kind == "plain":
            return p, optim.adam(p, 5e-4, 0.5)
        return p, optim.FlatAdam(p, 0.5, grad_clip=5.0, lr=5e-4)

    def steps(p, opt, gs):
        for g in gs:
            for t, a in zip(p, g):
                t.grad = torch.from_numpy(a.copy()).to(t.device)
            opt.step()

    for kind in ("clipped", "plain", "flat"):
        (pc, oc), (ph, oh) = build(kind, cuda), build(kind, "cpu")
        steps(pc, oc, grads[:2])
        steps(ph, oh, grads[:2])
        loaded_p, loaded = build(kind, cuda)
        with torch.no_grad():
            for t, h in zip(loaded_p, ph):
                t.copy_(h)
        optim.load_optimizer_state(loaded, copy.deepcopy(oh.state_dict()))
        for p, opt in ((pc, oc), (loaded_p, loaded)):
            steps(p, opt, grads[2:])
            assert all(s["step"].device.type == "cuda"
                       and s["step"].dtype == torch.float32
                       and float(s["step"]) == 5
                       for s in opt.state.values())
            if kind != "flat":
                assert all(g["capturable"] for g in opt.param_groups)
        steps(ph, oh, grads[2:])
        for a, b, h in zip(pc, loaded_p, ph):
            np.testing.assert_allclose(a.detach().cpu().numpy(),
                                       h.detach().numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(b.detach().cpu().numpy(),
                                       h.detach().numpy(), rtol=0, atol=1e-6)
