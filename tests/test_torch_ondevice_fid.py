"""The port's on-device SIFID / SVFID (parallel/sampling.py, the eval CLIs'
--on-device-fid) held against the JAX package's on the CPU.

Weights are the JAX package's, perturbed with numpy (the generators of
tests/test_torch_sampling.py and tests/test_torch_video.py); the metric
features are both packages' default init, which agree bit for bit. Every
draw the JAX sampler makes from its key (z, then each sample's refinement
noise from its own vmapped key) is reproduced here and replayed into the
port (tools/step_parity.py::ReplayedNoise). Tolerances: the per-sample
statistics at rtol 1e-4 / atol 2e-5 (per op); the samples at atol 1e-4
(a multi-scale generator); the per-sample distances and their mean at rtol
1e-3 (sqrtm amplifies the statistics' float32 differences).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu.parallel import sampling as jsampling
from hpvaegan_tpu.parallel.mesh import make_mesh
from hpvaegan_tpu.utils.pyramid import scale_size_2d

from hpvaegan_tpu_torch import eval_image as timage_cli
from hpvaegan_tpu_torch import eval_video as tvideo_cli
from hpvaegan_tpu_torch import evaluation as teval
from hpvaegan_tpu_torch.parallel import sampling as tsampling
from hpvaegan_tpu_torch.tools.step_parity import ReplayedNoise
from hpvaegan_tpu_torch.utils.noise import NoiseSource

import test_torch_sampling as s2
import test_torch_video as s3

torch.set_num_threads(1)

STATS_TOL = dict(rtol=1e-4, atol=2e-5)
GEN_TOL = dict(rtol=0, atol=1e-4)
FID_TOL = dict(rtol=1e-3)


def _draws_2d(cfg, key, batch):
    """jax sharded_sampler's draws in 2D train mode (parallel/sampling.py:
    66-82, networks_2d.py:232-270): z from the first split; each sample's
    key splits into (kz, kr), kr once per stage."""
    kn, kf = jax.random.split(key)
    z = np.asarray(jax.random.normal(kn, (batch,) + teval.eval_z_tail(cfg)))
    per = []
    for k in jax.random.split(kf, batch):
        kr = jax.random.split(k)[1]
        stages = []
        for idx in range(cfg.stop_scale):
            kr, sub = jax.random.split(kr)
            h, w = scale_size_2d(idx + 1, cfg.scale_factor, cfg.stop_scale,
                                 cfg.img_size, cfg.ar)
            stages.append(np.asarray(jax.random.normal(sub, (1, h, w, 3))))
        per.append(stages)
    return [torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
            for a in [z] + [np.concatenate(s) for s in zip(*per)]]


def _draws_3d(cfg, key, batch):
    """The same in 3D: refinement noise only where vae_levels <= idx + 1
    (networks_3d.py:226-231)."""
    kn, kf = jax.random.split(key)
    z = np.asarray(jax.random.normal(kn, (batch,) + teval.eval_z_tail(cfg, 3)))
    per = [s3._refinement_draws(cfg, jax.random.split(k)[1], 1)
           for k in jax.random.split(kf, batch)]
    return [s3._ncdhw(a) for a in [z] + [np.concatenate(s)
                                        for s in zip(*per)]]


@pytest.mark.parametrize("shape", [(3, 7, 9, 64), (2, 3, 5, 6, 64),
                                   (4, 1, 1, 2048)])
def test_per_sample_stats_match_jax(shape):
    """float32 mu and sigma = centered^T centered / (n - 1) per sample;
    JAX features are channels-last, the port's channels-first."""
    feats = np.random.RandomState(len(shape)).randn(*shape).astype(
        np.float32)
    mu_j, sig_j = jsampling._per_sample_stats(feats)
    mu_t, sig_t = tsampling._per_sample_stats(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(feats, -1, 1))))
    assert mu_t.dtype == sig_t.dtype == torch.float32
    assert tuple(sig_t.shape) == (shape[0], shape[-1], shape[-1])
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **STATS_TOL)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), **STATS_TOL)


def _image_setup():
    cj, ct = s2._cfgs()
    for c in (cj, ct):
        c.Noise_Amps = s2.AMPS
        c.scale_idx = c.stop_scale
    params, state = s2._jax_generator(cj, seed=6)
    real = s2._smooth_images(7, 1, size=40)[0].astype(np.float32) / 255
    return cj, ct, params, state, real


def test_sampled_sifid_matches_jax():
    cj, ct, params, state, real = _image_setup()
    key = jax.random.PRNGKey(11)
    want, want_k = jsampling.sampled_sifid(cj, params, state, real, 5, key,
                                           mesh=make_mesh(1),
                                           return_samples=2)
    noise = ReplayedNoise(_draws_2d(cj, key, 5), "cpu")
    gen = s2._port_generator(ct, params, state)
    got, got_k = tsampling.sampled_sifid(ct, gen, real, 5, noise,
                                         return_samples=2)
    assert not noise.drawn
    assert got_k.shape == np.asarray(want_k).shape == (2, 33, 33, 3)
    np.testing.assert_allclose(got_k, np.asarray(want_k), **GEN_TOL)
    assert len(got) == 5 and all(np.isfinite(got)) and min(got) > 0
    np.testing.assert_allclose(got, want, **FID_TOL)
    # without return_samples: the values only
    again = tsampling.sampled_sifid(
        ct, gen, real, 5, ReplayedNoise(_draws_2d(cj, key, 5), "cpu"))
    np.testing.assert_allclose(again, got, rtol=1e-6)


def test_sampled_svfid_matches_jax():
    cj, ct = s3._cfgs()
    for c in (cj, ct):
        c.Noise_Amps = s3.AMPS
        c.scale_idx = c.stop_scale
        c.td = s3._stage_thw(c, c.stop_scale)[0]
    params, state = s3._jax_generator(cj, seed=8)
    real = s3._smooth_videos(9, 1)[0]
    key = jax.random.PRNGKey(12)
    z_tail = teval.eval_z_tail(ct, 3)
    want, want_k = jsampling.sampled_svfid(cj, params, state, real, 3, key,
                                           mesh=make_mesh(1), z_tail=z_tail,
                                           return_samples=3)
    noise = ReplayedNoise(_draws_3d(cj, key, 3), "cpu")
    gen = s3._port_generator(ct, params, state)
    got, got_k = tsampling.sampled_svfid(ct, gen, real, 3, noise,
                                         z_tail=z_tail, return_samples=3)
    assert not noise.drawn
    assert got_k.shape == np.asarray(want_k).shape == (3, 3, 24, 33, 3)
    np.testing.assert_allclose(got_k, np.asarray(want_k), **GEN_TOL)
    assert all(np.isfinite(got)) and min(got) > 0
    np.testing.assert_allclose(got, want, **FID_TOL)


@pytest.mark.parametrize("ndim", [2, 3])
def test_sub_batches_give_the_same_values(monkeypatch, ndim):
    """The features and statistics run per sampler sub-batch: with the
    element cap lowered so that 5 samples run as 3 forwards, the values and
    the kept samples equal one forward's (at amps 0 after scale 0 only z
    matters, drawn once before the split)."""
    if ndim == 2:
        cj, ct = s2._cfgs()
        params, state = s2._jax_generator(cj, seed=2)
        gen = s2._port_generator(ct, params, state)
        real = s2._smooth_images(3, 1, size=40)[0].astype(np.float32) / 255
        run = tsampling.make_sampled_sifid
    else:
        cj, ct = s3._cfgs()
        ct.td = s3._stage_thw(ct, ct.stop_scale)[0]
        params, state = s3._jax_generator(cj, seed=2)
        gen = s3._port_generator(ct, params, state)
        real = s3._smooth_videos(3, 1)[0]
        run = tsampling.make_sampled_svfid
    ct.Noise_Amps = [1.0] + [0.0] * ct.stop_scale
    ct.scale_idx = ct.stop_scale
    z_tail = teval.eval_z_tail(ct, ndim)
    one = run(ct, gen, real, z_tail=z_tail)(5, NoiseSource(0, "cpu"), 4)
    per = tsampling.generator_elements(ct, gen, ndim, z_tail)
    monkeypatch.setattr(tsampling, "MAX_ELEMENTS", 2 * per)
    assert len(tsampling.sub_batches(5, per)) == 3
    split = run(ct, gen, real, z_tail=z_tail)(5, NoiseSource(0, "cpu"), 4)
    # convolutions of another batch size may sum in another order
    np.testing.assert_allclose(split[1], one[1], **GEN_TOL)
    np.testing.assert_allclose(split[0], one[0], **FID_TOL)
    assert split[1].shape[0] == 4


def _jax_eval(evaluate, exp, **kw):
    """The JAX package's eval with --on-device-fid on `exp`, 8 samples over
    its default 8-device mesh."""
    cfg = jeval.hydrate_config(str(exp), dict(
        niter=1, num_samples=8, max_samples=3, batch_size=1, data_rep=1,
        save_path="images", scale_idx=-1, on_device_fid=True, netG="", **kw))
    value, saver = evaluate(cfg, str(exp), seed=4)
    return value, np.load(os.path.join(saver.eval_dir, "random_samples.npy"))


def _check_artifacts(exp, metric, value, want_samples, names):
    ev = exp / "eval"
    samples = np.load(ev / "random_samples.npy")
    assert samples.shape == want_samples.shape and samples.shape[0] == 3
    np.testing.assert_allclose(samples, want_samples, **GEN_TOL)
    assert sorted(os.listdir(ev / "images")) == names
    rec = json.loads((ev / "metrics.json").read_text())
    assert rec["metric"] == metric and rec["value"] == value
    assert rec["on_device_fid"] is True and rec["num_samples"] == 8


def test_eval_image_on_device_fid_matches_jax(tmp_path, capsys):
    """eval_image_experiment(on_device_fid) on one JAX-format experiment:
    the JAX package's score, artifacts and metrics.json; then the CLI flag
    on the CPU."""
    exp = s2._write_experiment(tmp_path)
    want, want_samples = _jax_eval(jeval.eval_image_experiment, exp)
    cfg = teval.hydrate_config(str(exp), dict(
        niter=1, num_samples=8, max_samples=3, batch_size=1, data_rep=1,
        save_path="images", scale_idx=-1, on_device_fid=True, netG=""))
    draws = _draws_2d(cfg_j(exp), jax.random.PRNGKey(4), 8)
    noise = ReplayedNoise(draws, "cpu")
    got, _ = teval.eval_image_experiment(cfg, str(exp), device="cpu",
                                         noise=noise)
    assert not noise.drawn
    np.testing.assert_allclose(got, want, **FID_TOL)
    _check_artifacts(exp, "SIFID", got, want_samples,
                     ["fake_0.png", "fake_1.png", "fake_2.png"])
    timage_cli.main(["--exp-dir", str(exp), "--device", "cpu",
                     "--num-samples", "4", "--max-samples", "2",
                     "--on-device-fid"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SIFID: ")]
    rec = json.loads((exp / "eval" / "metrics.json").read_text())
    assert len(line) == 1 and float(line[0].split()[1]) == rec["value"]
    assert rec["on_device_fid"] is True and rec["num_samples"] == 4
    assert np.load(exp / "eval" / "random_samples.npy").shape[0] == 2


def cfg_j(exp):
    """The JAX package's config of `exp` at its saved scale."""
    cfg = jeval.hydrate_config(str(exp), dict(scale_idx=-1, netG=""))
    cfg.scale_idx = cfg.stop_scale
    return cfg


def test_eval_video_on_device_fid_matches_jax(tmp_path, capsys):
    """The same for eval_video_experiment: z at the eval scale's time
    depth, the real side the strided window of the saved scale."""
    exp = s3._write_experiment(tmp_path)
    want, want_samples = _jax_eval(jeval.eval_video_experiment, exp)
    cfg = teval.hydrate_config(str(exp), dict(
        niter=1, num_samples=8, max_samples=3, batch_size=1, data_rep=1,
        save_path="images", scale_idx=-1, on_device_fid=True, netG=""))
    cj = cfg_j(exp)
    cj.td = s3._stage_thw(cj, cj.stop_scale)[0]
    noise = ReplayedNoise(_draws_3d(cj, jax.random.PRNGKey(4), 8), "cpu")
    got, _ = teval.eval_video_experiment(cfg, str(exp), device="cpu",
                                         noise=noise)
    assert not noise.drawn
    np.testing.assert_allclose(got, want, **FID_TOL)
    _check_artifacts(exp, "SVFID", got, want_samples,
                     ["fake.gif", "fake_unfold.png", "real.gif",
                      "real_unfold.png"])
    tvideo_cli.main(["--exp-dir", str(exp), "--device", "cpu",
                     "--num-samples", "2", "--on-device-fid"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SVFID: ")]
    rec = json.loads((exp / "eval" / "metrics.json").read_text())
    assert len(line) == 1 and float(line[0].split()[1]) == rec["value"]
    assert rec["on_device_fid"] is True and rec["num_samples"] == 2
