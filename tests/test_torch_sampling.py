"""The port's sampling slice held against the JAX package on the CPU: the
generator's random-mode forward, `generate_samples` in both BatchNorm modes
(train=False runs kernel K1 through its plain version), SIFID, the eval
CLI, and the port's independence from JAX.

Weights are the JAX package's, perturbed with numpy, and cross through
tools/convert.py::from_jax. Every draw the JAX package makes (z_init, the
per-stage refinement noise) is reproduced from its key splits here and
handed to the port through an injected NoiseSource. Tolerance for the
multi-scale generator and sampler is atol 1e-4: float32 convolutions sum in
another order, over up to 5 scales of conv stacks.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hpvaegan_tpu import config as jcfg
from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu.metrics import fid as jfid
from hpvaegan_tpu.metrics import inception as jinception
from hpvaegan_tpu.models import networks_2d as jnet
from hpvaegan_tpu.utils.pyramid import scale_size_2d

from hpvaegan_tpu_torch import config as tcfg
from hpvaegan_tpu_torch import eval_image as teval_cli
from hpvaegan_tpu_torch import evaluation as teval
from hpvaegan_tpu_torch.metrics import fid as tfid
from hpvaegan_tpu_torch.metrics import inception as tinception
from hpvaegan_tpu_torch.models import get_generator
from hpvaegan_tpu_torch.models.networks_2d import GeneratorHPVAEGAN
from hpvaegan_tpu_torch.parallel import sampling as tsampling
from hpvaegan_tpu_torch.tools.convert import from_jax, to_jax
from hpvaegan_tpu_torch.utils.device import resolve_device
from hpvaegan_tpu_torch.utils.noise import NoiseSource

torch.set_num_threads(1)

GEN_TOL = dict(rtol=0, atol=1e-4)  # multi-scale generator / sampler
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
           min_size=16, max_size=32, vae_levels=2)  # 5 scales, 17 -> 33
AMPS = [1.0, 0.3, 0.2, 0.1, 0.05]


def _cfgs(**kw):
    j = jcfg.Config(**{**CFG, **kw}).finalize()
    t = tcfg.Config(**{**CFG, **kw}).finalize()
    return j, t


def _jax_generator(cfg, seed=0):
    """JAX init at scale stop_scale, every leaf perturbed so that stages
    differ and BatchNorm moving stats are not (0, 1)."""
    params, state = jnet.generator_hpvaegan_init(cfg, jax.random.PRNGKey(seed))
    for k in range(cfg.stop_scale):
        params, state = jnet.generator_init_next_stage(
            cfg, params, state, jax.random.PRNGKey(seed + 1 + k))
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = str(path[-1])
        if "var" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if "mean" in name:
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if "'u'" in name or "'v'" in name:
            return a
        return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(perturb, params),
            jax.tree_util.tree_map_with_path(perturb, state))


def _port_generator(tcfg_, params, state):
    gen = GeneratorHPVAEGAN(tcfg_)
    for _ in range(len(params["body"])):
        gen.init_next_stage()
    gen.load_state_dict(from_jax(params, state))
    return gen


class InjectedNoise(NoiseSource):
    """Hands out given normals (NHWC numpy, handed over as NCHW) in order,
    and all-zero words for K1, as the JAX kernel draws in interpret mode.
    With zeros_after, draws past the given ones are zeros (for noise that
    amp 0 scales away)."""

    def __init__(self, normals_nhwc, zeros_after=False):
        super().__init__(0, "cpu")
        self.normals = [np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                        for a in normals_nhwc]
        self.zeros_after = zeros_after
        self.kernel_calls = 0

    def normal(self, shape):
        if not self.normals and self.zeros_after:
            return torch.zeros(tuple(shape))
        a = self.normals.pop(0)
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        return torch.from_numpy(a)

    def kernel_bits(self, shape):
        self.kernel_calls += 1
        z = torch.zeros(tuple(shape), dtype=torch.int32)
        return z, z


def _jax_z_draws(cfg, seed, niter, batch):
    """The z_init of jax generate_samples: evaluation.py:150-158 then
    parallel/sampling.py:68-70."""
    h0, w0 = scale_size_2d(0, cfg.scale_factor, cfg.stop_scale, cfg.img_size,
                           cfg.ar)
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(niter):
        key, ks = jax.random.split(key)
        kn, _ = jax.random.split(ks)
        out.append(np.asarray(jax.random.normal(
            kn, (batch, h0, w0, cfg.latent_dim))))
    return out


# ---------------------------------------------------------- generator ---

def test_generator_random_forward_matches_jax():
    """Batch-statistics BatchNorm, non-zero amps, the JAX package's per-stage
    noise; also the moving stats the forward folds."""
    cj, ct = _cfgs()
    params, state = _jax_generator(cj, seed=1)
    z = np.random.RandomState(2).randn(2, 17, 17, 8).astype(np.float32)
    key = jax.random.PRNGKey(7)
    (x_j, vae_j, _, _), new_state = jnet.generator_hpvaegan_apply(
        cj, params, state, amps=jnp.asarray(AMPS + [0.0], jnp.float32),
        noise_init=jnp.asarray(z), key=key, is_random=True, train=True)

    _, k = jax.random.split(key)
    noises = []
    for idx in range(cj.stop_scale):
        k, sub = jax.random.split(k)
        h, w = scale_size_2d(idx + 1, cj.scale_factor, cj.stop_scale,
                             cj.img_size, cj.ar)
        noises.append(np.asarray(jax.random.normal(sub, (2, h, w, 3))))
    gen = _port_generator(ct, params, state)
    with torch.no_grad():
        x_t, vae_t = gen(torch.from_numpy(z.transpose(0, 3, 1, 2).copy()),
                         np.asarray(AMPS + [0.0], np.float32),
                         InjectedNoise(noises), bn="batch")
    np.testing.assert_allclose(vae_t.numpy().transpose(0, 2, 3, 1),
                               np.asarray(vae_j), **GEN_TOL)
    np.testing.assert_allclose(x_t.numpy().transpose(0, 2, 3, 1),
                               np.asarray(x_j), **GEN_TOL)
    _, state_t = to_jax(gen.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(state_t),
                    jax.tree_util.tree_leaves(new_state)):
        np.testing.assert_allclose(a, np.asarray(b), **GEN_TOL)


def test_init_next_stage_deep_copies():
    _, ct = _cfgs()
    gen = GeneratorHPVAEGAN(ct)
    gen.init_next_stage(torch.Generator().manual_seed(0))
    gen.init_next_stage()
    w0, w1 = gen.body[0].head.conv.weight, gen.body[1].head.conv.weight
    assert torch.equal(w0, w1) and w0.data_ptr() != w1.data_ptr()
    assert float(w0.detach().std()) > 0.01


# ------------------------------------------------------------ sampler ---

def test_generate_samples_fused_moving_stats_matches_jax():
    """train=False + pallas_fused_sampling with non-zero amps: JAX runs its
    Pallas kernel in interpret mode (zero bits), the port K1's plain version
    on the same zero words."""
    cj, ct = _cfgs(pallas_fused_sampling=True, niter=2, num_samples=3)
    for c in (cj, ct):
        c.Noise_Amps = AMPS
    params, state = _jax_generator(cj, seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = jeval.generate_samples(cj, params, state, ndim=2, seed=0,
                                      train_mode=False)
    noise = InjectedNoise(_jax_z_draws(cj, 0, 2, 3))
    got = teval.generate_samples(ct, _port_generator(ct, params, state),
                                 ndim=2, train_mode=False, noise=noise)
    assert noise.kernel_calls == 2 * cj.stop_scale  # K1 ran at every stage
    assert got.shape == want.shape == (6, 33, 33, 3)
    np.testing.assert_allclose(got, np.asarray(want), **GEN_TOL)


def test_generate_samples_per_sample_bn_matches_jax():
    """The CLI's default: per-sample batch statistics (the JAX vmap of
    batch-1 forwards), at amps 0 so only z_init is random."""
    cj, ct = _cfgs(niter=1, num_samples=3)
    for c in (cj, ct):
        c.Noise_Amps = [1.0, 0.0, 0.0, 0.0, 0.0]
    params, state = _jax_generator(cj, seed=4)
    want = jeval.generate_samples(cj, params, state, ndim=2, seed=5,
                                  train_mode=True)
    noise = InjectedNoise(_jax_z_draws(cj, 5, 1, 3), zeros_after=True)
    got = teval.generate_samples(ct, _port_generator(ct, params, state),
                                 ndim=2, train_mode=True, noise=noise)
    assert noise.kernel_calls == 0
    np.testing.assert_allclose(got, np.asarray(want), **GEN_TOL)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("niter", [1, 2])
def test_generate_samples_is_the_sampler_channels_last(ndim, niter):
    """generate_samples' array is C-contiguous (niter x N, H, W, C), in 3D
    (niter x N, T, H, W, C), and equals, bit for bit, the sampler's niter
    batches drawn from the same NoiseSource, moved channels-last and
    joined."""
    cfg = tcfg.Config(**{**CFG, "niter": niter, "num_samples": 3,
                         "sampling_rates": [2, 1]}).finalize()
    cfg.org_fps, cfg.ar, cfg.fps_lcm, cfg.td = 24.0, 0.75, 2, 3
    cfg.Noise_Amps = AMPS[:cfg.stop_scale + 1]
    gen = get_generator("GeneratorHPVAEGAN", ndim)(cfg)
    for _ in range(cfg.stop_scale):
        gen.init_next_stage(torch.Generator().manual_seed(0))
    got = teval.generate_samples(cfg, gen, ndim, noise=NoiseSource(5, "cpu"))
    sample = tsampling.sharded_sampler(cfg, gen, ndim,
                                       z_tail=teval.eval_z_tail(cfg, ndim))
    noise = NoiseSource(5, "cpu")
    want = torch.cat([sample(3, noise).movedim(1, -1)
                      for _ in range(niter)]).numpy()
    assert got.shape == want.shape and got.shape[0] == 3 * niter
    assert got.shape[-1] == 3 and got.ndim == ndim + 2
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- SIFID ---

def _smooth_images(seed, n, size=96):
    rng = np.random.RandomState(seed)
    base = rng.rand(n, size // 8, size // 8, 3)
    img = np.kron(base, np.ones((1, 8, 8, 1)))
    return (np.clip(img + 0.1 * rng.rand(n, size, size, 3), 0, 1) * 255
            ).astype(np.uint8)


def test_sifid_matches_jax_with_shared_weights(tmp_path):
    """One block-0 .npz fed to both packages (without one, each draws its
    own random features and the SIFIDs differ). Frechet distances of 64x64
    covariances over 22x22 positions: agreement to rtol 1e-3."""
    from PIL import Image

    npz = tmp_path / "inception_block0.npz"
    np.savez(npz, **jinception._init_params(0, seed=3))
    for name, seed, n in (("real", 1, 1), ("fake", 2, 3)):
        (tmp_path / name).mkdir()
        for i, im in enumerate(_smooth_images(seed, n)):
            Image.fromarray(im).save(tmp_path / name / f"{name}_{i}.png")
    want = jfid.calculate_SIFID(str(tmp_path / "real"), str(tmp_path / "fake"),
                                weights=str(npz))
    got = tfid.calculate_SIFID(str(tmp_path / "real"), str(tmp_path / "fake"),
                               weights=str(npz), device="cpu")
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)
    with pytest.raises(FileNotFoundError):
        tfid.calculate_SIFID(str(tmp_path / "real"), str(tmp_path / "fake"),
                             weights=str(tmp_path / "missing.npz"),
                             device="cpu")


# ----------------------------------------------------------------- CLI ---

def _write_experiment(root, seed=0):
    """An experiment dir in the JAX package's format at scale 4."""
    cj, _ = _cfgs(image_path=os.path.join(REPO, "data/imgs/air_balloons.jpg"))
    params, state = _jax_generator(cj, seed=seed)
    exp = root / "exp"
    exp.mkdir()
    cj.write_args_txt(str(exp / "args.txt"))
    (exp / "intermediate.json").write_text(json.dumps(
        {"noise_amps": AMPS, "scale_idx": cj.stop_scale}))
    with open(exp / f"netG_{cj.stop_scale}.ckpt", "wb") as f:
        pickle.dump({"params": params, "state": state}, f)
    return exp


def test_eval_image_cli_on_cpu(tmp_path, capsys):
    exp = _write_experiment(tmp_path)
    teval_cli.main(["--exp-dir", str(exp), "--device", "cpu",
                    "--num-samples", "3", "--max-samples", "2"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SIFID: ")]
    assert len(line) == 1 and np.isfinite(float(line[0].split()[1]))
    samples = np.load(exp / "eval" / "random_samples.npy")
    assert samples.shape == (3, 3, 33, 33)
    assert np.isfinite(samples).all() and np.abs(samples).max() <= 1
    assert sorted(os.listdir(exp / "eval" / "images")) == ["fake_0.png",
                                                           "fake_1.png"]
    metrics = json.loads((exp / "eval" / "metrics.json").read_text())
    assert metrics["metric"] == "SIFID" and metrics["num_samples"] == 3
    assert metrics["value"] == float(line[0].split()[1])


def test_load_generator_rejects_mismatched_checkpoints(tmp_path):
    exp = _write_experiment(tmp_path)
    _, ct = _cfgs()
    ct.experiment_dir = str(exp)
    ct.scale_idx = 3
    os.rename(exp / "netG_4.ckpt", exp / "netG_3.ckpt")
    with pytest.raises(RuntimeError, match="4 refinement stages"):
        teval.load_generator(ct, str(exp), device="cpu")
    # a .pth loads now (tests/test_torch_interop.py); an empty one fails
    # in torch.load
    (exp / "netG.pth").write_bytes(b"")
    with pytest.raises(EOFError):
        teval.load_generator(ct, str(exp), netG=str(exp / "netG.pth"),
                             device="cpu")


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    # the metrics and the noise source default to the card as well
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinception.InceptionV3([0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfid.sifid_arrays(np.zeros((1, 8, 8, 3)), np.zeros((1, 8, 8, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NoiseSource(0)


def test_port_imports_no_jax(tmp_path):
    code = (
        "import os, sys, numpy as np, torch\n"
        "from hpvaegan_tpu_torch.config import Config\n"
        "from hpvaegan_tpu_torch.evaluation import generate_samples\n"
        "from hpvaegan_tpu_torch.models.networks_2d import GeneratorHPVAEGAN\n"
        "import hpvaegan_tpu_torch.eval_image, hpvaegan_tpu_torch.metrics\n"
        "import hpvaegan_tpu_torch.tools.step_parity\n"
        "from hpvaegan_tpu_torch import train_image\n"
        "cfg = Config(nfc=4, latent_dim=4, num_layer=1, img_size=24,\n"
        "             min_size=16, max_size=24, niter=1, num_samples=2,\n"
        "             pallas_fused_sampling=True).finalize()\n"
        "cfg.Noise_Amps = [1.0] * (cfg.stop_scale + 1)\n"
        "g = GeneratorHPVAEGAN(cfg)\n"
        "for _ in range(cfg.stop_scale):\n"
        "    g.init_next_stage(torch.Generator().manual_seed(0))\n"
        "for mode in (True, False):\n"
        "    out = generate_samples(cfg, g, train_mode=mode)\n"
        "    assert out.shape[0] == 2 and np.isfinite(out).all()\n"
        "exp = train_image.main(['--image-path', 'data/imgs/air_balloons.jpg',\n"
        "    '--device', 'cpu', '--nfc', '4', '--latent-dim', '4',\n"
        "    '--num-layer', '1', '--enc-blocks', '1', '--niter', '1',\n"
        "    '--img-size', '24', '--min-size', '16', '--max-size', '24',\n"
        "    '--vae-levels', '1', '--run-dir', sys.argv[1]])\n"
        "assert os.path.isfile(os.path.join(exp, 'netD_1.ckpt'))\n"
        "from hpvaegan_tpu_torch.training import trainer\n"
        "class Stop(Exception):\n"
        "    pass\n"
        "def stop(done, st, metrics):\n"
        "    if len(st.G.body) == 1 and done == 1:\n"
        "        raise Stop\n"
        "run_training = trainer.run_training\n"
        "trainer.run_training = lambda *a, **kw: run_training(\n"
        "    *a, step_callback=stop, **kw)\n"
        "tiny = ['--image-path', 'data/imgs/air_balloons.jpg', '--device',\n"
        "    'cpu', '--nfc', '4', '--latent-dim', '4', '--num-layer', '1',\n"
        "    '--enc-blocks', '1', '--niter', '2', '--img-size', '24',\n"
        "    '--min-size', '16', '--max-size', '24', '--vae-levels', '1',\n"
        "    '--ckpt-interval', '1', '--steps-per-call', '1']\n"
        "killed = os.path.join(sys.argv[1], 'k')\n"
        "try:\n"
        "    train_image.main(tiny + ['--run-dir', killed])\n"
        "except Stop:\n"
        "    trainer.run_training = run_training\n"
        "killed = os.path.join(killed, 'air_balloons', 'debug', 'experiment_0')\n"
        "exp = train_image.main(tiny + ['--run-dir', sys.argv[1] + '/r',\n"
        "    '--netG', os.path.join(killed, 'inflight_1.ckpt'),\n"
        "    '--intermediate', os.path.join(killed, 'intermediate.json')])\n"
        "assert os.path.isfile(os.path.join(exp, 'netG_1.ckpt'))\n"
        "import hpvaegan_tpu_torch.eval_video, hpvaegan_tpu_torch.metrics.c3d\n"
        "from hpvaegan_tpu_torch.data.video import SingleVideoDataset\n"
        "from hpvaegan_tpu_torch.models import networks_3d\n"
        "vcfg = Config(nfc=4, latent_dim=4, num_layer=1, img_size=24,\n"
        "              min_size=16, max_size=24, niter=1, num_samples=2,\n"
        "              video_path='data/vids/synthetic.avi', max_frames=5,\n"
        "              sampling_rates=[2, 1]).finalize()\n"
        "SingleVideoDataset(vcfg, 'cpu')\n"
        "vcfg.Noise_Amps = [1.0] * (vcfg.stop_scale + 1)\n"
        "vcfg.scale_idx = vcfg.stop_scale\n"
        "vg = networks_3d.GeneratorHPVAEGAN(vcfg)\n"
        "for _ in range(vcfg.stop_scale):\n"
        "    vg.init_next_stage(torch.Generator().manual_seed(0))\n"
        "for mode in (True, False):\n"
        "    out = generate_samples(vcfg, vg, ndim=3, train_mode=mode)\n"
        "    assert out.ndim == 5 and np.isfinite(out).all()\n"
        "from hpvaegan_tpu_torch import train_video\n"
        "exp = train_video.main(['--video-path', 'data/vids/synthetic.avi',\n"
        "    '--sampling-rates', '2', '1', '--max-frames', '5',\n"
        "    '--device', 'cpu', '--nfc', '4', '--latent-dim', '4',\n"
        "    '--num-layer', '1', '--enc-blocks', '1', '--niter', '1',\n"
        "    '--img-size', '24', '--min-size', '16', '--max-size', '24',\n"
        "    '--vae-levels', '1', '--run-dir', sys.argv[1]])\n"
        "assert os.path.isfile(os.path.join(exp, 'netD_1.ckpt'))\n"
        "assert os.sep + 'synthetic' + os.sep in exp\n"
        "from hpvaegan_tpu_torch import train_video_baselines\n"
        "exp = train_video_baselines.main(['--video-path',\n"
        "    'data/vids/synthetic.avi', '--sampling-rates', '2', '1',\n"
        "    '--max-frames', '5', '--device', 'cpu', '--nfc', '4',\n"
        "    '--num-layer', '1', '--niter', '1', '--img-size', '24',\n"
        "    '--min-size', '16', '--max-size', '24', '--generator',\n"
        "    'GeneratorSG', '--run-dir', sys.argv[1] + '/b'])\n"
        "assert os.path.isfile(os.path.join(exp, 'Z_init.npy'))\n"
        "hpvaegan_tpu_torch.eval_video.main(['--exp-dir', exp, '--device',\n"
        "    'cpu', '--num-samples', '2'])\n"
        "hpvaegan_tpu_torch.eval_video.main(['--exp-dir', exp, '--device',\n"
        "    'cpu', '--num-samples', '2', '--on-device-fid'])\n"
        "import hpvaegan_tpu_torch.tools.export_ms\n"
        "import hpvaegan_tpu_torch.export.serving\n"
        "import hpvaegan_tpu_torch.export.__main__\n"
        "import hpvaegan_tpu_torch.preprocess, hpvaegan_tpu_torch.postprocess\n"
        "import hpvaegan_tpu_torch.tools.run_infer\n"
        "import hpvaegan_tpu_torch.native.build\n"
        "import hpvaegan_tpu_torch.tools.metric_weights\n"
        "from hpvaegan_tpu_torch.metrics.inception import InceptionV3\n"
        "assert len(InceptionV3([3], device='cpu')(torch.rand(1, 3, 75, 75))) == 1\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'hpvaegan_tpu' or m.startswith('hpvaegan_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("clean")
