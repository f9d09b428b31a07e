"""The port's baselines training CLI on the CPU: train_video_baselines end to
end for GeneratorCSG and GeneratorSG, its experiments scored by either
package's eval_video (and a JAX-trained baseline run scored by the
port's), kill-and-resume bit for bit against the uninterrupted run (from
an inflight marker and from a finalized one), the reference-style resume
of a JAX-written run, and the refusals between the HP-VAE-GAN CLIs and the
baselines CLI.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu import config as jcfg
from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu.models import networks_3d as jnet
from hpvaegan_tpu.training.baselines_trainer import run_training as run_b
from hpvaegan_tpu.utils import saver as jsaver

from hpvaegan_tpu_torch import eval_video as teval_cli
from hpvaegan_tpu_torch import evaluation as teval
from hpvaegan_tpu_torch import models as tmodels
from hpvaegan_tpu_torch import train_image as timage_cli
from hpvaegan_tpu_torch import train_video as tvideo_cli
from hpvaegan_tpu_torch import train_video_baselines as tbase_cli
from hpvaegan_tpu_torch.models.blocks import init_weights_
from hpvaegan_tpu_torch.training import baselines_trainer as tbase
from hpvaegan_tpu_torch.utils import saver as tsaver

from test_torch_resume import Killed, assert_same_end, marker
from test_torch_trainer import TINY as IMAGE_TINY
from test_torch_trainer import restore_logging  # noqa: F401 (a fixture)
from test_torch_video import SYNTHETIC, _stage_thw
from test_torch_video_training import TINY as VIDEO_TINY

torch.set_num_threads(1)

# one iteration a chunk, the per-iteration cadence these tests hold
TINY = ["--video-path", SYNTHETIC, "--sampling-rates", "2", "1",
        "--max-frames", "5", "--checkname", "smoke", "--nfc", "8",
        "--num-layer", "2", "--niter", "2", "--img-size", "32",
        "--min-size", "16", "--max-size", "32", "--print-interval", "1",
        "--manualSeed", "1", "--device", "cpu", "--steps-per-call", "1"]
GENS = ["GeneratorCSG", "GeneratorSG"]


def run(args, kill=None):
    """One train_video_baselines run, stopped by `kill` (a step_callback)
    when given; returns the experiment dir."""
    if kill is None:
        return tbase_cli.main(TINY + args)
    orig, made = tbase.run_training, []

    def killed_run(cfg, saver, *a, **kw):
        made.append(saver.experiment_dir)
        return orig(cfg, saver, *a, step_callback=kill, **kw)

    tbase.run_training = killed_run
    try:
        with pytest.raises(Killed):
            tbase_cli.main(TINY + args)
    finally:
        tbase.run_training = orig
    return made[0]


def killer(scale_idx, at_iter):
    """Stop after iteration `at_iter` of scale `scale_idx` (a baseline G
    carries scale_idx + 1 stages)."""
    def callback(done, st, metrics):
        if len(st.G.body) == scale_idx + 1 and done == at_iter:
            raise Killed
    return callback


def _z_init(exp):
    return np.load(os.path.join(exp, "Z_init.npy"))


# ----------------------------------------------------------------- CLI ---

@pytest.mark.parametrize("name", GENS)
def test_baselines_cli_on_cpu_writes_a_jax_experiment(
        tmp_path, monkeypatch, restore_logging, name):
    """netG_<k> (k + 1 stages) and netD_<k> at every scale, D warm-started
    from netD_<k-1> at every scale > 0, Z_init.npy (1, td0, h0, w0, nc_im)
    equal to the weight generator's draw right after G's weights, amps[0] =
    1.0 and the rest calibrated (--const-amp is ignored), D and G metrics
    logged at every scale; the JAX package loads and applies netG and netD,
    and the port's loader grows netG_4 to its 5 stages."""
    loaded = []
    load = tsaver.DataSaver.load_checkpoint

    def spy(self, filename, path=None):
        loaded.append(filename)
        return load(self, filename, path)

    monkeypatch.setattr(tsaver.DataSaver, "load_checkpoint", spy)
    exp = run(["--run-dir", str(tmp_path), "--generator", name,
               "--const-amp"])
    files = set(os.listdir(exp))
    assert {f"netG_{k}.ckpt" for k in range(5)} <= files
    assert {f"netD_{k}.ckpt" for k in range(5)} <= files
    assert {"Z_init.npy", "args.txt", "intermediate.json"} <= files
    assert loaded == [f"netD_{k}.ckpt" for k in range(4)]
    inter = marker(exp)
    amps = inter["noise_amps"]
    assert inter["scale_idx"] == 4 and len(amps) == 5 and amps[0] == 1.0
    assert all(np.isfinite(a) and 0 < a < 1 for a in amps[1:])
    with open(os.path.join(exp, "logbook.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if "g_loss" in ln]
    assert len(lines) == 5 * 2 and all("d_loss" in ln for ln in lines)
    with open(os.path.join(exp, "args.txt")) as f:
        args = f.read().splitlines()
    assert f"generator: {name}" in args
    assert "discriminator: WDiscriminatorBaselines" in args

    cfg = jeval.hydrate_config(exp, dict(scale_idx=-1, netG=""))
    gen = torch.Generator().manual_seed(1)
    init_weights_(tmodels.get_generator(name, 3)(cfg), gen)
    want = torch.randn(tbase.z_init_shape(cfg), generator=gen)
    z_init = _z_init(exp)
    assert z_init.shape == (1,) + tuple(_stage_thw(cfg, 0)) + (3,)
    np.testing.assert_array_equal(z_init, want.movedim(1, -1).numpy())

    params, state, _ = jeval.load_generator(cfg, exp, ndim=3)
    assert len(params["body"]) == 5
    (x,), _ = jnet.generator_csg_apply(cfg, params, state, noise_init=z_init,
                                       amps=jnp.asarray(amps + [0.0]),
                                       key=jax.random.PRNGKey(0),
                                       train=True) \
        if name == "GeneratorCSG" else jnet.generator_sg_apply(
            cfg, params, state, noise_init=z_init,
            amps=jnp.asarray(amps + [0.0]), key=jax.random.PRNGKey(0),
            train=True)
    assert x.shape == (1,) + tuple(_stage_thw(cfg, 4)) + (3,)
    dck = jsaver.load_pytree(os.path.join(exp, "netD_4.ckpt"))
    y, _ = jnet.wdiscriminator_baselines_apply(cfg, dck["params"],
                                               dck["state"], x)
    assert bool(jnp.isfinite(y).all())

    tcfg_ = teval.hydrate_config(exp, dict(scale_idx=-1, netG=""))
    G, _ = teval.load_generator(tcfg_, exp, ndim=3, device="cpu")
    assert type(G).__name__ == name and len(G.body) == 5


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A finished tiny GeneratorCSG run of the port's CLI."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        yield tbase_cli.main(TINY + ["--run-dir",
                                     str(tmp_path_factory.mktemp("port"))])
    finally:
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers, root.level = handlers, level


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A finished tiny GeneratorCSG run of the JAX package's baselines
    trainer (tests/test_eval_e2e.py:85-100), the port's CLI geometry."""
    cfg = jcfg.Config(video_path=SYNTHETIC, checkname="jax", nfc=8,
                      num_layer=2, niter=2, img_size=32, min_size=16,
                      max_size=32, sampling_rates=[2, 1], max_frames=5,
                      generator="GeneratorCSG",
                      discriminator="WDiscriminatorBaselines",
                      print_interval=100, manualSeed=1,
                      run_dir=str(tmp_path_factory.mktemp("jax"))).finalize()
    _, _, _, saver = run_b(cfg, seed=1)
    return saver.experiment_dir


def test_jax_eval_scores_a_port_baseline_run(port_run):
    cfg = jeval.hydrate_config(port_run, dict(
        niter=1, num_samples=2, max_samples=2, batch_size=1, data_rep=1,
        save_path="images", scale_idx=-1, netG=""))
    svfid, saver = jeval.eval_video_experiment(cfg, port_run, seed=0)
    assert np.isfinite(svfid)
    samples = np.load(os.path.join(saver.eval_dir, "random_samples.npy"))
    assert samples.shape == (2, 3) + tuple(_stage_thw(cfg, 4))


@pytest.mark.parametrize("which", ["port", "jax"])
def test_port_eval_scores_a_baseline_run(port_run, jax_run, capsys, which):
    """The port's eval_video CLI on the port's run and on the JAX
    package's: z of nc_im channels at scale 0's time depth, netG_4's 5
    stages, a finite SVFID and the artifacts."""
    exp = port_run if which == "port" else jax_run
    capsys.readouterr()
    teval_cli.main(["--exp-dir", exp, "--device", "cpu", "--num-samples", "3",
                    "--max-samples", "2"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SVFID: ")]
    assert len(line) == 1 and np.isfinite(float(line[0].split()[1]))
    samples = np.load(os.path.join(exp, "eval", "random_samples.npy"))
    assert samples.shape == (3, 3, 3, 24, 33)
    assert {"fake.gif", "real.gif"} <= set(os.listdir(
        os.path.join(exp, "eval", "images")))


# -------------------------------------------------------------- resume ---

@pytest.mark.parametrize("name", GENS)
def test_baselines_inflight_resume_ends_as_the_uninterrupted_run(
        tmp_path, restore_logging, name):
    """Killed after iteration 1 of the last scale (its inflight checkpoint)
    and resumed from it under another seed: netG_4, netD_4, the amps and
    Z_init.npy equal the uninterrupted run's, bit for bit."""
    common = ["--generator", name, "--ckpt-interval", "1"]
    ref = run(common + ["--run-dir", str(tmp_path / "a")])
    killed = run(common + ["--run-dir", str(tmp_path / "b")],
                 kill=killer(4, 1))
    inter = marker(killed)
    assert inter["inflight"] == "inflight_4.ckpt"
    assert inter["inflight_iter"] == 1 and len(inter["noise_amps"]) == 5
    resumed = run(common + [
        "--run-dir", str(tmp_path / "c"), "--manualSeed", "77",
        "--netG", os.path.join(killed, "inflight_4.ckpt"),
        "--intermediate", os.path.join(killed, "intermediate.json")])
    assert_same_end(ref, resumed, 4)
    np.testing.assert_array_equal(_z_init(resumed), _z_init(ref))
    final = marker(resumed)
    assert "inflight" not in final and "key" not in final
    assert not [f for f in os.listdir(resumed) if f.startswith("inflight_")]


def test_baselines_finalized_resume_ends_as_the_uninterrupted_run(
        tmp_path, restore_logging):
    """Killed at the start of scale 2; the finalized marker of scale 1
    (torch_rng_1.pt) continues at scale 2 under another seed, netD_1
    copied for the warm start, and ends as the uninterrupted run."""
    ref = run(["--run-dir", str(tmp_path / "a")])
    killed = run(["--run-dir", str(tmp_path / "b")], kill=killer(2, 1))
    inter = marker(killed)
    assert inter["scale_idx"] == 1 and inter["torch_rng"] == "torch_rng_1.pt"
    resumed = run(["--run-dir", str(tmp_path / "c"), "--manualSeed", "5",
                   "--netG", os.path.join(killed, "netG_1.ckpt"),
                   "--intermediate", os.path.join(killed,
                                                  "intermediate.json")])
    files = os.listdir(resumed)
    assert "netD_1.ckpt" in files and "netG_1.ckpt" not in files
    assert_same_end(ref, resumed, 4)
    np.testing.assert_array_equal(_z_init(resumed), _z_init(ref))


def test_jax_baseline_run_resumes_reference_style(
        tmp_path, monkeypatch, restore_logging, jax_run):
    """A JAX-written marker (with its key) retrains its scale: G keeps
    netG_4's 5 stages, D warm-starts from netD_3 of --netG's directory,
    Z_init is the JAX run's, the amps keep their first 4 and scale 4's is
    recalibrated."""
    inter = marker(jax_run)
    assert inter["scale_idx"] == 4 and "key" in inter
    loaded = []
    load = tsaver.DataSaver.load_checkpoint

    def spy(self, filename, path=None):
        loaded.append((filename, path))
        return load(self, filename, path)

    monkeypatch.setattr(tsaver.DataSaver, "load_checkpoint", spy)
    resumed = run(["--run-dir", str(tmp_path),
                   "--netG", os.path.join(jax_run, "netG_4.ckpt"),
                   "--intermediate", os.path.join(jax_run,
                                                  "intermediate.json")])
    assert loaded == [("netD_3.ckpt", jax_run)]
    assert sorted(f for f in os.listdir(resumed) if f.startswith("net")) == [
        "netD_4.ckpt", "netG_4.ckpt"]
    netg = jsaver.load_pytree(os.path.join(resumed, "netG_4.ckpt"))
    assert len(netg["params"]["body"]) == 5
    np.testing.assert_array_equal(_z_init(resumed), _z_init(jax_run))
    got = marker(resumed)["noise_amps"]
    assert got[:4] == inter["noise_amps"][:4] and got[4] != \
        inter["noise_amps"][4]


def test_a_stage_count_that_does_not_match_the_marker_is_refused(
        tmp_path, restore_logging, port_run):
    with pytest.raises(RuntimeError, match="carries k \\+ 1"):
        run(["--run-dir", str(tmp_path),
             "--netG", os.path.join(port_run, "netG_3.ckpt"),
             "--intermediate", os.path.join(port_run, "intermediate.json")])


# ------------------------------------------------------------ refusals ---

@pytest.mark.parametrize("cli,args", [
    ("video", VIDEO_TINY + ["--generator", "GeneratorCSG"]),
    ("video", VIDEO_TINY + ["--generator", "GeneratorSG"]),
    ("image", IMAGE_TINY + ["--generator", "GeneratorCSG"])])
def test_hpvaegan_clis_refuse_the_baselines(tmp_path, cli, args):
    module = tvideo_cli if cli == "video" else timage_cli
    with pytest.raises(ValueError, match="train_video_baselines"):
        module.main(args + ["--run-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("name", ["GeneratorHPVAEGAN", "GeneratorVAE_nb"])
def test_baselines_cli_refuses_the_hpvaegan_family(tmp_path, name):
    with pytest.raises((ValueError, NotImplementedError), match=name):
        tbase_cli.main(TINY + ["--run-dir", str(tmp_path),
                               "--generator", name])
    assert not os.listdir(tmp_path)


def test_baselines_cli_flags_and_defaults():
    """train_video's flags with the baselines' defaults (root
    train_video_baselines.py:20-42)."""
    args = tbase_cli.build_parser().parse_args(["--video-path", SYNTHETIC])
    assert (args.generator, args.discriminator, args.niter, args.device,
            args.sampling_rates, args.max_frames) == (
        "GeneratorCSG", "WDiscriminatorBaselines", 50000, "cuda",
        [4, 3, 2, 1], 13)
    with pytest.raises(ValueError, match="video"):
        tbase.run_training(None, None, device="cpu", mode="image")


def test_baselines_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbase_cli.main(args + ["--run-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
