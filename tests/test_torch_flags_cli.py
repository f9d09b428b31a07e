"""The train CLIs with the training flags, on the CPU: --visualize (the JAX
file names, cadence and arrays), --profile-dir, --flat-opt and
--visualize through an inflight resume, evaluation of a bfloat16 run, and
the JAX package's qualified configuration (--compute-dtype bfloat16
--fused-dg) end to end in train_video, train_image and
train_video_baselines.

Resumes are held bit for bit (`assert_array_equal`), as
tests/test_torch_resume.py holds the plain runs; the visualization arrays
to the JAX package's from the same weights and draws at atol 0.02 on the
[0, 255] scale (127.5 x the generator tolerance GEN_TOL, 1e-4; in bfloat16
one bf16 ulp of the output, 127.5 / 128), the real image exactly.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.models import networks_2d as jnet
from hpvaegan_tpu.training import steps as jsteps
from hpvaegan_tpu.training import trainer as jtrainer
from hpvaegan_tpu.training.state import ScaleTrainState as JState

from hpvaegan_tpu_torch import eval_video as teval_video
from hpvaegan_tpu_torch import train_image as timage_cli
from hpvaegan_tpu_torch import train_video as tvideo_cli
from hpvaegan_tpu_torch import train_video_baselines as tbase_cli
from hpvaegan_tpu_torch.evaluation import (generate_samples, hydrate_config,
                                           load_generator)
from hpvaegan_tpu_torch.models.blocks import Conv, SNConv
from hpvaegan_tpu_torch.training import trainer as ttrainer
from hpvaegan_tpu_torch.utils import profiling
from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d

from test_torch_resume import assert_same_end, killer, marker, run
from test_torch_trainer import TINY, restore_logging  # noqa: F401
from test_torch_training import (cfgs, jax_generator, nchw, port_generator,
                                 replay)
from test_torch_video_training import TINY as VTINY
from test_torch_baselines_training import TINY as BTINY

torch.set_num_threads(1)

AMPS = np.asarray([1.0, 0.3, 0.2, 0.1, 0.05, 0.0], np.float32)


def _logged(exp):
    with open(os.path.join(exp, "logbook.txt")) as f:
        return [ln.split("] ", 1)[1] for ln in f.read().splitlines()
                if "[Scale " in ln]


def _finite_losses(exp):
    values = [float(kv.split(": ")[1]) for ln in _logged(exp)
              for kv in ln.split(", ")]
    return bool(values) and all(np.isfinite(values))


# ----------------------------------------------------------- visualize ---

def test_visualize_writes_the_jax_files_at_the_jax_cadence(tmp_path,
                                                           restore_logging):
    """--visualize --image-interval 2 with 4 iterations a scale: after
    iterations 2 and 4 of every scale, real_<i+1>, generated_<i+1>,
    generated_vae_<i+1>, fake_var_<i> and fake_vae_var<i> (each scale
    overwrites the last one's), upright RGB read back at the last scale's
    size, the reconstruction's vae at scale 0's."""
    exp = timage_cli.main(TINY + ["--run-dir", str(tmp_path), "--visualize",
                                  "--image-interval", "2"])
    img = os.path.join(exp, "img")
    want = set()
    for i in (2, 4):
        want |= {f"real_{i + 1}.jpg", f"generated_{i + 1}.jpg",
                 f"generated_vae_{i + 1}.jpg", f"fake_var_{i}.jpg",
                 f"fake_vae_var{i}.jpg"}
    assert set(os.listdir(img)) == want
    _, ct = cfgs(img_size=32, min_size=16, max_size=32)
    ct.ar = 0.75
    h, w = scale_size_2d(ct.stop_scale, ct.scale_factor, ct.stop_scale,
                         ct.img_size, ct.ar)
    h0, w0 = scale_size_2d(0, ct.scale_factor, ct.stop_scale, ct.img_size,
                           ct.ar)
    for name, hw in (("real_5.jpg", (h, w)), ("fake_var_4.jpg", (h, w)),
                     ("generated_vae_5.jpg", (h0, w0))):
        a = cv2.imread(os.path.join(img, name))
        assert a.shape == hw + (3,), name


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_visualize_arrays_match_jax(compute_dtype, monkeypatch):
    """The arrays the port's `visualize` hands to save_image equal the JAX
    trainer's `_visualize`'s from the same weights, batch and draws (eps,
    the noise_init-shaped normal, the stages' noise), in float32 and in
    bfloat16 (JAX's viz programs run in the compute dtype too: there the
    arrays agree to one bf16 ulp of the [-1, 1] output, 127.5 / 128)."""
    atol = 0.02 if compute_dtype == "float32" else 127.5 / 128
    cj, ct = cfgs(compute_dtype=compute_dtype)
    params, state = jax_generator(cj, 3, seed=2)
    rng = np.random.RandomState(7)
    real = rng.uniform(-1, 1, (2, 25, 25, 3)).astype(np.float32)
    real_zero = rng.uniform(-1, 1, (2, 17, 17, 3)).astype(np.float32)
    noise_init = rng.randn(2, 17, 17, cj.latent_dim).astype(np.float32)
    key = jax.random.PRNGKey(5)

    saved = {"jax": [], "port": []}

    class Saver:
        def __init__(self, who):
            self.who = who

        def save_image(self, img, filename):
            saved[self.who].append((filename, np.asarray(img, np.float32)))

    drawn = []
    orig = jnet.generate_noise

    def rec(k, shape, kind="normal", dtype=jnp.float32):
        out = orig(k, shape, kind, dtype)
        drawn.append(("normal", np.asarray(out)))
        return out

    monkeypatch.setattr(jnet, "generate_noise", rec)
    viz = (jsteps.make_recon(cj, jnet.generator_hpvaegan_apply),
           jsteps.make_sampler(cj, jnet.generator_hpvaegan_apply, train=True))
    jst = JState(params, state, None, None, None, None, None)
    with jax.disable_jit():
        jtrainer._visualize(viz, Saver("jax"), jst, jnp.asarray(real),
                            jnp.asarray(real_zero), jnp.asarray(noise_init),
                            jnp.asarray(AMPS), key, 6)
    _, kn, _ = jax.random.split(key, 3)
    z = np.asarray(jax.random.normal(kn, noise_init.shape))
    assert [a.shape[0] for _, a in drawn] == [2, 2, 2, 2]  # eps, 3 stages

    G = port_generator(ct, params, state)
    if compute_dtype == "bfloat16":
        from hpvaegan_tpu_torch.models.blocks import set_compute_dtype
        set_compute_dtype(G, torch.bfloat16)
    before = {k: v.clone() for k, v in G.state_dict().items()}
    noise = replay([drawn[0], ("normal", z)] + drawn[1:])
    ttrainer.visualize(G, Saver("port"), nchw(real), nchw(real_zero),
                       nchw(noise_init), list(AMPS), noise, 6)
    assert not noise.drawn
    assert all(torch.equal(v, before[k]) for k, v in G.state_dict().items())
    names = [n for n, _ in saved["jax"]]
    assert names == [n for n, _ in saved["port"]] == [
        "real_7.jpg", "generated_7.jpg", "generated_vae_7.jpg",
        "fake_var_6.jpg", "fake_vae_var6.jpg"]
    for (name, want), (_, got) in zip(saved["jax"], saved["port"]):
        assert got.shape == want.shape, name
        if name.startswith("real"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("flag", [["--visualize", "--image-interval", "1"],
                                  ["--flat-opt"]])
def test_inflight_resume_with_a_flag_ends_as_the_uninterrupted_run(
        tmp_path, restore_logging, flag):
    """tests/test_torch_resume.py's inflight resume with --visualize (its
    draws advance the generator state the inflight checkpoint holds) and
    with --flat-opt (the flat optimizer state round-trips): bit for bit."""
    common = ["--niter", "4", "--ckpt-interval", "2"] + flag
    ref = run("image", common + ["--run-dir", str(tmp_path / "a")])
    killed = run("image", common + ["--run-dir", str(tmp_path / "b")],
                 kill=killer(4, 3))
    assert marker(killed)["inflight"] == "inflight_4.ckpt"
    resumed = run("image", common + [
        "--run-dir", str(tmp_path / "c"), "--manualSeed", "77",
        "--netG", os.path.join(killed, "inflight_4.ckpt"),
        "--intermediate", os.path.join(killed, "intermediate.json")])
    assert_same_end(ref, resumed, 4)
    if "--visualize" in flag:
        # the resumed tail's images (iterations 3 and 4 of the last scale)
        # are the uninterrupted run's, byte for byte
        tail = sorted(os.listdir(os.path.join(resumed, "img")))
        assert tail == ["fake_vae_var3.jpg", "fake_vae_var4.jpg",
                        "fake_var_3.jpg", "fake_var_4.jpg", "generated_4.jpg",
                        "generated_5.jpg", "generated_vae_4.jpg",
                        "generated_vae_5.jpg", "real_4.jpg", "real_5.jpg"]
        for name in tail:
            with open(os.path.join(ref, "img", name), "rb") as f, \
                    open(os.path.join(resumed, "img", name), "rb") as g:
                assert f.read() == g.read(), name


def test_resume_across_optimizer_layouts_is_refused(tmp_path,
                                                    restore_logging):
    """An inflight checkpoint written with --flat-opt does not resume
    without it, and one written without does not resume with it."""
    common = ["--niter", "4", "--ckpt-interval", "2"]
    for written, resumed in ((["--flat-opt"], []), ([], ["--flat-opt"])):
        killed = run("image", common + written + [
            "--run-dir", str(tmp_path / f"k{len(written)}")],
            kill=killer(2, 3))
        with pytest.raises(ValueError, match="--flat-opt"):
            run("image", common + resumed + [
                "--run-dir", str(tmp_path / f"r{len(written)}"),
                "--netG", os.path.join(killed, "inflight_2.ckpt"),
                "--intermediate", os.path.join(killed, "intermediate.json")])


def test_train_video_visualize_writes_nothing(tmp_path, restore_logging):
    """The JAX trainer visualizes in 2D only: train_video --visualize
    makes the img/ dir, as the JAX saver does, and writes no image."""
    exp = tvideo_cli.main(VTINY + ["--run-dir", str(tmp_path), "--visualize",
                                   "--image-interval", "1"])
    assert os.listdir(os.path.join(exp, "img")) == []
    assert _finite_losses(exp)


# --------------------------------------------------------- profile-dir ---

def test_profile_dir_writes_one_trace(tmp_path, restore_logging):
    """--profile-dir: one Chrome trace JSON of the run, with the convolution
    operators in it."""
    prof = tmp_path / "prof"
    timage_cli.main(TINY + ["--run-dir", str(tmp_path / "run"), "--niter",
                            "1", "--profile-dir", str(prof)])
    assert os.listdir(prof) == ["trace.json"]
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::conv2d" for e in events)


def test_trace_without_a_dir_starts_no_profiler(monkeypatch):
    """trace('') / trace(None) run the block and start no profiler;
    barrier and StepTimer (utils/profiling.py) read a scalar back."""
    def refuse(*a, **kw):
        raise AssertionError("a profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    ran = []
    for d in ("", None):
        with profiling.trace(d, "cpu"):
            ran.append(d)
    assert ran == ["", None]
    assert profiling.barrier(torch.tensor([2.5, 1.0])) == 2.5
    timer = profiling.StepTimer()
    rate = timer.tick(4, torch.ones(()))
    assert timer.steps == 4 and rate > 0


# ------------------------------------------------- bf16 runs end to end ---

def _bf16_convs(gen):
    return [m.compute_dtype for m in gen.modules()
            if isinstance(m, (Conv, SNConv))]


def test_eval_of_a_bf16_run_samples_in_float32(tmp_path, restore_logging):
    """An experiment trained with --compute-dtype bfloat16 --fused-dg keeps
    compute_dtype in args.txt; eval_image loads it with float32 convs, and
    its samples equal those of the same experiment with args.txt saying
    float32: evaluation never reads compute_dtype (as in the JAX package).
    (eval_video scores a bf16 run in
    test_train_video_bf16_fused_dg_then_eval_video.)"""
    exp = timage_cli.main(TINY + ["--run-dir", str(tmp_path),
                                  "--compute-dtype", "bfloat16",
                                  "--fused-dg"])
    assert _finite_losses(exp)
    args = os.path.join(exp, "args.txt")
    with open(args) as f:
        text = f.read()
    assert "compute_dtype: bfloat16" in text.splitlines()

    def samples():
        cfg = hydrate_config(exp, dict(scale_idx=-1, netG="", num_samples=2))
        assert cfg.compute_dtype in ("bfloat16", "float32")
        gen, _ = load_generator(cfg, exp, ndim=2, device="cpu")
        assert set(_bf16_convs(gen)) == {None}
        return generate_samples(cfg, gen, seed=3)

    got = samples()
    assert got.dtype == np.float32
    with open(args, "w") as f:
        f.write(text.replace("compute_dtype: bfloat16",
                             "compute_dtype: float32"))
    np.testing.assert_array_equal(got, samples())


def test_train_video_bf16_fused_dg_then_eval_video(tmp_path, restore_logging,
                                                   capsys, monkeypatch):
    """The JAX package's qualified configuration, tiny, through train_video
    (the card's main path at full width, chip_smoke.py phase 16): every
    GAN scale runs the fused iteration with bf16 convs, the losses are
    finite, and eval_video scores the run."""
    from hpvaegan_tpu_torch.training import steps as tsteps

    fused, dtypes = [], set()
    orig = tsteps.fused_dg_iteration

    def spy(cfg, st, *a):
        fused.append(cfg.scale_idx)
        dtypes.update(_bf16_convs(st.G) + _bf16_convs(st.D))
        return orig(cfg, st, *a)

    monkeypatch.setattr(tsteps, "fused_dg_iteration", spy)
    exp = tvideo_cli.main(VTINY + ["--run-dir", str(tmp_path),
                                   "--compute-dtype", "bfloat16",
                                   "--fused-dg"])
    assert fused == [2, 2, 3, 3, 4, 4]  # niter 2 at the GAN scales 2-4
    assert dtypes == {torch.bfloat16}
    assert _finite_losses(exp)
    capsys.readouterr()
    teval_video.main(["--exp-dir", exp, "--device", "cpu", "--num-samples",
                      "2", "--max-samples", "2"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SVFID: ")]
    assert len(line) == 1 and np.isfinite(float(line[0].split()[1]))


def test_train_video_baselines_with_the_flags(tmp_path, restore_logging):
    """train_video_baselines takes --compute-dtype bfloat16, --fused-dg and
    --flat-opt (and --paired-g, which changes nothing there): every scale
    trains, with finite losses and d_loss at each."""
    exp = tbase_cli.main(BTINY + ["--run-dir", str(tmp_path),
                                  "--compute-dtype", "bfloat16", "--fused-dg",
                                  "--flat-opt", "--paired-g"])
    files = set(os.listdir(exp))
    assert {f"netG_{k}.ckpt" for k in range(5)} <= files
    logged = _logged(exp)
    assert logged and all("d_loss" in ln for ln in logged)
    assert _finite_losses(exp)

