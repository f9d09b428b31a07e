"""Resume and inflight checkpoints of the port's trainer, on the CPU.

A run killed through `step_callback` and resumed ends bit for bit equal to
the uninterrupted run (netG, netD and the amps; `assert_array_equal`):
  * from an inflight marker (--ckpt-interval), mid-scale at the last scale,
    in 2D and in 3D;
  * from a finalized marker of the port (its "torch_rng" sidecar), killed
    at the start of a scale and resumed with another --manualSeed.
A JAX-written experiment resumes reference-style (the marker's scale is
recalibrated and trained again); a JAX inflight pickle is refused without
importing jax; both packages read the markers and experiments the port
writes; and the CLIs take --netG, --intermediate, --ckpt-interval and
--netD.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu.models import networks_2d as jnet
from hpvaegan_tpu.training.state import ScaleTrainState as JState
from hpvaegan_tpu.utils import saver as jsaver

from hpvaegan_tpu_torch import train_image as timage_cli
from hpvaegan_tpu_torch import train_video as tvideo_cli
from hpvaegan_tpu_torch.training import trainer as ttrainer
from hpvaegan_tpu_torch.utils import saver as tsaver

from test_torch_trainer import TINY, restore_logging  # noqa: F401
from test_torch_training import IMAGE, REPO, cfgs
from test_torch_video_training import TINY as VTINY

torch.set_num_threads(1)

CLIS = {"image": (timage_cli, TINY), "video": (tvideo_cli, VTINY)}


class Killed(Exception):
    """What the tests' step_callback raises to stop a run."""


def killer(scale_idx, at_iter):
    """A step_callback that stops the run after iteration `at_iter` of
    scale `scale_idx` (the scale G's stage count tells)."""
    def callback(done, st, metrics):
        if len(st.G.body) == scale_idx and done == at_iter:
            raise Killed
    return callback


def run(cli, args, kill=None):
    """One CLI run, stopped by `kill` (a step_callback) when given; returns
    the experiment dir."""
    module, tiny = CLIS[cli]
    if kill is None:
        return module.main(tiny + args)
    orig, made = ttrainer.run_training, []

    def killed_run(cfg, saver, *a, **kw):
        made.append(saver.experiment_dir)
        return orig(cfg, saver, *a, step_callback=kill, **kw)

    ttrainer.run_training = killed_run
    try:
        with pytest.raises(Killed):
            module.main(tiny + args)
    finally:
        ttrainer.run_training = orig
    return made[0]


def marker(exp):
    with open(os.path.join(exp, "intermediate.json")) as f:
        return json.load(f)


def assert_same_end(a, b, last):
    """netG_<last>, netD_<last> and the amps of two experiments, bit for
    bit."""
    for name in (f"netG_{last}.ckpt", f"netD_{last}.ckpt"):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               jsaver.load_pytree(os.path.join(a, name)),
                               jsaver.load_pytree(os.path.join(b, name)))
    assert marker(a)["noise_amps"] == marker(b)["noise_amps"]


@pytest.mark.parametrize("cli,last,niter,interval,kill_at", [
    ("image", 4, 4, 2, 3), ("video", 4, 2, 1, 1)])
def test_inflight_resume_ends_as_the_uninterrupted_run(
        tmp_path, restore_logging, cli, last, niter, interval, kill_at):
    """Killed mid-scale at the last scale, after its inflight checkpoint;
    resumed from the marker in a new experiment dir with another seed."""
    common = ["--niter", str(niter), "--ckpt-interval", str(interval)]
    ref = run(cli, common + ["--run-dir", str(tmp_path / "a")])
    killed = run(cli, common + ["--run-dir", str(tmp_path / "b")],
                 kill=killer(last, kill_at))
    inter = marker(killed)
    saved = kill_at - kill_at % interval
    assert inter == {"noise_amps": inter["noise_amps"], "scale_idx": last,
                     "inflight": f"inflight_{last}.ckpt",
                     "inflight_iter": saved}
    assert len(inter["noise_amps"]) == last + 1
    payload = tsaver.load_inflight(os.path.join(killed,
                                                f"inflight_{last}.ckpt"))
    assert payload["iter"] == saved
    assert sorted(payload) == ["D", "G", "iter", "opt_d", "opt_g", "rng"]

    resumed = run(cli, common + [
        "--run-dir", str(tmp_path / "c"), "--manualSeed", "77",
        "--netG", os.path.join(killed, f"inflight_{last}.ckpt"),
        "--intermediate", os.path.join(killed, "intermediate.json")])
    assert_same_end(ref, resumed, last)
    final = marker(resumed)
    assert "inflight" not in final and "key" not in final
    assert final["torch_rng"] == f"torch_rng_{last}.pt"
    assert not [f for f in os.listdir(resumed) if f.startswith("inflight_")]
    assert not os.path.exists(os.path.join(resumed, f"netG_{last - 1}.ckpt"))


def test_finalized_resume_ends_as_the_uninterrupted_run(tmp_path,
                                                       restore_logging):
    """Killed at the start of scale 2 (vae_levels 1: scale 1 is a GAN scale
    whose netD_1 warm-starts scale 2's D); the finalized marker of scale 1
    continues at scale 2 under another --manualSeed."""
    common = ["--vae-levels", "1"]
    ref = run("image", common + ["--run-dir", str(tmp_path / "a")])
    killed = run("image",
                 common + ["--run-dir", str(tmp_path / "b")],
                 kill=killer(2, 1))
    inter = marker(killed)
    assert inter["scale_idx"] == 1 and inter["torch_rng"] == "torch_rng_1.pt"
    assert "key" not in inter and "inflight" not in inter
    resumed = run("image", common + [
        "--run-dir", str(tmp_path / "c"), "--manualSeed", "123",
        "--netG", os.path.join(killed, "netG_1.ckpt"),
        "--intermediate", os.path.join(killed, "intermediate.json")])
    assert os.path.isfile(os.path.join(resumed, "netD_1.ckpt"))
    assert not os.path.exists(os.path.join(resumed, "netG_1.ckpt"))
    assert_same_end(ref, resumed, 4)

    # the JAX package reads the experiment resumed once
    cfg = jeval.hydrate_config(resumed, dict(scale_idx=-1, netG=""))
    params, _, _ = jeval.load_generator(cfg, resumed, ndim=2)
    assert cfg.scale_idx == 4 and len(params["body"]) == 4
    # a marker of the last scale leaves nothing to train
    again = run("image", common + [
        "--run-dir", str(tmp_path / "d"),
        "--netG", os.path.join(resumed, "netG_4.ckpt"),
        "--intermediate", os.path.join(resumed, "intermediate.json")])
    assert not [f for f in os.listdir(again) if f.startswith("netG_")]


def _jax_experiment(root, k=2, key_in_marker=True):
    """A JAX-written experiment at scale k of the tiny config (vae_levels
    1): JAX-initialised netG_k and netD_{k-1}, written by the JAX package's
    own DataSaver, its marker with (or without) the JAX key."""
    cj, _ = cfgs(image_path=IMAGE, run_dir=str(root), checkname="jax",
                 num_layer=1, vae_levels=1)
    saver = jsaver.DataSaver(cj)
    cj.ar = 0.75
    cj.write_args_txt(os.path.join(saver.experiment_dir, "args.txt"))
    params, state = jnet.generator_hpvaegan_init(cj, jax.random.PRNGKey(0))
    for i in range(k):
        params, state = jnet.generator_init_next_stage(
            cj, params, state, jax.random.PRNGKey(1 + i))
    d_params, d_state = jnet.wdiscriminator2d_init(cj, jax.random.PRNGKey(9))
    saver.save_checkpoint(jax.tree_util.tree_map(np.asarray, {
        "params": d_params, "state": d_state}), f"netD_{k - 1}.ckpt")
    amps = [1.0] + [0.777] * k
    saver.finalize_scale(k, amps, jax.tree_util.tree_map(np.asarray, {
        "params": params, "state": state}),
        key=jax.random.PRNGKey(5) if key_in_marker else None)
    return saver.experiment_dir, amps


@pytest.mark.parametrize("key_in_marker", [True, False])
def test_jax_experiment_resumes_reference_style(
        tmp_path, monkeypatch, restore_logging, key_in_marker):
    """The marker's scale is trained again: G keeps its 2 stages (netG_2
    of the new run has 2), D warm-starts from netD_1 of --netG's dir, the
    amp of scale 2 is recalibrated, and the run completes."""
    exp, amps = _jax_experiment(tmp_path / "jax", key_in_marker=key_in_marker)
    assert ("key" in marker(exp)) == key_in_marker
    loaded = []
    load = tsaver.DataSaver.load_checkpoint

    def spy(self, filename, path=None):
        loaded.append((filename, path))
        return load(self, filename, path)

    monkeypatch.setattr(tsaver.DataSaver, "load_checkpoint", spy)
    resumed = timage_cli.main(TINY + [
        "--num-layer", "1", "--vae-levels", "1",
        "--run-dir", str(tmp_path / "port"),
        "--netG", os.path.join(exp, "netG_2.ckpt"),
        "--intermediate", os.path.join(exp, "intermediate.json")])
    assert loaded[0] == ("netD_1.ckpt", exp)
    assert ("netD_2.ckpt", None) in loaded
    files = os.listdir(resumed)
    assert {f"netG_{k}.ckpt" for k in (2, 3, 4)} <= set(files)
    assert "netG_1.ckpt" not in files
    netg2 = jsaver.load_pytree(os.path.join(resumed, "netG_2.ckpt"))
    assert len(netg2["params"]["body"]) == 2
    got = marker(resumed)
    assert got["scale_idx"] == 4 and len(got["noise_amps"]) == 5
    assert got["noise_amps"][:2] == amps[:2]
    assert got["noise_amps"][2] != amps[2]
    assert all(np.isfinite(a) and a > 0 for a in got["noise_amps"])


def test_jax_inflight_pickle_is_refused_without_jax(tmp_path):
    """A JAX inflight_<k>.ckpt pickles the JAX ScaleTrainState; the port
    refuses it before unpickling, in a process that never imports jax."""
    exp = tmp_path / "exp"
    exp.mkdir()
    cj, _ = cfgs(image_path=IMAGE, run_dir=str(tmp_path), checkname="x")
    cj.experiment_dir = str(exp)
    saver = jsaver.DataSaver(cj)
    st = JState({"w": np.zeros(2, np.float32)}, {}, {}, {}, (), (),
                jax.random.PRNGKey(0))
    saver.save_inflight(2, st, jax.random.PRNGKey(1), 10, [1.0, 0.1, 0.1])
    code = (
        "import sys\n"
        "from hpvaegan_tpu_torch import train_image\n"
        "exp = sys.argv[1]\n"
        "try:\n"
        "    train_image.main(['--image-path', 'data/imgs/air_balloons.jpg',\n"
        "        '--device', 'cpu', '--run-dir', sys.argv[2],\n"
        "        '--netG', exp + '/inflight_2.ckpt',\n"
        "        '--intermediate', exp + '/intermediate.json'])\n"
        "except ValueError as e:\n"
        "    assert 'not a torch archive' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('accepted a JAX pickle')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'hpvaegan_tpu')]\n"
        "assert not bad, bad\n"
        "print('refused')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, str(exp),
                          str(tmp_path / "run")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("refused")


def test_both_packages_resolve_a_port_inflight_marker(tmp_path,
                                                     restore_logging):
    killed = run("image", ["--ckpt-interval", "2", "--run-dir", str(tmp_path)],
                 kill=killer(3, 2))
    inter = marker(killed)
    assert inter["inflight"] == "inflight_3.ckpt"
    assert tsaver.resolve_finalized_scale(inter) == \
        jsaver.resolve_finalized_scale(inter) == 2
    cfg = jeval.hydrate_config(killed, dict(scale_idx=-1, netG=""))
    params, _, _ = jeval.load_generator(cfg, killed, ndim=2)
    assert cfg.scale_idx == 2 and len(params["body"]) == 2


@pytest.fixture(scope="module")
def finished(tmp_path_factory):
    """A finished tiny experiment of each CLI (restoring the root logger's
    handlers afterwards)."""
    import logging
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    base = tmp_path_factory.mktemp("finished")
    try:
        yield {cli: module.main(tiny + ["--niter", "1",
                                        "--run-dir", str(base / cli)])
               for cli, (module, tiny) in CLIS.items()}
    finally:
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers, root.level = handlers, level


@pytest.mark.parametrize("cli", ["image", "video"])
@pytest.mark.parametrize("flag", ["--netG", "--intermediate", "--netD",
                                  "--ckpt-interval"])
def test_resume_flags_are_accepted(tmp_path, restore_logging, finished,
                                   cli, flag):
    """Each flag runs and lands in args.txt; --netG and --intermediate go
    together (a resume of a finished experiment: nothing left to train),
    --netD changes nothing, and --ckpt-interval leaves no inflight file
    behind a finished run."""
    module, tiny = CLIS[cli]
    done = finished[cli]
    last = marker(done)["scale_idx"]
    values = {"--netG": os.path.join(done, f"netG_{last}.ckpt"),
              "--intermediate": os.path.join(done, "intermediate.json"),
              "--netD": os.path.join(done, f"netD_{last}.ckpt"),
              "--ckpt-interval": "1"}
    if flag in ("--netG", "--intermediate"):
        extra = ["--netG", values["--netG"],
                 "--intermediate", values["--intermediate"]]
    else:
        extra = [flag, values[flag], "--niter", "2"]
    exp = module.main(tiny + ["--run-dir", str(tmp_path)] + extra)
    with open(os.path.join(exp, "args.txt")) as f:
        args = f.read().splitlines()
    assert f"{flag[2:].replace('-', '_')}: {values[flag]}" in args
    assert not [f for f in os.listdir(exp) if f.startswith("inflight_")]
    if flag == "--netD":
        assert marker(exp)["scale_idx"] == last


@pytest.mark.parametrize("flag", ["--netG", "--intermediate"])
def test_a_lone_resume_flag_is_refused(tmp_path, flag):
    with pytest.raises(SystemExit, match="--netG and --intermediate"):
        timage_cli.main(TINY + ["--run-dir", str(tmp_path), flag, "x"])
    assert not os.listdir(tmp_path)


def test_foreign_netg_formats_raise(tmp_path, restore_logging, finished):
    """.pth and MindSpore generators resume (tests/test_torch_interop.py);
    malformed ones fail loudly with the loader's or the codec's error: a
    .pth that is no torch archive, a protobuf cut inside a field."""
    import pickle

    inter = os.path.join(finished["image"], "intermediate.json")
    for name, data, error, match in (
            ("g.pth", b"x", pickle.UnpicklingError, "Weights only load"),
            ("g.ckpt", b"\x0a\x05proto", ValueError, "wire type")):
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(error, match=match):
            timage_cli.main(TINY + ["--run-dir", str(tmp_path / "run"),
                                    "--netG", str(path),
                                    "--intermediate", inter])
