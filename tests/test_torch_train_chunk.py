"""The port's training chunk (training/chunk.py, --steps-per-call) on the
CPU, against the JAX package's fused chunk (training/steps.py::
make_train_chunk there):

  * train_image, train_video and train_video_baselines at --niter 7
    --steps-per-call 3 write their logbook lines, inflight checkpoints and
    (2D) --visualize images at the iterations the JAX CLIs do with the
    same flags, and lines of the same text (the baselines' without a
    noise amp, as scripts/analyze_soak.py's parse then reads them);
  * a chunked run ends bit for bit as the per-iteration one (2D, 3D, CSG);
  * a resume from an inflight iteration that is not a multiple of
    --steps-per-call is refused with the JAX trainer's message, and an
    aligned one ends as the uninterrupted run;
  * FlatAdam and the step-on-device (capturable) Adams match JAX's
    flat_adam / clipped_adam / adam over 5 steps, FlatAdam's step lives on
    the parameters' device, and an inflight optimizer state written with
    the step on the host loads;
  * the chunk's mode per device, backend and --split-step, and a gloo
    group's chunk running eagerly.

The CUDA-graph side (replays against eager iterations, a failed capture
raising) needs the card: tests/test_torch_cuda.py.
"""

import contextlib
import copy
import glob
import logging
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hpvaegan_tpu import optim as joptim
from hpvaegan_tpu.utils import saver as jsaver

from hpvaegan_tpu_torch import optim as toptim
from hpvaegan_tpu_torch import train_image as timage_cli
from hpvaegan_tpu_torch import train_video as tvideo_cli
from hpvaegan_tpu_torch import train_video_baselines as tbase_cli
from hpvaegan_tpu_torch.training import baselines_trainer as tbase
from hpvaegan_tpu_torch.training import trainer as ttrainer
from hpvaegan_tpu_torch.utils import saver as tsaver

from test_torch_resume import Killed, assert_same_end, marker
from test_torch_training import IMAGE, REPO
from test_torch_video import SYNTHETIC

torch.set_num_threads(1)

if REPO not in sys.path:  # the JAX package's CLIs live at the repo root
    sys.path.insert(0, REPO)

# three scales (0 and 1 VAE, 2 GAN in the HP-VAE-GAN runs)
SIZE = ["--nfc", "8", "--num-layer", "1", "--img-size", "32",
        "--min-size", "24", "--max-size", "32", "--manualSeed", "1",
        "--checkname", "chunk"]
HPVAEGAN = ["--latent-dim", "8", "--enc-blocks", "1", "--vae-levels", "2"]
CLIS = {
    "image": (timage_cli, "train_image",
              ["--image-path", IMAGE] + SIZE + HPVAEGAN),
    "video": (tvideo_cli, "train_video",
              ["--video-path", SYNTHETIC, "--sampling-rates", "2", "1",
               "--max-frames", "5"] + SIZE + HPVAEGAN),
    "baselines": (tbase_cli, "train_video_baselines",
                  ["--video-path", SYNTHETIC, "--sampling-rates", "2", "1",
                   "--max-frames", "5"] + SIZE),
}
CADENCE = ["--niter", "7", "--steps-per-call", "3", "--print-interval", "2",
           "--ckpt-interval", "2", "--no-compile-ahead"]
VISUALIZE = ["--visualize", "--image-interval", "2"]
LAST = 2  # the last scale


@contextlib.contextmanager
def own_logging():
    """A CLI installs its console and logbook handlers on the root logger:
    take them off (and close the logbook) after the body."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        yield
    finally:
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers, root.level = handlers, level


@contextlib.contextmanager
def inflight_saves(saver_cls):
    """The (scale, iteration) of every save_inflight of `saver_cls` in the
    body."""
    saves, save = [], saver_cls.save_inflight

    def recorded(self, scale_idx, payload, *rest):
        saves.append((scale_idx, rest[-2]))
        return save(self, scale_idx, payload, *rest)

    saver_cls.save_inflight = recorded
    try:
        yield saves
    finally:
        saver_cls.save_inflight = save


def logged_iterations(exp):
    """(scale, iteration) of every logbook line of the experiment."""
    with open(os.path.join(exp, "logbook.txt")) as f:
        return [tuple(int(x) for x in m.groups()) for m in
                re.finditer(r"\[Scale (\d+)/Iter (\d+)\]", f.read())]


def images(exp):
    img = os.path.join(exp, "img")
    return sorted(os.listdir(img)) if os.path.isdir(img) else []


def port_run(kind, run_dir, *extra, kill=None):
    """The port's CLI on the CPU; returns (experiment dir, inflight
    saves). `kill`: a step_callback that stops the run."""
    module, _, flags = CLIS[kind]
    owner = tbase if kind == "baselines" else ttrainer
    orig, made = owner.run_training, []

    def run_training(cfg, saver, *a, **kw):
        made.append(saver.experiment_dir)
        if kill is not None:
            kw["step_callback"] = kill
        return orig(cfg, saver, *a, **kw)

    owner.run_training = run_training
    try:
        with own_logging(), inflight_saves(tsaver.DataSaver) as saves:
            if kill is None:
                module.main(flags + ["--device", "cpu", "--run-dir",
                                     str(run_dir), *extra])
            else:
                with pytest.raises(Killed):
                    module.main(flags + ["--device", "cpu", "--run-dir",
                                         str(run_dir), *extra])
    finally:
        owner.run_training = orig
    return made[0], saves


def jax_run(kind, run_dir, monkeypatch, *extra):
    """The JAX package's CLI with the same flags (it reads sys.argv);
    returns (experiment dir, inflight saves)."""
    _, script, flags = CLIS[kind]
    cli = __import__(script)
    monkeypatch.setattr(sys, "argv", [script + ".py"] + flags + [
        "--run-dir", str(run_dir), *extra])
    with own_logging(), inflight_saves(jsaver.DataSaver) as saves:
        cli.main()
    exp, = glob.glob(os.path.join(str(run_dir), "*", "chunk",
                                  "experiment_0"))
    return exp, saves


@pytest.fixture(scope="module", params=["image", "video", "baselines"])
def cadence_runs(request, tmp_path_factory):
    """(kind, the port's run, its inflight saves, the JAX CLI's run, its
    inflight saves) of the `kind` CLI at --niter 7 --steps-per-call 3, in
    both packages."""
    kind = request.param
    extra = CADENCE + (VISUALIZE if kind == "image" else [])
    base = tmp_path_factory.mktemp(f"cadence_{kind}")
    port, port_saves = port_run(kind, base / "port", *extra)
    with pytest.MonkeyPatch.context() as monkeypatch:
        jax_exp, jax_saves = jax_run(kind, base / "jax", monkeypatch, *extra)
    return kind, port, port_saves, jax_exp, jax_saves


def test_chunk_cadence_matches_the_jax_clis(cadence_runs):
    """--niter 7 --steps-per-call 3: chunks end at 3, 6 and 7; the logbook
    (print interval 2) logs at all three, the inflight checkpoints
    (interval 2) land at 3 and 6, and the images (2D, image interval 2)
    are written at all three, in both packages, at every scale."""
    kind, port, port_saves, jax_exp, jax_saves = cadence_runs
    want_log = [(s, i) for s in range(1, LAST + 2) for i in (3, 6, 7)]
    assert logged_iterations(port) == logged_iterations(jax_exp) == want_log
    assert port_saves == jax_saves == [(s, i) for s in range(LAST + 1)
                                       for i in (3, 6)]
    assert images(port) == images(jax_exp)
    if kind == "image":
        assert images(port) == sorted(
            [f"{name}{n}.jpg" for n in (3, 6, 7)
             for name in ("fake_var_", "fake_vae_var")]
            + [f"{name}_{n + 1}.jpg" for n in (3, 6, 7)
               for name in ("real", "generated", "generated_vae")])


def logbook_lines(exp):
    """The experiment's "[Scale k/Iter n] ..." lines, every number masked:
    what the format leaves when the values are taken out."""
    with open(os.path.join(exp, "logbook.txt")) as f:
        lines = re.findall(r"\[Scale \d+/Iter \d+\].*", f.read())
    return [re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?|nan|inf", "#", ln)
            for ln in lines]


def test_logbook_lines_match_the_jax_clis(cadence_runs):
    """Each logbook line of the port's run has the JAX CLI's format: the
    HP-VAE-GAN trainers' "[Scale k/Iter n] Noise amp: a, <metrics>", the
    baselines' "[Scale k/Iter n] <metrics>" with no amp, the same metric
    names in the same order."""
    kind, port, _, jax_exp, _ = cadence_runs
    got, want = logbook_lines(port), logbook_lines(jax_exp)
    assert len(got) == 3 * (LAST + 1) and got == want
    assert all(("Noise amp" in ln) == (kind != "baselines") for ln in got)


def test_analyze_soak_reads_no_amp_from_a_baselines_run(cadence_runs):
    """scripts/analyze_soak.py's own parse (its LINE and METRIC patterns)
    of the port's baselines logbook finds the JAX baselines' metrics at
    every logged iteration, and no `amp` series; of the HP-VAE-GAN runs'
    (the image and video cases, which share the module's runs), the JAX
    CLIs' series with their `amp`. (Its rates need log lines seconds
    apart: tests/test_torch_run_tools.py runs the tool.)"""
    import importlib.util

    kind, port, _, jax_exp, _ = cadence_runs
    path = os.path.join(REPO, "scripts", "analyze_soak.py")
    spec = importlib.util.spec_from_file_location("analyze_soak", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def series(exp):
        with open(os.path.join(exp, "logbook.txt")) as f:
            found = [tool.LINE.match(ln.strip()) for ln in f]
        return [sorted(k for k, _ in tool.METRIC.findall(m.group(4)))
                for m in found if m]

    got = series(port)
    assert len(got) == 3 * (LAST + 1) and got == series(jax_exp)
    assert all(("amp" in keys) == (kind != "baselines") for keys in got)
    if kind == "baselines":
        assert all("d_loss" in keys for keys in got)


def assert_same_run(a, b):
    """Every checkpoint, generator state and amp of two experiments, bit
    for bit."""
    names = sorted(f for f in os.listdir(a)
                   if f.endswith((".ckpt", ".pt", ".npy")))
    assert names == sorted(f for f in os.listdir(b)
                           if f.endswith((".ckpt", ".pt", ".npy")))
    assert any(n.startswith("netD_") for n in names)
    for name in names:
        if name.endswith(".ckpt"):
            got, want = (_leaves(tsaver.load_pytree(os.path.join(d, name)))
                         for d in (a, b))
            assert len(got) == len(want)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
        elif name.endswith(".pt"):
            got, want = (tsaver.load_inflight(os.path.join(d, name))
                         for d in (a, b))
            assert torch.equal(got["init_gen"], want["init_gen"])
            for k in ("device", "host"):
                assert torch.equal(got["noise"][k], want["noise"][k])
        else:
            np.testing.assert_array_equal(np.load(os.path.join(a, name)),
                                          np.load(os.path.join(b, name)))
    assert marker(a)["noise_amps"] == marker(b)["noise_amps"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("kind", ["image", "video", "baselines"])
def test_chunked_run_equals_the_per_iteration_run(kind, tmp_path):
    """run_scale at --steps-per-call 3 (chunks of 3, 3 and 1) ends bit for
    bit as at 1 and under --split-step: the same iterations, the same
    draws in the same order. (--visualize draws its images at the chunk
    boundaries, so another chunk length draws them elsewhere in the
    stream, in the JAX trainer too.)"""
    extra = ["--niter", "7", "--print-interval", "2", "--ckpt-interval",
             "2"]
    chunked, _ = port_run(kind, tmp_path / "a", *extra,
                          "--steps-per-call", "3")
    single, _ = port_run(kind, tmp_path / "b", *extra,
                         "--steps-per-call", "1")
    split, _ = port_run(kind, tmp_path / "c", *extra, "--split-step")
    assert_same_run(chunked, single)
    assert_same_run(chunked, split)


def killer(at_iter):
    """A step_callback that stops the run after iteration `at_iter` of the
    last scale."""
    def callback(done, st, metrics):
        if len(st.G.body) - st.G.body_offset == LAST and done == at_iter:
            raise Killed
    return callback


@pytest.mark.parametrize("kind", ["image", "baselines"])
def test_misaligned_resume_is_refused_and_aligned_resume_continues(
        kind, tmp_path):
    """Killed after the chunk that ends at iteration 3 of the last scale
    (--steps-per-call 3, inflight at 3): resuming at --steps-per-call 2
    raises the JAX trainer's ValueError (trainer.py:220-227 there), and
    resuming at 3 ends as the uninterrupted run, bit for bit."""
    extra = CADENCE
    ref, _ = port_run(kind, tmp_path / "a", *extra)
    killed, saves = port_run(kind, tmp_path / "b", *extra, kill=killer(3))
    assert saves[-1] == (LAST, 3)
    assert marker(killed)["inflight_iter"] == 3
    resume = ["--netG", os.path.join(killed, f"inflight_{LAST}.ckpt"),
              "--intermediate", os.path.join(killed, "intermediate.json")]
    with pytest.raises(ValueError) as refused:
        port_run(kind, tmp_path / "c", *extra, "--steps-per-call", "2",
                 *resume)
    assert str(refused.value) == (
        "inflight iteration 3 is not a multiple of steps_per_call=2; resume "
        "with the original --steps-per-call (or one that divides 3)")
    resumed, saves = port_run(kind, tmp_path / "d", *extra, "--manualSeed",
                              "7", *resume)
    assert saves == [(LAST, 6)]
    assert_same_end(ref, resumed, LAST)


# ----------------------------------------------------------- optimizers ---

SHAPES = {"a": (4, 3, 3, 3), "b": (5,), "c": (2, 6)}
LRS = {"a": 5e-4, "b": 1e-4, "c": 5e-4}


def _problem():
    """5 steps of gradients; two of the three tensors exceed the clip."""
    rng = np.random.RandomState(3)
    start = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * (40.0 if k != "c" else 0.1)
                  ).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(5)]
    return start, grads


def _jax_params(opt_j, start, grads):
    params = {k: jnp.asarray(v) for k, v in start.items()}
    st = opt_j.init(params)
    for g in grads:
        upd, st = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                               params)
        params = optax.apply_updates(params, upd)
    return params


def _port_opt(kind, p):
    """The port's optimizer of `kind` over p."""
    if kind == "clipped_g":
        groups = [{"params": [p["a"], p["c"]], "lr": 5e-4},
                  {"params": [p["b"]], "lr": 1e-4}]
        return toptim.ClippedAdam(groups, 0.5, grad_clip=5.0)
    if kind == "plain_d":
        return toptim.adam(list(p.values()), 5e-4, 0.5)
    if kind == "flat_g":
        return toptim.FlatAdam([{"params": [p["a"], p["c"]], "lr": 5e-4},
                                {"params": [p["b"]], "lr": 1e-4}], 0.5,
                               grad_clip=5.0)
    return toptim.FlatAdam(list(p.values()), 0.5, grad_clip=float("inf"),
                           lr=5e-4)


@pytest.fixture
def adam_step_on_device(monkeypatch):
    """Build the Adams as on the card (capturable: the step and the bias
    corrections are tensors), which torch.optim.Adam otherwise allows on
    accelerators only; the arithmetic is the same on the CPU."""
    import torch.optim.adam as tadam

    monkeypatch.setattr(toptim, "_on_card", lambda params: True)
    monkeypatch.setattr(tadam, "_get_capturable_supported_devices",
                        lambda *a, **kw: ["cpu", "cuda"])


@pytest.mark.parametrize("kind", ["clipped_g", "plain_d", "flat_g", "flat_d"])
def test_step_on_device_optimizers_match_jax(kind, adam_step_on_device):
    """5 steps on identical gradients against JAX's clipped_adam / adam
    (flat_adam for FlatAdam), at test_torch_training.py's 1e-6; the step
    count is a float32 tensor on the parameters' device."""
    start, grads = _problem()
    if kind == "clipped_g":
        opt_j = joptim.clipped_adam(LRS, 0.5, grad_clip=5.0)
    elif kind == "flat_g":
        opt_j = joptim.clipped_adam(LRS, 0.5, grad_clip=5.0, flat=True)
    else:
        opt_j = joptim.adam(5e-4, 0.5, flat=kind == "flat_d")
    want = _jax_params(opt_j, start, grads)

    p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in start.items()}
    opt = _port_opt(kind, p)
    if not kind.startswith("flat"):
        assert all(g["capturable"] for g in opt.param_groups)
    for g in grads:
        for k, t in p.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
    steps = [s["step"] for s in opt.state.values()]
    assert steps and all(s.dtype == torch.float32 and s.device == p["a"].device
                         and float(s) == 5 for s in steps)
    for k in SHAPES:
        np.testing.assert_allclose(p[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["clipped_g", "plain_d", "flat_g"])
def test_a_host_step_state_loads_into_a_step_on_device_optimizer(
        kind, monkeypatch):
    """An inflight optimizer state written with the step count on the host
    (a CPU run, or the port before the step moved to the card: a plain
    float32 tensor and, for Adam, capturable False) loads into an
    optimizer built as on the card: the groups stay capturable, the step
    is a float32 tensor on the parameters' device, and the next 3 steps
    equal the uninterrupted host optimizer's."""
    import torch.optim.adam as tadam

    start, grads = _problem()

    def build():
        p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in start.items()}
        return p, _port_opt(kind, p)

    def steps(p, opt, gs):
        for g in gs:
            for k, t in p.items():
                t.grad = torch.from_numpy(g[k].copy())
            opt.step()

    host_p, host = build()
    steps(host_p, host, grads[:2])
    saved = copy.deepcopy(host.state_dict())  # as read back from a file
    if kind == "flat_g":  # FlatAdam's step was a host float32 tensor
        first = next(iter(saved["state"].values()))
        first["step"] = torch.tensor(float(first["step"]))
    else:
        assert not saved["param_groups"][0]["capturable"]

    monkeypatch.setattr(toptim, "_on_card", lambda params: True)
    monkeypatch.setattr(tadam, "_get_capturable_supported_devices",
                        lambda *a, **kw: ["cpu", "cuda"])
    p, opt = build()
    with torch.no_grad():
        for k in p:
            p[k].copy_(host_p[k])
    toptim.load_optimizer_state(opt, saved)
    if kind != "flat_g":
        assert all(g["capturable"] for g in opt.param_groups)
    assert all(s["step"].dtype == torch.float32 and float(s["step"]) == 2
               for s in opt.state.values())
    steps(p, opt, grads[2:])
    steps(host_p, host, grads[2:])
    for k in SHAPES:
        np.testing.assert_allclose(p[k].detach().numpy(),
                                   host_p[k].detach().numpy(), rtol=0,
                                   atol=1e-6)


# ------------------------------------------------ the chunk's mode ---

@pytest.mark.parametrize("device,split,backend,ranks,want", [
    ("cuda", False, None, 1, "graph"),
    ("cuda", False, "nccl", 4, "graph (4 NCCL ranks)"),
    ("cuda", False, "nccl", 1, "graph (1 NCCL rank)"),
    ("cuda", True, "nccl", 4, "eager (split-step)"),
    ("cuda", False, "gloo", 2, "eager (2 gloo ranks)"),
    ("cpu", False, "gloo", 4, "eager (4 gloo ranks)"),
    ("cpu", False, None, 1, "eager (cpu)"),
    ("cuda", True, None, 1, "eager (split-step)")])
def test_chunk_mode_names_the_backend(device, split, backend, ranks, want):
    """A chunk is a graph on the card, alone or in an NCCL group; a gloo
    group (its collectives copy through the host), the CPU and
    --split-step run eagerly, and the mode line says why."""
    from hpvaegan_tpu_torch.training.chunk import chunk_mode

    assert chunk_mode(device, split, backend, ranks) == want


def _tiny_chunk():
    """A scale-3 chunk of a tiny 2D config on the CPU, from seed 0."""
    from hpvaegan_tpu_torch.config import Config
    from hpvaegan_tpu_torch.tools.step_parity import build_state
    from hpvaegan_tpu_torch.training.chunk import TrainChunk
    from hpvaegan_tpu_torch.training.steps import batch_former
    from hpvaegan_tpu_torch.utils.noise import NoiseSource
    from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d

    cfg = Config(nfc=8, num_layer=2, img_size=32, min_size=16, max_size=32,
                 latent_dim=8, enc_blocks=1, vae_levels=2).finalize()
    cfg.scale_idx, cfg.ar = 3, 0.75
    st = build_state(cfg, 3, 0, "cpu")
    st.noise = NoiseSource(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    data = [torch.rand((1, 3) + tuple(scale_size_2d(
        k, cfg.scale_factor, cfg.stop_scale, cfg.img_size, cfg.ar)),
        generator=gen) for k in (3, 0)]
    return st, TrainChunk(cfg, st, data, [1.0] + [0.05] * (
        cfg.stop_scale + 1), False, batch_former(2, 3))


def test_a_gloo_group_chunk_stays_eager():
    """In a gloo group (here one rank, in this process) the chunk runs its
    iterations eagerly, with their collectives, and says so; it captures
    nothing, and its metrics are the chunk's with no group to 1e-5 (a
    group sums BatchNorm's statistics in another order)."""
    import torch.distributed as dist

    from hpvaegan_tpu_torch.parallel import mesh
    from hpvaegan_tpu_torch.training import chunk
    from test_torch_multihost import free_port

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        with mesh.data_parallel(mesh.DataGroup(0, 1, dist.group.WORLD)):
            _, grouped = _tiny_chunk()
            assert grouped.mode == "eager (1 gloo rank)"
            captures, calls = chunk.captures, mesh.collectives()
            got = grouped.run(2)
            assert sum(n for n, _ in mesh.collectives().values()) \
                > sum(n for n, _ in calls.values())
    finally:
        dist.destroy_process_group()
    assert chunk.captures == captures
    assert grouped.stream is None and grouped.graph is None
    _, alone = _tiny_chunk()
    assert alone.mode == "eager (cpu)"
    want = alone.run(2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
