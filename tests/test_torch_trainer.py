"""The port's training step, calibration and train CLI held against the JAX
package on the CPU.

One VAE-phase G step and one GAN-phase iteration (D, then G against the
updated D) run in the port and through the JAX package's unjitted step
cores (`_d_step_core`, `_g_step_core`) from the same weights. The JAX
draws of each step (the refinement noise, eps, the GP alpha of its key
split) are recorded and replayed to the port in call order, and the JAX
optimizers are wrapped to record the gradients they are given. Losses and
metrics agree to rtol 1e-4; gradients, BatchNorm and spectral-norm state
to atol 2e-5. Parameters after the step are not compared here: conv
biases in front of batch-statistics BatchNorm have a gradient that is zero
up to rounding, which Adam's first step turns into about +-lr; the
optimizer test (test_torch_training.py) holds the update on identical
gradients instead.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu import optim as joptim
from hpvaegan_tpu.models import networks_2d as jnet
from hpvaegan_tpu.training import partition as jpart
from hpvaegan_tpu.training import steps as jsteps
from hpvaegan_tpu.training.state import ScaleTrainState as JState
from hpvaegan_tpu.utils import saver as jsaver

from hpvaegan_tpu_torch import optim as toptim
from hpvaegan_tpu_torch import train_image as ttrain_cli
from hpvaegan_tpu_torch.tools.convert import to_jax, to_jax_discriminator
from hpvaegan_tpu_torch.training import chunk as tchunk
from hpvaegan_tpu_torch.training import partition as tpart
from hpvaegan_tpu_torch.training import steps as tsteps
from hpvaegan_tpu_torch.training import trainer as ttrainer
from hpvaegan_tpu_torch.training.state import ScaleTrainState
from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d
from hpvaegan_tpu_torch.utils.saver import DataSaver

from test_torch_training import (IMAGE, OP_TOL, replay,
                                 assert_trees_close, cfgs, jax_discriminator,
                                 jax_generator, nchw, port_discriminator,
                                 port_generator, port_grads)

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-4, atol=1e-7)
AMPS = np.asarray([1.0, 0.3, 0.2, 0.1, 0.05, 0.0], np.float32)


class Recorder:
    """Wraps an optax transformation and keeps the gradients it is given."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []
        self.init = opt.init

    def update(self, grads, state, params=None):
        self.grads.append(grads)
        return self.opt.update(grads, state, params)


@pytest.fixture
def jax_draws(monkeypatch):
    """Records every normal the JAX generator draws, in order (NHWC)."""
    drawn = []
    orig = jnet.generate_noise

    def record(key, shape, kind="normal", dtype=jnp.float32):
        out = orig(key, shape, kind, dtype)
        drawn.append((kind, np.asarray(out)))
        return out

    monkeypatch.setattr(jnet, "generate_noise", record)
    return drawn


def _setup(scale_idx, bug_compat=False, seed=0, **kw):
    """The same scale state in both packages: weights, plan, optimizers,
    and one batch (batch 2); `kw` goes to the configs (generator=...)."""
    cj, ct = cfgs(bug_compat=bug_compat, **kw)
    cj.scale_idx = ct.scale_idx = scale_idx
    g_params, g_state = jax_generator(cj, scale_idx, seed=seed)
    d_params, d_state = jax_discriminator(cj, seed=seed + 7)
    plan = jpart.make_lr_plan(cj, scale_idx, scale_idx)
    opt_g = Recorder(joptim.clipped_adam(jpart.lr_tree_for(
        jpart.split_params(g_params, plan)[0], plan), cj.beta1,
        grad_clip=cj.grad_clip))
    opt_d = Recorder(joptim.adam(cj.lr_d, cj.beta1))
    jst = JState(g_params, g_state, d_params, d_state,
                 opt_g.init(jpart.split_params(g_params, plan)[0]),
                 opt_d.init(d_params), jax.random.PRNGKey(seed + 3))

    G = port_generator(ct, g_params, g_state)
    D = port_discriminator(ct, d_params, d_state)
    tst = ScaleTrainState(
        G, D, toptim.ClippedAdam(tpart.apply_lr_plan(G, plan), ct.beta1,
                                 grad_clip=ct.grad_clip),
        toptim.adam(D.parameters(), ct.lr_d, ct.beta1), None)

    h, w = scale_size_2d(scale_idx, ct.scale_factor, ct.stop_scale,
                         ct.img_size, ct.ar)
    rng = np.random.RandomState(seed + 5)
    real = rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32)
    real_zero = rng.uniform(-1, 1, (2, 17, 17, 3)).astype(np.float32)
    noise_init = rng.randn(2, 17, 17, cj.latent_dim).astype(np.float32)
    batch = (real, real_zero, noise_init)
    return cj, ct, plan, (jst, opt_g, opt_d), tst, batch


def _clipped(grads, clip):
    """The JAX G optimizer's per-tensor clip (optim.py:20-37 there): the
    port's ClippedAdam scales .grad in place before its step."""
    def one(g):
        g = np.asarray(g)
        return g * min(1.0, clip / max(float(np.sqrt(np.sum(g ** 2))), 1e-12))
    return jax.tree_util.tree_map(one, grads)


def _g_grads_match(G, plan, jax_grads, clip):
    """Port .grad of the trainable subtrees == the JAX grads tree."""
    port = port_grads(G, to_jax)
    jax_grads = _clipped(jax_grads, clip)
    for name in ("encode", "decoder"):
        assert (name in jax_grads) == (plan[name] is not None)
        if name in jax_grads:
            assert_trees_close(port[name], jax_grads[name], **OP_TOL)
    assert sorted(jax_grads["body"]) == [
        i for i, lr in enumerate(plan["body"]) if lr is not None]
    for i, g in jax_grads["body"].items():
        assert_trees_close(port["body"][i], g, **OP_TOL)
    for name, p in G.named_parameters():
        assert (p.grad is not None) == p.requires_grad, name


def _metrics_match(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **LOSS_TOL)


def test_vae_phase_g_step_matches_jax(jax_draws):
    """Scale 1 of vae_levels 2: encoder, decoder and body[0] train on
    rec + KL; the reconstruction folds BN and advances the encoder SN."""
    cj, ct, plan, (jst, opt_g, _), tst, batch = _setup(1)
    real, real_zero, noise_init = batch
    core = jsteps._g_step_core(cj, jnet.generator_hpvaegan_apply,
                               jnet.wdiscriminator2d_apply, opt_g, plan,
                               vae_phase=True, cd=None)
    new_j, m_j = core(jst, jnp.asarray(real), jnp.asarray(real_zero),
                      jnp.asarray(noise_init), jnp.asarray(AMPS))
    assert [k for k, _ in jax_draws] == ["normal"]  # eps only

    tst.noise = replay(jax_draws)
    m_t = tsteps.g_step(ct, tst, nchw(real), nchw(real_zero),
                        nchw(noise_init), list(AMPS), vae_phase=True)
    assert not tst.noise.drawn
    _metrics_match(m_t, m_j)
    _g_grads_match(tst.G, plan, opt_g.grads[0], ct.grad_clip)
    assert_trees_close(to_jax(tst.G.state_dict())[1], new_j.g_state, **OP_TOL)


@pytest.mark.parametrize("bug_compat", [False, True])
def test_gan_iteration_matches_jax(jax_draws, bug_compat):
    """Scale 3 of vae_levels 2: the D step (fake under no_grad, real pass's
    SN state kept, GP double backward), then the G step (recon then fake,
    BN folded twice) against the updated D. bug_compat freezes alpha at
    0.5 and detaches the fake in the adversarial term."""
    cj, ct, plan, (jst, opt_g, opt_d), tst, batch = _setup(3, bug_compat)
    real, real_zero, noise_init = batch
    amps = jnp.asarray(AMPS)

    d_core = jsteps._d_step_core(cj, jnet.generator_hpvaegan_apply,
                                 jnet.wdiscriminator2d_apply, opt_d, None)
    mid_j, md_j = d_core(jst, jnp.asarray(real), jnp.asarray(noise_init),
                         amps)
    _, _, k_alpha = jax.random.split(jst.key, 3)
    draws = list(jax_draws)
    if not bug_compat:
        draws.append(("uniform", np.asarray(jax.random.uniform(k_alpha, ()))))
    g_state_before = to_jax(tst.G.state_dict())[1]
    tst.noise = replay(draws)
    md_t = tsteps.d_step(ct, tst, nchw(real), nchw(noise_init), list(AMPS))
    assert not tst.noise.drawn
    _metrics_match(md_t, md_j)
    assert_trees_close(port_grads(tst.D, to_jax_discriminator),
                       opt_d.grads[0], **OP_TOL)
    assert_trees_close(to_jax_discriminator(tst.D.state_dict())[1],
                       mid_j.d_state, **OP_TOL)
    # the D step keeps none of G's state
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           to_jax(tst.G.state_dict())[1], g_state_before)
    # the port's D after its step drives its G step, as the JAX one's does
    assert_trees_close(to_jax_discriminator(tst.D.state_dict())[0],
                       mid_j.d_params, rtol=0, atol=1e-6)

    jax_draws.clear()
    g_core = jsteps._g_step_core(cj, jnet.generator_hpvaegan_apply,
                                 jnet.wdiscriminator2d_apply, opt_g, plan,
                                 vae_phase=False, cd=None)
    new_j, mg_j = g_core(mid_j, jnp.asarray(real), jnp.asarray(real_zero),
                         jnp.asarray(noise_init), amps)
    assert [k for k, _ in jax_draws] == ["normal"] * 4  # eps, 3 stages
    tst.noise = replay(jax_draws)
    d_state = {k: v.clone() for k, v in tst.D.state_dict().items()}
    mg_t = tsteps.g_step(ct, tst, nchw(real), nchw(real_zero),
                         nchw(noise_init), list(AMPS), vae_phase=False)
    _metrics_match(mg_t, mg_j)
    _g_grads_match(tst.G, plan, opt_g.grads[0], ct.grad_clip)
    assert_trees_close(to_jax(tst.G.state_dict())[1], new_j.g_state, **OP_TOL)
    # D's weights and (u, v) do not move in the G step
    assert all(torch.equal(v, d_state[k])
               for k, v in tst.D.state_dict().items())


def test_calibration_matches_jax():
    """RMSE of a reconstruction, and no state kept."""
    cj, ct, _, (jst, _, _), tst, batch = _setup(2, seed=4)
    real, real_zero, _ = batch
    key = jax.random.PRNGKey(21)
    calib = jsteps.make_calibration(cj, jnet.generator_hpvaegan_apply)
    want = float(calib(jst.g_params, jst.g_state, jnp.asarray(real),
                       jnp.asarray(real_zero), jnp.asarray(AMPS), key))
    kz, _ = jax.random.split(key)
    eps = np.asarray(jax.random.normal(kz, (2, 17, 17, cj.latent_dim)))
    before = {k: v.clone() for k, v in tst.G.state_dict().items()}
    got = tsteps.calibrate(tst.G, nchw(real), nchw(real_zero), list(AMPS),
                           replay([("normal", eps)]))
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    assert all(torch.equal(v, before[k])
               for k, v in tst.G.state_dict().items())


# ------------------------------------------------------------- trainer ---

@pytest.mark.parametrize("mode", ["default", "const_amp", "bug_compat"])
def test_trainer_amps_and_d_warm_start(tmp_path, monkeypatch, mode):
    """The amp of every scale after 0: noise_amp_init * RMSE, divided by the
    batch size again only under bug_compat, 1.0 under const_amp; D warm-
    starts from netD_<k-1> at scales k > vae_levels (2 here)."""
    kw = dict(image_path=IMAGE, run_dir=str(tmp_path), niter=1,
              print_interval=1, batch_size=2)
    if mode != "default":
        kw[mode] = True
    _, ct = cfgs(**kw)
    monkeypatch.setattr(ttrainer, "calibrate",
                        lambda *args: torch.tensor(0.5))
    loaded = []
    load = DataSaver.load_checkpoint

    def spy(self, filename, path=None):
        loaded.append(filename)
        return load(self, filename, path)

    monkeypatch.setattr(DataSaver, "load_checkpoint", spy)
    G, amps = ttrainer.run_training(ct, DataSaver(ct, create=True),
                                    device="cpu", seed=3)
    want = {"default": 0.05, "const_amp": 1.0, "bug_compat": 0.025}[mode]
    assert amps == [1.0] + [pytest.approx(want)] * 4
    assert loaded == ["netD_2.ckpt", "netD_3.ckpt"]
    assert len(G.body) == 4


def test_trainer_aborts_on_non_finite_metrics(tmp_path, monkeypatch):
    _, ct = cfgs(image_path=IMAGE, run_dir=str(tmp_path), niter=2,
                 print_interval=2)
    monkeypatch.setattr(tchunk, "train_iteration",
                        lambda *args: {"g_loss": torch.tensor(float("nan"))})
    saver = DataSaver(ct, create=True)
    with pytest.raises(RuntimeError, match="non-finite.*g_loss"):
        ttrainer.run_training(ct, saver, device="cpu", seed=0)
    assert not os.path.exists(os.path.join(saver.experiment_dir,
                                           "netG_0.ckpt"))


# ----------------------------------------------------------------- CLI ---

# one iteration a chunk: the per-iteration cadence of the logbook, images
# and inflight checkpoints that these tests and the ones that import TINY
# hold (tests/test_torch_train_chunk.py holds the default chunks)
TINY = ["--image-path", IMAGE, "--checkname", "smoke", "--nfc", "8",
        "--latent-dim", "8", "--num-layer", "1", "--enc-blocks", "1",
        "--niter", "4", "--img-size", "32", "--min-size", "16",
        "--max-size", "32", "--vae-levels", "2", "--print-interval", "2",
        "--manualSeed", "1", "--device", "cpu", "--steps-per-call", "1"]


@pytest.fixture
def restore_logging():
    """main() installs its console and logbook handlers on the root logger;
    put pytest's back and close the logbook afterwards."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers:
        if h not in handlers:
            h.close()
    root.handlers, root.level = handlers, level


def test_train_cli_on_cpu_writes_a_jax_experiment(tmp_path, restore_logging):
    """The CLI end to end: a JAX-format experiment whose netG and netD the
    JAX package loads and applies, and which its eval loader reads."""
    exp = ttrain_cli.main(TINY + ["--run-dir", str(tmp_path)])
    assert exp == os.path.join(str(tmp_path), "air_balloons", "smoke",
                               "experiment_0")
    files = set(os.listdir(exp))
    assert {f"netG_{k}.ckpt" for k in range(5)} <= files
    assert {f"netD_{k}.ckpt" for k in range(2, 5)} <= files
    assert "netD_0.ckpt" not in files and "netD_1.ckpt" not in files
    assert {"args.txt", "logbook.txt", "intermediate.json"} <= files
    with open(os.path.join(exp, "intermediate.json")) as f:
        inter = json.load(f)
    assert inter["scale_idx"] == 4 and "key" not in inter
    amps = inter["noise_amps"]
    assert len(amps) == 5 and amps[0] == 1.0
    assert all(np.isfinite(a) and a > 0 for a in amps)
    with open(os.path.join(exp, "logbook.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if "g_loss" in ln]
    assert len(lines) == 5 * 2  # niter 4, print interval 2
    assert "d_loss" in lines[-1] and "d_loss" not in lines[0]
    with open(os.path.join(exp, "args.txt")) as f:
        assert "ar: 0.75" in f.read()

    cfg = jeval.hydrate_config(exp, dict(scale_idx=-1, netG=""))
    params, state, _ = jeval.load_generator(cfg, exp, ndim=2)
    assert cfg.scale_idx == 4 and len(params["body"]) == 4
    ckpt = jsaver.load_pytree(os.path.join(exp, "netG_4.ckpt"))
    h0, w0 = scale_size_2d(0, cfg.scale_factor, cfg.stop_scale, cfg.img_size,
                           cfg.ar)
    h4, w4 = scale_size_2d(4, cfg.scale_factor, cfg.stop_scale, cfg.img_size,
                           cfg.ar)
    z = jax.random.normal(jax.random.PRNGKey(0), (2, h0, w0, 8))
    (x, _, _, _), _ = jnet.generator_hpvaegan_apply(
        cfg, ckpt["params"], ckpt["state"], amps=jnp.asarray(amps + [0.0]),
        noise_init=z, key=jax.random.PRNGKey(1), is_random=True, train=True)
    assert x.shape == (2, h4, w4, 3) and bool(jnp.isfinite(x).all())
    dck = jsaver.load_pytree(os.path.join(exp, "netD_4.ckpt"))
    y, _ = jnet.wdiscriminator2d_apply(cfg, dck["params"], dck["state"], x)
    assert y.shape == (2, h4, w4, 1) and bool(jnp.isfinite(y).all())

    # a second run numbers its experiment one past the largest
    os.rename(exp, exp[:-1] + "9")
    assert ttrain_cli.main(TINY + ["--run-dir", str(tmp_path), "--niter",
                                   "1"]).endswith("experiment_10")


@pytest.mark.parametrize("flag", [
    ["--mesh-data", "2"], ["--mesh-sp", "2"],
    ["--dist-coordinator", "localhost:1234"], ["--dist-nprocs", "2"],
    ["--dist-procid", "0"]])
def test_unported_flags_raise(flag, tmp_path):
    """A data or spatial mesh axis, a coordinator, a process count or a
    process id that one process cannot run is refused with a message
    naming the flag. Nothing is written either way."""
    with pytest.raises(ValueError, match=flag[0]):
        ttrain_cli.main(TINY + ["--run-dir", str(tmp_path)] + flag)
    assert not os.listdir(tmp_path)  # nothing written


def launched_cfg(cli, args, monkeypatch, trainer=ttrainer):
    """cli.main(args) with `trainer`'s run_training replaced by one that
    writes args.txt and returns: (the cfg it was given, the experiment
    dir)."""
    seen = []

    def run_training(cfg, saver, **kw):
        seen.append(cfg)
        cfg.write_args_txt(os.path.join(saver.experiment_dir, "args.txt"))

    monkeypatch.setattr(trainer, "run_training", run_training)
    exp = cli.main(args)
    return seen[0], exp


@pytest.mark.parametrize("flag,field,value", [
    (["--visualize"], "visualize", True),
    (["--paired-g"], "paired_g", True),
    (["--fused-dg"], "fused_dg", True),
    (["--flat-opt"], "flat_opt", True),
    (["--compute-dtype", "bfloat16"], "compute_dtype", "bfloat16"),
    (["--profile-dir", "prof"], None, None)])
def test_training_flags_are_accepted_and_kept(flag, field, value, tmp_path,
                                               monkeypatch, restore_logging):
    """The training flags reach the trainer's cfg and args.txt (as the
    JAX CLI writes them); --profile-dir, which is no Config field there
    either, traces the run into its dir."""
    if flag[0] == "--profile-dir":
        flag = [flag[0], str(tmp_path / "prof")]
    cfg, exp = launched_cfg(ttrain_cli,
                            TINY + ["--run-dir", str(tmp_path)] + flag,
                            monkeypatch)
    if field is None:
        assert os.listdir(tmp_path / "prof") == ["trace.json"]
        return
    assert getattr(cfg, field) == value
    with open(os.path.join(exp, "args.txt")) as f:
        assert f"{field}: {value}" in f.read().splitlines()


def test_train_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain_cli.main(args + ["--run-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)  # nothing written


def test_xla_knobs_are_accepted_and_kept():
    """The JAX trainer's five dispatch flags parse and stay in cfg;
    --scan-unroll, --compile-ahead and --xla-option say that they have no
    effect, and --steps-per-call and --split-step, which set the training
    chunk (training/chunk.py), do not."""
    parser = ttrain_cli.build_parser()
    args = parser.parse_args(
        TINY + ["--steps-per-call", "3", "--scan-unroll", "2",
                "--no-compile-ahead", "--split-step",
                "--xla-option", "a=1"])
    cfg = ttrain_cli.cfg_from_args(args)
    assert (cfg.steps_per_call, cfg.scan_unroll, cfg.compile_ahead,
            cfg.split_step, cfg.xla_options) == (3, 2, False, True,
                                                 {"a": "1"})
    helps = {a.dest: a.help for a in parser._actions}
    for dest in ("scan_unroll", "compile_ahead", "xla_options"):
        assert "no effect" in helps[dest], dest
    for dest in ("steps_per_call", "split_step"):
        assert "no effect" not in helps[dest], dest
