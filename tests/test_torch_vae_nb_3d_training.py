"""The port's 3D GeneratorVAE_nb in training held against the JAX package on
the CPU: one VAE-scale G step, one GAN-scale D + G iteration (also under
--train-all), the amp calibration, --compute-dtype bfloat16 and --fused-dg
iterations, and the CLIs end to end: train_video --generator
GeneratorVAE_nb writes an experiment that the JAX package reads and the
port's eval_video scores and export serves, and a killed run resumes
exactly from its inflight checkpoint.

The JAX package's 3D GeneratorVAE_nb runs through the `shim` of
tests/test_torch_vae_nb_3d.py (its module doc). The states, batches and
draws are those of tests/test_torch_video_training.py's 3D steps with
GeneratorVAE_nb's weights: the JAX draws recorded and replayed to the port
in call order. Tolerances: metrics rtol 1e-4 / atol 1e-7, gradients,
BatchNorm and SN state rtol 1e-4 / atol 2e-5 (the bar of
test_torch_vae_nb.py's 2D iteration); bf16 and fused-dg as
test_torch_flags.py holds the 3D GeneratorHPVAEGAN.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu import optim as joptim
from hpvaegan_tpu.models import networks_3d as jnet
from hpvaegan_tpu.training import partition as jpart
from hpvaegan_tpu.training import steps as jsteps
from hpvaegan_tpu.training.state import ScaleTrainState as JState
from hpvaegan_tpu.utils import saver as jsaver

from hpvaegan_tpu_torch import eval_video as teval_cli
from hpvaegan_tpu_torch import evaluation as teval
from hpvaegan_tpu_torch import optim as toptim
from hpvaegan_tpu_torch import train_video as tvideo_cli
from hpvaegan_tpu_torch.export import __main__ as texport_cli
from hpvaegan_tpu_torch.export import serving
from hpvaegan_tpu_torch.models.blocks import set_compute_dtype
from hpvaegan_tpu_torch.tools import step_parity
from hpvaegan_tpu_torch.training import partition as tpart
from hpvaegan_tpu_torch.training import steps as tsteps
from hpvaegan_tpu_torch.training.state import ScaleTrainState

import test_torch_flags as tf
import test_torch_video_training as t3
from test_torch_flags import f32_bn_reductions, record  # noqa: F401
from test_torch_resume import assert_same_end, killer, marker, run
from test_torch_trainer import LOSS_TOL, Recorder, restore_logging  # noqa
from test_torch_training import OP_TOL, assert_trees_close, port_grads
from test_torch_vae_nb_3d import (AMPS, cfgs, f32_logistic,  # noqa: F401
                                  jax_nb, port_nb, replay, shim, thw,
                                  to_jax3)
from test_torch_video_training import TINY, jax_draws  # noqa: F401

torch.set_num_threads(1)

VTINY_NB = TINY + ["--generator", "GeneratorVAE_nb"]


def _setup(scale_idx, seed=0, **kw):
    """The same 3D GeneratorVAE_nb scale state in both packages (weights,
    plan, optimizers) and one batch of 2 clips, as test_torch_video_
    training.py's _setup makes it for GeneratorHPVAEGAN."""
    cj, ct = cfgs(**kw)
    cj.scale_idx = ct.scale_idx = scale_idx
    g_params, g_state = jax_nb(cj, scale_idx, seed=seed)
    d_params, d_state = t3._jax_discriminator(cj, seed=seed + 7)
    plan = jpart.make_lr_plan(cj, scale_idx, scale_idx)
    opt_g = Recorder(joptim.clipped_adam(jpart.lr_tree_for(
        jpart.split_params(g_params, plan)[0], plan), cj.beta1,
        grad_clip=cj.grad_clip))
    opt_d = Recorder(joptim.adam(cj.lr_d, cj.beta1))
    jst = JState(g_params, g_state, d_params, d_state,
                 opt_g.init(jpart.split_params(g_params, plan)[0]),
                 opt_d.init(d_params), jax.random.PRNGKey(seed + 3))
    G = port_nb(ct, g_params, g_state)
    D = t3._port_discriminator(ct, d_params, d_state)
    tst = ScaleTrainState(
        G, D, toptim.ClippedAdam(tpart.apply_lr_plan(G, plan), ct.beta1,
                                 grad_clip=ct.grad_clip),
        toptim.adam(D.parameters(), ct.lr_d, ct.beta1), None)
    rng = np.random.RandomState(seed + 5)
    td0, h0, w0 = thw(cj, 0)
    real = rng.uniform(-1, 1, (2,) + thw(cj, scale_idx) + (3,))
    real_zero = rng.uniform(-1, 1, (2, td0, h0, w0, 3))
    noise_init = rng.randn(2, td0, h0, w0, cj.latent_dim)
    batch = tuple(a.astype(np.float32) for a in (real, real_zero, noise_init))
    return cj, ct, plan, (jst, opt_g, opt_d), tst, batch


def _jax_batch(batch):
    return [jnp.asarray(a) for a in batch]


def _port_batch(batch):
    return [t3._ncdhw(a) for a in batch]


def test_vae_phase_g_step_matches_jax(shim, jax_draws):
    """Scale 1 of vae_levels 2: rec + KL from z_norm * z_bern (eps, then
    u); kl_bern is not in the loss, as in the JAX steps (out[:4])."""
    cj, ct, plan, (jst, opt_g, _), tst, batch = _setup(1)
    core = jsteps._g_step_core(cj, jnet.generator_vae_nb_apply,
                               jnet.wdiscriminator3d_apply, opt_g, plan,
                               vae_phase=True, cd=None)
    new_j, m_j = core(jst, *_jax_batch(batch), jnp.asarray(AMPS))
    assert [k for k, _ in jax_draws] == ["normal", "uniform"]
    tst.noise = replay(jax_draws)
    m_t = tsteps.g_step(ct, tst, *_port_batch(batch), list(AMPS),
                        vae_phase=True)
    assert not tst.noise.drawn
    t3._metrics_match(m_t, m_j)
    t3._g_grads_match(tst.G, plan, opt_g.grads[0], ct.grad_clip)
    assert_trees_close(to_jax3(tst.G.state_dict())[1], new_j.g_state,
                       **OP_TOL)


@pytest.mark.parametrize("train_all", [False, True])
def test_gan_iteration_matches_jax(shim, jax_draws, train_all):
    """Scale 3 of vae_levels 2: the D step (the fake's gate and noise at
    all 3 stages, then alpha), then the G step (eps, u, then the fake's
    gate and noise) against the updated D. Under --train-all (train_depth
    4) the plan also trains the encoder, the decoder and stage 0, below
    the VAE boundary, whose gradients the unconditional detach makes zero
    in both."""
    cj, ct, plan, (jst, opt_g, opt_d), tst, batch = _setup(
        3, train_all=train_all, train_depth=4)
    real, real_zero, noise_init = batch
    amps = jnp.asarray(AMPS)
    d_core = jsteps._d_step_core(cj, jnet.generator_vae_nb_apply,
                                 jnet.wdiscriminator3d_apply, opt_d, None)
    mid_j, md_j = d_core(jst, jnp.asarray(real), jnp.asarray(noise_init),
                         amps)
    _, _, k_alpha = jax.random.split(jst.key, 3)
    draws = list(jax_draws) + [
        ("uniform", np.asarray(jax.random.uniform(k_alpha, ())))]
    assert [k for k, _ in draws] == ["bernoulli"] + ["normal"] * 3 + \
        ["uniform"]
    tst.noise = replay(draws)
    md_t = tsteps.d_step(ct, tst, t3._ncdhw(real), t3._ncdhw(noise_init),
                         list(AMPS))
    assert not tst.noise.drawn
    t3._metrics_match(md_t, md_j)
    assert_trees_close(port_grads(tst.D, t3._to_jax_d), opt_d.grads[0],
                       **OP_TOL)
    assert_trees_close(t3._to_jax_d(tst.D.state_dict())[1], mid_j.d_state,
                       **OP_TOL)

    jax_draws.clear()
    g_core = jsteps._g_step_core(cj, jnet.generator_vae_nb_apply,
                                 jnet.wdiscriminator3d_apply, opt_g, plan,
                                 vae_phase=False, cd=None)
    new_j, mg_j = g_core(mid_j, jnp.asarray(real), jnp.asarray(real_zero),
                         jnp.asarray(noise_init), amps)
    assert [k for k, _ in jax_draws] == ["normal", "uniform", "bernoulli"] \
        + ["normal"] * 3
    tst.noise = replay(jax_draws)
    mg_t = tsteps.g_step(ct, tst, *_port_batch(batch), list(AMPS),
                         vae_phase=False)
    assert not tst.noise.drawn
    t3._metrics_match(mg_t, mg_j)
    t3._g_grads_match(tst.G, plan, opt_g.grads[0], ct.grad_clip)
    assert_trees_close(to_jax3(tst.G.state_dict())[1], new_j.g_state,
                       **OP_TOL)
    # train_depth 4 > 3 stages: --train-all trains the encoder, the
    # decoder and every stage; those below the boundary get zero
    # gradients in both
    grads = opt_g.grads[0]
    assert ("decoder" in grads and 0 in grads["body"]) == train_all
    if train_all:
        for tree in (grads["encode"], grads["decoder"], grads["body"][0]):
            assert not any(np.any(np.asarray(g))
                           for g in jax.tree_util.tree_leaves(tree))
        for m in (tst.G.encode, tst.G.decoder, tst.G.body[0]):
            assert not any(p.grad.any() for p in m.parameters())


def test_calibration_matches_jax(shim):
    """RMSE of a clip's reconstruction from the same eps and u, and no
    state kept."""
    cj, ct, _, (jst, _, _), tst, batch = _setup(2, seed=4)
    real, real_zero, _ = batch
    key = jax.random.PRNGKey(21)
    calib = jsteps.make_calibration(cj, jnet.generator_vae_nb_apply)
    want = float(calib(jst.g_params, jst.g_state, jnp.asarray(real),
                       jnp.asarray(real_zero), jnp.asarray(AMPS), key))
    kz, kb, _ = jax.random.split(key, 3)
    td0, h0, w0 = thw(cj, 0)
    draws = [("normal", jax.random.normal(kz, (2, 1, 1, 1, cj.latent_dim))),
             ("uniform", jax.random.uniform(kb, (2, td0, h0, w0, 1)))]
    before = {k: v.clone() for k, v in tst.G.state_dict().items()}
    got = tsteps.calibrate(tst.G, t3._ncdhw(real), t3._ncdhw(real_zero),
                           list(AMPS), replay(draws))
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    assert all(torch.equal(v, before[k])
               for k, v in tst.G.state_dict().items())


class NbVariant(tf.Variant):
    """test_torch_flags.py's 3D variant with GeneratorVAE_nb's state."""

    def __init__(self, scale_idx, **kw):
        self.kind, self.ndim, self.jnet = "3d", 3, jnet
        (self.cj, self.ct, self.plan, (self.jst, self.opt_g, self.opt_d),
         self.tst, self.batch) = _setup(scale_idx, **kw)
        self.g_apply = jnet.generator_vae_nb_apply
        self.d_apply = jnet.wdiscriminator3d_apply
        self.clip = self.ct.grad_clip

    def replay(self, draws):
        return replay(draws)


@pytest.mark.parametrize("scale_idx,held", [(1, "GM"), (3, "D")])
def test_bf16_iteration_matches_jax_bf16(shim, record, f32_bn_reductions,
                                         f32_logistic, scale_idx, held):
    """--compute-dtype bfloat16: a VAE-phase G step (scale 1) and a D + G
    iteration (scale 3) against the JAX cores with cd=bfloat16, within
    test_torch_flags.py's bf16 bars and, for the parts in `held`, closer
    to JAX-bf16 than half the JAX-bf16 to JAX-f32 distance (the parts it
    holds for the 3D GeneratorHPVAEGAN, for the same reason)."""
    v = NbVariant(scale_idx)
    drawn = record(jnet)
    vae_phase = v.cj.vae_levels >= scale_idx + 1
    m_bf, dg_bf, gg_bf, st_bf, d_draws, g_draws = tf._jax_iteration(
        v, jnp.bfloat16, vae_phase, drawn)
    m_32, dg_32, gg_32, _, _, _ = tf._jax_iteration(v, None, vae_phase,
                                                    drawn)
    v.ct.compute_dtype = "bfloat16"
    for m in (v.tst.G, v.tst.D):
        set_compute_dtype(m, torch.bfloat16)
    m_t = tf._port_iteration(v, vae_phase, d_draws, g_draws)
    tf._metrics_close(m_t, m_bf, **tf.BF16_LOSS_TOL)
    parts = {"G": (tf._weights(v.g_pairs(gg_bf)),
                   tf._weights(v.g_pairs(gg_32)))}
    if dg_bf is not None:
        parts["D"] = (tf._weights(v.d_pairs(dg_bf)),
                      tf._weights(v.d_pairs(dg_32)))
    for bf, _ in parts.values():
        tf._pairs_close(bf, **tf.BF16_TOL)
    assert_trees_close(to_jax3(v.tst.G.state_dict())[1], st_bf.g_state,
                       **tf.BF16_STATE_TOL)
    assert_trees_close(v.to_d(v.tst.D.state_dict())[1], st_bf.d_state,
                       **tf.BF16_STATE_TOL)
    for part in held:
        if part == "M":
            keys = sorted(m_bf)
            got = tf._ratio(*([[float(m[k]) for k in keys]]
                              for m in (m_t, m_bf, m_32)))
        else:
            bf, f32 = parts[part]
            got = tf._ratio([a for a, _ in bf], [b for _, b in bf],
                            [b for _, b in f32])
        assert got < 0.5, (part, got)


def test_fused_dg_iteration_matches_jax(shim, record):
    """--fused-dg at scale 3: one fake forward (the gate and 3 stages'
    noise) shared by the D loss and G's adversarial term, then alpha, then
    the reconstruction's eps and u; metrics, D's and G's gradients, G's
    BatchNorm state (recon, then the fake), D's (u, v) and weights."""
    v = NbVariant(3)
    drawn = record(jnet)
    new_j, m_j, draws = tf._fused(v, drawn, n_fake=4)
    assert [k for k, _ in draws] == ["bernoulli"] + ["normal"] * 3 + \
        ["uniform", "normal", "uniform"]
    v.tst.noise = v.replay(draws)
    m_t = tsteps.fused_dg_iteration(v.ct, v.tst, *v.port_batch(),
                                    list(AMPS))
    assert not v.tst.noise.drawn
    tf._metrics_close(m_t, m_j, **LOSS_TOL)
    tf._pairs_close(v.d_pairs(v.opt_d.grads[0]), **OP_TOL)
    tf._pairs_close(v.g_pairs(v.opt_g.grads[0]), **OP_TOL)
    assert_trees_close(to_jax3(v.tst.G.state_dict())[1], new_j.g_state,
                       **OP_TOL)
    assert_trees_close(v.to_d(v.tst.D.state_dict())[1], new_j.d_state,
                       **OP_TOL)


@pytest.mark.parametrize("scale_idx", [1, 3])
def test_step_parity_replays_its_own_draws(scale_idx):
    """tools/step_parity.py takes the 3D GeneratorVAE_nb
    (test_torch_cuda.py::test_video_vae_nb_iteration_matches_cpu runs it
    card against CPU): an iteration replayed from
    another's recorded draws, the gate among them, equals it bit for
    bit."""
    ct = cfgs(max_frames=5, hflip=True, batch_size=2)[1]
    rec = step_parity.RecordingNoise(0, "cpu")
    kw = dict(ndim=3, generator="GeneratorVAE_nb")
    a = step_parity.run_iteration(ct, scale_idx, 0, "cpu", rec, **kw)
    gates = [t.shape for t in rec.drawn if t.dtype == torch.bool
             and t.dim() == 5]
    assert gates == ([] if scale_idx == 1 else [(2, 1, 2, 12, 17)] * 2)
    b = step_parity.run_iteration(
        ct, scale_idx, 0, "cpu", step_parity.ReplayedNoise(rec.drawn, "cpu"),
        **kw)
    assert a["metrics"] == b["metrics"]
    for part in ("grads", "state"):
        assert sorted(a[part]) == sorted(b[part])
        for k, x in a[part].items():
            np.testing.assert_array_equal(x, b[part][k], err_msg=k)


# ----------------------------------------------------------------- CLIs ---

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One tiny train_video --generator GeneratorVAE_nb run (the root
    logger's handlers restored afterwards)."""
    import logging
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        yield tvideo_cli.main(VTINY_NB + ["--run-dir", str(
            tmp_path_factory.mktemp("nb3d"))])
    finally:
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers, root.level = handlers, level


def test_train_video_cli_writes_an_experiment_both_packages_read(
        shim, trained, restore_logging, capsys):
    """train_video --generator GeneratorVAE_nb end to end: netG at every
    scale with the bern head, netD at the GAN scales; the JAX package's
    hydrate_config / load_generator(ndim=3) read it and its (shimmed)
    forward applies it; the port's eval_video scores it."""
    exp = trained
    inter = marker(exp)
    assert inter["scale_idx"] == 4 and "key" not in inter
    with open(os.path.join(exp, "args.txt")) as f:
        assert "generator: GeneratorVAE_nb" in f.read().splitlines()
    cfg = jeval.hydrate_config(exp, dict(scale_idx=-1, netG=""))
    assert cfg.generator == "GeneratorVAE_nb"
    params, state, _ = jeval.load_generator(cfg, exp, ndim=3)
    assert "bern" in params["encode"] and len(params["body"]) == 4
    assert params["encode"]["bern"]["w"].shape == (3, 3, 3, 8, 1)
    td0, h0, w0 = thw(cfg, 0)
    (x, _, _, _, _), _ = jnet.generator_vae_nb_apply(
        cfg, params, state, amps=jnp.asarray(inter["noise_amps"] + [0.0]),
        noise_init=jax.random.normal(jax.random.PRNGKey(0),
                                     (2, td0, h0, w0, 8)),
        key=jax.random.PRNGKey(1), is_random=True, train=True)
    assert x.shape == (2, 3, 24, 33, 3) and bool(jnp.isfinite(x).all())
    for k in range(5):
        assert os.path.exists(os.path.join(exp, f"netG_{k}.ckpt"))
        assert os.path.exists(os.path.join(exp, f"netD_{k}.ckpt")) == \
            (k >= 2)
    assert jsaver.load_pytree(os.path.join(exp, "netD_4.ckpt"))

    capsys.readouterr()
    teval_cli.main(["--exp-dir", exp, "--device", "cpu", "--num-samples",
                    "3", "--max-samples", "2"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SVFID: ")]
    assert len(line) == 1 and np.isfinite(float(line[0].split()[1]))


def test_export_cli_serves_the_experiment(trained, restore_logging):
    """python -m hpvaegan_tpu_torch.export on the CPU: the .pt2 of the 3D
    GeneratorVAE_nb sampler (its gated three-way key split) equals the
    eager serving module, bit for bit, and its noise bins have the 3D z
    shape."""
    texport_cli.main(["--exp-dir", trained, "--device", "cpu",
                      "--num-samples", "1"])
    infer = os.path.join(trained, "infer")
    assert os.path.isfile(os.path.join(infer, "netG_4.pt2"))
    with open(os.path.join(infer, "io_spec.txt")) as f:
        assert f.readline().split() == ["f32", "1,8,2,12,17"]
    cfg = teval.hydrate_config(trained, dict(scale_idx=-1, netG=""))
    G, _ = teval.load_generator(cfg, trained, ndim=3, device="cpu")
    module = serving.ServingModule(G)
    assert module.gated
    z, amps, _ = serving.serving_input_specs(cfg, 3)
    z = np.random.RandomState(0).standard_normal(z.shape).astype(np.float32)
    amps = np.asarray(marker(trained)["noise_amps"] + [0.0], np.float32)
    with torch.no_grad():
        eager = module(torch.from_numpy(z), torch.from_numpy(amps),
                       torch.tensor(3, dtype=torch.int32))
    got = serving.load_and_run_serialized(
        os.path.join(infer, "netG_4.pt2"), z, amps, np.int32(3))
    assert got.shape == (1, 3, 3, 24, 33)
    assert torch.equal(got, eager)


def test_bf16_fused_dg_cli_runs_and_keeps_its_flags(tmp_path,
                                                    restore_logging):
    """train_video --generator GeneratorVAE_nb --compute-dtype bfloat16
    --fused-dg (the JAX package's qualified pair): a finished experiment
    with the flags in args.txt and float32 checkpoints."""
    exp = tvideo_cli.main(VTINY_NB + [
        "--run-dir", str(tmp_path), "--compute-dtype", "bfloat16",
        "--fused-dg"])
    with open(os.path.join(exp, "args.txt")) as f:
        args = f.read().splitlines()
    assert {"compute_dtype: bfloat16", "fused_dg: True",
            "generator: GeneratorVAE_nb"} <= set(args)
    ck = jsaver.load_pytree(os.path.join(exp, "netG_4.ckpt"))
    leaves = jax.tree_util.tree_leaves(ck)
    assert all(np.asarray(a).dtype == np.float32 and np.isfinite(a).all()
               for a in leaves)


def test_inflight_resume_ends_as_the_uninterrupted_run(tmp_path,
                                                       restore_logging):
    """Killed after iteration 1 of 2 at the last scale, after its inflight
    checkpoint, and resumed from the marker with another seed: netG_4,
    netD_4 and the amps equal the uninterrupted run's bit for bit."""
    common = ["--generator", "GeneratorVAE_nb", "--ckpt-interval", "1"]
    ref = run("video", common + ["--run-dir", str(tmp_path / "a")])
    killed = run("video", common + ["--run-dir", str(tmp_path / "b")],
                 kill=killer(4, 1))
    inter = marker(killed)
    assert (inter["inflight"], inter["inflight_iter"]) == \
        ("inflight_4.ckpt", 1)
    resumed = run("video", common + [
        "--run-dir", str(tmp_path / "c"), "--manualSeed", "77",
        "--netG", os.path.join(killed, "inflight_4.ckpt"),
        "--intermediate", os.path.join(killed, "intermediate.json")])
    assert_same_end(ref, resumed, 4)
    with open(os.path.join(resumed, "intermediate.json")) as f:
        final = json.load(f)
    assert "inflight" not in final and final["torch_rng"] == "torch_rng_4.pt"
