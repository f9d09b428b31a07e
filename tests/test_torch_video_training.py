"""The port's video training slice held against the JAX package on the CPU:
WDiscriminator3D and its converter, the video batch former, the 5D
gradient penalty, the 3D D and G steps, calibration, the per-scale
schedule, and the train_video CLI end to end.

Inputs, weights and draws are made with numpy or by the JAX package from
fixed seeds and go through both packages; the port works in NCDHW, the JAX
package in NDHWC. The JAX draws of each step (window starts, flips, z_init,
the refinement noise, eps, the GP alpha) are recorded or reproduced from
its key splits and replayed to the port in call order. Tolerances: rtol
1e-4, atol 2e-5 per op and for gradients and state; losses rtol 1e-4,
atol 1e-7; atol 1e-4 for multi-scale generator outputs.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu import config as jcfg
from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu import losses as jlosses
from hpvaegan_tpu import optim as joptim
from hpvaegan_tpu.data import video as jvideo
from hpvaegan_tpu.models import networks_2d as jnet2
from hpvaegan_tpu.models import networks_3d as jnet
from hpvaegan_tpu.tools import convert as jconvert
from hpvaegan_tpu.training import partition as jpart
from hpvaegan_tpu.training import steps as jsteps
from hpvaegan_tpu.training.state import ScaleTrainState as JState
from hpvaegan_tpu.utils import pyramid as jpyr
from hpvaegan_tpu.utils import saver as jsaver
from hpvaegan_tpu.utils.noise import generate_noise as jnoise

from hpvaegan_tpu_torch import config as tcfg
from hpvaegan_tpu_torch import eval_video as teval_cli
from hpvaegan_tpu_torch import losses as tlosses
from hpvaegan_tpu_torch import models as tmodels
from hpvaegan_tpu_torch import optim as toptim
from hpvaegan_tpu_torch import train_image as timage_cli
from hpvaegan_tpu_torch import train_video as tvideo_cli
from hpvaegan_tpu_torch.data import video as tvideo
from hpvaegan_tpu_torch.models.blocks import assign_sn_state
from hpvaegan_tpu_torch.models.networks_3d import (WDiscriminator3D,
                                                   WDiscriminatorBaselines)
from hpvaegan_tpu_torch.tools.convert import (_v_perm, from_jax_discriminator,
                                              to_jax, to_jax_discriminator)
from hpvaegan_tpu_torch.tools.step_parity import ReplayedNoise
from hpvaegan_tpu_torch.training import partition as tpart
from hpvaegan_tpu_torch.training import steps as tsteps
from hpvaegan_tpu_torch.training import trainer as ttrainer
from hpvaegan_tpu_torch.training.state import ScaleTrainState
from hpvaegan_tpu_torch.utils.saver import new_experiment_dir

from test_torch_trainer import (LOSS_TOL, Recorder, _clipped, launched_cfg,
                                restore_logging)  # noqa: F401 (a fixture)
from test_torch_training import OP_TOL, assert_trees_close, port_grads
from test_torch_video import (CFG, GEN_TOL, SYNTHETIC, _cfgs, _ncdhw, _ndhwc,
                              _perturb_tree, _port_generator, _stage_thw)

torch.set_num_threads(1)

AMPS = np.asarray([1.0, 0.3, 0.2, 0.1, 0.05, 0.0], np.float32)


def _replay(draws):
    """ReplayedNoise over JAX draws in call order: ("normal", NDHWC array,
    handed over NCDHW), ("uniform", scalar), ("bernoulli", bools) or
    ("randint", ints)."""
    def one(kind, a):
        a = np.asarray(a)
        if kind == "bernoulli":
            return torch.from_numpy(a.astype(bool).reshape(-1))
        if kind == "randint":
            return torch.from_numpy(a.astype(np.int64))
        return _ncdhw(a.astype(np.float32)) if a.ndim == 5 else \
            torch.from_numpy(a.astype(np.float32))
    return ReplayedNoise([one(k, a) for k, a in draws], "cpu")


def _jax_discriminator(cfg, seed):
    params, state = jnet.wdiscriminator3d_init(cfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    return _perturb_tree(params, rng), jax.tree_util.tree_map(np.asarray,
                                                              state)


def _port_discriminator(cfg, params, state):
    D = tmodels.get_discriminator("WDiscriminator3D", 3)(cfg)
    D.load_state_dict(from_jax_discriminator(params, state, ndim=3))
    return D


def _jax_generator(cfg, scale_idx, seed):
    params, state = jnet.generator_hpvaegan_init(cfg, jax.random.PRNGKey(seed))
    for k in range(scale_idx):
        params, state = jnet.generator_init_next_stage(
            cfg, params, state, jax.random.PRNGKey(seed + 1 + k))
    rng = np.random.RandomState(seed)
    return _perturb_tree(params, rng), _perturb_tree(state, rng)


def _to_jax_d(sd):
    return to_jax_discriminator(sd, ndim=3)


def _to_jax_g(sd):
    return to_jax(sd, ndim=3)


# ------------------------------------------------------- discriminator ---

def test_wdiscriminator3d_forward_and_sn_state_match_jax():
    """Scores (B, 1, T, H, W) with the tail's padding 1, and the new (u, v)
    of every SN conv; the forward writes no buffer."""
    cj, ct = _cfgs()
    params, state = _jax_discriminator(cj, seed=1)
    x = np.random.RandomState(2).randn(2, 3, 13, 17, 3).astype(np.float32)
    y_j, new_state = jnet.wdiscriminator3d_apply(cj, params, state,
                                                 jnp.asarray(x))
    D = _port_discriminator(ct, params, state)
    before = {k: v.clone() for k, v in D.state_dict().items()}
    y_t, sn_state = D(_ncdhw(x))
    assert all(torch.equal(v, before[k]) for k, v in D.state_dict().items())
    assert y_t.shape == (2, 1, 3, 13, 17)
    np.testing.assert_allclose(_ndhwc(y_t), np.asarray(y_j), **OP_TOL)
    assign_sn_state(D, sn_state)
    assert_trees_close(to_jax_discriminator(D.state_dict(), ndim=3)[1],
                       new_state, **OP_TOL)
    conv = D.head.conv
    perm = _v_perm(tuple(conv.weight_orig.shape))
    np.testing.assert_allclose(conv.weight_v.numpy()[perm],
                               np.asarray(new_state["head"]["sn"]["v"]),
                               **OP_TOL)


def test_wdiscriminator3d_checkpoint_round_trip_and_rank_check():
    """netD (params, state) -> the port -> back, bit for bit, and equal to
    the JAX package's own torch->JAX converter; a 2D checkpoint read as 3D
    (and the reverse) is refused."""
    cj, _ = _cfgs()
    params, state = _jax_discriminator(cj, seed=3)
    sd = from_jax_discriminator(params, state, ndim=3)
    assert sd["head.conv.weight_orig"].shape == (8, 3, 3, 3, 3)  # OIDHW
    p2, s2 = to_jax_discriminator(sd, ndim=3)
    pj, sj = jconvert.p2j_WDiscriminator(
        {k: v.numpy() for k, v in sd.items()}, ndim=3)
    for got, ref in ((p2, params), (s2, state), (p2, pj), (s2, sj)):
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(ref))
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
            got, ref)
    with pytest.raises(ValueError, match="rank"):
        to_jax_discriminator(sd, ndim=2)
    d2p, d2s = jnet2.wdiscriminator2d_init(cj, jax.random.PRNGKey(4))
    with pytest.raises(ValueError, match="rank"):
        from_jax_discriminator(d2p, d2s, ndim=3)


def test_registry_has_the_3d_discriminator():
    assert tmodels.get_discriminator("WDiscriminator3D", 3) is WDiscriminator3D
    assert tmodels.get_discriminator("WDiscriminatorBaselines", 3) is \
        WDiscriminatorBaselines
    with pytest.raises(NotImplementedError):
        tmodels.get_discriminator("WDiscriminator3D", 2)
    with pytest.raises(NotImplementedError):
        tmodels.get_discriminator("WDiscriminatorBaselines", 2)
    with pytest.raises(NotImplementedError):
        tmodels.get_generator("GeneratorCSG", 2)


# ------------------------------------------------------ batch former ---

def _flip_key(batch):
    """A key whose flips take both branches."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        _, k_flip, _ = jax.random.split(key, 3)
        flips = np.asarray(jax.random.bernoulli(k_flip, 0.5,
                                                (batch, 1, 1, 1, 1)))
        if flips.any() and not flips.all():
            return key
    raise AssertionError("no key flips some samples and not others")


@pytest.mark.parametrize("hflip", [True, False])
def test_video_batch_former_matches_jax(hflip):
    """Batch 4 at scale 4, whose sampling rate (1) differs from
    sampling_rates[0] (2): random windows of the scale's frames and of
    scale 0's from the same starts, per-sample flips, [-1, 1], z_init at
    scale 0's time depth; JAX's starts, flips and noise replayed."""
    batch, scale = 4, 4
    cj, ct = _cfgs(batch_size=batch, hflip=hflip)
    _, _, fps_index = jpyr.get_fps_td_by_index(
        scale, cj.stop_scale_time, cj.sampling_rates, cj.org_fps, cj.fps_lcm)
    assert cj.sampling_rates[fps_index] != cj.sampling_rates[0]
    td0, h0, w0 = _stage_thw(cj, 0)
    _, h, w = _stage_thw(cj, scale)
    rng = np.random.RandomState(0)
    frames = rng.rand(1, 5, h, w, 3).astype(np.float32)
    zero = rng.rand(1, 5, h0, w0, 3).astype(np.float32)
    key = _flip_key(batch)
    real_j, zero_j, noise_j = jvideo.make_video_batch_body(cj, scale)(
        jnp.asarray(frames), jnp.asarray(zero), key)

    k_start, k_flip, k_noise = jax.random.split(key, 3)
    starts = np.asarray(jax.random.randint(k_start, (batch,), 0, 5 - 2))
    assert len(set(starts.tolist())) > 1
    draws = [("randint", starts)]
    if hflip:
        draws.append(("bernoulli", jax.random.bernoulli(
            k_flip, 0.5, (batch, 1, 1, 1, 1))))
    draws.append(("normal", jnoise(k_noise, (batch, td0, h0, w0,
                                             cj.latent_dim))))
    noise = _replay(draws)
    real_t, zero_t, noise_t = tvideo.make_video_batch(
        ct, _ncdhw(frames), _ncdhw(zero), noise, scale_idx=scale)
    assert not noise.drawn
    assert real_t.shape == (batch, 3, 3, h, w)  # frames s, s+1, s+2
    assert zero_t.shape == (batch, 3, 2, h0, w0)  # frames s, s+2
    # dense in the port's 3D layout, channels-last (ops/layout.py)
    assert all(t.is_contiguous(memory_format=torch.channels_last_3d)
               for t in (real_t, zero_t))
    np.testing.assert_allclose(_ndhwc(real_t), np.asarray(real_j), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(_ndhwc(zero_t), np.asarray(zero_j), rtol=0,
                               atol=2e-6)
    np.testing.assert_array_equal(_ndhwc(noise_t), np.asarray(noise_j))


def test_batch_former_per_ndim():
    assert tsteps.batch_former(2, 3) is tsteps.make_image_batch
    former = tsteps.batch_former(3, 2)
    assert former.func is tvideo.make_video_batch
    assert former.keywords == {"scale_idx": 2}


# -------------------------------------------------------------- losses ---

@pytest.mark.parametrize("which", ["gp", "d_loss"])
def test_d_loss_and_gp_double_backward_5d_match_jax(which):
    """The GP's per-channel norm over dim 1 of NCDHW (axis -1 of NDHWC
    there) and the full D loss on clips: values, metrics, and D's
    gradients through the double backward."""
    cj, ct = _cfgs()
    params, state = _jax_discriminator(cj, seed=5)
    rng = np.random.RandomState(6)
    real = rng.uniform(-1, 1, (2, 3, 12, 16, 3)).astype(np.float32)
    fake = rng.uniform(-1, 1, (2, 3, 12, 16, 3)).astype(np.float32)
    alpha = 0.37

    def jd(p):
        return lambda x: jnet.wdiscriminator3d_apply(cj, p, state, x)[0]

    def jloss(p):
        if which == "gp":
            return jlosses.gradient_penalty(jd(p), jnp.asarray(real),
                                            jnp.asarray(fake), alpha,
                                            cj.lambda_grad), {}
        return jlosses.d_loss_fn(cj, jd(p), jnp.asarray(real),
                                 jnp.asarray(fake), alpha)

    (val_j, aux_j), g_j = jax.value_and_grad(jloss, has_aux=True)(params)
    D = _port_discriminator(ct, params, state)

    def td(x):
        return D(x)[0]

    if which == "gp":
        val_t, aux_t = tlosses.gradient_penalty(
            td, _ncdhw(real), _ncdhw(fake), torch.tensor(alpha),
            ct.lambda_grad), {}
    else:
        val_t, aux_t = tlosses.d_loss_fn(ct, td, _ncdhw(real), _ncdhw(fake),
                                         torch.tensor(alpha))
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), **LOSS_TOL)
    assert sorted(aux_t) == sorted(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(aux_t[k].item(), float(aux_j[k]),
                                   **LOSS_TOL)
    assert_trees_close(port_grads(D, _to_jax_d), g_j, **OP_TOL)


# --------------------------------------------------------------- steps ---

@pytest.fixture
def jax_draws(monkeypatch):
    """Records every draw of the JAX 3D generator, in order (NDHWC)."""
    drawn = []
    orig = jnet.generate_noise

    def record(key, shape, kind="normal", dtype=jnp.float32):
        out = orig(key, shape, kind, dtype)
        drawn.append((kind, np.asarray(out)))
        return out

    monkeypatch.setattr(jnet, "generate_noise", record)
    return drawn


def _setup(scale_idx, bug_compat=False, seed=0):
    """The same 3D scale state in both packages: weights, plan, optimizers,
    and one batch of 2 clips."""
    cj, ct = _cfgs(bug_compat=bug_compat)
    cj.scale_idx = ct.scale_idx = scale_idx
    g_params, g_state = _jax_generator(cj, scale_idx, seed=seed)
    d_params, d_state = _jax_discriminator(cj, seed=seed + 7)
    plan = jpart.make_lr_plan(cj, scale_idx, scale_idx)
    opt_g = Recorder(joptim.clipped_adam(jpart.lr_tree_for(
        jpart.split_params(g_params, plan)[0], plan), cj.beta1,
        grad_clip=cj.grad_clip))
    opt_d = Recorder(joptim.adam(cj.lr_d, cj.beta1))
    jst = JState(g_params, g_state, d_params, d_state,
                 opt_g.init(jpart.split_params(g_params, plan)[0]),
                 opt_d.init(d_params), jax.random.PRNGKey(seed + 3))

    G = _port_generator(ct, g_params, g_state)
    D = _port_discriminator(ct, d_params, d_state)
    tst = ScaleTrainState(
        G, D, toptim.ClippedAdam(tpart.apply_lr_plan(G, plan), ct.beta1,
                                 grad_clip=ct.grad_clip),
        toptim.adam(D.parameters(), ct.lr_d, ct.beta1), None)

    rng = np.random.RandomState(seed + 5)
    td0, h0, w0 = _stage_thw(cj, 0)
    real = rng.uniform(-1, 1, (2,) + tuple(_stage_thw(cj, scale_idx)) + (3,))
    real_zero = rng.uniform(-1, 1, (2, td0, h0, w0, 3))
    noise_init = rng.randn(2, td0, h0, w0, cj.latent_dim)
    batch = tuple(a.astype(np.float32) for a in (real, real_zero, noise_init))
    return cj, ct, plan, (jst, opt_g, opt_d), tst, batch


def _g_grads_match(G, plan, jax_grads, clip):
    """Port .grad of the trainable subtrees == the JAX grads tree."""
    port = port_grads(G, _to_jax_g)
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


def test_vae_phase_3d_g_step_matches_jax(jax_draws):
    """Scale 1 of vae_levels 2: encoder, decoder and body[0] train on
    rec + KL; the reconstruction folds BN and advances the encoder SN; no
    refinement noise (the stage is below vae_levels)."""
    cj, ct, plan, (jst, opt_g, _), tst, batch = _setup(1)
    core = jsteps._g_step_core(cj, jnet.generator_hpvaegan_apply,
                               jnet.wdiscriminator3d_apply, opt_g, plan,
                               vae_phase=True, cd=None)
    new_j, m_j = core(jst, *(jnp.asarray(a) for a in batch),
                      jnp.asarray(AMPS))
    assert [k for k, _ in jax_draws] == ["normal"]  # eps only

    tst.noise = _replay(jax_draws)
    m_t = tsteps.g_step(ct, tst, *(_ncdhw(a) for a in batch), list(AMPS),
                        vae_phase=True)
    assert not tst.noise.drawn
    _metrics_match(m_t, m_j)
    _g_grads_match(tst.G, plan, opt_g.grads[0], ct.grad_clip)
    assert_trees_close(_to_jax_g(tst.G.state_dict())[1], new_j.g_state,
                       **OP_TOL)


@pytest.mark.parametrize("bug_compat", [False, True])
def test_gan_3d_iteration_matches_jax(jax_draws, bug_compat):
    """Scale 3 of vae_levels 2: the D step (fake under no_grad, real pass's
    SN state kept, GP double backward on clips), then the G step (recon
    then fake, BN folded twice) against the updated D. Noise is drawn only
    at stages idx + 1 >= vae_levels (2 of the 3 here)."""
    cj, ct, plan, (jst, opt_g, opt_d), tst, batch = _setup(3, bug_compat)
    real, real_zero, noise_init = batch
    amps = jnp.asarray(AMPS)

    d_core = jsteps._d_step_core(cj, jnet.generator_hpvaegan_apply,
                                 jnet.wdiscriminator3d_apply, opt_d, None)
    mid_j, md_j = d_core(jst, jnp.asarray(real), jnp.asarray(noise_init),
                         amps)
    assert [k for k, _ in jax_draws] == ["normal"] * 2
    _, _, k_alpha = jax.random.split(jst.key, 3)
    draws = list(jax_draws)
    if not bug_compat:
        draws.append(("uniform", np.asarray(jax.random.uniform(k_alpha, ()))))
    g_state_before = _to_jax_g(tst.G.state_dict())[1]
    tst.noise = _replay(draws)
    md_t = tsteps.d_step(ct, tst, _ncdhw(real), _ncdhw(noise_init),
                         list(AMPS))
    assert not tst.noise.drawn
    _metrics_match(md_t, md_j)
    assert_trees_close(port_grads(tst.D, _to_jax_d), opt_d.grads[0],
                       **OP_TOL)
    assert_trees_close(_to_jax_d(tst.D.state_dict())[1], mid_j.d_state,
                       **OP_TOL)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           _to_jax_g(tst.G.state_dict())[1], g_state_before)
    assert_trees_close(_to_jax_d(tst.D.state_dict())[0], mid_j.d_params,
                       rtol=0, atol=1e-6)

    jax_draws.clear()
    g_core = jsteps._g_step_core(cj, jnet.generator_hpvaegan_apply,
                                 jnet.wdiscriminator3d_apply, opt_g, plan,
                                 vae_phase=False, cd=None)
    new_j, mg_j = g_core(mid_j, jnp.asarray(real), jnp.asarray(real_zero),
                         jnp.asarray(noise_init), amps)
    assert [k for k, _ in jax_draws] == ["normal"] * 3  # eps, 2 stages
    tst.noise = _replay(jax_draws)
    d_state = {k: v.clone() for k, v in tst.D.state_dict().items()}
    mg_t = tsteps.g_step(ct, tst, _ncdhw(real), _ncdhw(real_zero),
                         _ncdhw(noise_init), list(AMPS), vae_phase=False)
    assert not tst.noise.drawn
    _metrics_match(mg_t, mg_j)
    _g_grads_match(tst.G, plan, opt_g.grads[0], ct.grad_clip)
    assert_trees_close(_to_jax_g(tst.G.state_dict())[1], new_j.g_state,
                       **OP_TOL)
    assert all(torch.equal(v, d_state[k])
               for k, v in tst.D.state_dict().items())


def test_calibration_3d_matches_jax():
    """RMSE of a clip's reconstruction, and no state kept."""
    cj, ct, _, (jst, _, _), tst, batch = _setup(2, seed=4)
    real, real_zero, _ = batch
    key = jax.random.PRNGKey(21)
    calib = jsteps.make_calibration(cj, jnet.generator_hpvaegan_apply)
    want = float(calib(jst.g_params, jst.g_state, jnp.asarray(real),
                       jnp.asarray(real_zero), jnp.asarray(AMPS), key))
    kz, _ = jax.random.split(key)
    td0, h0, w0 = _stage_thw(cj, 0)
    eps = np.asarray(jax.random.normal(kz, (2, td0, h0, w0, cj.latent_dim)))
    before = {k: v.clone() for k, v in tst.G.state_dict().items()}
    got = tsteps.calibrate(tst.G, _ncdhw(real), _ncdhw(real_zero),
                           list(AMPS), _replay([("normal", eps)]))
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    assert all(torch.equal(v, before[k])
               for k, v in tst.G.state_dict().items())


# ------------------------------------------------------------- trainer ---

def test_trainer_sets_the_jax_per_scale_schedule(tmp_path, monkeypatch,
                                                 caplog):
    """At every scale the trainer sets cfg.fps, cfg.td and cfg.fps_index as
    the JAX trainer does (get_fps_td_by_index of the scale), logs them,
    and trains the 3D networks on the video dataset's frames."""
    ct = tcfg.Config(**CFG, run_dir=str(tmp_path), niter=1).finalize()
    cj = jcfg.Config(**CFG).finalize()
    jvideo.SingleVideoDataset(cj)
    seen = []

    def spy(cfg, G, dataset, saver, noise_amps, noise, init_gen, *resume):
        assert G.ndim == 3 and len(G.body) == cfg.scale_idx
        assert dataset.scale_frames(cfg.scale_idx).ndim == 5
        seen.append((cfg.scale_idx, cfg.fps, cfg.td, cfg.fps_index))
        return list(noise_amps) + [1.0]

    monkeypatch.setattr(ttrainer, "train_scale", spy)
    with caplog.at_level(logging.INFO):
        ttrainer.run_training(ct, ttrainer.DataSaver(ct, create=True),
                              device="cpu", seed=0, mode="video")
    want = [(k,) + tuple(jpyr.get_fps_td_by_index(
        k, cj.stop_scale_time, cj.sampling_rates, cj.org_fps, cj.fps_lcm))
        for k in range(cj.stop_scale + 1)]
    assert seen == want
    assert [t for _, _, t, _ in seen] == [2, 2, 2, 2, 3]
    assert "scale 4: fps 24.00, time-depth 3, rate 1" in caplog.text
    with pytest.raises(ValueError, match="mode"):
        ttrainer.run_training(ct, None, device="cpu", mode="audio")


def test_saver_names_the_clip_after_the_video():
    cfg = tcfg.Config(video_path="some/dir/clip.name.avi", run_dir="r",
                      checkname="c")
    assert new_experiment_dir(cfg) == os.path.join("r", "clip.name", "c",
                                                   "experiment_0")
    cfg.image_path = "x/pic.png"  # the image wins where both are set
    assert new_experiment_dir(cfg).startswith(os.path.join("r", "pic", "c"))
    with pytest.raises(AttributeError):
        new_experiment_dir(tcfg.Config())


# ----------------------------------------------------------------- CLI ---

# one iteration a chunk: the per-iteration cadence that these tests and
# the ones that import TINY hold (tests/test_torch_train_chunk.py holds
# the default chunks)
TINY = ["--video-path", SYNTHETIC, "--sampling-rates", "2", "1",
        "--max-frames", "5", "--checkname", "smoke", "--nfc", "8",
        "--latent-dim", "8", "--num-layer", "2", "--enc-blocks", "1",
        "--niter", "2", "--img-size", "32", "--min-size", "16",
        "--max-size", "32", "--vae-levels", "2", "--print-interval", "1",
        "--manualSeed", "1", "--device", "cpu", "--steps-per-call", "1"]
VIDEO_KEYS = ("org_fps", "fps_lcm", "ar", "sampling_rates", "max_frames",
              "start_frame", "video_path", "discriminator", "niter")


def _args_txt(path):
    with open(path) as f:
        return dict(ln.rstrip("\n").split(": ", 1) for ln in f if ": " in ln)


def test_train_video_cli_on_cpu_writes_a_jax_experiment(tmp_path, capsys,
                                                        restore_logging):
    """The CLI end to end: run/<clip>/<checkname>/experiment_0 with netG at
    every scale, netD at the GAN scales, intermediate.json and an args.txt
    whose video keys are what the JAX dataset and config write for the same
    flags; the JAX package loads and applies netG and netD, and the port's
    eval_video CLI scores the experiment."""
    exp = tvideo_cli.main(TINY + ["--run-dir", str(tmp_path)])
    assert exp == os.path.join(str(tmp_path), "synthetic", "smoke",
                               "experiment_0")
    files = set(os.listdir(exp))
    assert {f"netG_{k}.ckpt" for k in range(5)} <= files
    assert {f for f in files if f.startswith("netD_")} == {
        f"netD_{k}.ckpt" for k in range(2, 5)}
    assert {"args.txt", "logbook.txt", "intermediate.json"} <= files
    with open(os.path.join(exp, "intermediate.json")) as f:
        inter = json.load(f)
    amps = inter["noise_amps"]
    assert inter["scale_idx"] == 4 and len(amps) == 5 and amps[0] == 1.0
    assert all(np.isfinite(a) and a > 0 for a in amps)
    with open(os.path.join(exp, "logbook.txt")) as f:
        log = f.read()
    lines = [ln for ln in log.splitlines() if "g_loss" in ln]
    assert len(lines) == 5 * 2  # niter 2, print interval 1
    assert "d_loss" in lines[-1] and "d_loss" not in lines[0]
    values = [float(kv.split(": ")[1]) for ln in lines
              for kv in ln.split("] ", 1)[1].split(", ")]
    assert all(np.isfinite(values))
    for name in ("Start frame    : 0", "Max frames     : 5",
                 "Sampling rates : [2, 1]"):
        assert name in log

    cj = jcfg.Config(**{k: v for k, v in CFG.items()}, niter=2,
                     checkname="smoke", discriminator="WDiscriminator3D",
                     print_interval=1, manualSeed=1).finalize()
    jvideo.SingleVideoDataset(cj)
    cj.write_args_txt(str(tmp_path / "jax_args.txt"))
    got, want = _args_txt(os.path.join(exp, "args.txt")), \
        _args_txt(tmp_path / "jax_args.txt")
    for k in VIDEO_KEYS:
        assert got[k] == want[k], k

    cfg = jeval.hydrate_config(exp, dict(scale_idx=-1, netG=""))
    params, _, _ = jeval.load_generator(cfg, exp, ndim=3)
    assert cfg.scale_idx == 4 and len(params["body"]) == 4
    ckpt = jsaver.load_pytree(os.path.join(exp, "netG_4.ckpt"))
    td0, h0, w0 = _stage_thw(cfg, 0)
    z = jax.random.normal(jax.random.PRNGKey(0), (2, td0, h0, w0, 8))
    (x, _, _, _), _ = jnet.generator_hpvaegan_apply(
        cfg, ckpt["params"], ckpt["state"], amps=jnp.asarray(amps + [0.0]),
        noise_init=z, key=jax.random.PRNGKey(1), is_random=True, train=True)
    assert x.shape == (2,) + tuple(_stage_thw(cfg, 4)) + (3,)
    assert bool(jnp.isfinite(x).all())
    dck = jsaver.load_pytree(os.path.join(exp, "netD_4.ckpt"))
    y, _ = jnet.wdiscriminator3d_apply(cfg, dck["params"], dck["state"], x)
    assert y.shape == x.shape[:-1] + (1,) and bool(jnp.isfinite(y).all())

    capsys.readouterr()
    teval_cli.main(["--exp-dir", exp, "--device", "cpu", "--num-samples", "3",
                    "--max-samples", "2"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SVFID: ")]
    assert len(line) == 1 and np.isfinite(float(line[0].split()[1]))


@pytest.mark.parametrize("flag", [
    ["--generator", "GeneratorCSG"], ["--mesh-data", "2"],
    ["--dist-nprocs", "2"]])
def test_unported_video_flags_raise(flag, tmp_path):
    """A generator that train_video does not train (a baseline, which
    train_video_baselines trains), or a data axis or a process count that
    one process cannot run, is refused with a ValueError naming it."""
    with pytest.raises(ValueError, match=flag[0]):
        tvideo_cli.main(TINY + ["--run-dir", str(tmp_path)] + flag)
    assert not os.listdir(tmp_path)  # nothing written


@pytest.mark.parametrize("flag,field,value", [
    (["--paired-g"], "paired_g", True),
    (["--fused-dg"], "fused_dg", True),
    (["--compute-dtype", "bfloat16"], "compute_dtype", "bfloat16"),
    (["--profile-dir", "prof"], None, None)])
def test_video_training_flags_are_accepted_and_kept(
        flag, field, value, tmp_path, monkeypatch, restore_logging):
    """test_training_flags_are_accepted_and_kept for train_video."""
    if flag[0] == "--profile-dir":
        flag = [flag[0], str(tmp_path / "prof")]
    cfg, exp = launched_cfg(tvideo_cli,
                            TINY + ["--run-dir", str(tmp_path)] + flag,
                            monkeypatch)
    if field is None:
        assert os.listdir(tmp_path / "prof") == ["trace.json"]
        return
    assert getattr(cfg, field) == value
    with open(os.path.join(exp, "args.txt")) as f:
        assert f"{field}: {value}" in f.read().splitlines()


def test_video_cli_flags_and_defaults():
    """--image-path is gone, the video flags and the JAX CLI's video
    defaults are in, and --visualize is accepted by both CLIs' configs (the
    JAX trainer ignores it for video)."""
    parser = tvideo_cli.build_parser()
    args = parser.parse_args(["--video-path", SYNTHETIC, "--visualize"])
    assert not hasattr(args, "image_path")
    assert (args.discriminator, args.niter, args.checkname, args.start_frame,
            args.max_frames, args.sampling_rates) == (
        "WDiscriminator3D", 50000, "DEBUG", 0, 13, [4, 3, 2, 1])
    assert timage_cli.cfg_from_args(args, ndim=3).visualize
    assert timage_cli.cfg_from_args(args, ndim=2).visualize
    with pytest.raises(SystemExit):
        parser.parse_args(["--image-path", "x.png"])


def test_video_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvideo_cli.main(args + ["--run-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)  # nothing written
