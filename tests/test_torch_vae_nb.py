"""The port's 2D GeneratorVAE_nb held against the JAX package on the CPU.

Weights are the JAX package's init of GeneratorVAE_nb (perturbed with numpy)
and cross through tools/convert.py. The JAX draws (the gate, the
refinement noise, eps and the Gumbel u) are recorded by monkeypatching
`hpvaegan_tpu.models.networks_2d.generate_noise` and replayed to the port
in call order; the gate is (B, h, w, 1) there and (B, 1, h, w) here, the
same flat order. Tolerances: rtol 1e-4 / atol 2e-5 per op, losses rtol 1e-4
/ atol 1e-7, atol 1e-4 for multi-scale forwards.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu import losses as jlosses
from hpvaegan_tpu.models import networks_2d as jnet
from hpvaegan_tpu.training import steps as jsteps
from hpvaegan_tpu.utils import saver as jsaver

from hpvaegan_tpu_torch import eval_image as teval_cli
from hpvaegan_tpu_torch import losses as tlosses
from hpvaegan_tpu_torch import models as tmodels
from hpvaegan_tpu_torch import train_image as timage_cli
from hpvaegan_tpu_torch import train_video as tvideo_cli
from hpvaegan_tpu_torch.models.blocks import assign_sn_state, init_weights_
from hpvaegan_tpu_torch.models.networks_2d import (Encode2DVAE_nb,
                                                   GeneratorHPVAEGAN,
                                                   GeneratorVAE_nb)
from hpvaegan_tpu_torch.tools.convert import (from_jax, to_jax,
                                              to_jax_discriminator)
from hpvaegan_tpu_torch.tools.step_parity import ReplayedNoise
from hpvaegan_tpu_torch.training import steps as tsteps
from hpvaegan_tpu_torch.utils.noise import NoiseSource
from hpvaegan_tpu_torch.utils.pyramid import scale_size_2d

from test_torch_trainer import (AMPS, LOSS_TOL, TINY, _g_grads_match,
                                _metrics_match, _setup, jax_draws,  # noqa: F401
                                restore_logging)
from test_torch_training import (GEN_TOL, OP_TOL, assert_trees_close, cfgs,
                                 jax_generator, nchw, port_generator,
                                 port_grads)

torch.set_num_threads(1)

NB = dict(generator="GeneratorVAE_nb")


def replay_nb(draws):
    """ReplayedNoise over recorded JAX draws: NHWC arrays handed over NCHW,
    the gate as bools (B, 1, h, w)."""
    return ReplayedNoise([nchw(a).bool() if kind == "bernoulli" else nchw(a)
                          for kind, a in draws], "cpu")


class ZeroBitsReplay(ReplayedNoise):
    """Replayed draws, and all-zero words for K1's plain version, as the
    JAX package's Pallas kernel draws in interpret mode."""

    kernel_calls = 0

    def kernel_bits(self, shape):
        self.kernel_calls += 1
        z = torch.zeros(tuple(shape), dtype=torch.int32)
        return z, z


def _nb(scale_idx=4, seed=1, **kw):
    cj, ct = cfgs(**NB, **kw)
    params, state = jax_generator(cj, scale_idx, seed=seed)
    return cj, ct, params, state, port_generator(ct, params, state)


def _state_close(G, jax_state):
    assert_trees_close(to_jax(G.state_dict())[1], jax_state, **GEN_TOL)


def test_encoder_matches_jax():
    """(mu, logvar, bern) and the SN blocks' new (u, v)."""
    cj, ct, params, state, G = _nb(scale_idx=0)
    assert isinstance(G.encode, Encode2DVAE_nb)
    x = np.random.RandomState(3).uniform(-1, 1, (2, 17, 17, 3)).astype(
        np.float32)
    (mu_j, lv_j, bern_j), enc_s = jnet.encode2dvae_nb_apply(
        cj, params["encode"], state["encode"], jnp.asarray(x))
    (mu_t, lv_t, bern_t), sn = G.encode(nchw(x))
    assert mu_t.shape == (2, 8, 1, 1) and bern_t.shape == (2, 1, 17, 17)
    for got, want in ((mu_t, mu_j), (lv_t, lv_j), (bern_t, bern_j)):
        np.testing.assert_allclose(got.detach().numpy(),
                                   nchw(want).numpy(), **OP_TOL)
    assign_sn_state(G.encode, sn)
    assert_trees_close(to_jax(G.state_dict())[1]["encode"], enc_s, **OP_TOL)


@pytest.mark.parametrize("bn", ["batch", "moving"])
def test_random_forward_matches_jax(jax_draws, bn):
    """Batch statistics (train) and moving statistics through K1's plain
    version (pallas_fused_sampling; JAX's kernel in interpret mode): the
    gate first, then the refinement noise."""
    cj, ct, params, state, G = _nb(pallas_fused_sampling=(bn == "moving"))
    z = np.random.RandomState(2).randn(2, 17, 17, 8).astype(np.float32)
    amps = np.asarray(AMPS, np.float32)
    with pltpu.force_tpu_interpret_mode():
        (x_j, vae_j, _, _, bern_j), new_state = jnet.generator_vae_nb_apply(
            cj, params, state, amps=jnp.asarray(amps),
            noise_init=jnp.asarray(z), key=jax.random.PRNGKey(7),
            is_random=True, train=bn == "batch")
    assert bern_j is None
    kinds = [k for k, _ in jax_draws]
    assert kinds == ["bernoulli"] + (["normal"] * 4 if bn == "batch" else [])
    assert jax_draws[0][1].shape == (2, 17, 17, 1)
    noise = ZeroBitsReplay([nchw(a).bool() if k == "bernoulli" else nchw(a)
                            for k, a in jax_draws], "cpu")
    with torch.no_grad():
        x_t, vae_t = G(nchw(z), amps, noise, bn=bn)
    assert not noise.drawn
    assert noise.kernel_calls == (4 if bn == "moving" else 0)
    for got, want in ((vae_t, vae_j), (x_t, x_j)):
        np.testing.assert_allclose(got.numpy(), nchw(want).numpy(),
                                   **GEN_TOL)
    _state_close(G, new_state)


def test_per_sample_bn_forward_matches_jax(jax_draws):
    """BatchNorm mode "sample" equals batch-1 train forwards of each sample
    (the JAX sampler's vmap), on the same gates and noise."""
    cj, ct, params, state, G = _nb()
    z = np.random.RandomState(4).randn(3, 17, 17, 8).astype(np.float32)
    amps = np.asarray(AMPS, np.float32)
    want, draws = [], []
    for i in range(3):
        jax_draws.clear()
        (x_j, _, _, _, _), _ = jnet.generator_vae_nb_apply(
            cj, params, state, amps=jnp.asarray(amps),
            noise_init=jnp.asarray(z[i:i + 1]), key=jax.random.PRNGKey(i),
            is_random=True, train=True)
        want.append(np.asarray(x_j))
        draws.append(list(jax_draws))
    batched = [(draws[0][j][0], np.concatenate([d[j][1] for d in draws]))
               for j in range(len(draws[0]))]
    with torch.no_grad():
        x_t, _ = G(nchw(z), amps, replay_nb(batched), bn="sample")
    np.testing.assert_allclose(x_t.numpy(),
                               nchw(np.concatenate(want)).numpy(), **GEN_TOL)


def test_reconstruction_matches_jax(jax_draws):
    """eps (normal, mu's shape) then u (uniform, bern's shape); the outputs,
    mu, logvar, the encoder's bern and the folded state."""
    cj, ct, params, state, G = _nb()
    x = np.random.RandomState(5).uniform(-1, 1, (2, 17, 17, 3)).astype(
        np.float32)
    amps = np.asarray(AMPS, np.float32)
    (x_j, vae_j, mu_j, lv_j, bern_j), new_state = jnet.generator_vae_nb_apply(
        cj, params, state, video=jnp.asarray(x), amps=jnp.asarray(amps),
        key=jax.random.PRNGKey(8), train=True)
    assert [k for k, _ in jax_draws] == ["normal", "uniform"]
    bern_t = G.encode(nchw(x))[0][2]
    noise = replay_nb(jax_draws)
    out = G.reconstruct(nchw(x), amps, noise)
    assert len(out) == 4 and not noise.drawn
    for got, want in zip(out + (bern_t,), (x_j, vae_j, mu_j, lv_j, bern_j)):
        np.testing.assert_allclose(got.detach().numpy(), nchw(want).numpy(),
                                   **GEN_TOL)
    _state_close(G, new_state)


def test_kl_bern_criterion_matches_jax():
    x = np.random.RandomState(6).uniform(0, 1, (2, 1, 9, 7)).astype(
        np.float32)
    x[0, 0, 0, :2] = (0.0, 1.0)  # the 1e-20 guards
    np.testing.assert_allclose(
        float(tlosses.kl_bern_criterion(torch.from_numpy(x))),
        float(jlosses.kl_bern_criterion(jnp.asarray(x))), **LOSS_TOL)


def test_converters_round_trip_the_bern_head():
    cj, ct, params, state, G = _nb(scale_idx=2)
    sd = from_jax(params, state)
    assert {"encode.bern.conv.weight", "encode.bern.conv.bias"} <= set(sd)
    assert sd["encode.bern.conv.weight"].shape == (1, 8, 3, 3)
    p2, s2 = to_jax(G.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, (p2, s2),
                           (params, state))


def test_vae_phase_g_step_matches_jax(jax_draws):
    """Scale 1 of vae_levels 2: rec + KL from z_norm * z_bern."""
    cj, ct, plan, (jst, opt_g, _), tst, batch = _setup(1, **NB)
    real, real_zero, noise_init = batch
    core = jsteps._g_step_core(cj, jnet.generator_vae_nb_apply,
                               jnet.wdiscriminator2d_apply, opt_g, plan,
                               vae_phase=True, cd=None)
    new_j, m_j = core(jst, jnp.asarray(real), jnp.asarray(real_zero),
                      jnp.asarray(noise_init), jnp.asarray(AMPS))
    assert [k for k, _ in jax_draws] == ["normal", "uniform"]
    tst.noise = replay_nb(jax_draws)
    m_t = tsteps.g_step(ct, tst, nchw(real), nchw(real_zero),
                        nchw(noise_init), list(AMPS), vae_phase=True)
    assert not tst.noise.drawn
    _metrics_match(m_t, m_j)
    _g_grads_match(tst.G, plan, opt_g.grads[0], ct.grad_clip)
    assert_trees_close(to_jax(tst.G.state_dict())[1], new_j.g_state, **OP_TOL)


def test_gan_iteration_matches_jax(jax_draws):
    """Scale 3 of vae_levels 2: the D step (gate and noise of the fake,
    then alpha), then the G step (eps, u, then the fake's gate and noise)."""
    cj, ct, plan, (jst, opt_g, opt_d), tst, batch = _setup(3, **NB)
    real, real_zero, noise_init = batch
    amps = jnp.asarray(AMPS)
    d_core = jsteps._d_step_core(cj, jnet.generator_vae_nb_apply,
                                 jnet.wdiscriminator2d_apply, opt_d, None)
    mid_j, md_j = d_core(jst, jnp.asarray(real), jnp.asarray(noise_init),
                         amps)
    _, _, k_alpha = jax.random.split(jst.key, 3)
    draws = list(jax_draws) + [
        ("uniform", np.asarray(jax.random.uniform(k_alpha, ())))]
    assert [k for k, _ in draws] == ["bernoulli"] + ["normal"] * 3 + \
        ["uniform"]
    tst.noise = replay_nb(draws)
    md_t = tsteps.d_step(ct, tst, nchw(real), nchw(noise_init), list(AMPS))
    assert not tst.noise.drawn
    _metrics_match(md_t, md_j)
    assert_trees_close(port_grads(tst.D, to_jax_discriminator),
                       opt_d.grads[0], **OP_TOL)

    jax_draws.clear()
    g_core = jsteps._g_step_core(cj, jnet.generator_vae_nb_apply,
                                 jnet.wdiscriminator2d_apply, opt_g, plan,
                                 vae_phase=False, cd=None)
    new_j, mg_j = g_core(mid_j, jnp.asarray(real), jnp.asarray(real_zero),
                         jnp.asarray(noise_init), amps)
    assert [k for k, _ in jax_draws] == ["normal", "uniform", "bernoulli"] \
        + ["normal"] * 3
    tst.noise = replay_nb(jax_draws)
    mg_t = tsteps.g_step(ct, tst, nchw(real), nchw(real_zero),
                         nchw(noise_init), list(AMPS), vae_phase=False)
    assert not tst.noise.drawn
    _metrics_match(mg_t, mg_j)
    _g_grads_match(tst.G, plan, opt_g.grads[0], ct.grad_clip)
    assert_trees_close(to_jax(tst.G.state_dict())[1], new_j.g_state, **OP_TOL)


@pytest.mark.parametrize("train_all", [False, True])
def test_vae_boundary_detach_ignores_train_all(train_all):
    """The decoder gets no gradient through the refinement output in
    GeneratorVAE_nb, train_all or not; GeneratorHPVAEGAN's train_all lifts
    its detach (JAX tests/test_models.py:252-283)."""
    def decoder_grad(cls):
        _, ct = cfgs(vae_levels=1, train_all=train_all)
        G = cls(ct)
        G.init_next_stage(torch.Generator().manual_seed(1))
        init_weights_(G, torch.Generator().manual_seed(0))
        video = torch.full((1, 3, 17, 17), 0.1)
        x = G.reconstruct(video, np.ones(ct.stop_scale + 2, np.float32),
                          NoiseSource(2, "cpu"))[0]
        grads = torch.autograd.grad((x ** 2).sum(),
                                    list(G.decoder.parameters()),
                                    allow_unused=True, materialize_grads=True)
        return sum(float(g.abs().sum()) for g in grads)

    assert decoder_grad(GeneratorVAE_nb) == 0.0
    assert (decoder_grad(GeneratorHPVAEGAN) > 0.0) == train_all


def test_registry_and_video_cli_refuse_the_3d_generator(tmp_path,
                                                        restore_logging):
    """The registry returns the 2D class and the 3D one (a subclass: the
    gate and the Gumbel latent are the 2D class's), and the video CLI
    trains the 3D one (tests/test_torch_vae_nb_3d*.py hold it against the
    JAX package)."""
    from hpvaegan_tpu_torch.models import networks_3d

    assert tmodels.get_generator("GeneratorVAE_nb") is GeneratorVAE_nb
    cls = tmodels.get_generator("GeneratorVAE_nb", 3)
    assert cls is networks_3d.GeneratorVAE_nb and cls.ndim == 3
    assert issubclass(cls, GeneratorVAE_nb) and cls.reconstruct_pair is None
    from test_torch_video_training import TINY as VTINY
    exp = tvideo_cli.main(VTINY + ["--run-dir", str(tmp_path), "--generator",
                                   "GeneratorVAE_nb", "--niter", "1"])
    assert {f"netG_{k}.ckpt" for k in range(5)} <= set(os.listdir(exp))
    with open(os.path.join(exp, "args.txt")) as f:
        assert "generator: GeneratorVAE_nb" in f.read().splitlines()


def test_train_cli_writes_an_experiment_both_packages_read(
        tmp_path, restore_logging, capsys):
    """train_image --generator GeneratorVAE_nb end to end: the JAX loader
    reads it and applies it, and the port's eval CLI scores it."""
    exp = timage_cli.main(TINY + ["--run-dir", str(tmp_path), "--generator",
                                  "GeneratorVAE_nb", "--niter", "2"])
    with open(os.path.join(exp, "intermediate.json")) as f:
        inter = json.load(f)
    assert inter["scale_idx"] == 4 and "key" not in inter
    cfg = jeval.hydrate_config(exp, dict(scale_idx=-1, netG=""))
    assert cfg.generator == "GeneratorVAE_nb"
    params, state, _ = jeval.load_generator(cfg, exp, ndim=2)
    assert "bern" in params["encode"] and len(params["body"]) == 4
    h0, w0 = scale_size_2d(0, cfg.scale_factor, cfg.stop_scale, cfg.img_size,
                           cfg.ar)
    (x, _, _, _, _), _ = jnet.generator_vae_nb_apply(
        cfg, params, state, amps=jnp.asarray(inter["noise_amps"] + [0.0]),
        noise_init=jax.random.normal(jax.random.PRNGKey(0), (2, h0, w0, 8)),
        key=jax.random.PRNGKey(1), is_random=True, train=True)
    assert x.shape == (2, 24, 33, 3) and bool(jnp.isfinite(x).all())
    assert jsaver.load_pytree(os.path.join(exp, "netD_4.ckpt"))

    capsys.readouterr()
    teval_cli.main(["--exp-dir", exp, "--device", "cpu", "--num-samples",
                    "3", "--max-samples", "1"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SIFID: ")]
    assert len(line) == 1 and np.isfinite(float(line[0].split()[1]))
