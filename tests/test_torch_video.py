"""The port's video slice held against the JAX package on the CPU: the 3D
ops, the 3D converter, Encode3DVAE, the 3D GeneratorHPVAEGAN (random mode
with its vae_levels noise gate, and reconstruction), the sampler in both
BatchNorm modes at the eval time depth, C3D and SVFID, the frame decoder,
the dataset's per-scale frames, the GIF/unfold artifacts and the
eval_video CLI.

Inputs are made with numpy from fixed seeds and go through both packages;
the port works in NCDHW, the JAX package in NDHWC. Every draw the JAX
package makes (z_init, the per-stage refinement noise, eps) is reproduced
from its key splits here and handed to the port in call order. Tolerance
per op is rtol 1e-4, atol 2e-5; for the multi-scale generator and sampler
atol 1e-4 (float32 convolutions summed in another order over 5 scales).
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu import config as jcfg
from hpvaegan_tpu import evaluation as jeval
from hpvaegan_tpu.data import frames as jframes
from hpvaegan_tpu.data import video as jvideo
from hpvaegan_tpu.metrics import c3d as jc3d
from hpvaegan_tpu.metrics import fid as jfid
from hpvaegan_tpu.models import blocks as jblocks
from hpvaegan_tpu.models import networks_3d as jnet
from hpvaegan_tpu.ops import conv as jconv
from hpvaegan_tpu.ops import norm as jnorm
from hpvaegan_tpu.ops import resize as jresize
from hpvaegan_tpu.tools import convert as jconvert
from hpvaegan_tpu.utils import media as jmedia
from hpvaegan_tpu.utils import pyramid as jpyr

from hpvaegan_tpu_torch import config as tcfg
from hpvaegan_tpu_torch import eval_video as teval_cli
from hpvaegan_tpu_torch import evaluation as teval
from hpvaegan_tpu_torch import models as tmodels
from hpvaegan_tpu_torch.data import frames as tframes
from hpvaegan_tpu_torch.data import video as tvideo
from hpvaegan_tpu_torch.metrics import c3d as tc3d
from hpvaegan_tpu_torch.metrics import fid as tfid
from hpvaegan_tpu_torch.models.blocks import ConvStack
from hpvaegan_tpu_torch.models.networks_3d import (Encode3DVAE,
                                                   GeneratorHPVAEGAN,
                                                   WDiscriminator3D)
from hpvaegan_tpu_torch.ops import conv as tconv
from hpvaegan_tpu_torch.ops import norm as tnorm
from hpvaegan_tpu_torch.ops import resize as tresize
from hpvaegan_tpu_torch.parallel import sampling as tsampling
from hpvaegan_tpu_torch.tools import convert as tconvert
from hpvaegan_tpu_torch.tools.step_parity import ReplayedNoise
from hpvaegan_tpu_torch.utils import media as tmedia
from hpvaegan_tpu_torch.utils.noise import NoiseSource

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)  # per op, as tests/test_torch_parity.py:39
GEN_TOL = dict(rtol=0, atol=1e-4)  # multi-scale generator / sampler
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDS = os.path.join(REPO, "data", "vids")
SYNTHETIC = os.path.join(VIDS, "synthetic.avi")
# 5 scales, (T, H, W) (2, 12, 17) .. (2, 20, 27), (3, 24, 33)
CFG = dict(nfc=8, latent_dim=8, num_layer=2, enc_blocks=1, img_size=32,
           min_size=16, max_size=32, vae_levels=2, video_path=SYNTHETIC,
           max_frames=5, sampling_rates=[2, 1])
AMPS = [1.0, 0.3, 0.2, 0.1, 0.05]


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _ndhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _cfgs(**kw):
    """Both packages' configs, with what SingleVideoDataset sets from the
    clip (org_fps, ar, fps_lcm) filled in as synthetic.avi gives them."""
    out = []
    for mod in (jcfg, tcfg):
        c = mod.Config(**{**CFG, **kw}).finalize()
        c.org_fps, c.ar, c.fps_lcm = 24.0, 0.75, 2
        out.append(c)
    return out


def _perturb_tree(tree, rng):
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

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _jax_generator(cfg, seed=0):
    """The JAX package's 3D generator at scale stop_scale, every leaf
    perturbed with numpy so that stages differ and BatchNorm moving stats
    are not (0, 1)."""
    params, state = jnet.generator_hpvaegan_init(cfg, jax.random.PRNGKey(seed))
    for k in range(cfg.stop_scale):
        params, state = jnet.generator_init_next_stage(
            cfg, params, state, jax.random.PRNGKey(seed + 1 + k))
    rng = np.random.RandomState(seed)
    return _perturb_tree(params, rng), _perturb_tree(state, rng)


def _port_generator(cfg, params, state):
    gen = GeneratorHPVAEGAN(cfg)
    for _ in range(len(params["body"])):
        gen.init_next_stage()
    gen.load_state_dict(tconvert.from_jax(params, state, ndim=3))
    return gen


def _stage_thw(cfg, idx):
    return jpyr.scale_size_3d(idx, cfg.scale_factor, cfg.stop_scale,
                              cfg.img_size, cfg.stop_scale_time,
                              cfg.sampling_rates, cfg.org_fps, cfg.fps_lcm,
                              cfg.ar)


def _refinement_draws(cfg, key, batch):
    """The JAX package's refinement noise (networks_3d.py:226-231): one
    split per stage that adds noise, stages idx + 1 >= vae_levels."""
    out = []
    for idx in range(cfg.stop_scale):
        if cfg.vae_levels <= idx + 1:
            key, sub = jax.random.split(key)
            out.append(np.asarray(jax.random.normal(
                sub, (batch,) + tuple(_stage_thw(cfg, idx + 1)) + (3,))))
    return out


# ---------------------------------------------------------------- ops ---

@pytest.mark.parametrize("padding", [0, 1])
def test_conv3d_matches_jax(padding):
    rng = np.random.RandomState(padding)
    x = rng.randn(2, 5, 9, 11, 4).astype(np.float32)
    p = {"w": rng.randn(3, 3, 3, 4, 6).astype(np.float32) * 0.2,
         "b": rng.randn(6).astype(np.float32)}
    want = jconv.conv3d_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), padding=padding)
    got = tconv.conv3d(_ncdhw(x),
                       torch.from_numpy(tconvert._hwio_to_oihw(p["w"])),
                       torch.from_numpy(p["b"]), padding=padding)
    np.testing.assert_allclose(_ndhwc(got), np.asarray(want), **TOL)


def _bn_inputs(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(3, 4, 6, 7, 5) * 2 + 0.5).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 1.5, 5).astype(np.float32),
         "beta": rng.randn(5).astype(np.float32)}
    s = {"mean": rng.randn(5).astype(np.float32) * 0.1,
         "var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}
    return x, p, s


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("mode", ["batch", "moving"])
def test_batchnorm_5d_matches_jax(mode):
    x, p, s = _bn_inputs(seed=1)
    y_j, s_j = jnorm.batchnorm_apply(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in s.items()}, jnp.asarray(x),
        train=(mode == "batch"))
    y_t, m_t, v_t = tnorm.batchnorm(_ncdhw(x), _t(p["gamma"]), _t(p["beta"]),
                                    _t(s["mean"]), _t(s["var"]), mode)
    np.testing.assert_allclose(_ndhwc(y_t), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(s_j["mean"]), **TOL)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(s_j["var"]), **TOL)


def test_batchnorm_5d_per_sample_matches_jax_vmap_of_batch1():
    x, p, s = _bn_inputs(seed=2)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = {k: jnp.asarray(v) for k, v in s.items()}
    y_j = jax.vmap(lambda xi: jnorm.batchnorm_apply(jp, js, xi[None],
                                                    train=True)[0][0])(
        jnp.asarray(x))
    y_t, m_t, v_t = tnorm.batchnorm(_ncdhw(x), _t(p["gamma"]), _t(p["beta"]),
                                    _t(s["mean"]), _t(s["var"]), "sample")
    np.testing.assert_allclose(_ndhwc(y_t), np.asarray(y_j), **TOL)
    np.testing.assert_array_equal(m_t.numpy(), s["mean"])  # state unchanged
    np.testing.assert_array_equal(v_t.numpy(), s["var"])


@pytest.mark.parametrize("bn", ["batch", "moving", "sample"])
def test_conv_stack_3d_matches_jax(bn):
    """ConvBlock3D x (1 + num_layer) + tail with the JAX stack's weights,
    carried over by the converter's stack mapping; "sample" against the
    JAX vmap of batch-1 train-mode stacks."""
    params, state = jblocks.conv_stack_init(jax.random.PRNGKey(5), 3, 8, 3,
                                            3, 2, ndim=3)
    rng = np.random.RandomState(6)
    params, state = _perturb_tree(params, rng), _perturb_tree(state, rng)
    sd = {}
    tconvert._stack_from_jax("s", params, state, sd)
    stack = ConvStack(3, 8, 3, 3, 1, 2, ndim=3)
    stack.load_state_dict({k[2:]: torch.tensor(v) for k, v in sd.items()})
    x = rng.randn(2, 4, 7, 9, 3).astype(np.float32)

    def jstack(xj, train):
        return jblocks.conv_stack_apply(params, state, xj, ker=3, padd=1,
                                        train=train, ndim=3)[0]

    if bn == "sample":
        y_j = jax.vmap(lambda xi: jstack(xi[None], True)[0])(jnp.asarray(x))
    else:
        y_j = jstack(jnp.asarray(x), bn == "batch")
    with torch.no_grad():
        y_t = stack(_ncdhw(x), bn)
    np.testing.assert_allclose(_ndhwc(y_t), np.asarray(y_j), **TOL)


@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_bilinear_rank5_matches_jax(align_corners):
    """Frame by frame over H and W; the data path's half-pixel resize
    (align_corners False) and the model's."""
    x = np.random.RandomState(3).randn(2, 4, 13, 17, 3).astype(np.float32)
    for dst in ((24, 33), (7, 9)):
        want = jresize.resize_bilinear(jnp.asarray(x), dst,
                                       align_corners=align_corners)
        got = tresize.resize_bilinear(_ncdhw(x), dst,
                                      align_corners=align_corners)
        np.testing.assert_allclose(_ndhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_trilinear_matches_jax(align_corners):
    x = np.random.RandomState(4).randn(2, 4, 13, 17, 3).astype(np.float32)
    for dst in ((13, 24, 33), (2, 7, 9), (4, 13, 17)):
        want = jresize.resize_trilinear(jnp.asarray(x), dst,
                                        align_corners=align_corners)
        got = tresize.resize_trilinear(_ncdhw(x), dst,
                                       align_corners=align_corners)
        np.testing.assert_allclose(_ndhwc(got), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        tresize.resize_trilinear(torch.zeros(1, 3, 4, 4), (2, 2, 2))
    with pytest.raises(ValueError):
        tresize.resize_bilinear(torch.zeros(1, 3), (2, 2))


def test_upscale_3d_matches_jax():
    cj, ct = _cfgs()
    x = np.random.RandomState(5).randn(2, 2, 13, 17, 3).astype(np.float32)
    for index in range(1, cj.stop_scale + 1):
        args = (index, cj.scale_factor, cj.stop_scale, cj.img_size,
                cj.stop_scale_time, cj.sampling_rates, cj.org_fps,
                cj.fps_lcm, cj.ar)
        want = jresize.upscale_3d(jnp.asarray(x), *args)
        got = tresize.upscale_3d(_ncdhw(x), *args)
        assert got.shape[2:] == tuple(_stage_thw(cj, index))
        np.testing.assert_allclose(_ndhwc(got), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        tresize.upscale_3d(_ncdhw(x), 0, *args[1:])


# ---------------------------------------------------------- converter ---

def test_from_jax_3d_equals_j2t_and_to_jax_inverts():
    cj, _ = _cfgs(enc_blocks=2)
    params, state = _jax_generator(cj, seed=7)
    sd = tconvert.from_jax(params, state, ndim=3)
    want = jconvert.j2t_HPVAEGAN(params, state, ndim=3)
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    assert sd["decoder.head.conv.weight"].shape == (8, 8, 3, 3, 3)  # OIDHW
    p2, s2 = tconvert.to_jax(sd, ndim=3)
    pj, sj = jconvert.p2j_HPVAEGAN(want, ndim=3)
    for got, ref in ((p2, params), (s2, state), (p2, pj), (s2, sj)):
        lg, tg = jax.tree_util.tree_flatten(got)
        lr, tr = jax.tree_util.tree_flatten(ref)
        assert tg == tr
        for a, b in zip(lg, lr):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_converter_3d_sn_vectors_survive_the_permutation():
    """W_mat @ v pairs the same entries in both layouts: the port's
    (I, KD, KH, KW) flattening of v against its OIDHW weight gives the JAX
    package's product over (KD, KH, KW, I) and DHWIO."""
    cj, _ = _cfgs()
    params, state = _jax_generator(cj, seed=8)
    sd = tconvert.from_jax(params, state, ndim=3)
    w_j = np.asarray(params["encode"]["features"][0]["snconv"]["w"])
    v_j = np.asarray(state["encode"]["features"][0]["sn"]["v"])
    w_t = sd["encode.features.conv_block_0.conv.weight_orig"].numpy()
    v_t = sd["encode.features.conv_block_0.conv.weight_v"].numpy()
    np.testing.assert_allclose(w_t.reshape(w_t.shape[0], -1) @ v_t,
                               w_j.reshape(-1, w_j.shape[-1]).T @ v_j,
                               rtol=1e-5, atol=1e-6)


def test_converter_refuses_a_checkpoint_of_the_other_rank():
    cj, _ = _cfgs()
    params, state = _jax_generator(cj, seed=9)
    with pytest.raises(ValueError, match="rank"):
        tconvert.from_jax(params, state, ndim=2)
    sd = tconvert.from_jax(params, state, ndim=3)
    with pytest.raises(ValueError, match="rank"):
        tconvert.to_jax(sd, ndim=2)


# ------------------------------------------------------------- models ---

def test_registry_has_the_3d_generator():
    assert tmodels.get_generator("GeneratorHPVAEGAN", 3) is GeneratorHPVAEGAN
    assert tmodels.get_discriminator("WDiscriminator3D", 3) is \
        WDiscriminator3D
    with pytest.raises(NotImplementedError):
        tmodels.get_generator("GeneratorVAE_nb", 3)


def test_encoder_3d_matches_jax():
    """Encode3DVAE: (mu, logvar) and the SN blocks' new (u, v)."""
    cj, ct = _cfgs(enc_blocks=2)
    params, state = jnet.encode3dvae_init(cj, jax.random.PRNGKey(1),
                                          out_dim=cj.latent_dim, num_blocks=2)
    rng = np.random.RandomState(1)
    params = _perturb_tree(params, rng)
    state = jax.tree_util.tree_map(np.asarray, state)
    x = rng.uniform(-1, 1, (2, 3, 12, 16, 3)).astype(np.float32)
    (mu_j, lv_j), s_j = jnet.encode3dvae_apply(cj, params, state,
                                               jnp.asarray(x))
    enc = Encode3DVAE(ct, ct.latent_dim, 2)
    sd = {}
    for i, (fp, fs) in enumerate(zip(params["features"], state["features"])):
        tconvert._sn_from_jax(f"features.conv_block_{i}.conv", fp, fs, sd)
    for head in ("mu", "logvar"):
        sd[f"{head}.conv.weight"] = tconvert._hwio_to_oihw(params[head]["w"])
        sd[f"{head}.conv.bias"] = np.asarray(params[head]["b"])
    enc.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.no_grad():
        (mu_t, lv_t), s_t = enc(_ncdhw(x))
    np.testing.assert_allclose(_ndhwc(mu_t), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(_ndhwc(lv_t), np.asarray(lv_j), **TOL)
    for (u, v), ns, conv in zip(s_t, s_j["features"],
                                [getattr(enc.features, f"conv_block_{i}").conv
                                 for i in range(3)]):
        np.testing.assert_allclose(u.numpy(), np.asarray(ns["sn"]["u"]), **TOL)
        perm = tconvert._v_perm(tuple(conv.weight_orig.shape))
        np.testing.assert_allclose(v.numpy()[perm], np.asarray(ns["sn"]["v"]),
                                   **TOL)


def test_generator_3d_random_forward_matches_jax():
    """Batch-statistics BatchNorm, non-zero amps, the JAX package's draws:
    stage 1 (idx + 1 < vae_levels) gets no noise, stages 2-4 do; also the
    moving stats the forward folds."""
    cj, ct = _cfgs()
    params, state = _jax_generator(cj, seed=1)
    td0 = _stage_thw(cj, 0)[0]
    z = np.random.RandomState(2).randn(2, td0, 12, 17, 8).astype(np.float32)
    key = jax.random.PRNGKey(7)
    amps = np.asarray(AMPS + [0.0], np.float32)
    (x_j, vae_j, _, _), new_state = jnet.generator_hpvaegan_apply(
        cj, params, state, amps=jnp.asarray(amps), noise_init=jnp.asarray(z),
        key=key, is_random=True, train=True)
    _, kr = jax.random.split(key)
    draws = _refinement_draws(cj, kr, 2)
    assert len(draws) == cj.stop_scale - 1  # the gate left stage 1 out
    gen = _port_generator(ct, params, state)
    noise = ReplayedNoise([_ncdhw(d) for d in draws], "cpu")
    with torch.no_grad():
        x_t, vae_t = gen(_ncdhw(z), amps, noise, bn="batch")
    assert not noise.drawn
    assert x_t.shape == (2, 3) + tuple(_stage_thw(cj, cj.stop_scale))
    np.testing.assert_allclose(_ndhwc(vae_t), np.asarray(vae_j), **GEN_TOL)
    np.testing.assert_allclose(_ndhwc(x_t), np.asarray(x_j), **GEN_TOL)
    _, state_t = tconvert.to_jax(gen.state_dict(), ndim=3)
    for a, b in zip(jax.tree_util.tree_leaves(state_t),
                    jax.tree_util.tree_leaves(new_state)):
        np.testing.assert_allclose(a, np.asarray(b), **GEN_TOL)


def test_generator_3d_reconstruct_matches_jax():
    """Reconstruction mode: encoder, z = eps * exp(logvar / 2) + mu with the
    JAX package's eps, decoder and stages on batch statistics, no noise."""
    cj, ct = _cfgs()
    params, state = _jax_generator(cj, seed=3)
    td0, h0, w0 = _stage_thw(cj, 0)
    video = np.random.RandomState(4).uniform(
        -1, 1, (2, td0, h0, w0, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    amps = np.asarray(AMPS + [0.0], np.float32)
    (x_j, vae_j, mu_j, lv_j), _ = jnet.generator_hpvaegan_apply(
        cj, params, state, video=jnp.asarray(video), amps=jnp.asarray(amps),
        key=key, is_random=False, train=True)
    kz, _ = jax.random.split(key)
    eps = np.asarray(jax.random.normal(kz, mu_j.shape))
    gen = _port_generator(ct, params, state)
    with torch.no_grad():
        x_t, vae_t, mu_t, lv_t = gen.reconstruct(
            _ncdhw(video), amps, ReplayedNoise([_ncdhw(eps)], "cpu"),
            commit=False)
    np.testing.assert_allclose(_ndhwc(mu_t), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(_ndhwc(lv_t), np.asarray(lv_j), **TOL)
    np.testing.assert_allclose(_ndhwc(vae_t), np.asarray(vae_j), **GEN_TOL)
    np.testing.assert_allclose(_ndhwc(x_t), np.asarray(x_j), **GEN_TOL)


# ------------------------------------------------------------ sampler ---

def _jax_sampler_draws(cfg, seed, batch, train):
    """Every draw of jax generate_samples(ndim=3), niter 1
    (evaluation.py:150-158, parallel/sampling.py:66-86): z_init, then per
    noised stage one normal, per sample (vmapped keys) in train mode."""
    _, ks = jax.random.split(jax.random.PRNGKey(seed))
    kn, kf = jax.random.split(ks)
    z = np.asarray(jax.random.normal(
        kn, (batch,) + teval.eval_z_tail(cfg, 3)))
    if train:
        per = [_refinement_draws(cfg, jax.random.split(k)[1], 1)
               for k in jax.random.split(kf, batch)]
        stages = [np.concatenate(s) for s in zip(*per)]
    else:
        stages = _refinement_draws(cfg, jax.random.split(kf)[1], batch)
    return [z] + stages


@pytest.mark.parametrize("train", [True, False])
def test_generate_samples_3d_matches_jax(train):
    """Both sampler modes at non-zero amps, with z at the eval scale's time
    depth (cfg.td, as eval_video_experiment sets it), not td0."""
    cj, ct = _cfgs(niter=1, num_samples=3)
    for c in (cj, ct):
        c.Noise_Amps = AMPS
        c.scale_idx = c.stop_scale
        c.td = _stage_thw(c, c.stop_scale)[0]
    assert ct.td != _stage_thw(ct, 0)[0]
    params, state = _jax_generator(cj, seed=4)
    want = jeval.generate_samples(cj, params, state, ndim=3, seed=5,
                                  train_mode=train)
    draws = _jax_sampler_draws(cj, 5, 3, train)
    assert draws[0].shape[1] == ct.td
    noise = ReplayedNoise([_ncdhw(d) for d in draws], "cpu")
    got = teval.generate_samples(ct, _port_generator(ct, params, state),
                                 ndim=3, train_mode=train, noise=noise)
    assert not noise.drawn
    assert got.shape == want.shape == (3,) + tuple(
        _stage_thw(cj, cj.stop_scale)) + (3,)
    np.testing.assert_allclose(got, np.asarray(want), **GEN_TOL)


@pytest.mark.parametrize("train", [True, False])
def test_sampler_sub_batches_are_exact(monkeypatch, train):
    """With the element cap lowered so that 5 samples run as 3 forwards,
    the samples equal one forward's (at amps 0 only z is drawn, once)."""
    _, ct = _cfgs(niter=1, num_samples=5)
    ct.Noise_Amps = [1.0] + [0.0] * ct.stop_scale
    gen = GeneratorHPVAEGAN(ct)
    for _ in range(ct.stop_scale):
        gen.init_next_stage(torch.Generator().manual_seed(0))
    whole = teval.generate_samples(ct, gen, ndim=3, seed=1, train_mode=train,
                                   noise=NoiseSource(1, "cpu"))
    per = tsampling._sample_elements(ct, 3, ct.stop_scale,
                                     teval.eval_z_tail(ct, 3))
    monkeypatch.setattr(tsampling, "MAX_ELEMENTS", 2 * per)
    assert tsampling.sub_batches(5, per) == [(0, 1), (1, 3), (3, 5)]
    split = teval.generate_samples(ct, gen, ndim=3, seed=1, train_mode=train,
                                   noise=NoiseSource(1, "cpu"))
    np.testing.assert_allclose(split, whole, rtol=0, atol=1e-6)


def test_sub_batches_cover_the_batch_evenly():
    cap = tsampling.MAX_ELEMENTS
    full_width_sample = 64 * 13 * 192 * 257
    assert tsampling.sub_batches(64, full_width_sample) == [(0, 32), (32, 64)]
    assert tsampling.sub_batches(10, full_width_sample) == [(0, 10)]
    assert tsampling.sub_batches(3, cap + 1) == [(0, 1), (1, 2), (2, 3)]


def test_eval_z_tail_takes_the_eval_time_depth():
    cj, ct = _cfgs()
    for c in (cj, ct):
        c.scale_idx = c.stop_scale
    ct.td = cj.td = 0  # unset: the time depth of scale_idx
    assert teval.eval_z_tail(ct, 3) == jeval.eval_z_tail(cj, 3) == (
        3, 12, 17, 8)
    ct.td = cj.td = 2
    assert teval.eval_z_tail(ct, 3) == jeval.eval_z_tail(cj, 3) == (
        2, 12, 17, 8)
    assert teval.eval_z_tail(ct, 2) == (12, 17, 8)


# ------------------------------------------------------------ metrics ---

@pytest.fixture(scope="module")
def c3d_npz(tmp_path_factory):
    """The JAX package's random C3D parameters as one .npz for both."""
    path = tmp_path_factory.mktemp("c3d") / "c3d.npz"
    np.savez(path, **jc3d.C3D([0, 1, 2, 3], seed=3).params)
    return str(path)


def test_c3d_blocks_match_jax(c3d_npz):
    """Blocks 0-3 with one shared weights file (which also puts both on
    the pretrained input scale, x 255): compared to rtol 1e-4 of each
    block's largest feature."""
    x = np.random.RandomState(6).rand(1, 8, 32, 32, 3).astype(np.float32)
    want = jc3d.C3D([0, 1, 2, 3], weights=c3d_npz)(x)
    got = tc3d.C3D([0, 1, 2, 3], weights=c3d_npz, device="cpu")(_ncdhw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert _ndhwc(g).shape == w.shape
        np.testing.assert_allclose(_ndhwc(g), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    random_init = tc3d.C3D([1], device="cpu")
    assert not random_init.pretrained and len(random_init(_ncdhw(x))) == 1
    with pytest.raises(FileNotFoundError):
        tc3d.C3D([0], weights=c3d_npz + ".missing", device="cpu")


def _smooth_videos(seed, n, t=6, h=24, w=32):
    rng = np.random.RandomState(seed)
    base = rng.rand(n, t, h // 8, w // 8, 3)
    vid = np.kron(base, np.ones((1, 1, 8, 8, 1)))
    return np.clip(vid + 0.1 * rng.rand(n, t, h, w, 3), 0, 1).astype(
        np.float32)


def test_svfid_matches_jax_with_shared_weights(c3d_npz, tmp_path):
    """Per-pair SVFID over C3D block 0 with one .npz for both packages
    (64x64 covariances over 6x12x16 positions: rtol 1e-3), and the
    directory form over .npy clips of other sizes."""
    reals, fakes = _smooth_videos(1, 1), _smooth_videos(2, 3)
    want = jfid.svfid_arrays(reals, fakes, weights=c3d_npz)
    got = tfid.svfid_arrays(reals, fakes, weights=c3d_npz, device="cpu")
    assert len(got) == 3 and all(np.isfinite(got)) and min(got) > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)
    for name, vids in (("real", (reals * 255).astype(np.uint8)),
                       ("fake", fakes[:, :5, :20])):
        (tmp_path / name).mkdir()
        for i, v in enumerate(vids):
            np.save(tmp_path / name / f"{name}_{i}.npy", v)
    want = jfid.calculate_SVFID(str(tmp_path / "real"), str(tmp_path / "fake"),
                                weights=c3d_npz)
    got = tfid.calculate_SVFID(str(tmp_path / "real"), str(tmp_path / "fake"),
                               weights=c3d_npz, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-3)


# -------------------------------------------------------------- data ---

@pytest.mark.parametrize("name", ["balloons_pan.avi", "synthetic.avi"])
def test_frames_equal_jax_decode(name):
    """The port decodes with cv2.VideoCapture as the JAX package does: the
    same frames, bit for bit, and the same metadata."""
    path = os.path.join(VIDS, name)
    for start, most in ((0, 13), (3, 100)):
        got = tframes.video_to_frames(path, start, most)
        want = jframes.video_to_frames(path, start, most)
        assert got.dtype == np.uint8 and got.shape[-1] == 3
        np.testing.assert_array_equal(got, want)
    assert tframes.video_metadata(path) == jframes.video_metadata(path)


def test_frames_refuse_unreadable_input(tmp_path):
    bad = tmp_path / "bad.avi"
    bad.write_bytes(b"RIFF not a video")
    with pytest.raises(ValueError, match="cannot open"):
        tframes.video_metadata(str(bad))
    with pytest.raises(ValueError, match="cannot open"):
        tframes.video_to_frames(str(bad))
    with pytest.raises(FileNotFoundError):
        tframes.video_to_frames(str(tmp_path / "missing.avi"))
    with pytest.raises(ValueError, match="out of range"):
        tframes.video_to_frames(SYNTHETIC, start_frame=16)


def test_dataset_scale_frames_match_jax():
    """SingleVideoDataset: the fields it sets on the config, and every
    scale's half-pixel resize of the (equal) decoded frames."""
    cj, ct = (mod.Config(**CFG).finalize() for mod in (jcfg, tcfg))
    dj = jvideo.SingleVideoDataset(cj)
    dt = tvideo.SingleVideoDataset(ct, "cpu")
    assert (ct.org_fps, ct.ar, ct.fps_lcm) == (cj.org_fps, cj.ar, cj.fps_lcm)
    assert dt.num_frames == dj.num_frames == 5
    for idx in range(ct.stop_scale + 1):
        got = dt.scale_frames(idx)
        assert got.shape[2:] == (5,) + dt.scale_size(idx)
        np.testing.assert_allclose(_ndhwc(got), np.asarray(dj.scale_frames(idx)),
                                   **TOL)
    assert dt.scale_frames(2) is dt.scale_frames(2)  # cached
    with pytest.raises(ValueError, match="lcm"):
        tvideo.SingleVideoDataset(tcfg.Config(
            **{**CFG, "max_frames": 2}).finalize(), "cpu")
    with pytest.raises(FileNotFoundError):
        tvideo.SingleVideoDataset(tcfg.Config(
            **{**CFG, "video_path": SYNTHETIC + ".missing"}).finalize(), "cpu")


# --------------------------------------------------------- artifacts ---

class _Saver:
    def __init__(self, eval_dir):
        self.eval_dir = str(eval_dir)


def test_generate_gifs_matches_jax(tmp_path):
    """The same files; the unfold PNGs pixel for pixel; the GIFs with the
    same frame count, size and (to palette rounding) frames."""
    from PIL import Image

    rng = np.random.RandomState(7)
    real = rng.randint(0, 256, (5, 18, 24, 3)).astype(np.uint8)
    fakes = rng.uniform(-1, 1, (3, 3, 5, 18, 24)).astype(np.float32)
    cfg = tcfg.Config(max_samples=2, save_path="images")
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        np.save(tmp_path / side / "real_full_scale.npy", real)
        np.save(tmp_path / side / "random_samples.npy", fakes)
    jmedia.generate_gifs(cfg, _Saver(tmp_path / "jax"))
    tmedia.generate_gifs(cfg, _Saver(tmp_path / "port"))
    files = sorted(os.listdir(tmp_path / "port" / "images"))
    assert files == sorted(os.listdir(tmp_path / "jax" / "images")) == [
        "fake.gif", "fake_unfold.png", "real.gif", "real_unfold.png"]

    def load(side, name):
        return Image.open(tmp_path / side / "images" / name)

    for name in ("real_unfold.png", "fake_unfold.png"):
        np.testing.assert_array_equal(np.asarray(load("port", name)),
                                      np.asarray(load("jax", name)))
    assert np.asarray(load("port", "fake_unfold.png")).shape == (
        2 * 18, 3 * 24, 3)  # 2 videos, frames 0, 2, 4
    for name, width in (("real.gif", 24), ("fake.gif", 2 * 24 + 10)):
        with load("port", name) as a, load("jax", name) as b:
            assert a.n_frames == b.n_frames == 5
            assert a.size == b.size == (width, 18)
            assert a.info["loop"] == 0 and a.info["duration"] == 250


# ---------------------------------------------------------------- CLI ---

def _write_experiment(root, seed=0):
    """A video experiment dir in the JAX package's format at scale 4."""
    cj = jcfg.Config(**CFG).finalize()
    jvideo.SingleVideoDataset(cj)  # sets org_fps, ar, fps_lcm as training does
    params, state = _jax_generator(cj, seed=seed)
    exp = root / "exp"
    exp.mkdir()
    cj.write_args_txt(str(exp / "args.txt"))
    (exp / "intermediate.json").write_text(json.dumps(
        {"noise_amps": AMPS, "scale_idx": cj.stop_scale}))
    with open(exp / f"netG_{cj.stop_scale}.ckpt", "wb") as f:
        pickle.dump({"params": params, "state": state}, f)
    return exp


def test_eval_video_cli_on_cpu(tmp_path, capsys):
    exp = _write_experiment(tmp_path)
    teval_cli.main(["--exp-dir", str(exp), "--device", "cpu",
                    "--num-samples", "3", "--max-samples", "2"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("SVFID: ")]
    assert len(line) == 1
    svfid = float(line[0].split()[1])
    assert np.isfinite(svfid) and svfid >= 0
    samples = np.load(exp / "eval" / "random_samples.npy")
    assert samples.shape == (3, 3, 3, 24, 33)  # (N, C, T, H, W) at scale 4
    assert np.isfinite(samples).all() and np.abs(samples).max() <= 1
    real = np.load(exp / "eval" / "real_full_scale.npy")
    assert real.shape == (5, 24, 33, 3) and real.dtype == np.uint8
    assert sorted(os.listdir(exp / "eval" / "images")) == [
        "fake.gif", "fake_unfold.png", "real.gif", "real_unfold.png"]
    metrics = json.loads((exp / "eval" / "metrics.json").read_text())
    assert metrics["metric"] == "SVFID" and metrics["num_samples"] == 3
    assert metrics["value"] == svfid and metrics["scale_idx"] == 4
