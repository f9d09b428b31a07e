"""The PyTorch port's ops, config and converters held against the JAX
package on the CPU.

Inputs are made with numpy from fixed seeds and go through both packages;
the port works in NCHW, the JAX package in NHWC. Tolerance per op is the
bar of tests/test_torch_parity.py: f32 with the sums taken in another
order (lax vs aten convolutions, one- vs two-pass variances).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu import config as jcfg
from hpvaegan_tpu.models import networks_2d as jnet
from hpvaegan_tpu.ops import conv as jconv
from hpvaegan_tpu.ops import norm as jnorm
from hpvaegan_tpu.ops import resize as jresize
from hpvaegan_tpu.tools import convert as jconvert
from hpvaegan_tpu.utils import pyramid as jpyr

from hpvaegan_tpu_torch import config as tcfg
from hpvaegan_tpu_torch.models.blocks import ConvStack
from hpvaegan_tpu_torch.ops import conv as tconv
from hpvaegan_tpu_torch.ops import norm as tnorm
from hpvaegan_tpu_torch.ops import resize as tresize
from hpvaegan_tpu_torch.tools import convert as tconvert
from hpvaegan_tpu_torch.utils import noise as tnoise
from hpvaegan_tpu_torch.utils import pyramid as tpyr

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-5)  # per op, as tests/test_torch_parity.py:39


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# ------------------------------------------------------------ config ---

CONFIG_ARGS = [
    {},
    dict(nfc=8, latent_dim=8, num_layer=2, img_size=32, min_size=16,
         max_size=32),
    dict(img_size=200, min_size=25, max_size=180, scale_factor=0.8,
         batch_size=4, data_rep=2, pallas_fused_sampling=True),
]


@pytest.mark.parametrize("kw", CONFIG_ARGS)
def test_config_fields_equal_jax(kw):
    j = jcfg.Config(**kw).finalize()
    t = tcfg.Config(**kw).finalize()
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_args_txt_round_trips_across_packages(tmp_path):
    src = tcfg.Config(nfc=16, image_path="/data/my photos/a.jpg",
                      pallas_fused_sampling=True,
                      sampling_rates=[3, 1]).finalize()
    src.write_args_txt(str(tmp_path / "t.txt"))
    back_j = jcfg.Config.from_args_txt(str(tmp_path / "t.txt"))
    back_t = tcfg.Config.from_args_txt(str(tmp_path / "t.txt"))
    assert back_t.pallas_fused_sampling is True
    assert dataclasses.asdict(back_j) == dataclasses.asdict(back_t) \
        == dataclasses.asdict(src)
    jcfg.Config(pallas_fused_sampling=True).finalize().write_args_txt(
        str(tmp_path / "j.txt"))
    assert tcfg.Config.from_args_txt(str(tmp_path / "j.txt")
                                     ).pallas_fused_sampling is True


def test_pyramid_equals_jax():
    for img_size, sf, stop in ((256, 0.7937005259840998, 9), (32, 0.84, 4),
                               (200, 0.8, 7)):
        for i in range(stop + 1):
            for ar in (1.0, 0.75):
                assert tpyr.scale_size_2d(i, sf, stop, img_size, ar) == \
                    jpyr.scale_size_2d(i, sf, stop, img_size, ar)
            assert tpyr.scale_size_3d(i, sf, stop, img_size, stop, [4, 3, 2, 1],
                                      24.0, 12, 1.0) == \
                jpyr.scale_size_3d(i, sf, stop, img_size, stop, [4, 3, 2, 1],
                                   24.0, 12, 1.0)


# ------------------------------------------------------------ resize ---

@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("src,dst", [((17, 17), (21, 21)), ((13, 20), (27, 9)),
                                     ((33, 33), (41, 41)), ((5, 1), (9, 4))])
def test_resize_bilinear_matches_jax(align_corners, src, dst):
    for n_in, n_out in zip(src, dst):
        for a, b in zip(tresize._interp_gather(n_in, n_out, align_corners),
                        jresize._interp_gather(n_in, n_out, align_corners)):
            np.testing.assert_array_equal(a, b)
    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), dst,
                                              align_corners=align_corners))
    got = _nhwc(tresize.resize_bilinear(_nchw(x), dst,
                                        align_corners=align_corners))
    np.testing.assert_allclose(got, want, **TOL)


def test_upscale_2d_matches_jax():
    cfg = tcfg.Config(img_size=32, min_size=16, max_size=32).finalize()
    x = np.random.RandomState(1).randn(2, 17, 17, 3).astype(np.float32)
    for idx in (1, 2, 4):
        want = jresize.upscale_2d(jnp.asarray(x), idx, cfg.scale_factor,
                                  cfg.stop_scale, cfg.img_size, cfg.ar)
        got = tresize.upscale_2d(_nchw(x), idx, cfg.scale_factor,
                                 cfg.stop_scale, cfg.img_size, cfg.ar)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


# -------------------------------------------------------- conv and BN ---

@pytest.mark.parametrize("ker,pad,stride", [(3, 1, 1), (3, 0, 2), (1, 0, 1)])
def test_conv2d_matches_jax(ker, pad, stride):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 11, 11, 5).astype(np.float32)
    w = rng.randn(ker, ker, 5, 7).astype(np.float32) * 0.2
    b = rng.randn(7).astype(np.float32)
    want = jconv.conv2d_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                              jnp.asarray(x), stride=stride, padding=pad)
    got = tconv.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       torch.from_numpy(b), stride=stride, padding=pad)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def _bn_inputs(seed=3, b=3, c=4):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, 9, 7, c) * 2 + 0.5).astype(np.float32)
    p = {"gamma": (1 + 0.1 * rng.randn(c)).astype(np.float32),
         "beta": (0.1 * rng.randn(c)).astype(np.float32)}
    s = {"mean": (0.1 * rng.randn(c)).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return x, p, s


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("mode", ["batch", "moving"])
def test_batchnorm_train_and_eval_match_jax(mode):
    x, p, s = _bn_inputs()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = {k: jnp.asarray(v) for k, v in s.items()}
    y_j, s_j = jnorm.batchnorm_apply(jp, js, jnp.asarray(x),
                                     train=(mode == "batch"))
    y_t, m_t, v_t = tnorm.batchnorm(_nchw(x), _t(p["gamma"]), _t(p["beta"]),
                                    _t(s["mean"]), _t(s["var"]), mode)
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(s_j["mean"]), **TOL)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(s_j["var"]), **TOL)


def test_batchnorm_per_sample_matches_jax_vmap_of_batch1():
    x, p, s = _bn_inputs(seed=4)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = {k: jnp.asarray(v) for k, v in s.items()}
    y_j = jax.vmap(lambda xi: jnorm.batchnorm_apply(jp, js, xi[None],
                                                    train=True)[0][0])(
        jnp.asarray(x))
    y_t, m_t, v_t = tnorm.batchnorm(_nchw(x), _t(p["gamma"]), _t(p["beta"]),
                                    _t(s["mean"]), _t(s["var"]), "sample")
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), **TOL)
    np.testing.assert_array_equal(m_t.numpy(), s["mean"])  # state unchanged
    np.testing.assert_array_equal(v_t.numpy(), s["var"])
    with pytest.raises(ValueError):
        tnorm.batchnorm(_nchw(x), _t(p["gamma"]), _t(p["beta"]),
                        _t(s["mean"]), _t(s["var"]), "train")


@pytest.mark.parametrize("bn", ["batch", "moving"])
def test_conv_stack_matches_jax(bn):
    """ConvBlock x (1 + num_layer) + tail with the JAX stack's weights,
    carried over by the converter's stack mapping."""
    from hpvaegan_tpu.models import blocks as jblocks

    params, state = jblocks.conv_stack_init(jax.random.PRNGKey(5), 3, 8, 3,
                                            3, 2, ndim=2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * np.random.RandomState(a.size).randn(
            *a.shape).astype(np.float32), params)
    sd = {}
    tconvert._stack_from_jax("s", params, jax.tree_util.tree_map(np.asarray,
                                                                 state), sd)
    stack = ConvStack(3, 8, 3, 3, 1, 2)
    stack.load_state_dict({k[2:]: torch.tensor(v) for k, v in sd.items()})
    x = np.random.RandomState(6).randn(2, 13, 13, 3).astype(np.float32)
    y_j, _ = jblocks.conv_stack_apply(params, state, jnp.asarray(x), ker=3,
                                      padd=1, train=(bn == "batch"), ndim=2)
    with torch.no_grad():
        y_t = stack(_nchw(x), bn)
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), **TOL)


# ------------------------------------------------------------- noise ---

def test_noise_kinds_and_determinism():
    gen = torch.Generator().manual_seed(0)
    n = tnoise.generate_noise(gen, (64, 64))
    assert abs(float(n.mean())) < 0.05 and abs(float(n.std()) - 1) < 0.05
    b = tnoise.generate_noise(gen, (64, 64), "benoulli")
    assert set(np.unique(b.numpy())) == {0.0, 1.0}
    u = tnoise.generate_noise(gen, (64, 64), "uniform")
    assert 0 <= float(u.min()) and float(u.max()) < 1
    with pytest.raises(ValueError):
        tnoise.generate_noise(gen, (2,), "laplace")
    a, b = tnoise.NoiseSource(7, "cpu"), tnoise.NoiseSource(7, "cpu")
    assert torch.equal(a.normal((3, 4)), b.normal((3, 4)))
    seeds = [a.seed() for _ in range(3)]
    assert seeds == [b.seed() for _ in range(3)]
    assert all(0 <= s < 2 ** 31 - 1 for s in seeds)
    assert a.kernel_bits((1, 3, 4, 4)) is None


# --------------------------------------------------------- converter ---

def _jax_generator(cfg, n_stages, seed=0):
    params, state = jnet.generator_hpvaegan_init(cfg, jax.random.PRNGKey(seed))
    for k in range(n_stages):
        params, state = jnet.generator_init_next_stage(
            cfg, params, state, jax.random.PRNGKey(seed + 1 + k))
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


def test_from_jax_equals_j2t_and_to_jax_inverts():
    cfg = jcfg.Config(nfc=8, latent_dim=8, num_layer=2, enc_blocks=2,
                      img_size=32, min_size=16, max_size=32).finalize()
    params, state = _jax_generator(cfg, 2)
    sd = tconvert.from_jax(params, state)
    want = jconvert.j2t_HPVAEGAN(params, state)
    assert sorted(sd) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k])
    p2, s2 = tconvert.to_jax(sd)
    pj, sj = jconvert.p2j_HPVAEGAN(want)
    for got, ref in ((p2, params), (s2, state), (p2, pj), (s2, sj)):
        lg, tg = jax.tree_util.tree_flatten(got)
        lr, tr = jax.tree_util.tree_flatten(ref)
        assert tg == tr
        for a, b in zip(lg, lr):
            np.testing.assert_array_equal(a, b)
