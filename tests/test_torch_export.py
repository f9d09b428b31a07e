"""The port's exported sampler held against the JAX package's on the CPU:
the JAX seed stream as tensor arithmetic (utils/jax_prng.py), the serving
module (export/serving.py) against `make_serving_fn` (export/stablehlo.py
there) from the same weights, noise, amps and seed, the `torch.export`
program and its save/load round trip against the eager module, and the
refusal of the CSG/SG baselines.

Weights are the JAX package's init (perturbed with numpy) and cross through
tools/convert.py. Tolerances: split, bits, bernoulli and the normal draws
bit for bit (the tensor path's erfinv is XLA's polynomial as XLA:CPU
computes it, the numpy path's, in arithmetic a compiler cannot reorder);
the multi-scale sampler atol 1e-4; the exported program equals the eager
module bit for bit on the CPU.
"""

import os

import jax
import numpy as np
import pytest
import torch

from hpvaegan_tpu import models as jmodels
from hpvaegan_tpu.export import stablehlo as jexport

from hpvaegan_tpu_torch.export import __main__ as texport_cli
from hpvaegan_tpu_torch.export import serving
from hpvaegan_tpu_torch.models import get_generator
from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1
from hpvaegan_tpu_torch.utils import jax_prng
from hpvaegan_tpu_torch.utils.noise import KeyedNoise

import test_torch_training as st
import test_torch_video as s3

torch.set_num_threads(1)

GEN_TOL = dict(rtol=0, atol=1e-4)  # multi-scale sampler


def _key(seed):
    return jax_prng.prng_key(torch.tensor(seed, dtype=torch.int32))


def _jax_key_words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


# ------------------------------------------------------------ seed stream

@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 31 - 1])
def test_prng_key_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(np.int32(seed))
    np.testing.assert_array_equal(_key(seed).numpy(), _jax_key_words(key))
    for n in (2, 3, 5):
        np.testing.assert_array_equal(
            jax_prng.split(_key(seed), n).numpy(),
            _jax_key_words(jax.random.split(key, n)))
    # a batch of keys splits as jax.vmap(split) does
    keys = jax.random.split(key, 4)
    np.testing.assert_array_equal(
        jax_prng.split(torch.from_numpy(_jax_key_words(keys))).numpy(),
        _jax_key_words(jax.vmap(jax.random.split)(keys)))


@pytest.mark.parametrize("shape", [(1, 9, 13, 3), (1, 3, 7, 9, 3), (2, 5)],
                         ids=["2d", "3d", "flat"])
def test_normal_and_bernoulli_equal_jax(shape):
    for seed in (0, 5):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            jax_prng.normal(_key(seed), shape).numpy(),
            np.asarray(jax.random.normal(key, shape)))
        np.testing.assert_array_equal(
            jax_prng.bernoulli(_key(seed), shape).numpy(),
            np.asarray(jax.random.bernoulli(key, 0.5, shape)))
    # per-sample keys draw as a vmap of single draws
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    np.testing.assert_array_equal(
        jax_prng.normal(torch.from_numpy(_jax_key_words(keys)), shape).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape))(keys)))


@pytest.mark.parametrize("seed", [0, 1, 11, -7, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(1, 27, 36, 128), (1, 4, 24, 33, 128)],
                         ids=["image", "video"])
def test_normal_is_bit_equal_at_the_serving_shapes(seed, shape):
    """The tensor path's normals equal jax.random.normal bit for bit at the
    full-width serving models' z shapes (image 27 x 36, video 4 x 24 x 33,
    128 latent channels), and equal the numpy path's."""
    got = jax_prng.normal(_key(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(np.int32(seed)),
                                        shape))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if seed >= 0:
        np.testing.assert_array_equal(
            got, jax_prng.normal(jax_prng.prng_key(seed), shape))


def test_erfinv_tensor_equals_the_numpy_path():
    """The tensor erfinv equals the numpy copy of XLA's on 2^18 uniforms and
    at the ends of the uniform's range (both polynomial branches)."""
    u = np.random.RandomState(0).uniform(-1, 1, 2 ** 18).astype(np.float32)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.concatenate([u, np.float32([lo, -lo, 0.0, 2.0 ** -24, 0.5])])
    got = jax_prng._erfinv_tensor(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  jax_prng.erfinv(u).view(np.int32))


def test_keyed_noise_draws_channels_last_and_splits_per_draw():
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    noise = KeyedNoise(torch.from_numpy(_jax_key_words(keys)))
    for shape in ((2, 3, 5, 7), (2, 3, 4, 5, 7)):
        got = noise.normal(shape)
        pairs = jax.vmap(jax.random.split)(keys)
        keys, subs = pairs[:, 0], pairs[:, 1]
        tail = (1,) + shape[2:] + (shape[1],)
        want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, tail))(subs))
        np.testing.assert_array_equal(
            got.numpy(), np.moveaxis(want[:, 0], -1, 1))
    with pytest.raises(ValueError, match="gate keys"):
        noise.bernoulli((2, 1, 5, 7))


def test_keyed_noise_drawn_ahead_equals_drawn_in_turn():
    """Given the shapes of the draws to come (a previous forward's
    drawn_shapes, as the serving module passes them), KeyedNoise draws
    them all up front through one erfinv: the same bits, in the same key
    chain; a draw of another shape is refused."""
    keys = torch.from_numpy(_jax_key_words(jax.random.split(
        jax.random.PRNGKey(2), 2)))
    shapes = [(2, 3, 5, 7), (2, 3, 4, 9, 11), (2, 3, 6, 6)]
    in_turn = KeyedNoise(keys)
    want = [in_turn.normal(s) for s in shapes]
    ahead = KeyedNoise(keys, shapes=in_turn.drawn_shapes)
    for s, w in zip(shapes, want):
        assert torch.equal(ahead.normal(s), w)
    assert ahead.drawn_shapes == shapes
    with pytest.raises(ValueError, match="drawn ahead"):
        KeyedNoise(keys, shapes=shapes).normal((2, 3, 5, 8))


# ---------------------------------------------------------- serving module

def _models(kind):
    """(JAX cfg, params, state, port cfg, port generator, ndim)."""
    if kind == "3d":
        cj, ct = s3._cfgs()
        params, state = s3._jax_generator(cj)
        return cj, params, state, ct, s3._port_generator(ct, params, state), 3
    kw = {"generator": "GeneratorVAE_nb"} if kind == "vae_nb" else {}
    cj, ct = st.cfgs(**kw)
    params, state = st.jax_generator(cj, cj.stop_scale, seed=1)
    return cj, params, state, ct, st.port_generator(ct, params, state), 2


def _inputs(cfg, ndim, batch, seed=0):
    rng = np.random.RandomState(seed)
    z_shape, amps_shape, _ = serving.serving_input_specs(cfg, ndim, batch)
    z = rng.standard_normal(z_shape[0]).astype(np.float32)
    amps = rng.uniform(0.05, 0.5, amps_shape[0]).astype(np.float32)
    amps[0] = 1.0
    return z, amps


@pytest.mark.parametrize("kind,batch", [("2d", 1), ("2d", 2), ("3d", 1),
                                        ("3d", 2), ("vae_nb", 1),
                                        ("vae_nb", 2), ("vae_nb", 3)])
def test_serving_module_matches_jax(kind, batch):
    """The port's serving module equals JAX make_serving_fn (jit, CPU) for
    the same noise_init, amps and seed, and leaves BatchNorm's running
    statistics untouched."""
    cj, params, state, ct, gen, ndim = _models(kind)
    z, amps = _inputs(ct, ndim, batch)
    fn = jax.jit(jexport.make_serving_fn(cj, params, state, ndim))
    want = np.asarray(fn(z, amps, np.int32(11)))
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    with torch.no_grad():
        got = serving.ServingModule(gen)(
            torch.from_numpy(z), torch.from_numpy(amps),
            torch.tensor(11, dtype=torch.int32)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **GEN_TOL)
    for k, v in gen.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_serving_input_specs_match_jax():
    for kind in ("2d", "3d"):
        cj, _, _, ct, _, ndim = _models(kind)
        for batch in (1, 3):
            got = serving.serving_input_specs(ct, ndim, batch)
            want = jexport.serving_input_specs(cj, ndim, batch)
            assert [tuple(s.shape) for s in got] == \
                [tuple(s.shape) for s in want]
            assert [str(s.dtype).split(".")[-1] for s in got] == \
                [s.dtype.name for s in want]


@pytest.fixture(scope="module")
def exported_2d(tmp_path_factory):
    cj, params, state, ct, gen, _ = _models("2d")
    prefix = str(tmp_path_factory.mktemp("export") / "netG")
    program = serving.export_sampler(ct, gen, 2, batch=2, device="cpu")
    serving.save_exported(program, prefix)
    return ct, gen, program, prefix + ".pt2"


def test_exported_program_equals_eager_and_round_trips(exported_2d):
    ct, gen, program, path = exported_2d
    z, amps = _inputs(ct, 2, 2, seed=3)
    with torch.no_grad():
        eager = serving.ServingModule(gen)(
            torch.from_numpy(z), torch.from_numpy(amps),
            torch.tensor(5, dtype=torch.int32))
    for out in (serving.run_serialized(program, z, amps, np.int32(5)),
                serving.load_and_run_serialized(path, z, amps, np.int32(5))):
        assert torch.equal(out, eager)
    assert serving.program_device(program) == torch.device("cpu")


def test_exported_batch_keeps_samples_independent(exported_2d):
    """Sample 0 does not change when only sample 1's noise changes (the
    port's form of tests/test_export.py:65), and the seed is an input."""
    ct, _, _, path = exported_2d
    program = serving.load_serialized(path)
    z, amps = _inputs(ct, 2, 2, seed=4)
    a = serving.run_serialized(program, z, amps, np.int32(3)).numpy()
    z2 = z.copy()
    z2[1] = np.random.RandomState(9).standard_normal(z[1].shape)
    b = serving.run_serialized(program, z2, amps, np.int32(3)).numpy()
    np.testing.assert_array_equal(a[0], b[0])
    assert np.abs(a[1] - b[1]).max() > 0
    c = serving.run_serialized(program, z, amps, np.int32(4)).numpy()
    assert np.abs(a - c).max() > 0


def test_serving_runs_no_kernel(exported_2d):
    """K1 stays off the serving path even with pallas_fused_sampling set:
    the JAX function is train-mode, and its kernel runs only when not
    training."""
    ct, gen, _, _ = exported_2d
    ct.pallas_fused_sampling = True
    z, amps = _inputs(ct, 2, 2)
    before = k1.fused_upscale_noise_2d.launches
    try:
        with torch.no_grad():
            serving.ServingModule(gen)(torch.from_numpy(z),
                                       torch.from_numpy(amps),
                                       torch.tensor(0, dtype=torch.int32))
    finally:
        ct.pallas_fused_sampling = False
    assert k1.fused_upscale_noise_2d.launches == before


# -------------------------------------------------------------- baselines

def test_baselines_are_refused_and_their_jax_export_fails(tmp_path):
    """The JAX export builds a latent_dim-channel noise_init, which a
    baseline's nc_im-channel head cannot take, so it fails; the port
    refuses such a generator with that reason, in the module and the
    CLI."""
    cj, ct = s3._cfgs(generator="GeneratorCSG")
    init = jmodels.get_generator("GeneratorCSG", 3)[0]
    params, state = init(cj, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=r"8 // 1 != 3"):
        jexport.export_sampler(cj, params, state, ndim=3, platforms=("cpu",))
    gen = get_generator("GeneratorCSG", 3)(ct)
    with pytest.raises(ValueError, match="baselines cannot be served"):
        serving.ServingModule(gen)
    ct.write_args_txt(str(tmp_path / "args.txt"))
    with pytest.raises(SystemExit, match="GeneratorCSG: the CSG/SG"):
        texport_cli.main(["--exp-dir", str(tmp_path), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "infer")
