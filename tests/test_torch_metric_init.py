"""The port's default SIFID / SVFID features equal the JAX package's.

Without a weights file both packages score with seeded random features:
conv i of InceptionV3 / C3D draws jax.random.normal(fold_in(PRNGKey(seed),
i)) / sqrt(fan_in). The port draws them with utils/jax_prng.py, a numpy
copy of jax.random (threefry2x32, fold_in, the partitionable bits layout,
uniform, XLA:CPU's float32 erfinv), which these tests hold to `jax.random`
bit for bit: the draws over keys, fold-ins and shapes, and every array of
both networks' default init at seeds 0 and 1. The features themselves
(InceptionV3 blocks 1-3 in tests/test_torch_inception.py) and the default
`sifid_arrays` / `svfid_arrays` are held to the JAX package's at rtol 1e-5.
No init array is committed.
"""

import os

import jax
import numpy as np
import pytest
import torch

from hpvaegan_tpu.metrics import c3d as jc3d
from hpvaegan_tpu.metrics import fid as jfid
from hpvaegan_tpu.metrics import inception as jinception

from hpvaegan_tpu_torch.metrics import c3d as tc3d
from hpvaegan_tpu_torch.metrics import fid as tfid
from hpvaegan_tpu_torch.metrics import inception as tinception
from hpvaegan_tpu_torch.utils import jax_prng

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INCEPTION_BLOCK0 = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3")


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_committed_arrays_equal_the_jax_init():
    """The arrays the port once shipped as default_init.npz (InceptionV3
    block 0 and C3D conv1a at seed 0) are now drawn by it: bit for bit the
    JAX package's init, and no such file ships."""
    want = jinception._init_params(0, 0)
    got = tinception._init_params(0, 0)
    assert sorted(got) == sorted(want)
    for name in INCEPTION_BLOCK0:
        for k in ("w", "bn_gamma", "bn_beta", "bn_mean", "bn_var"):
            key = f"{name}.{k}"
            assert got[key].dtype == np.float32, key
            np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))
    c3d = jc3d.C3D([0], weights="").params
    mine = tc3d._init_params(0, 0)
    for k in ("conv1a.w", "conv1a.b"):
        np.testing.assert_array_equal(_bits(mine[k]), _bits(c3d[k]))
    n = sum(v.size for k, v in got.items() if k.endswith(".w"))
    assert n + mine["conv1a.w"].size == 28512 + 5184
    assert not os.path.exists(os.path.join(
        REPO, "hpvaegan_tpu_torch", "metrics", "default_init.npz"))


def test_default_sifid_equals_jax():
    rng = np.random.RandomState(0)
    reals = rng.uniform(0, 1, (2, 41, 37, 3)).astype(np.float32)
    fakes = rng.uniform(0, 1, (3, 41, 37, 3)).astype(np.float32)
    want = jfid.sifid_arrays(reals, fakes)
    got = tfid.sifid_arrays(reals, fakes, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_default_svfid_equals_jax():
    rng = np.random.RandomState(1)
    reals = rng.uniform(0, 1, (1, 4, 20, 18, 3)).astype(np.float32)
    fakes = rng.uniform(0, 1, (2, 4, 20, 18, 3)).astype(np.float32)
    want = jfid.svfid_arrays(reals, fakes)
    got = tfid.svfid_arrays(reals, fakes, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_other_seeds_keep_the_torch_init():
    """Seeds other than 0, and C3D blocks 1-3, were torch draws before the
    port had jax_prng; now they are the JAX package's too: block 0 at seed
    1 and C3D conv2a at seed 0, bit for bit (every block at both seeds:
    test_c3d_default_init_equals_jax, tests/test_torch_inception.py)."""
    other = tinception.InceptionV3([0], seed=1, device="cpu")
    want = jinception._init_params(0, 1)
    assert not np.array_equal(other.params["Conv2d_1a_3x3.w"],
                              tinception._init_params(0, 0)
                              ["Conv2d_1a_3x3.w"])
    for k, v in want.items():
        np.testing.assert_array_equal(_bits(other.params[k]), _bits(v))
    default = tc3d.C3D([0, 1], device="cpu")
    assert not default.pretrained
    jparams = jc3d.C3D([0, 1], weights="").params
    for k in ("conv1a.w", "conv2a.w"):
        np.testing.assert_array_equal(_bits(default.params[k]),
                                      _bits(jparams[k]))


# -------------------------------------------------------------- PRNG ---

@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 + 5])
def test_prng_key_and_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(w) for w in jax.random.key_data(key)) == \
        jax_prng.prng_key(seed)
    for data in (0, 1, 7, 94, 2 ** 32 - 1):
        want = jax.random.key_data(jax.random.fold_in(key, data))
        assert tuple(int(w) for w in want) == \
            jax_prng.fold_in(jax_prng.prng_key(seed), data)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 3, 3, 5), (1, 7, 64, 33),
                                   (3, 3, 3, 64, 65)])
@pytest.mark.parametrize("seed,fold", [(0, 0), (0, 93), (1, 4), (9, 1)])
def test_normal_equals_jax_bit_for_bit(seed, fold, shape):
    """Odd sizes, the metric networks' shapes (up to 0.8M draws), bits,
    uniforms and normals, including erfinv's |w| >= 5 branch."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    mine = jax_prng.fold_in(jax_prng.prng_key(seed), fold)
    n = int(np.prod(shape))
    np.testing.assert_array_equal(
        jax_prng.random_bits(mine, n).reshape(shape),
        np.asarray(jax.random.bits(key, shape)))
    want = np.asarray(jax.random.normal(key, shape))
    got = jax_prng.folded_normal(seed, fold, shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_erfinv_equals_xla_on_a_grid():
    """XLA's float32 erfinv against the numpy copy on 2^20 uniforms in
    (-1, 1), both tails included."""
    u = np.linspace(-1, 1, 2 ** 20 + 2, dtype=np.float32)[1:-1]
    u = np.concatenate([u, np.float32([-0.99999994, 0.99999994, 0.0])])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    np.testing.assert_array_equal(_bits(jax_prng.erfinv(u)), _bits(want))


def test_prng_refuses_seeds_outside_32_bits():
    with pytest.raises(ValueError):
        jax_prng.prng_key(-1)
    with pytest.raises(ValueError):
        jax_prng.prng_key(2 ** 32)


# -------------------------------------------------------------- C3D ---

@pytest.mark.parametrize("seed", [0, 1])
def test_c3d_default_init_equals_jax(seed):
    """Blocks 0-3 at seeds 0 and 1: every array bit for bit, and the four
    blocks' features at rtol 1e-5 (of each block's largest feature)."""
    jmodel = jc3d.C3D([0, 1, 2, 3], weights="", seed=seed)
    tmodel = tc3d.C3D([0, 1, 2, 3], seed=seed, device="cpu")
    assert sorted(tmodel.params) == sorted(jmodel.params)
    for k, v in jmodel.params.items():
        np.testing.assert_array_equal(_bits(tmodel.params[k]), _bits(v))
    x = np.random.RandomState(seed).rand(1, 8, 16, 16, 3).astype(np.float32)
    want = jmodel(x)
    got = tmodel(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = np.moveaxis(g.numpy(), 1, -1)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
