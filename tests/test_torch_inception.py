"""The port's InceptionV3 blocks 0-3 against the JAX package's, on the CPU.

One 75x75 image (the smallest size that reaches block 3: 17x17, 7x7, 3x3
and 1x1 features) through both packages: with one weights .npz for both
(random BatchNorm statistics, so that the BatchNorm arithmetic is held
too), and with the default init at seeds 0 and 1, whose arrays
utils/jax_prng.py draws as jax.random does. Features agree to rtol 1e-5 of
each block's largest feature: float32 convolutions sum in another order
over up to 49 conv layers.
"""

import numpy as np
import pytest
import torch

from hpvaegan_tpu.metrics import fid as jfid
from hpvaegan_tpu.metrics import inception as jinception

from hpvaegan_tpu_torch.metrics import fid as tfid
from hpvaegan_tpu_torch.metrics import inception as tinception

torch.set_num_threads(1)

X = np.random.RandomState(9).rand(1, 75, 75, 3).astype(np.float32)
SHAPES = [(1, 17, 17, 64), (1, 7, 7, 192), (1, 3, 3, 768), (1, 1, 1, 2048)]


def _features_equal(got, want):
    assert len(got) == len(want) == 4
    for g, w, shape in zip(got, want, SHAPES):
        w = np.asarray(w)
        g = np.moveaxis(g.numpy(), 1, -1)
        assert g.shape == w.shape == shape
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def _nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def test_blocks_with_shared_weights_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    params = {k: np.asarray(v, np.float32)
              for k, v in tinception._init_params(3, seed=5).items()}
    for k in params:
        if k.endswith(("bn_mean", "bn_beta")):
            params[k] = (0.1 * rng.randn(*params[k].shape)).astype(np.float32)
        elif k.endswith(("bn_var", "bn_gamma")):
            params[k] = rng.uniform(0.5, 1.5, params[k].shape).astype(
                np.float32)
    npz = tmp_path / "inception.npz"
    np.savez(npz, **params)
    want = jinception.InceptionV3([0, 1, 2, 3], weights=str(npz))(X)
    model = tinception.InceptionV3([0, 1, 2, 3], weights=str(npz),
                                   device="cpu")
    assert model.pretrained
    _features_equal(model(_nchw(X)), want)
    # any subset of blocks, in block order
    sub = tinception.InceptionV3([3, 1], weights=str(npz), device="cpu")
    assert sub.output_blocks == [1, 3]
    outs = sub(_nchw(X))
    np.testing.assert_array_equal(outs[1].numpy(),
                                  model(_nchw(X))[3].numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_default_init_blocks_match_jax(seed):
    want = jinception.InceptionV3([0, 1, 2, 3], seed=seed)(X)
    model = tinception.InceptionV3([0, 1, 2, 3], seed=seed, device="cpu")
    assert not model.pretrained
    _features_equal(model(_nchw(X)), want)


def test_sifid_arrays_pick_the_block_of_dims():
    """dims 192 picks block 1 of a model built with more blocks, as JAX
    fid.py::_block_out does; an unknown block is refused."""
    rng = np.random.RandomState(4)
    reals = rng.rand(1, 75, 75, 3).astype(np.float32)
    fakes = rng.rand(2, 75, 75, 3).astype(np.float32)
    jmodel = jinception.InceptionV3([0, 1])
    tmodel = tinception.InceptionV3([0, 1], device="cpu")
    want = jfid.sifid_arrays(reals, fakes, dims=192, model=jmodel)
    got = tfid.sifid_arrays(reals, fakes, dims=192, model=tmodel)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    block0 = tfid.sifid_arrays(reals, fakes, dims=64, model=tmodel)
    assert not np.allclose(block0, got)
    with pytest.raises(ValueError):
        tinception.InceptionV3([4], device="cpu")
