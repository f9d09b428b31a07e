"""The port's default SIFID / SVFID features equal the JAX package's.

Without a weights file both packages score with seeded random features.
The port cannot draw them with `jax.random`, so the seed-0 arrays of the
blocks the CLIs use (InceptionV3 block 0, C3D conv1a) are committed as
`hpvaegan_tpu_torch/metrics/default_init.npz`, which this file writes:

    JAX_PLATFORMS=cpu python tests/test_torch_metric_init.py

The tests hold the committed file to the JAX package's init bit for bit, and
the port's default `sifid_arrays` / `svfid_arrays` to the JAX package's on
the same arrays (rtol 1e-5).
"""

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "hpvaegan_tpu_torch", "metrics", "default_init.npz")
INCEPTION_BLOCK0 = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3")


def jax_default_init():
    """The JAX package's seed-0 init of InceptionV3 block 0 and C3D conv1a,
    keyed as the port's default_init.npz keys them."""
    from hpvaegan_tpu.metrics import c3d as jc3d
    from hpvaegan_tpu.metrics import inception as jinception

    out = {}
    inception = jinception._init_params(0, 0)
    for name in INCEPTION_BLOCK0:
        for k in ("w", "bn_gamma", "bn_beta", "bn_mean", "bn_var"):
            out[f"inception/{name}.{k}"] = inception[f"{name}.{k}"]
    c3d = jc3d.C3D([0], weights="").params
    for k in ("w", "b"):
        out[f"c3d/conv1a.{k}"] = c3d[f"conv1a.{k}"]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def test_committed_arrays_equal_the_jax_init():
    want = jax_default_init()
    with np.load(NPZ) as npz:
        got = {k: npz[k] for k in npz.files}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    n = sum(v.size for k, v in got.items() if k.endswith(".w"))
    assert n == 28512 + 5184


def test_default_sifid_equals_jax():
    from hpvaegan_tpu.metrics import fid as jfid
    from hpvaegan_tpu_torch.metrics import fid as tfid

    rng = np.random.RandomState(0)
    reals = rng.uniform(0, 1, (2, 41, 37, 3)).astype(np.float32)
    fakes = rng.uniform(0, 1, (3, 41, 37, 3)).astype(np.float32)
    want = jfid.sifid_arrays(reals, fakes)
    got = tfid.sifid_arrays(reals, fakes, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_default_svfid_equals_jax():
    from hpvaegan_tpu.metrics import fid as jfid
    from hpvaegan_tpu_torch.metrics import fid as tfid

    rng = np.random.RandomState(1)
    reals = rng.uniform(0, 1, (1, 4, 20, 18, 3)).astype(np.float32)
    fakes = rng.uniform(0, 1, (2, 4, 20, 18, 3)).astype(np.float32)
    want = jfid.svfid_arrays(reals, fakes)
    got = tfid.svfid_arrays(reals, fakes, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_other_seeds_keep_the_torch_init():
    """Seeds other than 0 and C3D blocks 1-3 have no committed arrays."""
    from hpvaegan_tpu_torch.metrics import c3d as tc3d
    from hpvaegan_tpu_torch.metrics import inception as tinception

    with np.load(NPZ) as npz:
        w0 = npz["inception/Conv2d_1a_3x3.w"]
        c0 = npz["c3d/conv1a.w"]
    other = tinception.InceptionV3([0], seed=1, device="cpu")
    assert not np.array_equal(other.params["Conv2d_1a_3x3.w"], w0)
    default = tc3d.C3D([0, 1], device="cpu")
    np.testing.assert_array_equal(default.params["conv1a.w"], c0)
    assert not default.pretrained
    np.testing.assert_array_equal(default.params["conv2a.w"],
                                  tc3d._init_params(0)["conv2a.w"])


if __name__ == "__main__":
    import sys

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    arrays = jax_default_init()
    np.savez(NPZ, **arrays)
    print(f"wrote {NPZ}: {len(arrays)} arrays, "
          f"{os.path.getsize(NPZ)} bytes")
