"""Kernel K1 of the port (ops/fused_upscale_noise.py) held against the JAX
package's Pallas kernel on the CPU.

The JAX kernel runs as tests/test_pallas_kernels.py runs it here, in TPU
interpret mode, where its hardware PRNG draws all-zero bits: its noise is
then the constant sqrt(2 ln 2) * cos(pi) per element. The port's plain
version, fed the same zero words, must give that noise exactly. The
kernel's own stream (Philox4x32-10) is checked against the published
known-answer vectors and statistically. The CUDA kernel itself runs only
on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hpvaegan_tpu.ops.pallas.upsample_noise import \
    fused_upscale_noise_2d as jax_fused

from hpvaegan_tpu_torch.ops import fused_upscale_noise as k1

torch.set_num_threads(1)

CLEAN_TOL = dict(rtol=0, atol=1e-5)  # matmul-form vs gather-form upscale


def _jax_k1(x_nhwc, out_hw, amp, seed):
    with pltpu.force_tpu_interpret_mode():
        clean, noised = jax_fused(jnp.asarray(x_nhwc), out_hw, amp, seed)
    return np.asarray(clean), np.asarray(noised)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _zero_bits(shape):
    z = torch.zeros(shape, dtype=torch.int32)
    return z, z


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    t = [torch.tensor([v], dtype=torch.int64) for v in counter + key]
    got = k1.philox4x32_10(t[:4], t[4:])
    assert tuple(int(g) for g in got) == want


@pytest.mark.parametrize("shape,out_hw", [((2, 17, 17, 3), (21, 21)),
                                          ((2, 13, 9, 3), (20, 15))])
def test_plain_matches_jax_kernel_interpret(shape, out_hw):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    clean_j, noised_j = _jax_k1(x, out_hw, 0.3, 3)
    b, _, _, c = shape
    clean_t, noised_t = k1.fused_upscale_noise_2d(
        _nchw(x), out_hw, 0.3, seed=3, bits=_zero_bits((b, c) + out_hw))
    np.testing.assert_allclose(clean_t.numpy().transpose(0, 2, 3, 1), clean_j,
                               **CLEAN_TOL)
    np.testing.assert_allclose(noised_t.numpy().transpose(0, 2, 3, 1),
                               noised_j, **CLEAN_TOL)


def test_plain_noise_equals_jax_exactly_with_zero_bits():
    """On a zero input the upscale is exactly 0 in both packages, so the
    outputs are the noise alone: the Box-Muller map must agree bit for bit."""
    x = np.zeros((2, 9, 11, 3), np.float32)
    _, noised_j = _jax_k1(x, (16, 13), 0.7, 11)
    _, noised_t = k1.fused_upscale_noise_2d(
        _nchw(x), (16, 13), 0.7, seed=11, bits=_zero_bits((2, 3, 16, 13)))
    np.testing.assert_array_equal(noised_t.numpy().transpose(0, 2, 3, 1),
                                  noised_j)
    const = np.float32(0.7) * np.float32(-1.1774100)
    np.testing.assert_allclose(noised_j, const, rtol=1e-6)


def test_wrapper_default_bits_are_the_kernels_philox_stream():
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 3, 9, 9)
                         .astype(np.float32))
    launches = k1.fused_upscale_noise_2d.launches
    clean, noised = k1.fused_upscale_noise_2d(x, (14, 12), 0.5, seed=42)
    bits = k1.philox_bits(42, (3, 3, 14, 12))
    want_clean, want_noised = k1.fused_upscale_noise_2d_plain(x, (14, 12),
                                                              0.5, bits)
    assert torch.equal(clean, want_clean) and torch.equal(noised, want_noised)
    assert k1.fused_upscale_noise_2d.launches == launches  # CPU: no launch
    # amp 0 -> noised == clean; same seed -> same output
    c0, n0 = k1.fused_upscale_noise_2d(x, (14, 12), 0.0, seed=42)
    assert torch.equal(c0, n0)
    _, again = k1.fused_upscale_noise_2d(x, (14, 12), 0.5, seed=42)
    assert torch.equal(again, noised)


def test_philox_noise_statistics_and_streams():
    x = torch.zeros(4, 3, 64, 64)
    clean, noised = k1.fused_upscale_noise_2d(x, (96, 96), 1.0, seed=5)
    noise = (noised - clean).numpy()
    assert np.isfinite(noise).all()
    assert abs(noise.mean()) < 0.05
    assert abs(noise.std() - 1.0) < 0.05
    assert np.abs(noise[0] - noise[1]).max() > 0  # per-sample streams
    _, other = k1.fused_upscale_noise_2d(x, (96, 96), 1.0, seed=6)
    assert np.abs(other.numpy() - noised.numpy()).max() > 0
    # the key is (seed + b) mod 2^32: no overflow at the int32 edge
    w_hi = k1.philox_bits(2 ** 31 - 2, (3, 1, 2, 2))[0]
    w_wrap = k1.philox_bits(2 ** 32 - 1, (2, 1, 2, 2))[0]
    assert torch.equal(w_hi[1:2], k1.philox_bits(2 ** 31 - 1,
                                                 (1, 1, 2, 2))[0])
    assert torch.equal(w_wrap[1:2], k1.philox_bits(0, (1, 1, 2, 2))[0])


@pytest.mark.parametrize("shape", [(2, 3, 5, 8), (3, 2, 4, 7), (1, 1, 3, 1)])
def test_philox_bits_one_call_per_column_pair(shape):
    """philox_bits at (b, c, h, 2j) and (b, c, h, 2j + 1) are words (0, 1)
    and (2, 3) of counter (j, h, c, 0) under key (seed + b, 0); an odd last
    column takes words 0 and 1."""
    seed = 2 ** 32 - 2  # the key wraps at b = 2
    u1, u2 = k1.philox_bits(seed, shape)
    assert u1.shape == u2.shape == shape and u1.dtype == torch.int32
    b_n, c_n, h_n, w_n = shape
    for b in range(b_n):
        for c in range(c_n):
            for h in range(h_n):
                for j in range((w_n + 1) // 2):
                    t = [torch.tensor([v], dtype=torch.int64) for v in
                         (j, h, c, 0, (seed + b) % 2 ** 32, 0)]
                    words = [int(v) % 2 ** 32
                             for v in k1.philox4x32_10(t[:4], t[4:])]
                    for w, (i1, i2) in ((2 * j, (0, 1)), (2 * j + 1, (2, 3))):
                        if w < w_n:
                            got = (int(u1[b, c, h, w]) % 2 ** 32,
                                   int(u2[b, c, h, w]) % 2 ** 32)
                            assert got == (words[i1], words[i2])


@pytest.mark.parametrize("hw_in,hw_out", [
    ((33, 33), (41, 41)), ((204, 204), (257, 257)), ((7, 8), (30, 32)),
    ((13, 14), (37, 45)), ((1, 5), (9, 12)), ((257, 258), (41, 43))])
def test_kernel_plan_packs_the_interp_tables(hw_in, hw_out):
    """The kernel's one int32 table holds _interp_gather's six arrays (the
    fractions as their float bits), every tap inside the input."""
    (h_in, w_in), (h_out, w_out) = hw_in, hw_out
    tables, _ = k1._plan(h_in, w_in, h_out, w_out, torch.device("cpu"))
    t = tables.numpy()
    assert t.dtype == np.int32 and t.size == 3 * (h_out + w_out)
    lo_h, hi_h, f_h = (t[i * h_out:(i + 1) * h_out] for i in range(3))
    lo_w, hi_w, f_w = (t[3 * h_out + i * w_out:3 * h_out + (i + 1) * w_out]
                       for i in range(3))
    for got, want in zip((lo_h, hi_h, f_h.view(np.float32), lo_w, hi_w,
                          f_w.view(np.float32)),
                         k1._interp_gather(h_in, h_out, True)
                         + k1._interp_gather(w_in, w_out, True)):
        np.testing.assert_array_equal(got, want)
    assert 0 <= min(lo_h.min(), lo_w.min())
    assert hi_h.max() < h_in and hi_w.max() < w_in


@pytest.mark.parametrize("w_out", [1, 41, 65, 257, 1023, 1025, 4000])
def test_kernel_block_covers_each_column_pair_once(w_out):
    """A block's threads over the pairs of a row, its rows at once dividing
    the row tile, at most 512 threads."""
    bx, by = k1._block_shape(w_out)
    pairs = (w_out + 1) // 2
    assert bx == min(pairs, 512) and bx * by <= 512
    assert by in (1, 2, 4) and k1._TILE_H % by == 0
    assert by == 4 or bx * 2 * by > 512


def test_wrapper_refuses_unknown_devices():
    with pytest.raises(ValueError):
        k1.fused_upscale_noise_2d(torch.zeros(1, 3, 4, 4, device="meta"),
                                  (8, 8), 1.0, seed=0)
