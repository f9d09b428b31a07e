"""The JAX seed stream without JAX: in numpy for the metric networks' init,
and as traceable tensor arithmetic for the exported sampler.

The JAX package initialises its metric networks (metrics/inception.py:
175-188, metrics/c3d.py:50-62 there) with these draws, float32, under
jax 0.9's default `jax_threefry_partitionable=True`. The port keeps its own
copy so that its default SIFID / SVFID features equal the JAX package's at
every block and seed:
  * `prng_key(seed)`: PRNGKey's two words (0, seed) for a 32-bit seed;
  * `fold_in(key, i)`: threefry2x32(key, (0, i));
  * `random_bits(key, n)`: element j hashes the 64-bit counter j as (hi,
    lo) words and keeps the XOR of the two outputs (the partitionable
    layout);
  * `uniform`: the top 23 bits as the mantissa of a float in [1, 2), minus
    1, scaled to [nextafter(-1, 0), 1);
  * `normal`: sqrt(2) * erfinv(u), erfinv as XLA computes it in float32
    (M. Giles' single-precision polynomial, the one `lax.erf_inv` lowers
    to).

The tensor path (`prng_key`, `split`, `normal` and `bernoulli` on tensors)
draws what the JAX package's serving function draws (export/stablehlo.py
there: PRNGKey(seed), split, jax.random.normal / bernoulli), as tensor
arithmetic that `torch.export` traces with the seed as a graph input. A key
is an int64 tensor (..., 2) holding two 32-bit words; words stay in int64
masked to 32 bits, so no unsigned type or bitcast is needed. Each function
maps over the key's leading axes, as `jax.vmap` over a batch of keys does.
The uniform is `(bits >> 9) * 2**-23` (exact), and the normal is
`sqrt(2) * torch.erfinv(u)`: PyTorch's erfinv, not XLA's polynomial, so a
draw may differ from JAX's by an ulp or so (the numpy path above is the bit
exact one).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MASK = 0xFFFFFFFF  # the tensor path's 32-bit words, held in int64
# erfinv's polynomial coefficients for w < 5 and w >= 5, highest first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# log's Cephes coefficients (three groups of three), and log1p's rational
# function's numerator and denominator, highest first
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under `key`, uint32 in and out."""
    u32 = np.uint32
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = np.asarray(x0, np.uint32) + u32(ks[0])
    x1 = np.asarray(x1, np.uint32) + u32(ks[1])
    tmp = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.right_shift(x1, u32(32 - r), out=tmp)
            x1 <<= u32(r)
            x1 |= tmp
            x1 ^= x0
        x0 += u32(ks[(i + 1) % 3])
        x1 += u32((ks[(i + 2) % 3] + i + 1) & 0xFFFFFFFF)
    return x0, x1


def prng_key(seed):
    """jax.random.PRNGKey(seed) for a seed in [0, 2^32); for a tensor seed
    (an int32 0-d tensor, negative ones taken modulo 2^32 as JAX does), the
    key tensor (..., 2)."""
    if torch.is_tensor(seed):
        low = seed.to(torch.int64) & _MASK
        return torch.stack([torch.zeros_like(low), low], dim=-1)
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return 0, int(seed)


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """jax.random.fold_in(key, data)."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.full(1, int(data), np.uint32))
    return int(y0[0]), int(y1[0])


def random_bits(key: Tuple[int, int], n: int) -> np.ndarray:
    """n 32-bit words as jax.random.bits gives them, partitionable
    layout."""
    j = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (j >> np.uint64(32)).astype(np.uint32),
                          j.astype(np.uint32))
    y0 ^= y1
    return y0


def uniform(key: Tuple[int, int], shape: Sequence[int],
            minval: float, maxval: float) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    n = int(np.prod(shape, dtype=np.int64))
    bits = random_bits(key, n)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    out = np.maximum(lo, floats * (hi - lo) + lo)
    return out.reshape(tuple(shape))


def _fma(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding, as the fused multiply-adds
    XLA:CPU emits. The product is exact in float64; rounding the float64
    sum to float32 rounds twice, which goes wrong only where that sum lies
    on a float32 midpoint (its low 29 mantissa bits 1 then zeros): there
    the sum's own rounding error decides."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = a.astype(np.float64) * b
    s = p + c
    r = s.astype(np.float32)
    mid = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(1 << 28)
    if mid.any():
        p, s, c = (np.broadcast_to(v, r.shape)[mid] for v in (p, s, c))
        t = s - p
        err = (p - (s - t)) + (c - t)  # s + err == p + c exactly
        nudged = np.nextafter(s, np.where(err > 0, np.inf, -np.inf))
        r[mid] = np.where(err != 0, nudged, s).astype(np.float32)
    return r


def _polynomial(x, coeffs) -> np.ndarray:
    """Horner's rule with fused multiply-adds, highest coefficient first."""
    p = np.full_like(x, np.float32(coeffs[0]))
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _log(x) -> np.ndarray:
    """XLA:CPU's float32 log of x > 0 (the Cephes polynomial on the
    mantissa in [sqrt(1/2), sqrt(2)), fused multiply-adds)."""
    f32 = np.float32
    bits = np.maximum(np.asarray(x, f32), np.array(0x00800000, np.uint32)
                      .view(f32)).view(np.uint32)
    e = f32(1) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F
                  ).astype(f32)
    m = ((bits & np.uint32(0x807FFFFF)) | np.array(0.5, f32).view(np.uint32)
         ).view(f32)  # in [0.5, 1)
    low = m < f32(0.707106781186547524)
    e = e - np.where(low, f32(1), f32(0))
    m = (m - f32(1)) + np.where(low, m, f32(0))
    m2 = m * m
    m3 = m2 * m
    y = _fma(_polynomial(m, _LOG_P[0:3]), m3, _polynomial(m, _LOG_P[3:6]))
    y = _fma(y, m3, _polynomial(m, _LOG_P[6:9]))
    y = _fma(y, m3, f32(-2.12194440e-4) * e)
    m = _fma(f32(-0.5), m2, m) + y
    return _fma(f32(0.693359375), e, m)


def _log1p(x) -> np.ndarray:
    """XLA:CPU's float32 log1p: a Cephes rational function where |x| <
    sqrt(2) - 1, else log(1 + x)."""
    f32 = np.float32
    x = np.asarray(x, f32)
    small = np.abs(x) < f32(0.41421356237309504880)
    out = np.empty_like(x)
    out[~small] = _log(f32(1) + x[~small])
    x = x[small]
    x2 = x * x
    y = (x * x2) * (_polynomial(x, _LOG1P_NUM) / _polynomial(x, _LOG1P_DEN))
    out[small] = x + _fma(f32(-0.5), x2, y)
    return out


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv (the Giles polynomial), as XLA:CPU computes
    it, for x in (-1, 1)."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -_log1p(-x * x)
    small = w < f32(5)
    p = np.empty_like(x)
    p[small] = _polynomial(w[small] - f32(2.5), _ERFINV_SMALL)
    p[~small] = _polynomial(np.sqrt(w[~small]) - f32(3), _ERFINV_LARGE)
    return p * x


def normal(key, shape: Sequence[int]):
    """jax.random.normal(key, shape) in float32; for a key tensor (*K, 2),
    a tensor (*K, *shape) on the key's device."""
    if torch.is_tensor(key):
        return _normal_tensor(key, shape)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * erfinv(u)


def folded_normal(seed: int, i: int, shape: Sequence[int]) -> np.ndarray:
    """jax.random.normal(jax.random.fold_in(PRNGKey(seed), i), shape), the
    metric networks' draw for their i-th conv."""
    return normal(fold_in(prng_key(seed), i), shape)


# ---------------------------------------------------------------- tensors --


def _threefry_tensor(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 on int64 tensors of 32-bit words: key (*K, 2), the
    counter words (N,) -> two (*K, N) words."""
    k0, k1 = key[..., 0:1], key[..., 1:2]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """jax.random.split(key, n) of a key tensor (*K, 2): (*K, n, 2), key i
    the hash of the counter (0, i)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = _threefry_tensor(key, torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def _bits_tensor(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.bits(key, shape) of 32-bit words (partitionable layout):
    element j (row-major) is the XOR of the hash of the counter (j >> 32,
    j & 0xFFFFFFFF). Returns (*K, *shape) int64."""
    shape = tuple(int(s) for s in shape)
    j = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                     device=key.device)
    y0, y1 = _threefry_tensor(key, j >> 32, j & _MASK)
    return (y0 ^ y1).reshape(tuple(key.shape[:-1]) + shape)


def _uniform_tensor(key: torch.Tensor, shape: Sequence[int], minval: float,
                    maxval: float) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval): the top 23
    bits as a float in [0, 1), exactly, then scaled in float32."""
    floats = (_bits_tensor(key, shape) >> 9).to(torch.float32) * 2.0 ** -23
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


def _normal_tensor(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = _uniform_tensor(key, shape, lo, 1.0)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2)))


def bernoulli(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.bernoulli(key, 0.5, shape) of a key tensor (*K, 2): bool
    (*K, *shape), a float32 uniform below 0.5."""
    return _uniform_tensor(key, shape, 0.0, 1.0) < 0.5
