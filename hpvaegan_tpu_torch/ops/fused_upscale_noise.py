"""Fused align-corners bilinear upscale + noise injection (kernel K1).

Replaces `ops/pallas/upsample_noise.py::fused_upscale_noise_2d`, the JAX
package's one Pallas kernel. The refinement stage of the generator
in random mode needs
    clean  = upscale(x)                      (the tanh residual's input)
    noised = upscale(x) + amp * N(0, 1)      (the conv stack's input)
and this computes both from one read of x.

On a CUDA tensor `fused_upscale_noise_2d` launches the hand-written kernel
of csrc/upsample_noise.cu (a block per tile of output rows of one plane,
a thread per pair of columns, one Philox call per pair; the source says
what bounds it and what its design does about that). The two outputs are
the halves of one (2, B, C, H, W) buffer. On a CPU tensor it
runs `fused_upscale_noise_2d_plain`, the same function in plain PyTorch:
the upscale through ops/resize.py and the Box-Muller map of
upsample_noise.py:84-89 over given 32-bit words. Where no words are given,
`philox_bits` draws the kernel's own Philox4x32-10 stream in plain PyTorch,
so the plain version and the kernel agree for the same seed.

The random words cannot equal the TPU's hardware PRNG bits; tests hold the
noise against JAX by feeding both the same words (the JAX kernel in
interpret mode draws all-zero bits) and hold the kernel's stream
statistically.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from .resize import _interp_gather, resize_bilinear

_MASK32 = 0xFFFFFFFF
_TILE_H = 8  # output rows per block of the kernel
_GRID_YZ_MAX = 65535  # C and B are the kernel's grid y and z
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * m, for a int64 tensor of uint32 values;
    the 64-bit product is formed from 16-bit halves to stay inside int64."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (s >> 32)) & _MASK32, s & _MASK32


def philox4x32_10(counter: Sequence[torch.Tensor], key: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding uint32 values (broadcast)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo32(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def philox_bits(seed: int, shape: Sequence[int], device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's random words for an output of `shape` (B, C, H, W), as
    (u1 words, u2 words), int32. One Philox4x32-10 call per pair of columns:
    key (seed + b, 0) mod 2^32, counter (j, h, c, 0) for columns 2j and
    2j + 1 of row h, channel c; words 0 and 1 go to column 2j, words 2 and
    3 to column 2j + 1 (an odd last column takes words 0 and 1 only)."""
    b, c, h, w = (int(s) for s in shape)
    pairs = (w + 1) // 2

    def axis(n, dim):
        view = [1, 1, 1, 1]
        view[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).reshape(view)

    key0 = (int(seed) + axis(b, 0)) & _MASK32
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = torch.broadcast_tensors(*philox4x32_10(
        (axis(pairs, 3), axis(h, 2), axis(c, 1), zero), (key0, zero)))

    def columns(even, odd):
        both = torch.stack((even, odd), dim=-1).reshape(b, c, h, 2 * pairs)
        return _to_int32(both[..., :w])

    return columns(words[0], words[2]), columns(words[1], words[3])


def box_muller(u1b: torch.Tensor, u2b: torch.Tensor) -> torch.Tensor:
    """N(0, 1) from two int32 words, as upsample_noise.py:84-89 maps them."""
    inv = 1.0 / 4294967296.0
    u1 = (u1b.to(torch.float32) + 2147483648.0) * inv
    u2 = (u2b.to(torch.float32) + 2147483648.0) * inv
    u1 = torch.clamp(u1, 1e-7, 1.0 - 1e-7)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(2.0 * math.pi * u2)


def fused_upscale_noise_2d_plain(x: torch.Tensor, out_hw: Sequence[int], amp,
                                 bits: Tuple[torch.Tensor, torch.Tensor]
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: x (B, C, H_in, W_in) f32 -> (clean, noised),
    each (B, C, H_out, W_out); bits = (u1b, u2b) int32 of the output shape."""
    clean = resize_bilinear(x, out_hw, align_corners=True)
    return clean, clean + float(amp) * box_muller(*bits)


def _check_cuda_input(x: torch.Tensor, out_hw: Sequence[int]) -> None:
    if x.dtype != torch.float32 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("fused_upscale_noise_2d takes a contiguous float32 "
                         f"(B, C, H, W) tensor, got {x.dtype} {tuple(x.shape)}"
                         f" contiguous={x.is_contiguous()}")
    n_out = x.shape[0] * x.shape[1] * out_hw[0] * out_hw[1]
    if (min(out_hw) < 1 or n_out >= 2 ** 31 or x.numel() >= 2 ** 31
            or max(x.shape[:2]) > _GRID_YZ_MAX):
        raise ValueError(f"unsupported sizes: x {tuple(x.shape)} -> {out_hw} "
                         "(the kernel takes 1 to 2^31 - 1 elements in and "
                         f"out, and B and C up to {_GRID_YZ_MAX})")


def _block_shape(w_out: int) -> Tuple[int, int]:
    """(threads over the column pairs of a row, rows of the tile at once):
    one thread per pair up to 512 pairs, and the largest power of two of
    rows up to 4 that keeps the block within the kernel's launch bound of
    512 threads (the best of the shapes tried at the nine stage shapes on
    an H100)."""
    bx = min((w_out + 1) // 2, 512)
    by = 1
    while 2 * by <= min(4, 512 // bx):
        by *= 2
    return bx, by


@functools.lru_cache(maxsize=None)
def _plan(h_in: int, w_in: int, h_out: int, w_out: int,
          device: torch.device) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The kernel's tables for one stage shape, packed in one int32 tensor
    on `device` (lo_h, hi_h, f_h, lo_w, hi_w, f_w; the fractions as their
    float bits), made once per shape and device, and its block shape."""
    lo_h, hi_h, f_h = _interp_gather(h_in, h_out, True)
    lo_w, hi_w, f_w = _interp_gather(w_in, w_out, True)
    packed = np.concatenate([lo_h, hi_h, f_h.view(np.int32),
                             lo_w, hi_w, f_w.view(np.int32)])
    return torch.from_numpy(packed).to(device), _block_shape(w_out)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its argument types declared."""
    fn = cuda_build.load("upsample_noise").hpv_upsample_noise_2d
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_uint, ctypes.c_int,
                      ctypes.c_void_p])
    return fn


def _launch(x: torch.Tensor, out_hw: Sequence[int], amp: float, seed: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, c, h_in, w_in = x.shape
    h_out, w_out = out_hw
    tables, (block_x, block_y) = _plan(h_in, w_in, h_out, w_out, x.device)
    out = torch.empty((2, b, c, h_out, w_out), dtype=torch.float32,
                      device=x.device)
    err = _kernel()(x.data_ptr(), out.data_ptr(), tables.data_ptr(),
                    b, c, h_in, w_in, h_out, w_out, _TILE_H, block_x,
                    block_y, amp, seed & _MASK32, x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"upsample_noise kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)} -> {tuple(out_hw)})")
    fused_upscale_noise_2d.launches += 1
    return out.unbind(0)


def fused_upscale_noise_2d(x: torch.Tensor, out_hw: Sequence[int], amp,
                           seed: int,
                           bits: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, C, H_in, W_in) f32 -> (clean, noised), each (B, C, H_out, W_out).

    CUDA tensor: one launch of the kernel (counted in `.launches`); it draws
    its own words from `seed`, so `bits` must be None. CPU tensor: the plain
    version, over `bits` or, by default, the kernel's Philox words for
    `seed`."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if x.shape[0] == 0:  # no samples (a rank's empty sub-batch): no launch
        empty = x.new_empty((0, x.shape[1]) + out_hw)
        return empty, empty.clone()
    if x.is_cuda:
        if bits is not None:
            raise ValueError("the CUDA kernel draws its own random words; "
                             "injected bits run only on CPU tensors")
        _check_cuda_input(x, out_hw)
        return _launch(x, out_hw, float(amp), int(seed))
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    if bits is None:
        bits = philox_bits(seed, (x.shape[0], x.shape[1]) + out_hw, x.device)
    return fused_upscale_noise_2d_plain(x, out_hw, amp, bits)


fused_upscale_noise_2d.launches = 0
