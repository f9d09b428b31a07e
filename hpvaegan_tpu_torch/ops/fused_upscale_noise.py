"""Fused align-corners bilinear upscale + noise injection (kernel K1).

Replaces `ops/pallas/upsample_noise.py::fused_upscale_noise_2d`, the JAX
package's one Pallas kernel. The refinement stage of the generator
in random mode needs
    clean  = upscale(x)                      (the tanh residual's input)
    noised = upscale(x) + amp * N(0, 1)      (the conv stack's input)
and this computes both from one read of x.

On a CUDA tensor `fused_upscale_noise_2d` launches the hand-written kernel
of csrc/upsample_noise.cu (one thread per output element; the source says
what bounds it and what its design does about that). On a CPU tensor it
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

import torch

from . import cuda_build
from .resize import interp_tables, resize_bilinear

_MASK32 = 0xFFFFFFFF
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
    """The kernel's random words for an output of `shape` (B, C, H, W):
    Philox4x32-10 keyed (seed + b, 0) mod 2^32, counter (index within the
    sample, 0, 0, 0); words 0 and 1, as int32."""
    b = int(shape[0])
    per_sample = math.prod(int(s) for s in shape[1:])
    idx = torch.arange(per_sample, dtype=torch.int64, device=device)[None]
    key0 = (int(seed) + torch.arange(b, dtype=torch.int64, device=device)
            )[:, None] & _MASK32
    zero = torch.zeros((b, per_sample), dtype=torch.int64, device=device)
    c0 = idx.expand(b, per_sample)
    w0, w1, _, _ = philox4x32_10((c0, zero, zero, zero), (key0, zero))
    return (_to_int32(w0).reshape(tuple(shape)),
            _to_int32(w1).reshape(tuple(shape)))


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
    if min(out_hw) < 1 or n_out >= 2 ** 31:
        raise ValueError(f"unsupported sizes: x {tuple(x.shape)} -> {out_hw} "
                         "(the kernel takes 1 to 2^31 - 1 outputs)")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its argument types declared."""
    fn = cuda_build.load("upsample_noise").hpv_upsample_noise_2d
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_uint, ctypes.c_void_p])
    return fn


def _launch(x: torch.Tensor, out_hw: Sequence[int], amp: float, seed: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, c, h_in, w_in = x.shape
    h_out, w_out = out_hw
    fn = _kernel()
    lo_h, hi_h, f_h = interp_tables(h_in, h_out, True, x.device)
    lo_w, hi_w, f_w = interp_tables(w_in, w_out, True, x.device)
    clean = torch.empty((b, c, h_out, w_out), dtype=torch.float32,
                        device=x.device)
    noised = torch.empty_like(clean)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), clean.data_ptr(), noised.data_ptr(),
                 lo_h.data_ptr(), hi_h.data_ptr(), f_h.data_ptr(),
                 lo_w.data_ptr(), hi_w.data_ptr(), f_w.data_ptr(),
                 b, c, h_in, w_in, h_out, w_out, float(amp),
                 int(seed) & 0xFFFFFFFF, stream)
    if err != 0:
        raise RuntimeError(f"upsample_noise kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)} -> {tuple(out_hw)})")
    fused_upscale_noise_2d.launches += 1
    return clean, noised


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
