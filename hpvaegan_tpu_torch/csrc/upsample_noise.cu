// Fused align-corners bilinear upscale + Gaussian noise injection (K1).
//
// Replaces ops/pallas/upsample_noise.py::fused_upscale_noise_2d, the JAX
// package's one Pallas kernel. For x of (B, C, H_in, W_in) float32,
// NCHW and contiguous, it writes two (B, C, H_out, W_out) float32 tensors:
//   clean  = bilinear upscale of x, align_corners=True, H then W
//   noised = clean + amp * N(0, 1)
// The refinement stage of the generator consumes both (networks_2d.py).
//
// Bound, counting bytes and float operations: memory. Per output element
// the kernel reads about four input floats (mostly from cache: neighbouring
// outputs share taps) and writes two floats; its float arithmetic (three
// lerps and a Box-Muller) is a few dozen operations, far under the card's
// ratio of operations to bytes (the Philox4x32-10 is integer work on top).
// So the design spends nothing on data reuse and everything on
// moving each byte once: one thread per output element, consecutive threads
// on consecutive W, so the two stores of a warp are two 128-byte lines and
// the gathered loads fall in the same few lines of the input row; the
// upscale and the noise never make a round trip through device memory.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.154 ms
// of device time at B=64, 204->257, against 0.040 ms for its bytes; the
// per-thread instruction count (the 64-bit index division, ten Philox
// rounds, logf and cosf) is the suspect, not the bytes. A 2-D grid without
// the divisions keeps the stream; using all four Philox words and both
// Box-Muller outputs per call would change which word feeds which element,
// and the plain version with it. Both are left for a later change.
//
// Numbers the plain version reproduces bit for bit (same tables, same op
// order, each step rounded: the _rn intrinsics keep nvcc from contracting
// a lerp into an FMA that the plain PyTorch ops do not perform):
//   * the interpolation tables lo/hi/frac come from the host
//     (ops/resize.py::_interp_gather), one entry per output row and column;
//   * each lerp is a + (b - a) * f;
//   * the random words are Philox4x32-10 (Salmon et al., SC'11) keyed
//     (seed + b, 0) as uint32, counter (index within the sample, 0, 0, 0);
//     words 0 and 1 feed the Box-Muller of upsample_noise.py:84-89:
//     u = (float(int32 word) + 2^31) / 2^32, u1 clipped to [1e-7, 1 - 1e-7],
//     noise = sqrt(-2 ln u1) * cos(2 pi u2).
//
// Built by hpvaegan_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes from ops/fused_upscale_noise.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c[0];
    const uint32_t hi0 = __umulhi(kPhiloxM0, c[0]);
    const uint32_t lo1 = kPhiloxM1 * c[2];
    const uint32_t hi1 = __umulhi(kPhiloxM1, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

__device__ __forceinline__ float word_to_unit(uint32_t word) {
  const float w = static_cast<float>(static_cast<int32_t>(word));
  return __fmul_rn(__fadd_rn(w, 2147483648.0f), 2.3283064365386963e-10f);
}

__global__ void upsample_noise_2d_kernel(
    const float* __restrict__ x, float* __restrict__ clean,
    float* __restrict__ noised, const int* __restrict__ lo_h,
    const int* __restrict__ hi_h, const float* __restrict__ f_h,
    const int* __restrict__ lo_w, const int* __restrict__ hi_w,
    const float* __restrict__ f_w, int B, int C, int H_in, int W_in,
    int H_out, int W_out, float amp, uint32_t seed) {
  const int64_t per_sample = static_cast<int64_t>(C) * H_out * W_out;
  const int64_t total = per_sample * B;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;

  const int b = static_cast<int>(i / per_sample);
  const int e = static_cast<int>(i - static_cast<int64_t>(b) * per_sample);
  const int plane = H_out * W_out;
  const int c = e / plane;
  const int r = e - c * plane;
  const int h = r / W_out;
  const int w = r - h * W_out;

  const float* xp = x + (static_cast<int64_t>(b) * C + c) * H_in * W_in;
  const int h0 = lo_h[h] * W_in;
  const int h1 = hi_h[h] * W_in;
  const int w0 = lo_w[w];
  const int w1 = hi_w[w];
  const float fh = f_h[h];
  const float t0 = lerp_rn(xp[h0 + w0], xp[h1 + w0], fh);
  const float t1 = lerp_rn(xp[h0 + w1], xp[h1 + w1], fh);
  const float y = lerp_rn(t0, t1, f_w[w]);

  uint32_t ctr[4] = {static_cast<uint32_t>(e), 0u, 0u, 0u};
  philox4x32_10(ctr, seed + static_cast<uint32_t>(b), 0u);
  const float u1 = fminf(fmaxf(word_to_unit(ctr[0]), 1e-7f), 1.0f - 1e-7f);
  const float u2 = word_to_unit(ctr[1]);
  const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float n = __fmul_rn(rad, cosf(__fmul_rn(6.283185307179586f, u2)));

  clean[i] = y;
  noised[i] = __fadd_rn(y, __fmul_rn(amp, n));
}

}  // namespace

extern "C" int hpv_upsample_noise_2d(
    const float* x, float* clean, float* noised, const int* lo_h,
    const int* hi_h, const float* f_h, const int* lo_w, const int* hi_w,
    const float* f_w, int B, int C, int H_in, int W_in, int H_out, int W_out,
    float amp, unsigned int seed, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * C * H_out * W_out;
  if (total == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  upsample_noise_2d_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, clean, noised, lo_h, hi_h, f_h, lo_w, hi_w, f_w, B, C, H_in, W_in,
      H_out, W_out, amp, seed);
  return static_cast<int>(cudaGetLastError());
}
