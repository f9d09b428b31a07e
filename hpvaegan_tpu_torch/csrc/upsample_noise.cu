// Fused align-corners bilinear upscale + Gaussian noise injection (K1).
//
// Replaces ops/pallas/upsample_noise.py::fused_upscale_noise_2d, the JAX
// package's one Pallas kernel. For x of (B, C, H_in, W_in) float32,
// NCHW and contiguous, it writes two (B, C, H_out, W_out) float32 tensors,
// the two halves of one (2, B, C, H_out, W_out) buffer:
//   clean  = bilinear upscale of x, align_corners=True, H then W
//   noised = clean + amp * N(0, 1)
// The refinement stage of the generator consumes both (networks_2d.py).
//
// Bound. Per output element the kernel must read a fraction of an input
// float and write two floats: 0.040 ms for the bytes at B=64, 204->257 on
// an H100 SXM (3.35 TB/s). Its float work is small beside that, but the
// instructions it runs are not: a Philox4x32-10 call is twenty 32x32->64
// multiplies, and the accurate logf, cosf and sqrtf that keep it equal to
// its plain version are some eighty instructions per element. So the
// kernel is bound by instruction throughput, and the design spends
// nothing that is not arithmetic the function needs (PERF.md has the
// times; tools/k1_breakdown.py splits them):
//   * one Philox4x32-10 call feeds two outputs: a thread owns one pair of
//     output columns (2j, 2j + 1);
//   * grid (tiles of tile_h output rows, C, B), block (column pairs, rows
//     of the tile): b, c, the pair and the row come from the grid and the
//     thread index; the kernel has no division, and its offsets are 32-bit
//     (the wrapper keeps every tensor under 2^31 elements);
//   * a thread loads its columns' lo_w/hi_w/f_w once and walks down the
//     rows of its tile with them; per row it loads the row's three table
//     entries (one or two rows per warp, so one or two addresses) and its
//     eight taps of x, which neighbouring threads share in L1;
//   * the upscale and the noise never make a round trip through memory.
// Staging the tile's input rows and its outputs in shared memory was built
// and measured slower: the block-wide copies and barriers serialise
// memory traffic that the threads' own loads and stores overlap with the
// arithmetic of other warps. Stores are scalar: odd widths (41, 257) put
// every other row start off an 8-byte boundary, and float2 stores where
// aligned measured no faster. Tensor cores serve nothing here: the JAX
// kernel's interpolation-as-matmul would run in TF32 on this card and lose
// the bit-exact upscale.
//
// Numbers the plain version reproduces bit for bit (same tables, same op
// order, each step rounded: the _rn intrinsics keep nvcc from contracting
// a lerp into an FMA that the plain PyTorch ops do not perform; accurate
// logf, cosf and sqrtf, no fast-math):
//   * the interpolation tables lo/hi/frac come from the host
//     (ops/resize.py::_interp_gather), one entry per output row and column,
//     packed in one int32 buffer (lo_h, hi_h, f_h, lo_w, hi_w, f_w; the
//     fractions as their float bits);
//   * each lerp is a + (b - a) * f;
//   * the random words are Philox4x32-10 (Salmon et al., SC'11) keyed
//     (seed + b, 0) as uint32, counter (j, h, c, 0) for the column pair
//     j = w >> 1 of row h, channel c: words 0 and 1 feed column 2j, words
//     2 and 3 column 2j + 1 (an odd last column uses words 0 and 1 only);
//     each pair (u1 word, u2 word) goes through the Box-Muller map of
//     upsample_noise.py:84-89:
//     u = (float(int32 word) + 2^31) / 2^32, u1 clipped to [1e-7, 1 - 1e-7],
//     noise = sqrt(-2 ln u1) * cos(2 pi u2).
//
// Built by hpvaegan_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes from ops/fused_upscale_noise.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
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

__device__ __forceinline__ float box_muller(uint32_t w1, uint32_t w2) {
  const float u1 = fminf(fmaxf(word_to_unit(w1), 1e-7f), 1.0f - 1e-7f);
  const float u2 = word_to_unit(w2);
  const float rad = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(rad, cosf(__fmul_rn(6.283185307179586f, u2)));
}

// The upscale of output column (lo, hi, f) from input rows p0 and p1.
__device__ __forceinline__ float upscale_tap(const float* p0, const float* p1,
                                             float fh, int lo, int hi,
                                             float f) {
  return lerp_rn(lerp_rn(__ldg(p0 + lo), __ldg(p1 + lo), fh),
                 lerp_rn(__ldg(p0 + hi), __ldg(p1 + hi), fh), f);
}

__global__ void __launch_bounds__(kMaxThreads) upsample_noise_2d_kernel(
    const float* __restrict__ x, float* __restrict__ clean,
    float* __restrict__ noised, const int* __restrict__ tables, int H_in,
    int W_in, int H_out, int W_out, int tile_h, float amp, uint32_t seed) {
  const int* lo_h = tables;
  const int* hi_h = lo_h + H_out;
  const int* f_h = hi_h + H_out;
  const int* lo_w = f_h + H_out;
  const int* hi_w = lo_w + W_out;
  const int* f_w = hi_w + W_out;

  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int plane = b * gridDim.y + c;
  const int h_first = blockIdx.x * tile_h;
  const int h_end = min(h_first + tile_h, H_out);
  const float* xp = x + plane * H_in * W_in;
  const uint32_t key = seed + static_cast<uint32_t>(b);

  const int n_pairs = (W_out + 1) >> 1;
  for (int j = threadIdx.x; j < n_pairs; j += blockDim.x) {
    const int wa = 2 * j;
    const bool has_b = wa + 1 < W_out;
    const int wb = has_b ? wa + 1 : wa;
    const int a_lo = __ldg(lo_w + wa), a_hi = __ldg(hi_w + wa);
    const int b_lo = __ldg(lo_w + wb), b_hi = __ldg(hi_w + wb);
    const float fa = __int_as_float(__ldg(f_w + wa));
    const float fb = __int_as_float(__ldg(f_w + wb));
    for (int h = h_first + threadIdx.y; h < h_end; h += blockDim.y) {
      const float* p0 = xp + __ldg(lo_h + h) * W_in;
      const float* p1 = xp + __ldg(hi_h + h) * W_in;
      const float fh = __int_as_float(__ldg(f_h + h));
      const float ya = upscale_tap(p0, p1, fh, a_lo, a_hi, fa);
      const float yb = upscale_tap(p0, p1, fh, b_lo, b_hi, fb);

      uint32_t ctr[4] = {static_cast<uint32_t>(j), static_cast<uint32_t>(h),
                         static_cast<uint32_t>(c), 0u};
      philox4x32_10(ctr, key, 0u);
      const int o = (plane * H_out + h) * W_out + wa;
      clean[o] = ya;
      noised[o] = __fadd_rn(ya, __fmul_rn(amp, box_muller(ctr[0], ctr[1])));
      if (has_b) {
        clean[o + 1] = yb;
        noised[o + 1] =
            __fadd_rn(yb, __fmul_rn(amp, box_muller(ctr[2], ctr[3])));
      }
    }
  }
}

}  // namespace

// out holds clean then noised, each B*C*H_out*W_out floats. Blocks of
// block_x threads over the column pairs of a row and block_y rows of a tile
// of tile_h rows (the wrapper chooses all three from the shape). Launches on
// `stream` of card `device`.
extern "C" int hpv_upsample_noise_2d(
    const float* x, float* out, const int* tables, int B, int C, int H_in,
    int W_in, int H_out, int W_out, int tile_h, int block_x, int block_y,
    float amp, unsigned int seed, int device, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * C * H_out * W_out;
  if (total == 0) return static_cast<int>(cudaSuccess);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 block(block_x, block_y);
  const dim3 grid((H_out + tile_h - 1) / tile_h, C, B);
  upsample_noise_2d_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, out, out + total, tables, H_in, W_in, H_out, W_out, tile_h, amp,
      seed);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
