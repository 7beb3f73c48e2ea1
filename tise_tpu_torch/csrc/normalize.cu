// K1: uint8 NHWC (C = 3) -> f32 or bf16 `v * scale[c] + shift[c]`, for Hopper (sm_90a).
//
// Replaces the Pallas kernel tise_tpu/ops/preprocess.py::normalize_pallas:
// one fused elementwise pass over a contiguous uint8 tensor whose last
// dimension holds the three channels, with the per-channel scale and shift of
// a normalization recipe.  The arithmetic is the plain PyTorch version's,
// so the output is bit-equal to it:
//   * f32:  __fadd_rn(__fmul_rn(v, s), b), rounded twice, never contracted;
//   * bf16: the product rounded to bf16, then the f32 sum of that and the
//           bf16 shift rounded to bf16 (PyTorch's bf16 multiply, then add).
// The wrapper passes the constants as six floats already cast to the output
// dtype (ops/preprocess.py::_kernel_constants).
//
// What bounds it: bytes.  One uint8 read and one 4-byte (or 2-byte) write per
// element and three operations on it, so the least time is the 5 (or 3)
// bytes per element at the card's memory rate.  The design only streams, with
// every warp access coalesced:
//   * A thread of the body takes 12 words of 4 input bytes, at a stride of
//     THREADS words, so each load of a warp is 128 contiguous bytes and each
//     store 512 (f32, one float4 a thread) or 256 (bf16, 8 bytes).  That is
//     48 bytes, 16 pixels, a thread, as a design with 48 consecutive bytes a
//     thread (three 16-byte loads, twelve 16-byte stores) would take; that
//     design puts neighbouring threads 48 and 192 bytes apart, so every warp
//     access touches 12-32 lines, and on the card it ran several times slower
//     than this one, slower even than the Triton kernel it replaced.
//   * The channel of byte j of word w is (4w + j) mod 3 = (w + j) mod 3.  A
//     block starts at a multiple of 3 words and a thread's words are THREADS
//     words apart, so the channel is (t + i * THREADS + j) mod 3: a rotation
//     by t mod 3, picked once a thread from the six constants, and an offset
//     known when the kernel is compiled.  No modulo or select per element.
//   * The thread's place is a 64-bit block base plus a 32-bit offset.
//   * The tail beyond the last full block, or the whole tensor when its
//     pointer is not 4-byte aligned, takes one element a thread (channel =
//     index mod 3), as K2's scalar instance does.
// One launch covers both; ops/preprocess.py::normalize_geometry computes the
// body's blocks, the tail and the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WORDS = 12;  // 4-byte words of input a thread of the body takes: 48 bytes, 16 pixels

struct Affine {
  float s0, s1, s2, b0, b1, b2;
  __device__ float scale(int c) const { return c == 0 ? s0 : (c == 1 ? s1 : s2); }
  __device__ float shift(int c) const { return c == 0 ? b0 : (c == 1 ? b1 : b2); }
};

__device__ __forceinline__ float apply_f32(float v, float s, float b) { return __fadd_rn(__fmul_rn(v, s), b); }

__device__ __forceinline__ float apply_bf16(float v, float s, float b) {
  const float p = __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, s)));
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(p, b)));
}

template <bool BF16>
__device__ __forceinline__ float apply(float v, float s, float b) {
  return BF16 ? apply_bf16(v, s, b) : apply_f32(v, s, b);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
normalize_kernel(const uint8_t* __restrict__ x, void* __restrict__ out, long long body_blocks, int tail, Affine a) {
  const int t = threadIdx.x;
  if (static_cast<long long>(blockIdx.x) < body_blocks) {
    const long long w0 = static_cast<long long>(blockIdx.x) * (THREADS * WORDS);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(x) + w0 + t;
    uint32_t word[WORDS];
#pragma unroll
    for (int i = 0; i < WORDS; ++i) word[i] = src[i * THREADS];
    // channel of byte j of word i: (4 * (w0 + i * THREADS + t) + j) % 3 = (t + i * THREADS + j) % 3
    const int ph = t % 3;
    const float s[3] = {a.scale(ph), a.scale((ph + 1) % 3), a.scale((ph + 2) % 3)};
    const float b[3] = {a.shift(ph), a.shift((ph + 1) % 3), a.shift((ph + 2) % 3)};
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (i * (THREADS % 3) + j) % 3;
        y[j] = apply<BF16>(static_cast<float>((word[i] >> (8 * j)) & 0xffu), s[c], b[c]);
      }
      if (BF16) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]), hi = __floats2bfloat162_rn(y[2], y[3]);
        uint2 v;
        v.x = *reinterpret_cast<const uint32_t*>(&lo);
        v.y = *reinterpret_cast<const uint32_t*>(&hi);
        reinterpret_cast<uint2*>(out)[w0 + i * THREADS + t] = v;
      } else {
        reinterpret_cast<float4*>(out)[w0 + i * THREADS + t] = make_float4(y[0], y[1], y[2], y[3]);
      }
    }
    return;
  }
  // a tail thread: one element, from element body_blocks * THREADS * WORDS * 4 on
  const long long i = (static_cast<long long>(blockIdx.x) - body_blocks) * THREADS + t;
  if (i >= tail) return;
  const long long e = body_blocks * (THREADS * WORDS * 4) + i;
  const int c = static_cast<int>(e % 3);
  const float y = apply<BF16>(static_cast<float>(x[e]), a.scale(c), a.shift(c));
  if (BF16) {
    static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(out)[e] = y;
  }
}

}  // namespace

// x: uint8, contiguous, its element 0 of channel 0; out: f32 (dtype 0) or
// bf16 (dtype 1), the same n elements.  The first body_blocks blocks take
// THREADS * WORDS 4-byte words each from x's start (x then 4-byte and out
// 16-byte aligned); the next `tail` elements follow, one a thread, in the
// remaining blocks of the grid of `blocks`.  The cut is the caller's
// (ops/preprocess.py::normalize_geometry); one that does not cover the n
// elements exactly with this file's block is refused.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int tise_normalize(const void* x, void* out, long long n, long long body_blocks, int tail, int blocks,
                              int dtype, float s0, float s1, float s2, float b0, float b1, float b2, void* stream) {
  if (body_blocks < 0 || tail < 0 || blocks < 1 || blocks < body_blocks + (tail + THREADS - 1) / THREADS ||
      body_blocks * (THREADS * WORDS * 4) + tail != n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (body_blocks > 0 && (reinterpret_cast<uintptr_t>(x) % 4 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Affine a{s0, s1, s2, b0, b1, b2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(x);
  if (dtype == 0) {
    normalize_kernel<false><<<blocks, THREADS, 0, s>>>(src, out, body_blocks, tail, a);
  } else if (dtype == 1) {
    normalize_kernel<true><<<blocks, THREADS, 0, s>>>(src, out, body_blocks, tail, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
