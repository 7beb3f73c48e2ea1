// K2: NHWC 3x3 stride-1 pad-1 average pool for Hopper (sm_90a).
//
// Replaces the Pallas kernel tise_tpu/ops/fast_pool.py::_pallas_pool /
// _pool_kernel.  It computes what that kernel computes, with the same
// arithmetic: two separable 3-tap sums in f32, each multiplied by the
// reciprocal in-bounds tap count of its row or column (_edge_inv: 1/3
// everywhere when padding counts, 1/2 at an edge when it does not, 1 where
// the dimension is 1), output rounded to the input dtype.  Sums are taken in
// the reference's order ((x[i-1] + x[i]) + x[i+1]) with __fadd_rn/__fmul_rn,
// so no multiply-add is contracted and the result is bit-equal to the plain
// PyTorch version.
//
// What bounds it: bytes.  Nine taps per output and no other work, so the
// ideal is one read and one write of each element.  Each block stages an
// 8x8 output tile plus a one-pixel halo over a run of 32 channels (10x10x32
// f32 = 12.8 KB) in shared memory, reads its inputs from global memory once,
// and runs both passes out of shared memory.  Channels are the fastest index
// of a block's threads, so the NHWC loads and stores are coalesced.  The
// halo costs 100/64 reads per element on interior tiles; the tiles do not
// need the image's full width, so any H and W fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;    // output rows per block
constexpr int TW = 8;    // output columns per block
constexpr int TC = 32;   // channels per block
constexpr int THREADS = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// _edge_inv(n, include_pad)[i]
__device__ __forceinline__ float edge_inv(int i, int n, bool include_pad) {
  if (include_pad) return 1.0f / 3.0f;
  if (n == 1) return 1.0f;
  if (i == 0 || i == n - 1) return 0.5f;
  return 1.0f / 3.0f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
avg_pool3x3_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C,
                   int tiles_w, bool include_pad) {
  __shared__ float in_s[TH + 2][TW + 2][TC];
  __shared__ float row_s[TH][TW + 2][TC];

  const int b = blockIdx.z;
  const int h0 = (blockIdx.y / tiles_w) * TH;
  const int w0 = (blockIdx.y % tiles_w) * TW;
  const int c0 = blockIdx.x * TC;
  const int64_t img = (int64_t)b * H * W * C;

  // stage the tile and its halo; out-of-image taps are the zero padding
  for (int idx = threadIdx.x; idx < (TH + 2) * (TW + 2) * TC; idx += THREADS) {
    const int c = idx % TC;
    const int p = idx / TC;
    const int ww = p % (TW + 2), hh = p / (TW + 2);
    const int gh = h0 + hh - 1, gw = w0 + ww - 1, gc = c0 + c;
    float v = 0.0f;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W && gc < C)
      v = load_f(x + img + ((int64_t)gh * W + gw) * C + gc);
    in_s[hh][ww][c] = v;
  }
  __syncthreads();

  // pass 1: 3-tap sum down the rows, times the row's reciprocal count
  for (int idx = threadIdx.x; idx < TH * (TW + 2) * TC; idx += THREADS) {
    const int c = idx % TC;
    const int p = idx / TC;
    const int ww = p % (TW + 2), hh = p / (TW + 2);
    const float s = __fadd_rn(__fadd_rn(in_s[hh][ww][c], in_s[hh + 1][ww][c]), in_s[hh + 2][ww][c]);
    row_s[hh][ww][c] = __fmul_rn(s, edge_inv(min(h0 + hh, H - 1), H, include_pad));
  }
  __syncthreads();

  // pass 2: 3-tap sum along the columns, times the column's reciprocal count
  for (int idx = threadIdx.x; idx < TH * TW * TC; idx += THREADS) {
    const int c = idx % TC;
    const int p = idx / TC;
    const int ww = p % TW, hh = p / TW;
    const int gh = h0 + hh, gw = w0 + ww, gc = c0 + c;
    if (gh >= H || gw >= W || gc >= C) continue;
    const float s = __fadd_rn(__fadd_rn(row_s[hh][ww][c], row_s[hh][ww + 1][c]), row_s[hh][ww + 2][c]);
    store_f(out + img + ((int64_t)gh * W + gw) * C + gc, __fmul_rn(s, edge_inv(gw, W, include_pad)));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`; returns cudaGetLastError().
extern "C" int tise_avg_pool3x3_s1_p1(const void* x, void* out, int B, int H, int W, int C,
                                      int dtype, int include_pad, void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid((C + TC - 1) / TC, tiles_h * tiles_w, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    avg_pool3x3_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), H, W, C, tiles_w, include_pad != 0);
  } else if (dtype == 1) {
    avg_pool3x3_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), H, W, C, tiles_w,
        include_pad != 0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
