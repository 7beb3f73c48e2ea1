// K3: out = alpha * I + beta * (A @ B) in IEEE f32 for Hopper (sm_90a).
//
// Replaces the Pallas kernel tise_tpu/ops/pallas_kernels.py::epilogue_matmul /
// _epilogue_matmul_kernel, the step T = 0.5 * (3I - Z @ Y) of the
// Newton–Schulz matrix square root behind `--sqrtm ns-pallas`.  The TPU
// kernel walks k as a sequential grid axis with the sum in VMEM scratch;
// blocks here run in parallel and in no order, so the whole k loop runs
// inside each block and the sum stays in registers.  The epilogue scales by
// beta and adds alpha on the global diagonal (row == col) as two rounded
// operations, as the TPU kernel does; the ragged edge (n not a multiple of
// the tile) is masked in the loads and stores instead of padding the inputs.
//
// What bounds it: f32 arithmetic.  At n = 2048 the product is 17.2 GFLOP
// against 48 MB of traffic, far above the card's ridge point, and the f32
// path has no tensor cores (TF32 would lose the parity the JAX f32 dot
// keeps).  The design is the classic SIMT tiling: a 128x128 output tile per
// 256-thread block, each thread holding an 8x8 register block, k in steps of
// 8 through double-buffered shared-memory tiles (the next tile's global loads
// are in flight while the current one is multiplied), and 128-bit shared
// loads so each step costs 4 shared loads for 64 fused multiply-adds.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps the transposed A stores free of bank conflicts

__global__ void __launch_bounds__(THREADS, 2)
epilogue_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                       int M, int N, int K, float alpha, float beta) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];  // A tile, transposed: As[k][m]
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;

  // global -> register staging: 4 elements of A and 4 of B per thread
  float ra[4], rb[4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      const int m = idx / BK, k = idx % BK;
      const int gr = bm + m, gk = k0 + k;
      ra[i] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : 0.0f;
      const int kb = idx / BN, n = idx % BN;
      const int gkb = k0 + kb, gc = bn + n;
      rb[i] = (gkb < K && gc < N) ? B[(size_t)gkb * N + gc] : 0.0f;
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      As[buf][idx % BK][idx / BK] = ra[i];
      Bs[buf][idx / BN][idx % BN] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int k_tiles = (K + BK - 1) / BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < k_tiles) load_tile((kt + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      // this thread's rows are ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise with tx
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < k_tiles) store_tile(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = bm + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = bn + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c >= N) continue;
      float v = __fmul_rn(acc[i][j], beta);
      if (r == c) v = __fadd_rn(v, alpha);
      C[(size_t)r * N + c] = v;
    }
  }
}

}  // namespace

// A [M, K], B [K, N], C [M, N], all row-major contiguous f32.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int tise_epilogue_matmul(const void* a, const void* b, void* c, int M, int N, int K,
                                    float alpha, float beta, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  epilogue_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), M, N, K,
      alpha, beta);
  return static_cast<int>(cudaGetLastError());
}
