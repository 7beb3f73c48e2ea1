// P6: a chain of dependent bf16 matmuls out of shared memory, for Hopper (sm_90a).
//
// Replaces the Pallas kernel tools/stem_mm_probe.py::_mm_kernel, which asks
// how fast a chain of dots y = x @ w runs when both operands stay in fast
// on-chip memory, at the Inception stem's narrow output widths: nsteps times
//     y  = x @ w                  bf16 x bf16, f32 accumulate
//     s += y[0, 0]
//     w  = bf16(f32(w) + y[0, 0] * 1e-30)      (a dependency, so no dot is hoisted)
// and returns s.
//
// The TPU kernel holds all of x in its fast memory; an SM has 227 KB of shared
// memory, so here the rows of x are split over blocks.  A block owns 16 rows
// of x and up to 64 columns of w (w [1152, 128] alone is 288 KB, so a wide w
// is split by column as well), keeps its strip of x and its slice of w in
// shared memory for the whole chain, and runs the nsteps loop on them with
// tensor-core MMAs (nvcuda::wmma 16x16x16, bf16 in, f32 accumulators).  The
// original's dependency is kept inside each block: after every dot the
// block's slice of w is rewritten as bf16(f32(w) + y[r0, c0] * 1e-30), with
// (r0, c0) the block's first row and column.  Block (0, 0)'s running sum of
// y[0, 0] is the result.
//
// Layout in shared memory: x strip [16][LD] row-major and w slice TRANSPOSED
// [NB][LD] (so a B fragment is a column-major load), LD = Kp + 8 with Kp = K
// rounded up to 16.  The 8 extra bf16 shift successive rows by 16 bytes, so the
// fragment loads are free of bank conflicts.  Rows beyond m and columns beyond
// K are zero in shared memory (the caller's tensors are never padded).
//
// Work split inside a block: 8 warps = (NB / 16 column tiles) x KS slices of
// the K loop; each warp keeps one 16x16 accumulator.  y itself is never
// stored (the original discards it too), so splitting K costs only the sum of
// KS partial values of y[r0, c0].  So that no MMA is dead code, every warp
// folds one element of its accumulator into a checksum each step and writes
// it to `sink` at the end; on the last step the partial accumulators are also
// stored to `y_part` ([KS][m_pad][n] f32) when it is given, which lets a
// caller hold the whole last dot against a plain product.
//
// What bounds it: operations (2*m*k*n per dot against 989 TFLOP/s dense bf16),
// and below that the shared-memory bandwidth of one A and one B fragment load
// per MMA and the rewrite of w once per dot per block, which a block amortizes
// over only 16 rows.  Making it fast (wgmma, larger register tiles) is for a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int ROWS = 16;      // rows of x per block
constexpr int NB_MAX = 64;    // columns of w per block, at most
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__global__ void __launch_bounds__(THREADS)
stem_mm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               float* __restrict__ s_out, float* __restrict__ y_part, float* __restrict__ sink,
               int m, int k, int n, int nb, int kp, int m_pad, int nsteps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = kp + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);          // [ROWS][ld]
  __nv_bfloat16* wt = xs + ROWS * ld;                                   // [nb][ld], w transposed
  float* red = reinterpret_cast<float*>(wt + nb * ld);                  // [KS][16*16]

  const int r0 = blockIdx.x * ROWS;
  const int c0 = blockIdx.y * nb;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int ct_n = nb / 16;            // column tiles of this block
  const int ks_n = WARPS / ct_n;       // K slices
  const int ct = warp % ct_n;
  const int ks = warp / ct_n;
  const int kt_n = kp / 16;

  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int idx = tid; idx < ROWS * ld; idx += THREADS) {
    const int r = idx / ld, kk = idx % ld;
    xs[idx] = (r0 + r < m && kk < k) ? x[(int64_t)(r0 + r) * k + kk] : zero;
  }
  for (int idx = tid; idx < nb * ld; idx += THREADS) {
    const int c = idx % nb, kk = idx / nb;   // c fastest: coalesced reads of w's rows
    wt[c * ld + kk] = (kk < k) ? w[(int64_t)kk * n + c0 + c] : zero;
  }
  __syncthreads();

  float s = 0.0f;        // the running sum of y[r0, c0]; every thread keeps the same value
  float chk = 0.0f;
  for (int step = 0; step < nsteps; ++step) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kt = ks; kt < kt_n; kt += ks_n) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, xs + kt * 16, ld);
      wmma::load_matrix_sync(b, wt + ct * 16 * ld + kt * 16, ld);
      wmma::mma_sync(acc, a, b, acc);
    }
    chk += acc.x[0];
    if (ct == 0) wmma::store_matrix_sync(red + ks * 256, acc, 16, wmma::mem_row_major);
    if (y_part != nullptr && step == nsteps - 1)
      wmma::store_matrix_sync(y_part + ((int64_t)ks * m_pad + r0) * n + c0 + ct * 16, acc, n, wmma::mem_row_major);
    __syncthreads();
    float y00 = 0.0f;    // y[r0, c0]: the K slices' partial sums, added in a fixed order
    for (int i = 0; i < ks_n; ++i) y00 += red[i * 256];
    s += y00;
    const float d = y00 * 1e-30f;
    // rewrite the block's slice of w: 8 bf16 (16 bytes) per access
    uint4* wt4 = reinterpret_cast<uint4*>(wt);
    for (int idx = tid; idx < nb * ld / 8; idx += THREADS) {
      uint4 v = wt4[idx];
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(p[j]);
        p[j] = __floats2bfloat162_rn(f.x + d, f.y + d);
      }
      wt4[idx] = v;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) s_out[0] = s;
  sink[((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * THREADS + tid] = chk;
}

}  // namespace

// Bytes of dynamic shared memory one block needs for depth k and slice width nb.
extern "C" int tise_stem_mm_smem_bytes(int k, int nb) {
  const int kp = (k + 15) / 16 * 16;
  const int ks_n = WARPS / (nb / 16);
  return (ROWS + nb) * (kp + 8) * 2 + ks_n * 256 * 4;
}

// x [m, k] bf16, w [k, n] bf16, both row-major; n a multiple of 32 (a block
// takes min(n, 64) columns).  s_out [1] f32; y_part [KS, m_pad, n] f32 or
// null; sink [grid * 256] f32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int tise_stem_mm(const void* x, const void* w, void* s_out, void* y_part, void* sink,
                            int m, int k, int n, int nsteps, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || n % 32 != 0 || nsteps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = n < NB_MAX ? n : NB_MAX;
  if (n % nb != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int kp = (k + 15) / 16 * 16;
  const int m_pad = (m + ROWS - 1) / ROWS * ROWS;
  const int smem = tise_stem_mm_smem_bytes(k, nb);
  cudaError_t err = cudaFuncSetAttribute(stem_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(m_pad / ROWS, n / nb);
  stem_mm_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<float*>(s_out),
      static_cast<float*>(y_part), static_cast<float*>(sink), m, k, n, nb, kp, m_pad, nsteps);
  return static_cast<int>(cudaGetLastError());
}
