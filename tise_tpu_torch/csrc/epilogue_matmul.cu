// K3: out = alpha * I + beta * (A @ B) in IEEE f32 for Hopper (sm_90a).
//
// Replaces the Pallas kernel tise_tpu/ops/pallas_kernels.py::epilogue_matmul /
// _epilogue_matmul_kernel, the step T = 0.5 * (3I - Z @ Y) of the
// Newton–Schulz matrix square root behind `--sqrtm ns-pallas`.  The TPU
// kernel walks k as a sequential grid axis with the sum in VMEM scratch;
// blocks here run in parallel and in no order, so the whole k loop runs
// inside each block and the sum stays in registers.
//
// What bounds it: f32 arithmetic outside the tensor cores.  At n = 2048 the
// product is 17.2 GFLOP against 48 MB of traffic, far above the card's ridge
// point, and IEEE f32 has no tensor-core path (TF32 would lose the parity the
// JAX f32 dot keeps).  On this card a fused multiply-add and any other
// operation share one dispatch slot per scheduler per clock, so the design
// spends as few slots as it can on anything but the multiply-adds (in the
// compiled main loop 2,048 of 2,231 SASS lines are multiply-adds):
//
//   * a ring of STAGES tiles in dynamic shared memory (104 KB a block, asked
//     for with cudaFuncSetAttribute), filled by 16-byte `cp.async` copies
//     straight from global memory: no register staging, no shared-memory
//     stores, and one `__syncthreads()` per BK = 32 steps of k;
//   * a thread's copies keep their place from one k-tile to the next, so its
//     two source pointers only move on by a constant (TileCopier): the main
//     loop computes no index;
//   * A stays as it lies in memory, As[m][k] with k contiguous and the row
//     padded by 4 floats, so that a thread reads A[row][k..k+3] as one 128-bit
//     load for each of its eight rows (the four rows a warp reads at once fall
//     on disjoint banks); B is Bs[k][n], read as two 128-bit loads per k.
//     That is four shared loads for 64 multiply-adds;
//   * a 128x128 output tile per 256-thread block, two blocks an SM, 8x8 sums
//     a thread and a 32x64 tile per warp: per k a warp touches 2 x 128 bytes
//     of B and four rows of A, four shared-memory wavefronts;
//   * the k loop of a stage is fully unrolled and the fragments are double
//     buffered in registers: B's for step k + 1 and A's for the next four
//     steps are loaded before step k is multiplied;
//   * three instances of one template: INTERIOR (n a multiple of the tile
//     and of BK, pointers 16-byte aligned) has no predicate anywhere;
//     RAGGED16 (n % 4 == 0, aligned, e.g. 1000) zero-fills 16-byte copies past
//     the edge; RAGGED4 (any n, e.g. 127 or 2047, where a row of n floats is
//     not 16-byte aligned) copies 4 bytes at a time, still asynchronously.
//     The host entry picks one; none pads the inputs;
//   * the epilogue stores rows of four as float4 (scalars in RAGGED4), and
//     only tiles on the diagonal (blockIdx.x == blockIdx.y) test row == col.
//
// The arithmetic is fixed by the contract, not by the tiling: every output
// element is one chain of fmaf over k = 0 .. K-1 from zero, then one rounded
// multiply by beta, then one rounded add of alpha on the diagonal, as the TPU
// kernel's epilogue does.  No split-k, no reassociation: any tile size and
// any of the three instances gives the same bits (a k past the edge adds
// fmaf(0, 0, sum), which leaves the sum as it is).
//
// BK = 32, three stages and two blocks an SM are the fastest of the variants
// timed on an H100 (BK 8 to 64, two to eight stages, one to four blocks).
// tools/epilogue_matmul_compare.py times this source beside another one and
// torch.addmm in turns on the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;
constexpr int MAX_DEVICES = 64;
constexpr int LDA = BK + 4;  // padded row of the A tile: 16-byte aligned, conflict-free 128-bit reads
constexpr int A_FLOATS = BM * LDA;
constexpr int B_FLOATS = BK * BN;
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr int STAGE_BYTES = STAGE_FLOATS * static_cast<int>(sizeof(float));
constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;

static_assert(BM == BN, "the diagonal lies in the tiles with blockIdx.x == blockIdx.y only when tiles are square");
static_assert(BK % 8 == 0, "A's fragments are read four k at a time, and 256 threads copy 8 rows of B in a pass");
static_assert(STAGES >= 2, "the ring needs a stage to fill while one is read");

enum Mode { INTERIOR = 0, RAGGED16 = 1, RAGGED4 = 2 };

__device__ __forceinline__ void cp_async_16(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// `bytes` of the source are copied and the rest of the destination is
// zero-filled; with bytes == 0 the source is not read.
__device__ __forceinline__ void cp_async_16_zfill(unsigned dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4_zfill(unsigned dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's share of the copies of a k-tile (BK steps of k of A's rows
// bm.. and B's columns bn..) into a stage of the ring.  The tiles are cut
// into chunks of VEC floats; the 256 threads cover A_RSTEP rows of the A tile
// (B_RSTEP of the B tile) in one pass and take as many passes as the tile
// needs.  A thread's chunk keeps its place in every pass and every k-tile, so
// the source pointers only move on by BK columns (A) or BK rows (B) per tile:
// the interior instance computes no index and no predicate after set-up.
template <int MODE>
struct TileCopier {
  static constexpr int VEC = MODE == RAGGED4 ? 1 : 4;
  static constexpr int A_ROW = BK / VEC, A_RSTEP = THREADS / A_ROW, A_PASSES = BM / A_RSTEP;
  static constexpr int B_ROW = BN / VEC, B_RSTEP = THREADS / B_ROW, B_PASSES = BK / B_RSTEP;
  static_assert(THREADS % A_ROW == 0 && BM % A_RSTEP == 0 && THREADS % B_ROW == 0 && BK % B_RSTEP == 0,
                "whole passes");

  const float* a_src;  // this thread's chunk of A in the next k-tile to copy, first pass
  const float* b_src;
  size_t a_pass, b_pass;  // floats from one pass to the next in global memory
  unsigned a_dst, b_dst;  // shared-memory address of the chunk in stage 0, first pass
  int a_r, a_c, b_r, b_c;  // the chunk's row and column in the A tile and in the B tile

  __device__ __forceinline__ TileCopier(const float* A, const float* B, const float* ring, int N, int K, int bm,
                                        int bn, int tid) {
    a_r = tid / A_ROW, a_c = (tid % A_ROW) * VEC;
    b_r = tid / B_ROW, b_c = (tid % B_ROW) * VEC;
    a_src = A + static_cast<size_t>(bm + a_r) * K + a_c;
    b_src = B + static_cast<size_t>(b_r) * N + (bn + b_c);
    a_pass = static_cast<size_t>(A_RSTEP) * K;
    b_pass = static_cast<size_t>(B_RSTEP) * N;
    const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(ring));
    a_dst = base + (a_r * LDA + a_c) * 4;
    b_dst = base + (A_FLOATS + b_r * BN + b_c) * 4;
  }

  // Start the copies of k-tile k0 .. k0 + BK into the stage at byte offset `stage`, and move on to the next.
  __device__ __forceinline__ void copy(unsigned stage, const float* A, const float* B, int M, int N, int K, int bm,
                                       int bn, int k0) {
#pragma unroll
    for (int p = 0; p < A_PASSES; ++p) {
      const float* src = a_src + p * a_pass;
      const unsigned dst = a_dst + stage + p * (A_RSTEP * LDA * 4);
      if (MODE == INTERIOR) {
        cp_async_16(dst, src);
      } else {  // a chunk is wholly inside or wholly outside: K % 4 == 0 where VEC is 4
        const bool live = bm + a_r + p * A_RSTEP < M && k0 + a_c < K;
        if (MODE == RAGGED16) cp_async_16_zfill(dst, live ? src : A, live ? 16 : 0);
        else cp_async_4_zfill(dst, live ? src : A, live ? 4 : 0);
      }
    }
#pragma unroll
    for (int p = 0; p < B_PASSES; ++p) {
      const float* src = b_src + p * b_pass;
      const unsigned dst = b_dst + stage + p * (B_RSTEP * BN * 4);
      if (MODE == INTERIOR) {
        cp_async_16(dst, src);
      } else {  // N % 4 == 0 where VEC is 4
        const bool live = k0 + b_r + p * B_RSTEP < K && bn + b_c < N;
        if (MODE == RAGGED16) cp_async_16_zfill(dst, live ? src : B, live ? 16 : 0);
        else cp_async_4_zfill(dst, live ? src : B, live ? 4 : 0);
      }
    }
    a_src += BK;
    b_src += static_cast<size_t>(BK) * N;
  }
};

// A thread's fragments: a[i] = A[row_i][k .. k+3] for its eight rows, and for
// one k the eight values of B in its columns.
struct AFrag {
  float4 v[8];
};
struct BFrag {
  float4 lo, hi;
};

__device__ __forceinline__ void load_a(AFrag& a, const float* __restrict__ as, int k4) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a.v[i] = *reinterpret_cast<const float4*>(as + i * 4 * LDA + k4);
}

__device__ __forceinline__ void load_b(BFrag& b, const float* __restrict__ bs, int k) {
  b.lo = *reinterpret_cast<const float4*>(bs + k * BN);
  b.hi = *reinterpret_cast<const float4*>(bs + k * BN + 32);
}

__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma_step(float (&acc)[8][8], const AFrag& a, int q, const BFrag& b) {
  const float bv[8] = {b.lo.x, b.lo.y, b.lo.z, b.lo.w, b.hi.x, b.hi.y, b.hi.z, b.hi.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float av = component(a.v[i], q);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
  }
}

// The BK steps of one stage.  `as` points at this thread's first row of the A
// tile, `bs` at its first column of the B tile.  Fragments are double
// buffered in registers: B's for step k + 1 and A's for the next four steps
// are in flight while step k is multiplied.
__device__ __forceinline__ void compute_stage(float (&acc)[8][8], const float* __restrict__ as,
                                              const float* __restrict__ bs) {
  AFrag a[2];
  BFrag b[2];
  load_a(a[0], as, 0);
  load_b(b[0], bs, 0);
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const int g = k / 4, q = k % 4;  // group of four k, and place in it
    if (k + 1 < BK) load_b(b[(k + 1) & 1], bs, k + 1);
    if (q == 0 && k + 4 < BK) load_a(a[(g + 1) & 1], as, k + 4);
    fma_step(acc, a[g & 1], q, b[k & 1]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
epilogue_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C, int M,
                       int N, int K, float alpha, float beta) {
  extern __shared__ __align__(16) float ring[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps, each a 32 x 64 tile
  const int tm = lane / 8, tn = lane % 8;  // 4 x 8 threads, each 8 x 8
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  // this thread's rows are bm + row0 + 4 i (i = 0..7); its columns bn + col0 + {0..3} and + 32 + {0..3}
  const int row0 = wm * 32 + tm, col0 = wn * 64 + tn * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int k_tiles = (K + BK - 1) / BK;
  TileCopier<MODE> copier(A, B, ring, N, K, bm, bn, tid);
  // every thread commits one group per k-tile, empty past the end, so that
  // "all but the newest STAGES - 2 groups are complete" always means "tile kt has landed"
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) copier.copy(s * STAGE_BYTES, A, B, M, N, K, bm, bn, s * BK);
    cp_async_commit();
  }

  // this thread's first row of the A tile and first column of the B tile, in stage 0
  const float* as = ring + row0 * LDA;
  const float* bs = ring + A_FLOATS + col0;
  int read = 0, write = (STAGES - 1) * STAGE_FLOATS;  // float offsets of the stages holding tile kt, and to be filled
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt are done
    __syncthreads();              // everyone's are, and everyone has finished reading tile kt - 1
    const int next = kt + STAGES - 1;
    if (next < k_tiles) copier.copy(write * 4, A, B, M, N, K, bm, bn, next * BK);
    cp_async_commit();
    compute_stage(acc, as + read, bs + read);
    read = read + STAGE_FLOATS == RING_FLOATS ? 0 : read + STAGE_FLOATS;
    write = write + STAGE_FLOATS == RING_FLOATS ? 0 : write + STAGE_FLOATS;
  }

  const bool diagonal = blockIdx.x == blockIdx.y;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = bm + row0 + 4 * i;
    if (MODE != INTERIOR && r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = bn + col0 + 32 * h;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = __fmul_rn(acc[i][4 * h + q], beta);
      if (diagonal) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r == c + q) v[q] = __fadd_rn(v[q], alpha);
      }
      float* dst = C + static_cast<size_t>(r) * N + c;
      if (MODE == RAGGED4) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < N) dst[q] = v[q];
      } else if (MODE == INTERIOR || c < N) {  // N % 4 == 0: four columns are inside together
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const float* a, const float* b, float* c, int M, int N, int K, float alpha, float beta,
                   cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be asked for, once per
  // instance and device (a repeated request from two host threads is harmless)
  static bool asked[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !asked[dev]) {
    err = cudaFuncSetAttribute(epilogue_matmul_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) asked[dev] = true;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  epilogue_matmul_kernel<MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(a, b, c, M, N, K, alpha, beta);
  return cudaGetLastError();
}

// 16-byte copies need 16-byte aligned rows: aligned pointers and n % 4 == 0.
int pick_mode(const void* a, const void* b, const void* c, int M, int N, int K) {
  const bool aligned = (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c)) % 16 == 0 && N % 4 == 0 && K % 4 == 0;
  if (aligned && M % BM == 0 && N % BN == 0 && K % BK == 0) return INTERIOR;
  return aligned ? RAGGED16 : RAGGED4;
}

}  // namespace

// A [M, K], B [K, N], C [M, N], all row-major contiguous f32, any sizes >= 1.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int tise_epilogue_matmul(const void* a, const void* b, void* c, int M, int N, int K, float alpha,
                                    float beta, void* stream) {
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  auto* pc = static_cast<float*>(c);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (pick_mode(a, b, c, M, N, K)) {
    case INTERIOR: return static_cast<int>(launch<INTERIOR>(pa, pb, pc, M, N, K, alpha, beta, s));
    case RAGGED16: return static_cast<int>(launch<RAGGED16>(pa, pb, pc, M, N, K, alpha, beta, s));
    default: return static_cast<int>(launch<RAGGED4>(pa, pb, pc, M, N, K, alpha, beta, s));
  }
}

// The instance the entry above picks for these arguments (0 interior, 1
// ragged with 16-byte copies, 2 ragged with 4-byte copies): lets a check
// show that its sizes reached all three.
extern "C" int tise_epilogue_matmul_mode(const void* a, const void* b, const void* c, int M, int N, int K) {
  return pick_mode(a, b, c, M, N, K);
}
