// P6: a chain of dependent bf16 matmuls out of shared memory, on Hopper's
// warpgroup MMA (wgmma, sm_90a).
//
// Replaces the Pallas kernel tools/stem_mm_probe.py::_mm_kernel, which asks
// how fast a chain of dots y = x @ w runs when both operands stay in fast
// on-chip memory, at the Inception stem's narrow output widths: nsteps times
//     y  = x @ w                  bf16 x bf16, f32 accumulate
//     s += y[0, 0]
//     w  = bf16(f32(w) + y[0, 0] * 1e-30)      (a dependency, so no dot is hoisted)
// and returns s.
//
// The TPU kernel holds all of x in its fast memory; an SM has 227 KB of
// shared memory, so here a block owns a strip of 64 rows of x (the m of one
// wgmma) and a slice of nb columns of w (its n: 8, 16 or 32), keeps both
// in shared memory for the whole chain, and runs the nsteps loop on them with
// one warpgroup.  The original's dependency is kept inside each block: after
// every dot the block's slice of w is rewritten as bf16(f32(w) + y[r0, c0] *
// 1e-30), with (r0, c0) the block's first row and column.  Block (0, 0)'s
// running sum of y[0, 0] is the result.
//
// One step of a block:
//   1. wgmma.fence, then kp/16 wgmma.mma_async m64n{nb}k16 (bf16 in, f32
//      accumulators in registers), both operands read from shared memory
//      through matrix descriptors; commit, wait for the group.
//   2. y[r0, c0] is acc[0] of thread 0.  That thread writes it to one shared
//      word; the accumulator itself is never stored (the original discards y
//      too).  Barrier.
//   3. Every thread adds y[r0, c0] to its s and rewrites its share of the w
//      slice (16 bytes an access).  These are generic-proxy stores, and the
//      next step's wgmma reads the slice through the async proxy, so a
//      fence.proxy.async.shared::cta comes between them, then a barrier.
//      Leaving the fence out would go unseen in every check: for the probe's
//      inputs bf16(w + y * 1e-30) == w, so every step computes the same dot
//      whether the rewrite is seen or not.  The fence is written anyway.
// Two barriers a step, not one: the value of step 2 has to reach every
// thread that rewrites w, and every thread's rewrite has to land before the
// next wgmma reads the slice.  A rewrite by warp 0 alone (which holds y[r0,
// c0]) would save the first barrier at the cost of a quarter of the
// instruction rate on the rewrite, which costs more at every shape but conv1a's.
//
// Layout in shared memory: both operands K-major without swizzle, in the
// core matrices a descriptor takes (8 rows x 16 bytes, 128 contiguous
// bytes): element (r, kk) of a [rows][kp] operand at
//     ((r / 8) * (kp / 8) + kk / 8) * 64 + (r % 8) * 8        (bf16 elements)
// so the next core matrix along K is 128 bytes on (the leading byte offset)
// and the next 8 rows are kp * 16 bytes on (the stride byte offset); one k16
// step moves the start address by 256 bytes.  x's strip is stored as it is
// (rows of x are K-major); w's slice transposed, so its columns are rows.
// kp is K rounded up to 16.  Rows beyond m and K beyond k are zero in shared
// memory (the caller's tensors are never padded).  The rewrite makes w's
// padded K rows nonzero (0 + y * 1e-30); that is harmless only because x's
// padded K columns are zero.
//
// So that no MMA is dead code (the asm is volatile, but the sum of a chain
// could still be folded by a caller), every thread folds its acc[0] into a
// checksum each step and writes it to `sink` at the end.  On the last step,
// when `y_out` is given, every thread stores its accumulator fragment, which
// lets a caller hold the whole last dot against a plain product.
//
// What bounds it, per shape (the geometry is chosen by
// tise_tpu_torch/tools/stem_mm_probe.py::stem_geometry):
//   * conv1a (K 27, kp 32): latency.  Two wgmmas a step; the step cannot be
//     shorter than one wgmma group's latency, two barriers and the fence,
//     whatever its 4 ns of work.  A narrower wgmma finishes sooner, and
//     blocks that share an SM overlap their latencies, so at such a k the
//     geometry takes the narrowest nb whose grid still runs in one wave.
//   * conv2a/conv2b (K 288) and the A block and control (K 1152-1200):
//     shared-memory bandwidth, so the geometry picks the nb with which the
//     busiest SM moves the fewest bytes through shared memory a step.  A step of a block reads its x strip (128 * kp
//     bytes) and its w slice (2 * nb * kp) into the tensor cores, and reads
//     and writes the w slice once more in the rewrite (4 * nb * kp), for
//     2 * 64 * nb * kp operations.  At nb = 16 that is 224 bytes for every
//     2,048 FLOP: 1.75 clocks of an SM's shared memory (128 bytes a clock)
//     for every 0.5 clock of its tensor cores (about 4,096 bf16 FLOP a
//     clock at 989 TFLOP/s).  So no shape of this probe can come near the
//     operations bound: the rewrite alone is nb * kp elements of every block
//     every step, and the x strip is read whole for every nb columns.
// Why not the swapped order (y^T = w^T x^T, 64 columns of w as wgmma's m and
// a strip of x rows as its n): then each block rewrites a 64-column slice of
// w every step, 4 * 64 * kp bytes against 4 * nb * kp, and by the same count
// the busiest SM moves 1.35x (control) to 1.86x (A block) the bytes a step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;       // rows of x per block: the m of one wgmma
constexpr int THREADS = 128;   // one warpgroup

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint64_t descriptor(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  // K-major, no swizzle (layout type 0, base offset 0); addresses and offsets in 16-byte units
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous MMAs that own it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] * B[16 x N], A and B K-major in shared memory; `accumulate`
// 0 overwrites d.
template <int N> struct Mma;

template <> struct Mma<8> {
  __device__ static void run(float (&d)[4], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <> struct Mma<16> {
  __device__ static void run(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <> struct Mma<32> {
  __device__ static void run(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// Index (in bf16 elements) of element (r, kk) of a K-major [rows][kp] operand in core matrices.
__device__ __forceinline__ int core_index(int r, int kk, int kc_n) {
  return ((r >> 3) * kc_n + (kk >> 3)) * 64 + (r & 7) * 8 + (kk & 7);
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
stem_mm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, float* __restrict__ s_out,
               float* __restrict__ y_out, float* __restrict__ sink, int m, int k, int n, int kp, int nsteps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);        // [ROWS][kp], core matrices
  bf16* ws = xs + ROWS * kp;                       // [NB][kp], w's slice transposed, core matrices
  float* y00_word = reinterpret_cast<float*>(ws + NB * kp);

  const int r0 = blockIdx.x * ROWS;
  const int c0 = blockIdx.y * NB;
  const int tid = threadIdx.x;
  const int kc_n = kp / 8;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // the x strip, 8 consecutive K elements (one core-matrix row, 16 bytes) a store
  for (int idx = tid; idx < ROWS * kc_n; idx += THREADS) {
    const int r = idx / kc_n, kk0 = (idx % kc_n) * 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (r0 + r < m && kk0 + j < k) ? x[static_cast<int64_t>(r0 + r) * k + kk0 + j] : zero;
    *reinterpret_cast<uint4*>(xs + core_index(r, kk0, kc_n)) = *reinterpret_cast<const uint4*>(v);
  }
  // the w slice, transposed; c fastest, so a warp reads consecutive columns of a row of w
  for (int idx = tid; idx < NB * kc_n; idx += THREADS) {
    const int c = idx % NB, kk0 = (idx / NB) * 8;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (kk0 + j < k) ? w[static_cast<int64_t>(kk0 + j) * n + c0 + c] : zero;
    *reinterpret_cast<uint4*>(ws + core_index(c, kk0, kc_n)) = *reinterpret_cast<const uint4*>(v);
  }
  fence_proxy_async();  // the generic stores above, before the wgmmas read them
  __syncthreads();

  const uint32_t sbo = static_cast<uint32_t>(kp) * 16;
  const uint64_t desc_x = descriptor(xs, 128, sbo);
  const uint64_t desc_w = descriptor(ws, 128, sbo);
  const int kt_n = kp / 16;
  const int n_vec = NB * kp / 8;  // 16-byte words of the w slice
  uint4* ws4 = reinterpret_cast<uint4*>(ws);

  float acc[NB / 2] = {};
  float s = 0.0f;    // the running sum of y[r0, c0]; every thread keeps the same value
  float chk = 0.0f;
  for (int step = 0; step < nsteps; ++step) {
    fence_regs(acc);
    wgmma_fence();
    for (int t = 0; t < kt_n; ++t)  // + 16 descriptor units = 256 bytes = one k16 step
      Mma<NB>::run(acc, desc_x + 16 * t, desc_w + 16 * t, t);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (tid == 0) *y00_word = acc[0];  // y[r0, c0]
    chk += acc[0];
    if (y_out != nullptr && step == nsteps - 1) {
      const int warp = tid / 32, lane = tid % 32;
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) {
        const int r = r0 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
        const int c = c0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        if (r < m) y_out[static_cast<int64_t>(r) * n + c] = acc[i];
      }
    }
    __syncthreads();
    const float y00 = *y00_word;
    s += y00;
    const float d = __fmul_rn(y00, 1e-30f);
    for (int idx = tid; idx < n_vec; idx += THREADS) {
      uint4 v = ws4[idx];
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        p[j] = __floats2bfloat162_rn(__fadd_rn(f.x, d), __fadd_rn(f.y, d));
      }
      ws4[idx] = v;
    }
    fence_proxy_async();  // the rewrite, before the next step's wgmmas read it
    __syncthreads();
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) s_out[0] = s;
  sink[(static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * THREADS + tid] = chk;
}

template <int NB>
int launch(const void* x, const void* w, void* s_out, void* y_out, void* sink, int m, int k, int n, int smem,
           int nsteps, cudaStream_t stream) {
  const int kp = (k + 15) / 16 * 16;
  // the layout of stem_mm_kernel: the x strip, the w slice, the word of y[r0, c0]
  if (smem != (ROWS + NB) * kp * 2 + 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(stem_mm_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + ROWS - 1) / ROWS, n / NB);
  stem_mm_kernel<NB><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<float*>(s_out),
      static_cast<float*>(y_out), static_cast<float*>(sink), m, k, n, kp, nsteps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [m, k] bf16, w [k, n] bf16, both row-major; nb (the wgmma n: 8, 16 or
// 32) divides n.  Block (i, j) owns rows 64i.. of x and columns nb*j.. of w and
// takes smem_bytes of shared memory, which must be (64 + nb) * kp * 2 + 16, kp
// = k rounded up to 16 (the caller's geometry counts it to choose nb; a count
// that differs from this layout's is refused).  s_out [1] f32; y_out [m, n]
// f32 (the last dot) or null; sink [blocks * 128] f32.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int tise_stem_mm(const void* x, const void* w, void* s_out, void* y_out, void* sink, int m, int k, int n,
                            int nb, int smem_bytes, int nsteps, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || nsteps <= 0 || nb <= 0 || n % nb != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 8: return launch<8>(x, w, s_out, y_out, sink, m, k, n, smem_bytes, nsteps, s);
    case 16: return launch<16>(x, w, s_out, y_out, sink, m, k, n, smem_bytes, nsteps, s);
    case 32: return launch<32>(x, w, s_out, y_out, sink, m, k, n, smem_bytes, nsteps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
