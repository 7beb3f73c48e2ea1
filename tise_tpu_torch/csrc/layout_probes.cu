// P1-P5: the layout probes for Hopper (sm_90a).
//
// They replace the five Pallas kernels of tools/mosaic_probe.py (lane_split,
// dma_minor27, strided_slice, lane_concat, scratch_stage), which ask whether
// the layouts a fused Inception stem needs can be expressed inside a kernel:
// a minor dimension split into triples, blocks whose minor dimension is 27,
// a stride-2 slice, a concat of a tile with its transpose, and staging through
// on-chip scratch at 32-element offsets.  Each kernel here computes what its
// TPU kernel computes, at the same shape and type (f32), the way the layout
// would be used on this card: through shared memory, with the global accesses
// coalesced.
//
// What bounds them: bytes, and at these sizes (2 KB to 160 KB) the launch
// itself.  Each input element is read from global memory once and each output
// element written once.
//
// Every kernel's arithmetic is exact or in a fixed order (__fadd_rn /
// __fmul_rn, no contraction), so the results are bit-equal to the plain
// PyTorch versions wherever those add in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// P1 lane_split: x [R, 3G] -> out [R, G], out[r, g] = (x[r,3g] + x[r,3g+1]) + x[r,3g+2].
// One block per row.  The row (3G floats, 3G % 4 == 0 so it starts 16-byte
// aligned) is staged in shared memory with coalesced 16-byte loads; thread g
// then sums its triple from shared memory at stride 3, which is free of bank
// conflicts (3 is coprime with the 32 banks).
// ---------------------------------------------------------------------------
constexpr int P1_THREADS = 256;

__global__ void __launch_bounds__(P1_THREADS)
lane_split_kernel(const float* __restrict__ x, float* __restrict__ out, int G) {
  extern __shared__ __align__(16) float row_s[];
  const int r = blockIdx.x;
  const int n4 = (3 * G) / 4;
  const float4* src = reinterpret_cast<const float4*>(x + (int64_t)r * 3 * G);
  float4* dst = reinterpret_cast<float4*>(row_s);
  for (int i = threadIdx.x; i < n4; i += P1_THREADS) dst[i] = src[i];
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += P1_THREADS)
    out[(int64_t)r * G + g] = __fadd_rn(__fadd_rn(row_s[3 * g], row_s[3 * g + 1]), row_s[3 * g + 2]);
}

// ---------------------------------------------------------------------------
// P2 dma_minor27: x [B, R, M] -> out = 2x, moved in blocks of [BB, R, M]
// (BB = 2, R = 128, M = 27 in the probe) through shared memory.  A row of 27
// floats is 108 bytes and is not 16-byte aligned, but a whole block is one
// contiguous run of BB*R*M floats whose start IS 16-byte aligned when
// BB*R*M % 4 == 0 (the wrapper checks it), so the block moves between global
// and shared memory with 16-byte accesses over the flat run; the staging
// keeps the unpadded [BB*R][M] layout, and the compute step addresses it by
// (row, column) with 4-byte accesses, as a consumer of 27-wide patch rows
// would (column stride 27 is coprime with the 32 banks).
// ---------------------------------------------------------------------------
constexpr int P2_THREADS = 256;

__global__ void __launch_bounds__(P2_THREADS)
dma_minor27_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int M) {
  extern __shared__ __align__(16) float blk_s[];  // [rows][M], rows = BB * R
  const int n = rows * M;
  const int64_t base = (int64_t)blockIdx.x * n;
  const float4* src = reinterpret_cast<const float4*>(x + base);
  float4* stage = reinterpret_cast<float4*>(blk_s);
  for (int i = threadIdx.x; i < n / 4; i += P2_THREADS) stage[i] = src[i];
  __syncthreads();
  // one thread per row walks its 27 columns: the (row, column) view of the block
  for (int row = threadIdx.x; row < rows; row += P2_THREADS)
    for (int c = 0; c < M; ++c) blk_s[row * M + c] = __fmul_rn(blk_s[row * M + c], 2.0f);
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out + base);
  for (int i = threadIdx.x; i < n / 4; i += P2_THREADS) dst[i] = stage[i];
}

// ---------------------------------------------------------------------------
// P3 strided_slice: x [R, 2C] -> out [R, C], out[r, c] = x[r, 2c].
// Each thread reads one aligned 8-byte pair (so the reads stay coalesced) and
// keeps its even element.
// ---------------------------------------------------------------------------
constexpr int P3_THREADS = 128;

__global__ void __launch_bounds__(P3_THREADS)
strided_slice_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n_out) {
  const int64_t i = (int64_t)blockIdx.x * P3_THREADS + threadIdx.x;
  if (i < n_out) out[i] = reinterpret_cast<const float2*>(x)[i].x;  // row r, col c <-> flat pair r*C + c
}

// ---------------------------------------------------------------------------
// P4 lane_concat: x [N, N] -> out [N, 2N], out[:, :N] = 2x, out[:, N:] = x^T.
// 32x32 tiles, 32x8 threads.  A block reads its tile once (coalesced rows),
// writes 2x straight to the left half, and writes the tile transposed through
// shared memory padded to 33 columns (no bank conflicts on the column reads)
// into the right half, again as coalesced rows.
// ---------------------------------------------------------------------------
constexpr int P4_TILE = 32;
constexpr int P4_ROWS = 8;

__global__ void __launch_bounds__(P4_TILE * P4_ROWS)
lane_concat_kernel(const float* __restrict__ x, float* __restrict__ out, int N) {
  __shared__ float tile[P4_TILE][P4_TILE + 1];
  const int c0 = blockIdx.x * P4_TILE, r0 = blockIdx.y * P4_TILE;
  const int tx = threadIdx.x;
  for (int ty = threadIdx.y; ty < P4_TILE; ty += P4_ROWS) {
    const int r = r0 + ty, c = c0 + tx;
    if (r < N && c < N) {
      const float v = x[(int64_t)r * N + c];
      tile[ty][tx] = v;
      out[(int64_t)r * 2 * N + c] = __fmul_rn(v, 2.0f);
    }
  }
  __syncthreads();
  for (int ty = threadIdx.y; ty < P4_TILE; ty += P4_ROWS) {
    const int r = c0 + ty, c = r0 + tx;  // the transposed tile's place: row from the tile's columns
    if (r < N && c < N) out[(int64_t)r * 2 * N + N + c] = tile[tx][ty];
  }
}

// ---------------------------------------------------------------------------
// P5 scratch_stage: x [R, 64] -> out, out[:, :32] = 2 x[:, :32], out[:, 32:] = 3 x[:, 32:],
// staged through a shared-memory scratch of 8 rows: the two halves are stored
// into the scratch at offsets 0 and 32 in two separate steps, and the scratch
// is then copied out whole.  One block per 8 rows, one warp per half row.
// ---------------------------------------------------------------------------
constexpr int P5_ROWS = 8;
constexpr int P5_W = 64;

__global__ void __launch_bounds__(P5_ROWS * P5_W)
scratch_stage_kernel(const float* __restrict__ x, float* __restrict__ out, int R) {
  __shared__ float scratch[P5_ROWS][P5_W];
  const int col = threadIdx.x % P5_W, row = threadIdx.x / P5_W;
  const int r = blockIdx.x * P5_ROWS + row;
  const bool live = r < R;
  const float v = live ? x[(int64_t)r * P5_W + col] : 0.0f;
  if (col < 32) scratch[row][0 + col] = __fmul_rn(v, 2.0f);
  __syncthreads();
  if (col >= 32) scratch[row][32 + (col - 32)] = __fmul_rn(v, 3.0f);
  __syncthreads();
  if (live) out[(int64_t)r * P5_W + col] = scratch[row][col];
}

}  // namespace

// Every entry launches on `stream` and returns cudaGetLastError().

extern "C" int tise_probe_lane_split(const void* x, void* out, int R, int G, void* stream) {
  if ((3 * G) % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  lane_split_kernel<<<R, P1_THREADS, 3 * G * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), G);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tise_probe_dma_minor27(const void* x, void* out, int B, int BB, int R, int M, void* stream) {
  const int n = BB * R * M;
  if (B % BB != 0 || n % 4 != 0 || n * sizeof(float) > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  dma_minor27_kernel<<<B / BB, P2_THREADS, n * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), BB * R, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tise_probe_strided_slice(const void* x, void* out, int R, int C, void* stream) {
  const int64_t n_out = (int64_t)R * C;
  const unsigned blocks = static_cast<unsigned>((n_out + P3_THREADS - 1) / P3_THREADS);
  strided_slice_kernel<<<blocks, P3_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tise_probe_lane_concat(const void* x, void* out, int N, void* stream) {
  const unsigned t = (N + P4_TILE - 1) / P4_TILE;
  lane_concat_kernel<<<dim3(t, t), dim3(P4_TILE, P4_ROWS), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tise_probe_scratch_stage(const void* x, void* out, int R, void* stream) {
  scratch_stage_kernel<<<(R + P5_ROWS - 1) / P5_ROWS, P5_ROWS * P5_W, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), R);
  return static_cast<int>(cudaGetLastError());
}
