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
// ideal is one read and one write of each element.  The design reads each
// input element from device memory once:
//   * A block owns a band of rows of one image, a run of columns (the whole
//     width wherever it fits, else a chunk of it) and a slice of channel
//     vectors.  Its threads are (column, channel vector) pairs; the channel
//     vector is the fastest index, so the NHWC accesses are coalesced, and
//     each access is 16 bytes (4 f32 or 8 bf16) in the vector instance, one
//     element in the scalar instance (C not a multiple of the vector width,
//     or an unaligned pointer).
//   * Each thread walks down its column, keeping rows h-1, h and h+1 in
//     registers with the next two rows' loads in flight.  For each row it
//     writes the vertical sum times invh[h] into a shared-memory row buffer
//     (double-buffered, so one barrier a row), then sums columns w-1, w, w+1
//     of that buffer times invw[w] and stores the output row.
//   * The two columns beside the block's run are computed by two extra
//     thread columns and not stored (zero outside the image), so a chunked
//     row reads its one-column halo and a full row reads nothing twice.  A
//     band re-reads only its two halo rows.
// The wrapper (ops/fast_pool.py::pool_geometry) chooses the instance, the
// channel slice, the column chunks and the bands, and passes them here.
//
// The backward (the pool's adjoint, applied to the incoming gradient g) is a
// mode of the same kernel.  With count_include_pad the weights are the
// constant 1/3 and the stencil is symmetric, so the pool is its own adjoint
// and the wrapper launches the forward mode on g.  Without it, the weight of
// a tap belongs to the output position:
//   dx[h, w] = sum over (h', w') in the 3x3 neighbourhood of invh[h'] * invw[w'] * g[h', w'],
// so the adjoint mode takes each tap's weight at the neighbour instead of
// the centre: the vertical sum weighs rows h-1, h, h+1 by their own invh,
// each column multiplies its vertical sum by its own invw before the row
// buffer, and the horizontal sum adds the three columns unweighted.  Same
// bytes, same grid, same bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_SHARED = 48 * 1024;

// VEC consecutive channels of one pixel: the raw type moved in one access,
// and its conversion to and from f32.
template <typename T, int VEC> struct Pack;

template <> struct Pack<float, 4> {
  using Raw = float4;
  __device__ static Raw zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static void unpack(const Raw& r, float* f) { f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w; }
  __device__ static Raw pack(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
};

template <> struct Pack<float, 1> {
  using Raw = float;
  __device__ static Raw zero() { return 0.0f; }
  __device__ static void unpack(const Raw& r, float* f) { f[0] = r; }
  __device__ static Raw pack(const float* f) { return f[0]; }
};

template <> struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static float2 pair(uint32_t u) {
    __nv_bfloat162 b;
    *reinterpret_cast<uint32_t*>(&b) = u;
    return __bfloat1622float2(b);
  }
  __device__ static uint32_t word(float lo, float hi) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);  // round to nearest even, as .to(bfloat16)
    return *reinterpret_cast<const uint32_t*>(&b);
  }
  __device__ static void unpack(const Raw& r, float* f) {
    float2 p;
    p = pair(r.x); f[0] = p.x; f[1] = p.y;
    p = pair(r.y); f[2] = p.x; f[3] = p.y;
    p = pair(r.z); f[4] = p.x; f[5] = p.y;
    p = pair(r.w); f[6] = p.x; f[7] = p.y;
  }
  __device__ static Raw pack(const float* f) {
    return make_uint4(word(f[0], f[1]), word(f[2], f[3]), word(f[4], f[5]), word(f[6], f[7]));
  }
};

template <> struct Pack<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ static Raw zero() { return __float2bfloat16_rn(0.0f); }
  __device__ static void unpack(const Raw& r, float* f) { f[0] = __bfloat162float(r); }
  __device__ static Raw pack(const float* f) { return __float2bfloat16_rn(f[0]); }
};

// _edge_inv(n, include_pad)[i]
__device__ __forceinline__ float edge_inv(int i, int n, bool include_pad) {
  if (include_pad) return 1.0f / 3.0f;
  if (n == 1) return 1.0f;
  if (i == 0 || i == n - 1) return 0.5f;
  return 1.0f / 3.0f;
}

// The row buffer holds f32 vertical sums; a thread's VEC values are stored as
// VEC / G groups of G (float4 groups where VEC is a multiple of 4), group-major,
// so that the threads of a warp touch consecutive 16-byte (or 4-byte) words.
template <int VEC> struct RowBuffer {
  static constexpr int G = VEC % 4 == 0 ? 4 : 1;
  static constexpr int NG = VEC / G;
  float* base;
  int plane;  // words of one group plane: (columns) x (channel vectors)

  __device__ void put(int slot, const float* v) const {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if constexpr (G == 4)
        reinterpret_cast<float4*>(base)[g * plane + slot] = make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
      else
        base[g * plane + slot] = v[g];
    }
  }
  __device__ void get(int slot, float* v) const {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if constexpr (G == 4) {
        const float4 q = reinterpret_cast<const float4*>(base)[g * plane + slot];
        v[4 * g] = q.x; v[4 * g + 1] = q.y; v[4 * g + 2] = q.z; v[4 * g + 3] = q.w;
      } else {
        v[g] = base[g * plane + slot];
      }
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
avg_pool3x3_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C, int cvb,
                   int chunk_w, int n_chunks, int band_h, bool include_pad, bool adjoint) {
  using P = Pack<T, VEC>;
  using Raw = typename P::Raw;
  extern __shared__ __align__(16) float row_s[];  // two buffers of (chunk_w + 2) x cvb x VEC f32

  const int cols = chunk_w + 2;
  const int cv = threadIdx.x % cvb;  // channel vector within the slice
  const int j = threadIdx.x / cvb;   // column within the run; 0 and cols - 1 are the halo
  const int chunk = blockIdx.y % n_chunks, band = blockIdx.y / n_chunks;
  const int w = chunk * chunk_w - 1 + j;
  const int c = (blockIdx.x * cvb + cv) * VEC;
  const int h0 = band * band_h, h1 = min(H, h0 + band_h);
  const bool live = w >= 0 && w < W && c < C;
  const bool stores = live && j >= 1 && j <= chunk_w;
  const int64_t row = (int64_t)W * C;
  const int64_t at = (int64_t)blockIdx.z * H * row + (live ? (int64_t)w * C + c : 0);
  const Raw* src = reinterpret_cast<const Raw*>(x + at);
  Raw* dst = reinterpret_cast<Raw*>(out + at);
  const int64_t step = row / VEC;  // one image row, in Raw units
  const float invw = live ? edge_inv(w, W, include_pad) : 0.0f;

  // rows outside the image are the zero padding; rows past h1 are not needed
  auto load = [&](int h) -> Raw { return (live && h >= 0 && h <= h1 && h < H) ? src[h * step] : P::zero(); };

  const int plane = cols * cvb;
  const int slot = j * cvb + cv;

  float a[VEC], b[VEC], n[VEC];  // rows h - 1, h, h + 1
  P::unpack(load(h0 - 1), a);
  P::unpack(load(h0), b);
  P::unpack(load(h0 + 1), n);
  Raw ahead = load(h0 + 2);

  for (int h = h0, parity = 0; h < h1; ++h, parity ^= 1) {
    const Raw further = load(h + 3);
    float v[VEC];
    if (adjoint) {
      // each row's own weight (rows outside the image hold zeros: weight 0)
      const float ia = h >= 1 ? edge_inv(h - 1, H, include_pad) : 0.0f;
      const float ib = edge_inv(h, H, include_pad);
      const float ic = h + 1 < H ? edge_inv(h + 1, H, include_pad) : 0.0f;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        v[k] = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(a[k], ia), __fmul_rn(b[k], ib)), __fmul_rn(n[k], ic)), invw);
    } else {
      const float invh = edge_inv(h, H, include_pad);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = __fmul_rn(__fadd_rn(__fadd_rn(a[k], b[k]), n[k]), invh);
    }
    const RowBuffer<VEC> buf{row_s + parity * plane * VEC, plane};
    buf.put(slot, v);
    __syncthreads();
    if (stores) {
      float l[VEC], r[VEC], o[VEC];
      buf.get(slot - cvb, l);
      buf.get(slot + cvb, r);
      if (adjoint) {  // the columns' weights were taken before the buffer
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = __fadd_rn(__fadd_rn(l[k], v[k]), r[k]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = __fmul_rn(__fadd_rn(__fadd_rn(l[k], v[k]), r[k]), invw);
      }
      dst[h * step] = P::pack(o);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) { a[k] = b[k]; b[k] = n[k]; }
    P::unpack(ahead, n);
    ahead = further;
  }
}

template <typename T, int VEC>
int launch(const void* x, void* out, int B, int H, int W, int C, int cvb, int chunk_w, int n_chunks, int band_h,
           int n_bands, bool include_pad, bool adjoint, cudaStream_t s) {
  const int threads = (chunk_w + 2) * cvb;
  const size_t shared = 2 * (size_t)threads * VEC * sizeof(float);
  const int slices = (C / VEC + cvb - 1) / cvb;
  if (C % VEC != 0 || threads > MAX_THREADS || shared > MAX_SHARED || (int64_t)chunk_w * n_chunks < W ||
      (int64_t)band_h * n_bands < H || (int64_t)n_chunks * n_bands > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  avg_pool3x3_kernel<T, VEC><<<dim3(slices, n_chunks * n_bands, B), threads, shared, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, C, cvb, chunk_w, n_chunks, band_h, include_pad, adjoint);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  adjoint: 0 for the pool, 1 for its
// adjoint (the backward's mode above; x is then the incoming gradient and
// out the gradient of the pool's input).  vec: channels a thread moves in one
// access (4 for f32 or 8 for bf16: 16 bytes; or 1).  cvb: channel vectors per
// block.  The grid is (ceil(C / vec / cvb), n_chunks * n_bands, B) blocks of
// (chunk_w + 2) * cvb threads.  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry it cannot run.
extern "C" int tise_avg_pool3x3_s1_p1(const void* x, void* out, int B, int H, int W, int C, int dtype,
                                      int include_pad, int adjoint, int vec, int cvb, int chunk_w, int n_chunks,
                                      int band_h, int n_bands, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pad = include_pad != 0, adj = adjoint != 0;
  if (cvb < 1 || chunk_w < 1 || n_chunks < 1 || band_h < 1 || n_bands < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && vec == 4) return launch<float, 4>(x, out, B, H, W, C, cvb, chunk_w, n_chunks, band_h, n_bands, pad, adj, s);
  if (dtype == 0 && vec == 1) return launch<float, 1>(x, out, B, H, W, C, cvb, chunk_w, n_chunks, band_h, n_bands, pad, adj, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, out, B, H, W, C, cvb, chunk_w, n_chunks, band_h, n_bands, pad, adj, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, out, B, H, W, C, cvb, chunk_w, n_chunks, band_h, n_bands, pad, adj, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
