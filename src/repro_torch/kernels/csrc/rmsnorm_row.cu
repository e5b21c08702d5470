// RMSNorm for Hopper (sm_90a), a row's loads in flight at once:
// out = x * rsqrt(mean(x^2) + eps) * (1 + w) per row of D elements,
// computed in f32 and rounded once to x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm -> _kernel,
// the pl.pallas_call over grid (N / bn,) of (bn, D) row tiles).  It takes
// every card call of ops.rmsnorm; csrc/rmsnorm.cu (one warp a row, two
// passes) stays in the library for comparison.
//
// Bound on this card: HBM bytes — x read once and out written once (w is
// D elements, shared by every row); about 4 f32 operations per element.
// At decode (8 rows) the bytes take well under a microsecond, so the time
// is the latency of the row's loads, the reduction and the store.
//
// Design: the old kernel's lane walked its row in D / 256 serial 16-byte
// loads per pass, and its decode time grew with that walk.  Here a row is
// spread over ``tpr`` threads (ops.rmsnorm_row_geometry), each of which
// holds at most K "units" (16-byte vectors, or single elements when D or
// a base does not allow 16-byte loads) of x and the matching units of w
// in registers:
//   * every load of x and w is issued before the first use, so a row costs
//     one round trip to memory, not D / 256;
//   * the row stays in registers: one pass over HBM;
//   * the sum of squares is reduced with shuffles and, for rows wider than
//     a warp, one shared-memory step after which every warp sums the
//     partials itself (no second barrier); then each thread scales and
//     stores its own units;
//   * short rows (tpr <= 32, a power of two) share a CTA, several rows per
//     CTA, reduced with shuffles within their lanes; a wide row has a CTA
//     of its own (tpr a multiple of 32), so prefill's hundreds of rows are
//     hundreds of CTAs;
//   * K = 0 is the fallback for rows of more than 1024 x 2 units: a
//     strided two-pass loop (the second read from L1/L2).
// Rows and units are bound-checked; no thread returns before the
// reduction, so the shuffles see full warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// one unit of T: 16 bytes (kVec) or one element, as floats
template <typename T, bool kVec> struct Unit;
template <typename T> struct Unit<T, false> {
  static constexpr int N = 1;
  using Raw = T;
  static __device__ void unpack(const Raw& r, float* f) { f[0] = to_f32(r); }
  static __device__ void store(Raw* p, const float* f) { from_f32(p, f[0]); }
};
template <> struct Unit<float, true> {
  static constexpr int N = 4;
  using Raw = float4;
  static __device__ void unpack(const Raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ void store(Raw* p, const float* f) {
    *p = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Unit<__nv_bfloat16, true> {
  static constexpr int N = 8;
  using Raw = uint4;
  static __device__ void unpack(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  static __device__ void store(Raw* p, const float* f) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *p = r;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The sum of v over the tpr threads of each row.  tpr <= 32: a butterfly
// within the row's lanes; else the CTA is one row: warp sums, one
// shared-memory step, and every warp sums the partials (the butterfly
// gives every lane the same bits, so every thread scales alike).
__device__ __forceinline__ float row_sum(float v, int tpr) {
  if (tpr <= 32) {
    for (int o = tpr / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  __shared__ float part[kMaxThreads / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x % 32;
  if (lane == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  return warp_sum(lane < (int)blockDim.x / 32 ? part[lane] : 0.f);
}

template <typename T, bool kVec, int K>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_row_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ out, long long N, int D, int tpr,
                   float eps) {
  using U = Unit<T, kVec>;
  using Raw = typename U::Raw;
  const int units = D / U::N;
  const int t = threadIdx.x % tpr;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < N;
  const size_t base = (size_t)(live ? row : 0) * D;
  const Raw* xr = reinterpret_cast<const Raw*>(x + base);
  const Raw* wr = reinterpret_cast<const Raw*>(w);
  Raw* orow = reinterpret_cast<Raw*>(out + base);
  if constexpr (K > 0) {
    Raw xv[K], wv[K];
    bool has[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {       // every load before the first use
      const int u = t + k * tpr;
      has[k] = live && u < units;
      if (has[k]) {
        xv[k] = xr[u];
        wv[k] = wr[u];
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!has[k]) continue;
      float f[U::N];
      U::unpack(xv[k], f);
#pragma unroll
      for (int j = 0; j < U::N; ++j) ss += f[j] * f[j];
    }
    const float inv = rsqrtf(row_sum(ss, tpr) / (float)D + eps);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!has[k]) continue;
      float f[U::N], g[U::N];
      U::unpack(xv[k], f);
      U::unpack(wv[k], g);
#pragma unroll
      for (int j = 0; j < U::N; ++j) f[j] = f[j] * inv * (1.f + g[j]);
      U::store(orow + t + k * tpr, f);
    }
  } else {                              // rows too long for registers
    float ss = 0.f;
    for (int u = t; live && u < units; u += tpr) {
      float f[U::N];
      U::unpack(xr[u], f);
#pragma unroll
      for (int j = 0; j < U::N; ++j) ss += f[j] * f[j];
    }
    const float inv = rsqrtf(row_sum(ss, tpr) / (float)D + eps);
    for (int u = t; live && u < units; u += tpr) {
      float f[U::N], g[U::N];
      U::unpack(xr[u], f);
      U::unpack(wr[u], g);
#pragma unroll
      for (int j = 0; j < U::N; ++j) f[j] = f[j] * inv * (1.f + g[j]);
      U::store(orow + u, f);
    }
  }
}

template <typename T, bool kVec, int K>
int launch_k(const void* x, const void* w, void* out, long long N, int D,
             int tpr, int rows, float eps, cudaStream_t stream) {
  const long long blocks = (N + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rmsnorm_row_kernel<T, kVec, K><<<(unsigned)blocks, tpr * rows, 0,
                                   stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), N, D, tpr, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int launch_vec(const void* x, const void* w, void* out, long long N, int D,
               int per, int tpr, int rows, float eps, cudaStream_t st) {
  switch (per) {
    case 0: return launch_k<T, kVec, 0>(x, w, out, N, D, tpr, rows, eps, st);
    case 1: return launch_k<T, kVec, 1>(x, w, out, N, D, tpr, rows, eps, st);
    case 2: return launch_k<T, kVec, 2>(x, w, out, N, D, tpr, rows, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* x, const void* w, void* out, long long N, int D,
           int vec, int per, int tpr, int rows, float eps, cudaStream_t st) {
  constexpr int kVecN = Unit<T, true>::N;
  if (vec == kVecN) {
    if (D % kVecN || ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16)
      return (int)cudaErrorInvalidValue;
    return launch_vec<T, true>(x, w, out, N, D, per, tpr, rows, eps, st);
  }
  if (vec == 1)
    return launch_vec<T, false>(x, w, out, N, D, per, tpr, rows, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).  x and out
// are N contiguous rows of D elements; N, D > 0.  The geometry comes from
// ops.rmsnorm_row_geometry: ``vec`` elements a unit (16 bytes' worth, or
// 1), ``per`` units a thread held in registers (1 or 2; 0: the strided
// loop), ``tpr`` threads a row (a power of two up to 32, or a multiple of
// 32 with rows == 1) and ``rows`` rows a CTA, tpr * rows threads (a
// multiple of 32, at most 1024); with per > 0, tpr * per units must
// cover the row.  Returns the cudaError_t of the launch.
extern "C" int rmsnorm_row_launch(int dtype, const void* x, const void* w,
                                  void* out, long long N, int D, int vec,
                                  int per, int tpr, int rows, float eps,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = tpr * rows;
  const bool pow2 = tpr > 0 && (tpr & (tpr - 1)) == 0;
  if (N <= 0 || D <= 0 || vec <= 0 || rows <= 0 || tpr <= 0 ||
      threads > kMaxThreads || threads % 32 ||
      (tpr <= 32 ? !pow2 : (tpr % 32 || rows != 1)) ||
      (per > 0 && (long long)tpr * per < (long long)(D / vec)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, w, out, N, D, vec, per, tpr, rows, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, N, D, vec, per, tpr, rows, eps,
                                 st);
  return (int)cudaErrorInvalidValue;
}
