// RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * (1 + w)
// per row of D elements, computed in f32 and rounded once to x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm -> _kernel,
// the pl.pallas_call over grid (N / bn,) of (bn, D) row tiles).
//
// Bound on this card: HBM bytes — x read once and out written once (w is
// D elements, shared by every row); about 3 flops per element.
//
// Design: the TPU kernel normalises a (bn, D) tile in VMEM and needs
// N % bn == 0.  Here one warp owns one row (4 rows per 128-thread CTA, any
// N): pass 1 sums x^2 in f32 over the row with 16-byte loads and a
// shuffle reduction, pass 2 reads the row again (from L1/L2, not HBM: a
// row is at most a few tens of KB) with w and writes the result.  No
// shared memory and no __syncthreads; rows and columns are bound-checked,
// and rows whose length or base pointers do not allow 16-byte loads take
// the scalar path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerCta = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of T as floats
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  using Raw = float4;
  static __device__ void unpack(const Raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  static __device__ Raw pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Pack<__nv_bfloat16> {
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
  static __device__ Raw pack(const float* f) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return r;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, long long N, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kRowsPerCta + threadIdx.x / 32;
  if (row >= N) return;
  const T* xr = x + row * D;
  T* orow = out + row * D;
  using P = Pack<T>;
  float ss = 0.f;
  if (kVec) {
    const typename P::Raw* xv = reinterpret_cast<const typename P::Raw*>(xr);
    for (int i = lane; i < D / P::N; i += 32) {
      float f[P::N];
      P::unpack(xv[i], f);
#pragma unroll
      for (int j = 0; j < P::N; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / (float)D + eps);
  if (kVec) {
    const typename P::Raw* xv = reinterpret_cast<const typename P::Raw*>(xr);
    const typename P::Raw* wv = reinterpret_cast<const typename P::Raw*>(w);
    typename P::Raw* ov = reinterpret_cast<typename P::Raw*>(orow);
    for (int i = lane; i < D / P::N; i += 32) {
      float f[P::N], g[P::N];
      P::unpack(xv[i], f);
      P::unpack(wv[i], g);
#pragma unroll
      for (int j = 0; j < P::N; ++j) f[j] = f[j] * inv * (1.f + g[j]);
      ov[i] = P::pack(f);
    }
  } else {
    for (int i = lane; i < D; i += 32)
      from_f32(orow + i, to_f32(xr[i]) * inv * (1.f + to_f32(w[i])));
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, long long N, int D,
           float eps, cudaStream_t stream) {
  constexpr int kVecN = Pack<T>::N;
  const bool vec = D % kVecN == 0 &&
                   ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 == 0;
  const long long blocks = (N + kRowsPerCta - 1) / kRowsPerCta;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if (vec)
    rmsnorm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), N, D, eps);
  else
    rmsnorm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), N, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it).  x and out
// are N contiguous rows of D elements; N, D > 0.  Returns the
// cudaError_t of the launch.
extern "C" int rmsnorm_launch(int dtype, const void* x, const void* w,
                              void* out, long long N, int D, float eps,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, w, out, N, D, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, N, D, eps, st);
  return (int)cudaErrorInvalidValue;
}
