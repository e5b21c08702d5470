// Shared tile machinery of the two paged attention kernels
// (paged_attention.cu, paged_prefill_attention.cu).
//
// A CTA owns up to kRows softmax rows (query heads of one kv head, times
// chunk positions for prefill) and walks the keys in tiles of kTile
// tokens.  Per tile:
//   1. threads t < kTile resolve key row t to an element offset (or -1:
//      dead, zero-filled) — the page lookup happens once per row;
//   2. all threads stage K and V rows into shared memory as f32 with
//      16-byte loads (row stride hd + 4 floats, so the score phase's
//      float4 reads of 8 consecutive rows hit 32 distinct banks);
//   3. scores: thread (t, row group) holds kRows / kGroups row
//      accumulators in registers and reads each K float4 once;
//   4. online softmax: one warp per row, f32 running max m and sum l,
//      masked scores -1e30 and p re-zeroed under the mask;
//   5. P.V: each thread owns fixed (row, 4 columns) quads of the f32
//      accumulator, kept in registers across tiles.
// The key-side mask is a functor ``live(row, t)`` supplied per kernel, so
// the decode and prefill contracts stay separate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace paged {

constexpr int kThreads = 128;                  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                      // keys per tile
constexpr int kRows = 32;                      // softmax rows per CTA
constexpr int kGroups = kThreads / kTile;      // row groups in the score phase
constexpr int kRowsPerThread = kRows / kGroups;
constexpr int kMaxHd = 256;
constexpr int kMaxQuads = kRows * kMaxHd / 4 / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16-byte vector width in elements
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

// 16 bytes at src (16-byte aligned) -> Vec<T>::N floats at dst
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Shared-memory carve-up (all f32 except the row offsets).
struct Smem {
  float* q;          // [kRows][hd]
  float* k;          // [kTile][hd + 4]
  float* v;          // [kTile][hd + 4]
  float* p;          // [kRows][kTile]  scores, then probabilities
  float* m;          // [kRows] running max
  float* l;          // [kRows] running sum
  float* alpha;      // [kRows] this tile's rescale factor
  long long* rowoff; // [kTile] element offset of key row t, -1 = dead
};

__host__ __device__ inline int kv_stride(int hd) { return hd + 4; }

__host__ __device__ inline size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)kRows * hd + 2 * (size_t)kTile * kv_stride(hd)
                          + (size_t)kRows * kTile + 3 * kRows)
         + sizeof(long long) * kTile;
}

// Raise ``kernel``'s dynamic shared-memory limit to what the largest
// supported hd needs, once per device.  cudaFuncSetAttribute is a driver
// call and the decode tick is host-bound, so it is kept off the per-launch
// path; ``done`` holds one bit per device and is one per kernel
// instantiation.  A higher limit than a launch uses costs it nothing.
template <typename Kernel>
inline cudaError_t allow_max_smem(Kernel kernel,
                                  std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxHd));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

__device__ inline Smem carve(void* base, int hd) {
  Smem s;
  float* f = reinterpret_cast<float*>(base);
  s.q = f;                 f += kRows * hd;
  s.k = f;                 f += kTile * kv_stride(hd);
  s.v = f;                 f += kTile * kv_stride(hd);
  s.p = f;                 f += kRows * kTile;
  s.m = f;                 f += kRows;
  s.l = f;                 f += kRows;
  s.alpha = f;             f += kRows;
  // 3 * kRows floats keep f 8-byte aligned for the offsets
  s.rowoff = reinterpret_cast<long long*>(f);
  return s;
}

// Stage ``nrows`` query rows (f32) and reset the softmax state.  row_ptr(r)
// gives the first element of row r in global memory.
template <typename T, typename RowPtr>
__device__ void load_queries(const Smem& s, int hd, int nrows, RowPtr row_ptr) {
  const int nv = hd / Vec<T>::N;
  for (int i = threadIdx.x; i < nrows * nv; i += kThreads) {
    const int r = i / nv;
    const int c = (i - r * nv) * Vec<T>::N;
    load16(row_ptr(r) + c, s.q + r * hd + c);
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    s.m[r] = kNegInf;
    s.l[r] = 0.f;
  }
}

// Stage the K/V rows named by s.rowoff (relative to kbase/vbase); dead rows
// are zero-filled so that p = 0 never meets uninitialised memory.
template <typename T>
__device__ void load_tile(const Smem& s, int hd, const T* kbase, const T* vbase) {
  const int nv = hd / Vec<T>::N;
  const int ks = kv_stride(hd);
  for (int i = threadIdx.x; i < kTile * nv; i += kThreads) {
    const int t = i / nv;
    const int c = (i - t * nv) * Vec<T>::N;
    float* kd = s.k + t * ks + c;
    float* vd = s.v + t * ks + c;
    const long long off = s.rowoff[t];
    if (off >= 0) {
      load16(kbase + off + c, kd);
      load16(vbase + off + c, vd);
    } else {
#pragma unroll
      for (int j = 0; j < Vec<T>::N; ++j) { kd[j] = 0.f; vd[j] = 0.f; }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One tile of online softmax over the staged keys.  Entry: s.rowoff and the
// K/V tile are staged and a __syncthreads() has passed.  Exit: all threads
// are past a __syncthreads(), so the caller may restage.
template <typename Live>
__device__ __forceinline__ void attend_tile(const Smem& s, int hd, int nrows, float scale,
                            float4 (&acc)[kMaxQuads], Live live) {
  const int tid = threadIdx.x;
  const int ks = kv_stride(hd);
  // ---- scores: thread (t, group) over rows group*kRowsPerThread + i
  {
    const int t = tid % kTile;
    const int r0 = (tid / kTile) * kRowsPerThread;
    float sc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) sc[i] = 0.f;
    const float* krow = s.k + t * ks;
    for (int d = 0; d < hd; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (r0 + i < nrows) {
          const float4 qv = *reinterpret_cast<const float4*>(s.q + (r0 + i) * hd + d);
          sc[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + i;
      if (r < nrows) s.p[r * kTile + t] = live(r, t) ? sc[i] * scale : kNegInf;
    }
  }
  __syncthreads();
  // ---- online softmax: warp per row, lanes over the tile's keys
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < nrows; r += kWarps) {
      float* pr = s.p + r * kTile;
      float tmax = kNegInf;
      for (int t = lane; t < kTile; t += 32) tmax = fmaxf(tmax, pr[t]);
      tmax = warp_max(tmax);
      const float m_prev = s.m[r];
      const float m_new = fmaxf(m_prev, tmax);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = live(r, t) ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        s.alpha[r] = a;
        s.l[r] = s.l[r] * a + sum;
        s.m[r] = m_new;
      }
    }
  }
  __syncthreads();
  // ---- P.V into the register accumulator quads
  {
    const int nq = hd / 4;
#pragma unroll
    for (int j = 0; j < kMaxQuads; ++j) {
      const int qi = tid + j * kThreads;
      if (qi < nrows * nq) {
        const int r = qi / nq;
        const int d = (qi - r * nq) * 4;
        const float a = s.alpha[r];
        float4 o = acc[j];
        o.x *= a; o.y *= a; o.z *= a; o.w *= a;
        const float* pr = s.p + r * kTile;
        for (int t = 0; t < kTile; ++t) {
          const float p = pr[t];
          const float4 vv = *reinterpret_cast<const float4*>(s.v + t * ks + d);
          o.x += p * vv.x; o.y += p * vv.y; o.z += p * vv.z; o.w += p * vv.w;
        }
        acc[j] = o;
      }
    }
  }
  __syncthreads();
}

// out = acc / l, cast to T.  row_ptr(r) gives the output row in global memory.
template <typename T, typename RowPtr>
__device__ __forceinline__ void store_rows(const Smem& s, int hd, int nrows,
                           const float4 (&acc)[kMaxQuads], RowPtr row_ptr) {
  const int nq = hd / 4;
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) {
    const int qi = threadIdx.x + j * kThreads;
    if (qi < nrows * nq) {
      const int r = qi / nq;
      const int d = (qi - r * nq) * 4;
      const float l = s.l[r];
      T* o = row_ptr(r) + d;
      store_from_float(o + 0, acc[j].x / l);
      store_from_float(o + 1, acc[j].y / l);
      store_from_float(o + 2, acc[j].z / l);
      store_from_float(o + 3, acc[j].w / l);
    }
  }
}

__device__ __forceinline__ void zero_acc(float4 (&acc)[kMaxQuads]) {
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace paged
