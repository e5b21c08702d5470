// Grouped expert matmul (the MoE FFN) for Hopper (sm_90a):
// out[e] = xe[e] @ w[e] for every expert e, xe (E, C, D), w (E, D, F),
// out (E, C, F), accumulated in f32 and stored in the input dtype.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py (moe_gmm -> _kernel,
// the pl.pallas_call over grid (E, C/bc, F/bf, D/bd)).
//
// Bound on this card: at decode (C = 8 rows per expert) HBM bytes — every
// call streams one projection's weights (E * D * F elements) for 2 * C
// flops per weight element; in a full prefill chunk (C = 512) the same
// weights meet 2 * E * C * D * F flops, close to the balance point of
// the bf16 tensor cores.
//
// Design (a first, simple kernel; TMA staging and wgmma are later work):
//   * one CTA per (F tile of 64, C tile of BM, expert); BM = 16 for the
//     decode-sized C <= 16, else 64, so a decode call does not run 56 idle
//     rows per tile;
//   * a loop over D tiles replaces the Pallas kernel's sequential D grid
//     axis and its VMEM accumulator: each tile of xe and w is staged in
//     shared memory while the next one is loaded into registers;
//   * bf16 (the serving dtype) multiplies on the tensor cores through
//     WMMA 16x16x16 fragments (mma.sync underneath) with f32
//     accumulators, 4 warps per CTA, 16-byte loads when D and F are
//     multiples of 8; the f32 tile goes through shared memory to a
//     bound-checked bf16 store;
//   * f32 runs on the CUDA cores with f32 FMA (no TF32), each thread
//     keeping a (BM / 16) x 4 block of sums in registers, so f32 results
//     match an f32 matmul to rounding;
//   * ragged C, D and F are bound-checked (zero-filled on load, masked on
//     store) instead of padded to the block and sliced back as on the TPU.
// Every row of xe is computed, including the zero rows of dropless
// dispatch padding, exactly as the reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ bf16
constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcBN = 64;        // output columns (F) per CTA
constexpr int kTcBK = 64;        // contraction (D) per staged tile
constexpr int kTcPad = 8;        // bf16 elements of row padding in smem

// Eight consecutive bf16 values of one row (a "chunk"), zero past the end
// of the row or of the matrix.  Vec: the row length is a multiple of 8 and
// the base 16-byte aligned, so a chunk is wholly in or out of range.
template <bool Vec>
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* row,
                                            int col, int ncols, bool live) {
  if (Vec) {
    if (live && col < ncols) return *reinterpret_cast<const uint4*>(row + col);
    return make_uint4(0, 0, 0, 0);
  }
  union {
    uint4 u;
    unsigned short s[8];   // bf16 bit patterns; 0 is +0.0
  } v;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v.s[i] = (live && col + i < ncols) ? __bfloat16_as_ushort(row[col + i])
                                       : (unsigned short)0;
  return v.u;
}

template <int BM, bool Vec>
__global__ void __launch_bounds__(kTcThreads)
moe_gmm_bf16_kernel(const __nv_bfloat16* __restrict__ xe,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  using namespace nvcuda;
  constexpr int kLdA = kTcBK + kTcPad, kLdB = kTcBN + kTcPad;
  constexpr int kLdC = kTcBN + 4;
  // warp tiles: BM = 64 -> 2 x 2 warps of 32 x 32; BM = 16 -> 1 x 4 of 16
  constexpr int kWM = BM == 64 ? 32 : 16, kWN = BM == 64 ? 32 : 16;
  constexpr int kFM = kWM / 16, kFN = kWN / 16;
  constexpr int kWarpsN = kTcBN / kWN;
  constexpr int kAChunks = BM * kTcBK / 8, kBChunks = kTcBK * kTcBN / 8;
  constexpr int kAPer = (kAChunks + kTcThreads - 1) / kTcThreads;
  constexpr int kBPer = kBChunks / kTcThreads;
  __shared__ __align__(32) __nv_bfloat16 As[BM * kLdA];
  __shared__ __align__(32) __nv_bfloat16 Bs[kTcBK * kLdB];
  __shared__ __align__(32) float Cs[BM * kLdC];

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * kTcBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const __nv_bfloat16* xb = xe + (size_t)e * C * D;
  const __nv_bfloat16* wb = w + (size_t)e * D * F;

  uint4 ra[kAPer], rb[kBPer];
  // A chunk i: row i / (kTcBK / 8), columns (i % (kTcBK / 8)) * 8 + [0, 8);
  // B chunk i: row i / (kTcBN / 8), columns (i % (kTcBN / 8)) * 8 + [0, 8)
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int i = tid + j * kTcThreads;
      const int c = c0 + i / (kTcBK / 8), k = k0 + (i % (kTcBK / 8)) * 8;
      ra[j] = load_chunk<Vec>(xb + (size_t)c * D, k, D,
                              i < kAChunks && c < C);
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int i = tid + j * kTcThreads;
      const int k = k0 + i / (kTcBN / 8), f = f0 + (i % (kTcBN / 8)) * 8;
      rb[j] = load_chunk<Vec>(wb + (size_t)k * F, f, F, k < D);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int k0 = 0; k0 < D; k0 += kTcBK) {
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int i = tid + j * kTcThreads;
      if (i < kAChunks)
        *reinterpret_cast<uint4*>(
            &As[(i / (kTcBK / 8)) * kLdA + (i % (kTcBK / 8)) * 8]) = ra[j];
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int i = tid + j * kTcThreads;
      *reinterpret_cast<uint4*>(
          &Bs[(i / (kTcBN / 8)) * kLdB + (i % (kTcBN / 8)) * 8]) = rb[j];
    }
    __syncthreads();
    if (k0 + kTcBK < D) load(k0 + kTcBK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * kWM + i * 16) * kLdA + kk],
                               kLdA);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * kLdB + wn * kWN + j * 16],
                               kLdB);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
      wmma::store_matrix_sync(
          &Cs[(wm * kWM + i * 16) * kLdC + wn * kWN + j * 16], acc[i][j],
          kLdC, wmma::mem_row_major);
  __syncthreads();
  __nv_bfloat16* ob = out + (size_t)e * C * F;
  for (int i = tid; i < BM * kTcBN; i += kTcThreads) {
    const int c = c0 + i / kTcBN, f = f0 + i % kTcBN;
    if (c < C && f < F)
      ob[(size_t)c * F + f] = __float2bfloat16(Cs[(i / kTcBN) * kLdC +
                                                   i % kTcBN]);
  }
}

// ------------------------------------------------------------------- f32
constexpr int kThreads = 256;
constexpr int kBN = 64;   // output columns (F) per CTA
constexpr int kBK = 32;   // contraction (D) per staged tile
constexpr int kTN = 4;    // output columns per thread

template <int BM>
__global__ void __launch_bounds__(kThreads)
moe_gmm_f32_kernel(const float* __restrict__ xe, const float* __restrict__ w,
                   float* __restrict__ out, int C, int D, int F) {
  constexpr int kTM = BM / 16;                       // rows per thread
  constexpr int kAPer = BM * kBK / kThreads;         // A elements per thread
  constexpr int kBPer = kBK * kBN / kThreads;        // B elements per thread
  __shared__ float As[BM][kBK + 1];     // +1: the two row groups of a warp
                                        // read distinct banks
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BM;
  const int f0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;                 // row group: rows ty * kTM + i
  const int tx = tid % 16;                 // column group: cols tx * 4 + j
  const float* xb = xe + (size_t)e * C * D;
  const float* wb = w + (size_t)e * D * F;

  float ra[kAPer], rb[kBPer];
  // element i of a tile: A row i / kBK, col i % kBK (a warp reads one row's
  // 32 consecutive D values); B row i / kBN, col i % kBN (a warp reads 32
  // consecutive F values)
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int i = tid + j * kThreads;
      const int c = c0 + i / kBK, k = k0 + i % kBK;
      ra[j] = (c < C && k < D) ? xb[(size_t)c * D + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int i = tid + j * kThreads;
      const int k = k0 + i / kBN, f = f0 + i % kBN;
      rb[j] = (k < D && f < F) ? wb[(size_t)k * F + f] : 0.f;
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int i = tid + j * kThreads;
      As[i / kBK][i % kBK] = ra[j];
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int i = tid + j * kThreads;
      Bs[i / kBN][i % kBN] = rb[j];
    }
    __syncthreads();
    if (k0 + kBK < D) load(k0 + kBK);      // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * kTN]);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float a = As[ty * kTM + i][k];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  float* ob = out + (size_t)e * C * F;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int c = c0 + ty * kTM + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int f = f0 + tx * kTN + j;
      if (f < F) ob[(size_t)c * F + f] = acc[i][j];
    }
  }
}

template <int BM>
int launch_f32(const void* xe, const void* w, void* out, int E, int C, int D,
               int F, cudaStream_t stream) {
  const dim3 grid((F + kBN - 1) / kBN, (C + BM - 1) / BM, E);
  moe_gmm_f32_kernel<BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(xe), static_cast<const float*>(w),
      static_cast<float*>(out), C, D, F);
  return (int)cudaGetLastError();
}

template <int BM, bool Vec>
int launch_bf16(const void* xe, const void* w, void* out, int E, int C,
                int D, int F, cudaStream_t stream) {
  const dim3 grid((F + kTcBN - 1) / kTcBN, (C + BM - 1) / BM, E);
  moe_gmm_bf16_kernel<BM, Vec><<<grid, kTcThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(xe),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), C, D, F);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_bf16_for(const void* xe, const void* w, void* out, int E, int C,
                    int D, int F, cudaStream_t stream) {
  const bool vec = D % 8 == 0 && F % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(xe) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec) return launch_bf16<BM, true>(xe, w, out, E, C, D, F, stream);
  return launch_bf16<BM, false>(xe, w, out, E, C, D, F, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Every dimension must be > 0 (the
// wrapper returns the empty result itself).  Returns the cudaError_t of
// the launch.
extern "C" int moe_gmm_launch(int dtype, const void* xe, const void* w,
                              void* out, int E, int C, int D, int F,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return C <= 16 ? launch_f32<16>(xe, w, out, E, C, D, F, st)
                   : launch_f32<64>(xe, w, out, E, C, D, F, st);
  if (dtype == 1)
    return C <= 16 ? launch_bf16_for<16>(xe, w, out, E, C, D, F, st)
                   : launch_bf16_for<64>(xe, w, out, E, C, D, F, st);
  return (int)cudaErrorInvalidValue;
}
