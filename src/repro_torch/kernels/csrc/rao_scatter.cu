// RAO scatter-add (the paper's fetch-and-add over rows) for Hopper
// (sm_90a): table[idx[m], :] += vals[m, :] for m in [0, M), with duplicate
// indices, in place.  On the MoE path this is the gated combine: every
// dispatch row's expert output lands on its token's row, and all padding
// rows land on the one pad row N - 1.
//
// Replaces the TPU kernel src/repro/kernels/rao_scatter.py
// (rao_scatter_add -> _kernel, the pl.pallas_call over grid (M / bm,) with
// the table aliased in and out).
//
// Bound on this card: HBM bytes — vals (M x D) is read once and the table
// (N x D) read and written once, for one add per value read.
//
// Design:
//   * the TPU has no atomics and serialises duplicates through its
//     sequential grid; here CTAs run in parallel, so a duplicate row is
//     resolved with f32 atomicAdd in the L2;
//   * one CTA per (32 consecutive updates, 128 columns), one column per
//     thread: each thread walks its 32 updates in order and sums runs of
//     equal row ids in a register, issuing one atomic per run.  Runs are
//     long exactly where contention is worst — MoE dispatch padding all
//     targets the pad row, the CENTRAL pattern every row — so a hot row
//     takes M / 32 atomics per column, not M;
//   * sums are f32 whatever the table's type: an f32 table takes the
//     atomics directly; a bf16 table is widened into an f32 scratch of
//     the same shape (allocated by the caller), accumulated there, and
//     rounded back once, so a row's sum is rounded once rather than at
//     every add;
//   * row ids outside [0, N) are dropped, as XLA's scatter drops them.
// The order of the f32 adds into a row depends on the order in which CTAs
// reach the L2, so the last bits of a row's sum can differ from run to
// run (and from the plain version), within f32 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // updates per CTA
constexpr int kThreads = 128;  // columns per CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(float* __restrict__ acc, const int* __restrict__ idx,
                   const V* __restrict__ vals, int N, int M, int D) {
  __shared__ int rows[kRows];
  const int m0 = blockIdx.x * kRows;
  const int n = min(kRows, M - m0);
  if (threadIdx.x < n) rows[threadIdx.x] = idx[m0 + threadIdx.x];
  __syncthreads();
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (col >= D) return;
  const V* v = vals + (size_t)m0 * D + col;
  int cur = rows[0];
  float sum = 0.f;
  for (int r = 0; r < n; ++r) {
    const int row = rows[r];
    if (row != cur) {
      if (cur >= 0 && cur < N) atomicAdd(&acc[(size_t)cur * D + col], sum);
      cur = row;
      sum = 0.f;
    }
    sum += to_f32(v[(size_t)r * D]);
  }
  if (cur >= 0 && cur < N) atomicAdd(&acc[(size_t)cur * D + col], sum);
}

__global__ void widen_kernel(const __nv_bfloat16* __restrict__ src,
                             float* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __bfloat162float(src[i]);
}

__global__ void narrow_kernel(const float* __restrict__ src,
                              __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

template <typename V>
int scatter(float* acc, const void* idx, const void* vals, int N, int M,
            int D, cudaStream_t stream) {
  const dim3 grid((M + kRows - 1) / kRows, (D + kThreads - 1) / kThreads);
  scatter_add_kernel<V><<<grid, kThreads, 0, stream>>>(
      acc, static_cast<const int*>(idx), static_cast<const V*>(vals), N, M,
      D);
  return (int)cudaGetLastError();
}

int elementwise_grid(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (int)(blocks < 4096 ? blocks : 4096);
}

}  // namespace

// dtype: 0 = float32 (table updated by the atomics directly), 1 = bfloat16
// (scratch: an f32 buffer of N * D elements).  table and vals share the
// dtype; idx is int32.  Every dimension must be > 0 (the wrapper returns
// the table itself otherwise).  Returns the first cudaError_t of the
// launches.
extern "C" int rao_scatter_add_launch(int dtype, void* table, const void* idx,
                                      const void* vals, void* scratch, int N,
                                      int M, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || M <= 0 || D <= 0 || (D + kThreads - 1) / kThreads > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return scatter<float>(static_cast<float*>(table), idx, vals, N, M, D, st);
  if (dtype != 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)N * D;
  float* acc = static_cast<float*>(scratch);
  auto* tb = static_cast<__nv_bfloat16*>(table);
  widen_kernel<<<elementwise_grid(n), 256, 0, st>>>(tb, acc, n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = scatter<__nv_bfloat16>(acc, idx, vals, N, M, D, st);
  if (err) return err;
  narrow_kernel<<<elementwise_grid(n), 256, 0, st>>>(acc, tb, n);
  return (int)cudaGetLastError();
}
