// Causal / sliding-window flash attention for Hopper (sm_90a): the prompt
// forward's self-attention, q (B, S, H, hd) over k, v (B, T, K, hd) with
// H % K == 0 (GQA), online softmax in f32.
// It now serves f32 only (TF32-free parity on the CUDA cores); bf16 runs on
// the tensor cores in flash_attention_mma.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _kernel, the pl.pallas_call over grid
// (B * H, S / block_q, T / block_kv) with kv pre-expanded to H heads by
// repro/kernels/ops.py).
//
// Bound on this card: at the serving shapes (S <= 300, G = H / K in
// {3, 4}, hd in {64, 128}) a causal call does 2 * S^2 * H * hd flops
// over (2 S H + 2 S K) * hd elements.  In f32 the CUDA cores' 67 TFLOP/s
// make the arithmetic, not the bytes, its limit; TF32 tensor cores would
// lose the 1e-4 parity the f32 contract holds.
//
// Design (the tile machinery of paged_common.cuh):
//   * the TPU kernel reads kv heads repeated G times; here one CTA per
//     (32-row tile, kv head, batch row) serves all G query heads of its kv
//     head — softmax row r is query position (row0 + r) / G, head
//     (row0 + r) % G — so each K/V tile staged in shared memory is read
//     once for G heads, straight from the K kv heads (no repeat);
//   * the TPU grid walks kv blocks in order and carries (m, l, acc) in
//     VMEM scratch; here each CTA loops over its own 64-key tiles, the
//     running max and sum in shared memory, the accumulator in registers;
//   * kv tiles no row of the CTA can see (past the last row's causal edge,
//     before the first row's window floor) are never visited, as the TPU
//     kernel skips them with pl.when; keys past T and the causal edge
//     inside the diagonal tile are masked per (row, key), so any S and T
//     work (no block multiple);
//   * masks from absolute positions: key u is live for query c iff u < T,
//     u <= c when causal, and u > c - window with a window; masked scores
//     are -1e30, p is re-zeroed under the mask, the denominator is clamped
//     at 1e-20;
//   * scale = 1 / sqrt(hd); expf, not __expf, and plain f32 FMA (no TF32),
//     so f32 parity with the plain version holds.

#include "paged_common.cuh"

namespace {

using namespace paged;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int T_len, int H, int K, int hd, int causal,
                       int window, float scale) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, hd);
  const int row0 = blockIdx.x * kRows;   // first softmax row of this CTA
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int R = S * G;
  const int nrows = min(kRows, R - row0);
  const int tid = threadIdx.x;

  auto row_elem = [&](int r) {
    const int gr = row0 + r;
    const int c = gr / G;
    const int g = gr - c * G;
    return (((size_t)b * S + c) * H + (size_t)kvh * G + g) * hd;
  };
  auto row_c = [&](int r) { return (row0 + r) / G; };
  load_queries<T>(s, hd, nrows, [&](int r) { return q + row_elem(r); });
  float4 acc[kMaxQuads];
  zero_acc(acc);

  const int c_min = row_c(0);
  const int c_max = row_c(nrows - 1);
  const int hi = causal ? min(c_max + 1, T_len) : T_len;
  // the earliest row has the leftmost window floor
  const int lo = window ? max(0, c_min - window + 1) : 0;

  for (int t0 = (lo / kTile) * kTile; t0 < hi; t0 += kTile) {
    __syncthreads();
    if (tid < kTile) {
      const int u = t0 + tid;
      s.rowoff[tid] = (u >= lo && u < hi)
                          ? (((long long)b * T_len + u) * K + kvh) * hd
                          : -1;
    }
    __syncthreads();
    load_tile<T>(s, hd, k, v);
    __syncthreads();
    attend_tile(s, hd, nrows, scale, acc, [&](int r, int t) {
      const int u = t0 + t;
      const int c = row_c(r);
      return s.rowoff[t] >= 0 && (!causal || u <= c) &&
             (!window || u > c - window);
    });
  }

  store_rows<T>(s, hd, nrows, acc, [&](int r) { return out + row_elem(r); });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int H, int K, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err =
      allow_max_smem(flash_attention_kernel<T>, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(hd);
  const int R = S * (H / K);
  const dim3 grid((R + kRows - 1) / kRows, K, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, K, hd,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 only.  q/out (B, S, H, hd), k/v (B, T, K, hd), all contiguous;
// B, S, T > 0, H % K == 0, hd % 8 == 0, hd <= 256.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T, int H, int K, int hd, int causal,
                                      int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K || hd % 8 ||
      hd > paged::kMaxHd || B > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  return launch<float>(q, k, v, out, B, S, T, H, K, hd, causal, window,
                       scale, static_cast<cudaStream_t>(stream));
}
