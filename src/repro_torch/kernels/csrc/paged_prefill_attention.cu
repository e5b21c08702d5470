// Chunked-prefill paged attention for Hopper (sm_90a): one C-token prompt
// chunk per slot over its partial paged context plus the chunk's own keys
// under an in-chunk causal (and window) mask.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill_attention.py
// (paged_prefill_attention -> _kernel, the pl.pallas_call over grid
// (slot, kv_head, kv_block)).
//
// Bound on this card: at the serving shapes (C = 64, G = 4, hd = 128) a
// chunk does 4 * R * hd flops (R = C * G = 256 softmax rows) per K/V row
// of 4 * hd bytes it reads: about 256 flops per byte in bf16, just below
// the tensor cores' ~295 flops/byte, so the floor is HBM bytes.  This
// kernel computes on the CUDA cores in f32, which makes its arithmetic,
// not the bytes, its limit today (tensor cores via wgmma are a later
// change).
//
// Design: the softmax has R = C * G rows (256 at C = 64, G = 4).  A
// [256, 128] f32 accumulator does not fit one CTA, so rows are tiled: one
// CTA per (slot, kv_head, 32-row tile), each walking all of the slot's
// live pages in 64-token tiles and then the chunk's own keys.  Within a
// tile every K float4 read from shared memory feeds 16 row accumulators
// in registers, and each thread keeps its (row, 4-column) quads of the
// output accumulator in registers across tiles.  Page tiles that no row
// of the CTA can see (past ctx_len, before the earliest row's window
// floor) are never visited; rows with a released (< 0) table entry are
// not loaded.
//
// Contract kept from the TPU kernel (and kernels/ref.py) — deliberately
// not the decode kernel's:
//   * table entries < 0 are MASKED (window-released blocks);
//   * page position p is live for chunk row c iff p < ctx_len, its entry is
//     >= 0 and, with a window, p > ctx_len + c - window (per row);
//   * chunk key u is live for row c iff u <= c and, with a window,
//     u > c - window; the diagonal keeps every row finite, pad rows
//     included;
//   * masked scores are -1e30 and p is re-zeroed under the mask;
//   * scale = 1 / sqrt(hd); expf, not __expf, so f32 parity holds.

#include "paged_common.cuh"

namespace {

using namespace paged;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ ctx_lens, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* __restrict__ out, int C, int H, int K,
    int hd, int bt, int nb, int window, float scale) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, hd);
  const int row0 = blockIdx.x * kRows;   // first softmax row of this CTA
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int R = C * G;
  const int nrows = min(kRows, R - row0);
  const int tid = threadIdx.x;

  // softmax row r -> chunk position c = (row0 + r) / G, head g = (row0 + r) % G
  auto row_elem = [&](int r) {
    const int gr = row0 + r;
    const int c = gr / G;
    const int g = gr - c * G;
    return (((size_t)b * C + c) * H + (size_t)kvh * G + g) * hd;
  };
  auto row_c = [&](int r) { return (row0 + r) / G; };
  load_queries<T>(s, hd, nrows, [&](int r) { return q + row_elem(r); });
  float4 acc[kMaxQuads];
  zero_acc(acc);

  const int L0 = ctx_lens[b];
  const int c_min = row_c(0);
  const int c_max = row_c(nrows - 1);
  const int hi = min(L0, nb * bt);
  // the earliest row has the leftmost window floor
  const int lo = window ? max(0, L0 + c_min - window + 1) : 0;
  const int* row_tab = block_tables + (size_t)b * nb;

  for (int t0 = (lo / kTile) * kTile; t0 < hi; t0 += kTile) {
    __syncthreads();
    if (tid < kTile) {
      const int p = t0 + tid;
      long long off = -1;
      if (p >= lo && p < hi) {
        const int blk = p / bt;
        const int page = row_tab[blk];
        if (page >= 0)                                  // released: masked
          off = (((long long)page * bt + (p - blk * bt)) * K + kvh) * hd;
      }
      s.rowoff[tid] = off;
    }
    __syncthreads();
    load_tile<T>(s, hd, k_pages, v_pages);
    __syncthreads();
    attend_tile(s, hd, nrows, scale, acc, [&](int r, int t) {
      return s.rowoff[t] >= 0 && (!window || t0 + t > L0 + row_c(r) - window);
    });
  }

  // the chunk's own keys (pool-written by the caller after the call)
  const int u_lo = window ? max(0, c_min - window + 1) : 0;
  for (int u0 = (u_lo / kTile) * kTile; u0 <= c_max && u0 < C; u0 += kTile) {
    __syncthreads();
    if (tid < kTile) {
      const int u = u0 + tid;
      s.rowoff[tid] = (u >= u_lo && u <= c_max && u < C)
                          ? (((long long)b * C + u) * K + kvh) * hd
                          : -1;
    }
    __syncthreads();
    load_tile<T>(s, hd, k_new, v_new);
    __syncthreads();
    attend_tile(s, hd, nrows, scale, acc, [&](int r, int t) {
      const int u = u0 + t;
      const int c = row_c(r);
      return u < C && u <= c && (!window || u > c - window);
    });
  }

  store_rows<T>(s, hd, nrows, acc, [&](int r) { return out + row_elem(r); });
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* ctx_lens, const void* k_new,
           const void* v_new, void* out, int B, int C, int H, int K, int hd,
           int bt, int nb, int window, float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err =
      allow_max_smem(paged_prefill_attention_kernel<T>, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(hd);
  const int R = C * (H / K);
  const dim3 grid((R + kRows - 1) / kRows, K, B);
  paged_prefill_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(ctx_lens), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(out), C, H, K, hd, bt, nb,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int paged_prefill_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* ctx_lens, const void* k_new,
    const void* v_new, void* out, int B, int C, int H, int K, int hd, int bt,
    int nb, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, ctx_lens, k_new,
                         v_new, out, B, C, H, K, hd, bt, nb, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, ctx_lens,
                                 k_new, v_new, out, B, C, H, K, hd, bt, nb,
                                 window, scale, st);
  return (int)cudaErrorInvalidValue;
}
