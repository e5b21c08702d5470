// Paged decode attention for Hopper (sm_90a): one query token per slot over
// its block-table pages plus the not-yet-paged current token.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention -> _kernel, the pl.pallas_call over grid
// (slot, kv_head, kv_block)).
//
// Bound on this card: HBM bytes.  Each decode step reads every live K and
// V row once (B * ctx * K * hd * 2 tensors * 2 bytes in bf16) against G * 2
// flops per element read, far below the ~295 flops/byte at which the
// tensor cores would become the limit.
//
// Design: one CTA per (slot, kv_head) serves all G = H / K query heads of
// that group, so every page is read from HBM once per group, not once per
// query head.  A loop over 64-token tiles of the slot's table replaces the
// Pallas kernel's sequential grid axis; the CTA resolves its own table
// entries (no scalar prefetch) and reads the table width nb at run time,
// so any bucketed table width runs without a rebuild.  Tiles wholly
// outside [first live position, seq_len) are never visited and dead rows
// inside a tile are not loaded.  Staging uses 16-byte loads from all 128
// threads, so a tile's 32 KB (bf16, hd = 128) is in flight at once.  The
// softmax state m, l and acc[G, hd] stays in f32; the current token's
// (k_new, v_new) is folded in last.
//
// Contract kept from the TPU kernel (and kernels/ref.py):
//   * table entries < 0 are clamped to page 0 and NOT masked inside the
//     live range;
//   * live positions: p < seq_len and, with a window, p > seq_len - window;
//   * masked scores are -1e30 and p is re-zeroed under the mask; a slot
//     with seq_len = 0 still gets finite output from the folded-in token;
//   * scale = 1 / sqrt(hd); expf, not __expf, so f32 parity holds.

#include "paged_common.cuh"

namespace {

using namespace paged;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens,
                       const T* __restrict__ k_new, const T* __restrict__ v_new,
                       T* __restrict__ out, int H, int K, int hd, int bt,
                       int nb, int window, float scale) {
  extern __shared__ float4 smem_raw[];
  const Smem s = carve(smem_raw, hd);
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;

  // rows are the G query heads of this kv head
  load_queries<T>(s, hd, G, [&](int r) {
    return q + ((size_t)b * H + (size_t)kvh * G + r) * hd;
  });
  float4 acc[kMaxQuads];
  zero_acc(acc);

  const int L = seq_lens[b];
  const int hi = min(L, nb * bt);                      // past the last live key
  const int lo = window ? max(0, L - window + 1) : 0;  // first live key
  const int* row_tab = block_tables + (size_t)b * nb;

  for (int t0 = (lo / kTile) * kTile; t0 < hi; t0 += kTile) {
    __syncthreads();                     // queries staged / previous tile done
    if (tid < kTile) {
      const int p = t0 + tid;
      long long off = -1;
      if (p >= lo && p < hi) {
        const int blk = p / bt;
        const int page = max(row_tab[blk], 0);         // clamp, never mask
        off = (((long long)page * bt + (p - blk * bt)) * K + kvh) * hd;
      }
      s.rowoff[tid] = off;
    }
    __syncthreads();
    load_tile<T>(s, hd, k_pages, v_pages);
    __syncthreads();
    attend_tile(s, hd, G, scale, acc, [&](int, int t) {
      const int p = t0 + t;
      return p >= lo && p < hi;
    });
  }

  // fold in the current token (pool-written by the caller after the call)
  __syncthreads();
  if (tid < kTile)
    s.rowoff[tid] = tid == 0 ? ((long long)b * K + kvh) * hd : -1;
  __syncthreads();
  load_tile<T>(s, hd, k_new, v_new);
  __syncthreads();
  attend_tile(s, hd, G, scale, acc, [](int, int t) { return t == 0; });

  store_rows<T>(s, hd, G, acc, [&](int r) {
    return out + ((size_t)b * H + (size_t)kvh * G + r) * hd;
  });
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* seq_lens, const void* k_new,
           const void* v_new, void* out, int B, int H, int K, int hd, int bt,
           int nb, int window, float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err =
      allow_max_smem(paged_attention_kernel<T>, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(hd);
  const dim3 grid(K, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(out), H, K, hd, bt, nb,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, const void* k_new,
    const void* v_new, void* out, int B, int H, int K, int hd, int bt, int nb,
    int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, seq_lens, k_new,
                         v_new, out, B, H, K, hd, bt, nb, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, seq_lens,
                                 k_new, v_new, out, B, H, K, hd, bt, nb,
                                 window, scale, st);
  return (int)cudaErrorInvalidValue;
}
