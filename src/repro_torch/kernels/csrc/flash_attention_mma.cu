// Causal / sliding-window flash attention on Hopper's tensor cores
// (sm_90a), bf16: the prompt forward's self-attention, q (B, S, H, hd) over
// k, v (B, T, K, hd) with H % K == 0 (GQA), online softmax in f32.  The
// f32 contract stays on the CUDA cores (flash_attention.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _kernel, the pl.pallas_call at :99 over grid
// (B * H, S / block_q, T / block_kv) with kv pre-expanded to H heads).
//
// Bound on this card: bytes.  At the serving shapes a causal call does
// 4 hd flops per live (query, key) pair and head: mistral-nemo's largest
// group call, q (4, 209, 32, 128) over K = 8 kv heads, is ~1.4 GFLOP
// (~1.5 us at 989 TFLOP/s bf16) against 17 MB of q, k, v and out (~5.1 us
// at 3.35 TB/s); zamba2's q (4, 189, 32, 112), K = 32, is ~22 MB (~6.5 us).
//
// What held the CUDA-core kernel back, and what this design does about it:
//   * dot products in f32 FMA -> mma.sync.m16n8k16 bf16 with f32
//     accumulators, S = Q.K^T and O += P.V both on the tensor cores;
//   * K and V widened to f32 in shared memory (~92 KB per CTA at hd 128)
//     -> Q, K and V stay bf16 in shared memory (rows padded by 16 bytes, so
//     every ldmatrix phase reads 8 rows from 8 distinct bank groups);
//   * load, sync, compute with no overlap -> a 2-stage K/V ring filled by
//     16-byte cp.async copies: tile j + 1 is in flight while tile j
//     computes;
//   * softmax through shared memory, a warp per row -> each warp owns 16
//     softmax rows end to end in registers: scale and mask per element,
//     row max and sum across the quad by __shfl_xor_sync, P converted to
//     bf16 in registers and used as the A fragment of P.V directly.
//
// Contract (that of kernels/ref.py::flash_attention):
//   * softmax row r of a CTA is query position (row0 + r) / G, head
//     (row0 + r) % G with G = H / K, so each K/V tile staged in shared
//     memory serves all G query heads of its kv head (no repeat);
//   * key u is live for query c iff u < T, u <= c when causal, and
//     u > c - window with a window; masked scores are -1e30 and their
//     weight is zero; the denominator is clamped at 1e-20;
//   * the weights are rounded to bf16 before P.V, as JAX's gqa_attention
//     rounds them (here the running, not yet normalised weights; the plain
//     version rounds the normalised ones, so the two differ by bf16
//     rounding), and O is divided by the f32 sum at the end;
//   * any S and T: rows past S * G and keys past T are zero-filled in
//     shared memory and masked; any hd that is a multiple of 8 up to 256:
//     the kernel is instantiated for hd rounded up to 16, the columns past
//     hd zero-filled.
//
// Design: one CTA of 4 warps per (64 softmax rows, kv head, batch row),
// the row tiles with the most keys scheduled first.  K/V tiles of 64 keys
// that no row of the CTA can see (past its last row's causal edge, before
// its first row's window floor) are never loaded, as the TPU kernel skips
// them with pl.when; a warp whose 16 rows see none of a staged tile skips
// its arithmetic, and one whose rows all see the whole tile skips the
// per-element mask.  The output is staged through the warp's own Q rows
// in shared memory and written with 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // softmax rows per CTA, 16 per warp
constexpr int kKeys = 64;            // keys per K/V tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kPad = 8;              // bf16 elements of padding per row
constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int row_stride(int hdp) { return hdp + kPad; }

__host__ __device__ constexpr size_t smem_bytes(int hdp) {
  return sizeof(bf16) * (size_t)row_stride(hdp) *
         (kRows + 2 * kStages * kKeys);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without blocking; !valid zero-fills the
// destination and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// d += a.b for one 16 x 8 tile, depth 16: bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// two floats -> one register of two bf16 (lo in the low half), rounded
// to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// HDP: hd rounded up to 16 (the mma depth and the ldmatrix.x4 width).
// Fragment layout of m16n8k16 (lane = 4 * group + quad): an accumulator
// tile holds rows group and group + 8, columns 2 * quad and 2 * quad + 1.
template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           bf16* __restrict__ out, int S, int T, int H,
                           int K, int hd, int causal, int window,
                           float scale_log2) {
  constexpr int RS = row_stride(HDP);   // shared row stride, elements
  constexpr int CH = HDP / 8;           // 16-byte chunks of a padded row
  constexpr int NT = kKeys / 8;         // 8-key column tiles of S
  constexpr int DT = HDP / 8;           // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // [kRows][RS]
  bf16* skv = sq + kRows * RS;          // [stage][k, v][kKeys][RS]

  const int G = H / K;
  const int R = S * G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = lane / 4, quad = lane % 4;
  const int nrows = min(kRows, R - row0);
  const int hc = hd / 8;                // real 16-byte chunks of a row

  // element offset of this CTA's softmax row r in q and out
  auto row_off = [&](int r) {
    const int gr = row0 + r;
    const int c = gr / G;
    return (((size_t)b * S + c) * H + (size_t)kvh * G + (gr - c * G)) * hd;
  };

  // keys some row of the CTA can see: [lo, hi), walked in whole tiles
  const int c_min = row0 / G;
  const int c_max = (row0 + nrows - 1) / G;
  const int hi = causal ? min(c_max + 1, T) : T;
  const int lo = window ? max(0, c_min - window + 1) : 0;
  const int t_first = (lo / kKeys) * kKeys;
  const int n_tiles = hi > t_first ? (hi - t_first + kKeys - 1) / kKeys : 0;

  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, ch = i - r * CH;
    const bool ok = r < nrows && ch < hc;
    cp_async16(smem_u32(sq + r * RS + ch * 8),
               ok ? q + row_off(r) + ch * 8 : q, ok);
  }
  auto load_kv = [&](int stage, int t0) {
    bf16* dk = skv + stage * 2 * kKeys * RS;
    bf16* dv = dk + kKeys * RS;
    for (int i = tid; i < kKeys * CH; i += kThreads) {
      const int t = i / CH, ch = i - t * CH;
      const bool ok = t0 + t < hi && ch < hc;
      const size_t off =
          ok ? (((size_t)b * T + t0 + t) * K + kvh) * hd + ch * 8 : 0;
      cp_async16(smem_u32(dk + t * RS + ch * 8), k + off, ok);
      cp_async16(smem_u32(dv + t * RS + ch * 8), v + off, ok);
    }
  };
  // one group per tile, kStages - 1 ahead; Q rides in the first
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j, t_first + j * kKeys);
    cp_async_commit();
  }

  // this thread's two softmax rows and its warp's span of positions
  const int wr0 = warp * 16;
  const int ca = (row0 + wr0 + group) / G;
  const int cb = (row0 + wr0 + group + 8) / G;
  const bool warp_live = wr0 < nrows;
  const int cw_min = (row0 + wr0) / G;
  const int cw_max = (row0 + min(wr0 + 15, nrows - 1)) / G;

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};      // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's part of the sum

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = t_first + j * kKeys;
    const int ahead = j + kStages - 1;  // refills the stage of tile j - 1
    if (ahead < n_tiles) load_kv(ahead % kStages, t_first + ahead * kKeys);
    cp_async_commit();
    cp_async_wait<kStages - 1>();       // tile j (and Q) landed
    __syncthreads();
    const bool visible = warp_live && (!causal || t0 <= cw_max) &&
                         (!window || t0 + kKeys - 1 > cw_min - window);
    if (visible) {
      const bf16* sk = skv + (j % kStages) * 2 * kKeys * RS;
      const bf16* sv = sk + kKeys * RS;
      // ---- S = Q.K^T (16 rows x 64 keys per warp)
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(sq + (wr0 + (lane & 15)) * RS + kk * 16 +
                                (lane >> 4) * 8));
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          // matrices: keys of tile n at depth +0 / +8, then of tile n + 1
          uint32_t bk[4];
          const int mat = lane >> 3;
          ldmatrix_x4(bk, smem_u32(sk + (n * 8 + (mat >> 1) * 8 + (lane & 7)) * RS +
                                   kk * 16 + (mat & 1) * 8));
          mma_bf16(s[n], a, bk[0], bk[1]);
          mma_bf16(s[n + 1], a, bk[2], bk[3]);
        }
      }
      // ---- scale, and mask per element unless every row of the warp
      // sees the whole tile; row max across the quad
      const bool full = t0 + kKeys <= T &&
                        (!causal || t0 + kKeys - 1 <= cw_min) &&
                        (!window || t0 > cw_max - window);
      uint32_t live_bits = 0xffffffffu;
      float mx[2] = {kNegInf, kNegInf};
      if (full) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] *= scale_log2;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = t0 + n * 8 + quad * 2 + (e & 1);
            const int c = e < 2 ? ca : cb;
            const bool live = u < T && (!causal || u <= c) &&
                              (!window || u > c - window);
            s[n][e] = live ? s[n][e] * scale_log2 : kNegInf;
            if (!live) live_bits &= ~(1u << (n * 4 + e));
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= alpha[0]; o[d][1] *= alpha[0];
        o[d][2] *= alpha[1]; o[d][3] *= alpha[1];
      }
      // ---- P (f32 -> bf16 in registers) as the A fragments of P.V
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = (live_bits >> (n * 4 + e)) & 1u
                     ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
          l[e >> 1] += p[e];
        }
        pa[n / 2][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      // ---- O += P.V (16 rows x HDP per warp), V^T fragments by
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          // matrices: keys +0 / +8 of column tile d, then of tile d + 1
          uint32_t bv[4];
          const int mat = lane >> 3;
          ldmatrix_x4_trans(bv, smem_u32(sv + (kk * 16 + (mat & 1) * 8 +
                                               (lane & 7)) * RS +
                                         d * 8 + (mat >> 1) * 8));
          mma_bf16(o[d], pa[kk], bv[0], bv[1]);
          mma_bf16(o[d + 1], pa[kk], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                    // the stage may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();                      // Q's copies landed everywhere

  // ---- out = O / max(l, 1e-20), staged in the warp's own Q rows
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / fmaxf(quad_sum(l[h]), 1e-20f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    bf16* dst = sq + (wr0 + group) * RS + d * 8 + quad * 2;
    *reinterpret_cast<uint32_t*>(dst) =
        pack_bf16(o[d][0] * inv[0], o[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(dst + 8 * RS) =
        pack_bf16(o[d][2] * inv[1], o[d][3] * inv[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * hc; i += 32) {
    const int r = wr0 + i / hc, ch = i % hc;
    if (r < nrows)
      *reinterpret_cast<uint4*>(out + row_off(r) + ch * 8) =
          *reinterpret_cast<const uint4*>(sq + r * RS + ch * 8);
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T, int H, int K, int hd, int causal, int window,
           float scale, cudaStream_t stream) {
  // raise the dynamic shared-memory limit once per device
  // (cudaFuncSetAttribute is kept off the per-launch path); one bit per
  // device
  static std::atomic<unsigned long long> allowed{0};
  const size_t smem = smem_bytes(HDP);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(flash_attention_mma_kernel<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(bit, std::memory_order_release);
  }
  const int R = S * (H / K);
  const dim3 grid((R + kRows - 1) / kRows, K, B);
  flash_attention_mma_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, T, H, K, hd,
      causal, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only.  q/out (B, S, H, hd), k/v (B, T, K, hd), all contiguous and
// 16-byte aligned; B, S, T > 0, H % K == 0, hd % 8 == 0, hd <= 256.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_mma_launch(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int S, int T, int H, int K,
                                          int hd, int causal, int window,
                                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K || hd <= 0 || hd % 8 ||
      hd > kMaxHd || B > 65535 || K > 65535)
    return (int)cudaErrorInvalidValue;
  switch ((hd + 15) / 16) {
#define FLASH_MMA_CASE(n)                                                  \
  case n:                                                                  \
    return launch<16 * n>(q, k, v, out, B, S, T, H, K, hd, causal, window, \
                          scale, st);
    FLASH_MMA_CASE(1) FLASH_MMA_CASE(2) FLASH_MMA_CASE(3) FLASH_MMA_CASE(4)
    FLASH_MMA_CASE(5) FLASH_MMA_CASE(6) FLASH_MMA_CASE(7) FLASH_MMA_CASE(8)
    FLASH_MMA_CASE(9) FLASH_MMA_CASE(10) FLASH_MMA_CASE(11)
    FLASH_MMA_CASE(12) FLASH_MMA_CASE(13) FLASH_MMA_CASE(14)
    FLASH_MMA_CASE(15) FLASH_MMA_CASE(16)
#undef FLASH_MMA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
