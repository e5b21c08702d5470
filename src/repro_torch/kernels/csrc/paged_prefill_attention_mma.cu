// Chunked-prefill paged attention on Hopper's tensor cores (sm_90a), bf16:
// one C-token prompt chunk per slot over its partial paged context plus
// the chunk's own keys under an in-chunk causal (and window) mask.  The
// f32 contract stays on the CUDA cores (paged_prefill_attention.cu).
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill_attention.py
// (paged_prefill_attention -> _kernel, the pl.pallas_call at :157 over
// grid (slot, kv_head, kv_block)).
//
// Bound on this card: bytes.  A chunk does 4 hd flops per live (row, key)
// pair, with R = C * G softmax rows per kv head (256 at C 64, G 4): about
// 256 flops per K/V byte in bf16, under the tensor cores' ~295 flops per
// byte.  Mistral-nemo's chunk tick, q (8, 64, 32, 128) over 128 tokens of
// context, is 13.6 MB (4.1 us at 3.35 TB/s) and 1.08 GFLOP (1.1 us at
// 989 TFLOP/s), so the page gather and the bytes set the floor.
//
// What held the CUDA-core kernel back, and what this design does about it
// (it is built on the tile machinery of flash_attention_mma.cu):
//   * dot products in f32 FMA -> mma.sync.m16n8k16 bf16 with f32
//     accumulators, S = Q.K^T and O += P.V both on the tensor cores;
//   * K and V widened to f32 in shared memory (~93 KB per CTA at hd 128)
//     -> Q, K and V stay bf16 in shared memory, rows padded by 16 bytes so
//     every ldmatrix phase reads 8 rows from 8 distinct bank groups;
//   * load, sync, compute with no overlap -> a 2-stage K/V ring filled by
//     16-byte cp.async copies: tile j + 1 is in flight while tile j
//     computes (a third stage gained nothing at the serving shapes);
//   * softmax through shared memory, a warp per row -> each warp owns 16
//     softmax rows end to end in registers (row max and sum across the
//     quad by __shfl_xor_sync);
//   * 32 softmax rows per CTA, so at C 64, G 4 every K/V tile was staged
//     by 8 CTAs -> 8 warps, 128 rows per CTA: 2 CTAs per (slot, kv head)
//     at the serving shapes, 128 CTAs for the 132 SMs (4 warps of 16 rows
//     were as fast or, with a deeper ring, slower on the card).
// From hd 224 up a warp's O accumulator (hd / 2 registers) and the split
// weights no longer fit 255 registers, so two warps share 16 rows: both
// compute S and the softmax, each owns half of O's columns (64 rows per
// CTA).
//
// Paged K/V tiles.  A tile is 64 consecutive key positions.  Its rows
// are resolved once, before the tile is loaded, into a ring of row
// indices in shared memory (a page row, a chunk row, or -1: dead and
// zero-filled) with a 64-bit live mask beside them; the copies then read
// the page arena row by row.  One kv head's rows of the arena are
// 2 K hd bytes apart and a page holds bt of them, so no TMA box covers a
// tile (Hopper's TMA has no row gather): cp.async is the tool.  Any bt
// works, 64 or not.  After the paged tiles come the chunk's own keys from
// k_new / v_new.  Tiles no row of the CTA can see (past ctx_len, before
// its earliest row's window floor, chunk keys past its last row) are
// never loaded; a warp whose 16 rows see none of a staged tile skips its
// arithmetic, and one whose rows see all of it skips the per-element mask.
//
// f32 softmax weights.  The paged contract, as the Pallas kernel (its
// dot_general over the f32 p) and JAX's oracle (kernels/ref.py:80) keep
// it, multiplies V by f32 weights.  The tensor cores take bf16 operands,
// so P is split into a bf16 high part and the bf16 rounding of what
// remains, p = hi + lo to within 2^-18 p, and P.V runs as two mma per
// tile: V is bf16, so every product is exact in f32.  P is never rounded
// to bf16 as a whole.
//
// Contract (that of kernels/ref.py::paged_prefill_attention):
//   * softmax row r of a CTA is chunk position (row0 + r) / G, head
//     (row0 + r) % G with G = H / K, so each staged K/V tile serves all G
//     query heads of its kv head;
//   * table entries < 0 are MASKED (window-released blocks): the prefill
//     contract, not the decode one;
//   * page position p is live for chunk row c iff p < ctx_len, its entry
//     is >= 0 and, with a window, p > ctx_len + c - window; chunk key u
//     is live iff u <= c and, with a window, u > c - window, so the
//     diagonal keeps every row finite;
//   * masked scores are -1e30 and their weight is zero; the output is
//     O / max(l, 1e-20) with l the f32 sum of the f32 weights;
//   * any C >= 1, any G, any hd that is a multiple of 8 up to 256: the
//     kernel is instantiated for hd rounded up to 16, the columns past hd
//     zero-filled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;            // keys per K/V tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kSlots = kStages + 1;  // row-index ring depth
constexpr int kPad = 8;              // bf16 elements of padding per row
constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// HDP: hd rounded up to 16 (the mma depth and the ldmatrix.x4 width)
template <int HDP>
struct Shape {
  static constexpr int kSplit = HDP >= 224 ? 2 : 1;  // warps per 16 rows
  static constexpr int kRows = 16 * kWarps / kSplit; // softmax rows per CTA
  static constexpr int DT = HDP / 8;   // 8-wide column tiles of O
  // column tiles a warp owns (even: ldmatrix.x4 reads two at a time)
  static constexpr int DTW = (DT / kSplit + 1) / 2 * 2;
  static constexpr int RS = HDP + kPad;        // shared row stride
  // Q, the K/V ring, the row indices and the live masks
  static constexpr size_t smem =
      sizeof(bf16) * (size_t)RS * (kRows + 2 * kStages * kKeys) +
      sizeof(int) * kSlots * kKeys + sizeof(uint32_t) * kSlots * 2;
};

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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// two f32 weights -> their bf16 high parts (hi, one register, lo weight
// in the low half) and the bf16 rounding of what remains (lo)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - f.x, b - f.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layout of m16n8k16 (lane = 4 * group + quad): an accumulator
// tile holds rows group and group + 8, columns 2 * quad and 2 * quad + 1.
template <int HDP>
__global__ void __launch_bounds__(kThreads)
paged_prefill_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ ctx_lens, const bf16* __restrict__ k_new,
    const bf16* __restrict__ v_new, bf16* __restrict__ out, int C, int H,
    int K, int hd, int bt, int nb, int window, float scale_log2) {
  constexpr int kSplit = Shape<HDP>::kSplit;
  constexpr int kRows = Shape<HDP>::kRows;
  constexpr int DT = Shape<HDP>::DT;
  constexpr int DTW = Shape<HDP>::DTW;
  constexpr int RS = Shape<HDP>::RS;
  constexpr int CH = HDP / 8;           // 16-byte chunks of a padded row
  constexpr int NT = kKeys / 8;         // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // [kRows][RS]
  bf16* skv = sq + kRows * RS;          // [stage][k, v][kKeys][RS]
  int* srow = reinterpret_cast<int*>(skv + kStages * 2 * kKeys * RS);
  //                                       [slot][kKeys] row index or -1
  uint32_t* slive = reinterpret_cast<uint32_t*>(srow + kSlots * kKeys);
  //                                       [slot][2] live mask of a tile

  const int G = H / K;
  const int R = C * G;
  // the row tiles with the most chunk keys first
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
    return (((size_t)b * C + c) * H + (size_t)kvh * G + (gr - c * G)) * hd;
  };

  // keys some row of the CTA can see, walked in whole tiles: page
  // positions [lo, hi), then chunk keys [u_lo, u_hi)
  const int c_min = row0 / G;
  const int c_max = (row0 + nrows - 1) / G;
  const int L0 = ctx_lens[b];
  const int hi = min(L0, nb * bt);
  const int lo = window ? max(0, L0 + c_min - window + 1) : 0;
  const int pg_first = (lo / kKeys) * kKeys;
  const int n_pg = hi > pg_first ? (hi - pg_first + kKeys - 1) / kKeys : 0;
  const int u_lo = window ? max(0, c_min - window + 1) : 0;
  const int u_hi = min(c_max + 1, C);
  const int ch_first = (u_lo / kKeys) * kKeys;
  const int n_tiles = n_pg + (u_hi - ch_first + kKeys - 1) / kKeys;
  const int* tab = block_tables + (size_t)b * nb;

  auto tile_start = [&](int j) {
    return j < n_pg ? pg_first + j * kKeys : ch_first + (j - n_pg) * kKeys;
  };
  // key t of tile j -> its row (page * bt + offset in the arena, or u in
  // this slot's k_new / v_new) or -1, and the tile's live mask; called by
  // whole warps (the ballot)
  auto resolve = [&](int j, int t) {
    int idx = -1;
    const int p = tile_start(j) + t;
    if (j < n_pg) {
      if (p >= lo && p < hi) {
        const int blk = p / bt;
        const int page = tab[blk];
        if (page >= 0) idx = page * bt + (p - blk * bt);   // < 0: masked
      }
    } else if (j < n_tiles && p >= u_lo && p < u_hi) {
      idx = p;
    }
    const int slot = j % kSlots;
    srow[slot * kKeys + t] = idx;
    const uint32_t bits = __ballot_sync(0xffffffffu, idx >= 0);
    if ((t & 31) == 0) slive[slot * 2 + t / 32] = bits;
  };
  auto load_kv = [&](int j) {
    const int* rows = srow + (j % kSlots) * kKeys;
    bf16* dk = skv + (j % kStages) * 2 * kKeys * RS;
    bf16* dv = dk + kKeys * RS;
    const bool paged = j < n_pg;
    const bf16* kb = paged ? k_pages : k_new;
    const bf16* vb = paged ? v_pages : v_new;
    const size_t base = paged ? 0 : (size_t)b * C;
    for (int i = tid; i < kKeys * CH; i += kThreads) {
      const int t = i / CH, ch = i - t * CH;
      const int idx = rows[t];
      const bool ok = idx >= 0 && ch < hc;
      const size_t off =
          ok ? ((base + idx) * K + kvh) * (size_t)hd + ch * 8 : 0;
      cp_async16(smem_u32(dk + t * RS + ch * 8), kb + off, ok);
      cp_async16(smem_u32(dv + t * RS + ch * 8), vb + off, ok);
    }
  };

  // the first kStages tiles' rows, then Q (riding in the first group)
  for (int i = tid; i < kStages * kKeys; i += kThreads)
    resolve(i / kKeys, i % kKeys);
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, ch = i - r * CH;
    const bool ok = r < nrows && ch < hc;
    cp_async16(smem_u32(sq + r * RS + ch * 8),
               ok ? q + row_off(r) + ch * 8 : q, ok);
  }
  __syncthreads();                      // the row indices are visible
  // one group per tile, kStages - 1 ahead
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  // this thread's two softmax rows, its warp's span of positions and
  // first column tile of O
  const int wr0 = warp / kSplit * 16;
  const int d0 = warp % kSplit * DTW;
  const int ca = (row0 + wr0 + group) / G;
  const int cb = (row0 + wr0 + group + 8) / G;
  const bool warp_live = wr0 < nrows;
  const int cw_min = (row0 + wr0) / G;
  const int cw_max = (row0 + min(wr0 + 15, nrows - 1)) / G;

  float o[DTW][4];
#pragma unroll
  for (int d = 0; d < DTW; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};      // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's part of the sum

  for (int j = 0; j < n_tiles; ++j) {
    const int ahead = j + kStages - 1;  // refills the stage of tile j - 1
    if (ahead < n_tiles) load_kv(ahead);
    cp_async_commit();
    // the slot of tile j - 1, whose copies and arithmetic are done
    if (tid < kKeys) resolve(j + kStages, tid);
    cp_async_wait<kStages - 1>();       // tile j (and Q) landed
    __syncthreads();
    const int t0 = tile_start(j);
    const bool paged = j < n_pg;
    const uint32_t lb0 = slive[(j % kSlots) * 2];
    const uint32_t lb1 = slive[(j % kSlots) * 2 + 1];
    // can any row of the warp see a key of the tile, can all see all?
    bool visible = warp_live && (lb0 | lb1);
    bool full = (lb0 & lb1) == 0xffffffffu;
    if (paged) {
      visible = visible && (!window || t0 + kKeys - 1 > L0 + cw_min - window);
      full = full && (!window || t0 > L0 + cw_max - window);
    } else {
      visible = visible && t0 <= cw_max &&
                (!window || t0 + kKeys - 1 > cw_min - window);
      full = full && t0 + kKeys - 1 <= cw_min &&
             (!window || t0 > cw_max - window);
    }
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
      // ---- scale, and mask per element from absolute positions unless
      // every row of the warp sees the whole tile; row max across the quad
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
          const uint32_t lb = n < NT / 2 ? lb0 : lb1;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = n * 8 + quad * 2 + (e & 1);
            const int c = e < 2 ? ca : cb;
            bool live = (lb >> (t & 31)) & 1u;
            if (paged)
              live = live && (!window || t0 + t > L0 + c - window);
            else
              live = live && t0 + t <= c && (!window || t0 + t > c - window);
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
      for (int d = 0; d < DTW; ++d) {
        o[d][0] *= alpha[0]; o[d][1] *= alpha[0];
        o[d][2] *= alpha[1]; o[d][3] *= alpha[1];
      }
      // ---- the f32 weights P, each split into bf16 hi + lo, as the A
      // fragments of P.V; l sums the f32 weights
      uint32_t ph[NT / 2][4], pl[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = (live_bits >> (n * 4 + e)) & 1u
                     ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
          l[e >> 1] += p[e];
        }
        split_bf16(p[0], p[1], ph[n / 2][(n & 1) * 2 + 0],
                   pl[n / 2][(n & 1) * 2 + 0]);
        split_bf16(p[2], p[3], ph[n / 2][(n & 1) * 2 + 1],
                   pl[n / 2][(n & 1) * 2 + 1]);
      }
      // ---- O += P_hi.V + P_lo.V (16 rows x this warp's DTW column
      // tiles), V^T fragments by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int d = 0; d < DTW; d += 2) {
          if (d0 + d >= DT) break;      // the second warp's short share
          // matrices: keys +0 / +8 of column tile d, then of tile d + 1
          uint32_t bv[4];
          const int mat = lane >> 3;
          ldmatrix_x4_trans(bv, smem_u32(sv + (kk * 16 + (mat & 1) * 8 +
                                               (lane & 7)) * RS +
                                         (d0 + d) * 8 + (mat >> 1) * 8));
          mma_bf16(o[d], pl[kk], bv[0], bv[1]);
          mma_bf16(o[d + 1], pl[kk], bv[2], bv[3]);
          mma_bf16(o[d], ph[kk], bv[0], bv[1]);
          mma_bf16(o[d + 1], ph[kk], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                    // the stage may be refilled
  }
  cp_async_wait<0>();
  __syncthreads();                      // Q's copies landed everywhere

  // ---- out = O / max(l, 1e-20), staged in the warp's own Q rows and
  // columns (an 8-wide column tile is one 16-byte chunk)
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / fmaxf(quad_sum(l[h]), 1e-20f);
#pragma unroll
  for (int d = 0; d < DTW; ++d) {
    if (d0 + d >= DT) break;
    bf16* dst = sq + (wr0 + group) * RS + (d0 + d) * 8 + quad * 2;
    *reinterpret_cast<uint32_t*>(dst) =
        as_u32(__floats2bfloat162_rn(o[d][0] * inv[0], o[d][1] * inv[0]));
    *reinterpret_cast<uint32_t*>(dst + 8 * RS) =
        as_u32(__floats2bfloat162_rn(o[d][2] * inv[1], o[d][3] * inv[1]));
  }
  __syncthreads();                      // a row's columns come from kSplit warps
  for (int i = lane; i < 16 * hc; i += 32) {
    const int r = wr0 + i / hc, ch = i % hc;
    if (r < nrows && ch / DTW == warp % kSplit)
      *reinterpret_cast<uint4*>(out + row_off(r) + ch * 8) =
          *reinterpret_cast<const uint4*>(sq + r * RS + ch * 8);
  }
}

template <int HDP>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* ctx_lens, const void* k_new,
           const void* v_new, void* out, int B, int C, int H, int K, int hd,
           int bt, int nb, int window, float scale, cudaStream_t stream) {
  // raise the dynamic shared-memory limit once per device
  // (cudaFuncSetAttribute is kept off the per-launch path); one bit per
  // device
  static std::atomic<unsigned long long> allowed{0};
  const size_t smem = Shape<HDP>::smem;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(paged_prefill_attention_mma_kernel<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(bit, std::memory_order_release);
  }
  const int R = C * (H / K);
  const dim3 grid((R + Shape<HDP>::kRows - 1) / Shape<HDP>::kRows, K, B);
  paged_prefill_attention_mma_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(ctx_lens), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<bf16*>(out), C, H, K, hd,
      bt, nb, window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only.  q/out (B, C, H, hd), k_pages/v_pages (P, bt, K, hd),
// block_tables (B, nb) int32, ctx_lens (B,) int32, k_new/v_new (B, C, K,
// hd), all contiguous and 16-byte aligned; B, C > 0, H % K == 0, hd % 8
// == 0, hd <= 256, bt > 0.  Returns the cudaError_t of the launch.
extern "C" int paged_prefill_attention_mma_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* ctx_lens, const void* k_new,
    const void* v_new, void* out, int B, int C, int H, int K, int hd, int bt,
    int nb, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0 || K <= 0 || H % K || hd <= 0 || hd % 8 ||
      hd > kMaxHd || bt <= 0 || nb < 0 || window < 0 || B > 65535 ||
      K > 65535)
    return (int)cudaErrorInvalidValue;
  switch ((hd + 15) / 16) {
#define PREFILL_MMA_CASE(n)                                                \
  case n:                                                                  \
    return launch<16 * n>(q, k_pages, v_pages, block_tables, ctx_lens,     \
                          k_new, v_new, out, B, C, H, K, hd, bt, nb,       \
                          window, scale, st);
    PREFILL_MMA_CASE(1) PREFILL_MMA_CASE(2) PREFILL_MMA_CASE(3)
    PREFILL_MMA_CASE(4) PREFILL_MMA_CASE(5) PREFILL_MMA_CASE(6)
    PREFILL_MMA_CASE(7) PREFILL_MMA_CASE(8) PREFILL_MMA_CASE(9)
    PREFILL_MMA_CASE(10) PREFILL_MMA_CASE(11) PREFILL_MMA_CASE(12)
    PREFILL_MMA_CASE(13) PREFILL_MMA_CASE(14) PREFILL_MMA_CASE(15)
    PREFILL_MMA_CASE(16)
#undef PREFILL_MMA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
