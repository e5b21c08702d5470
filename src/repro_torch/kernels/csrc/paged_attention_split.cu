// Paged decode attention for Hopper (sm_90a), bf16, split-KV over a
// thread-block cluster: one query token per slot over its block-table
// pages plus the not-yet-paged current token.  The f32 contract stays on
// paged_attention.cu.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention -> _kernel, the pl.pallas_call at :132 over grid
// (slot, kv_head, kv_block)).
//
// Bound on this card: HBM bytes.  Each decode step reads every live K and
// V row once against 4 G flops per row element (G = H / K query heads per
// kv head, at most 32), far below the ~295 flops per byte at which the
// tensor cores' rate would matter.  Mistral-nemo's decode tick, q (8, 32,
// 128) over ~1,550 live positions, is 6.5 MB: 1.9 us at 3.35 TB/s.
//
// What held the one-CTA-per-(slot, kv head) kernel (paged_attention.cu)
// back, and what this design does about it:
//   * 64 CTAs for 132 SMs, each walking its slot's tiles in series ->
//     grid (S, K, B) with cluster dims (S, 1, 1): the S CTAs of a cluster
//     split one (slot, kv head)'s live range [lo, hi) into S even parts
//     and merge their partial softmax states through distributed shared
//     memory.  S = min(8, ceil(nb bt / 64)) comes from the table width nb
//     on the host (the decode bucket), never from seq_lens: reading that
//     device tensor would cost a host sync per layer;
//   * K and V widened to f32 in shared memory by a loop of blocking loads
//     -> K and V stay bf16 in shared memory and every 16-byte cp.async of
//     a tile is in flight before the first wait; a CTA whose part spans more
//     than one 64-key tile (contexts over S * 64 keys) prefetches tile
//     j + 1 into a second stage while tile j computes;
//   * a table entry and a division per key row and per thread -> q, k_new
//     and v_new are copied by cp.async while seq_len is read, and a tile's
//     key rows are resolved once (one table read per key) into a row-index
//     table, so the copies do no division;
//   * the arithmetic on the CUDA cores (the bf16 K and V widened once per
//     query row) -> S = Q.K^T and O += P.V on mma.sync.m16n8k16 (bf16
//     operands, f32 sums), the G query rows padded to 16 per m-tile: the
//     tensor cores are not needed for their rate but for their few
//     instructions a flop (a CUDA-core walk of the same design timed a
//     little slower on an H100).  The products of bf16 q and K are exact in
//     f32, so S is the f32 score up to the order of its sum.
// Within [lo, hi) every position is live (entries < 0 are clamped, not
// masked), so no score needs a mask; a CTA whose part is empty keeps
// m = -1e30, l = 0, O = 0 and touches no page.
//
// f32 softmax weights.  The paged contract, as the Pallas kernel (its
// dot_general over the f32 p) and JAX's oracle keep it, multiplies V by
// f32 weights: the online softmax runs in f32 (a warp per row, expf), and
// each weight is split into a bf16 high part and the bf16 rounding of
// what remains, p = hi + lo to within 2^-18 p, for two P.V mma per tile
// (as paged_prefill_attention_mma.cu does).  P is never rounded to bf16
// as a whole.
//
// Merge.  The S CTAs split the G hd outputs.  After its walk each CTA
// pushes its (m, l) rows to every peer and each share of its unnormalised
// O[G][hd] to the peer that owns those outputs, with stores into the
// peers' shared memory (cluster.map_shared_rank): stores do not wait for
// a round trip, as loads from a peer would.  One cluster.sync() publishes
// them; then each CTA computes, per row, m* = max(s_new, m_0 .. m_{S-1}),
// the factors exp(m_i - m*) and exp(s_new - m*) and 1 / denominator, and
// sums its share from its own shared memory, folding in the current token
// (k_new, v_new) exactly once.  A cluster barrier arrived at on entry and
// waited on before the first push keeps every store after its target
// started; no CTA touches a peer after the sync, so none waits to exit.
// One launch per layer, no scratch in device memory.
//
// Contract (that of kernels/ref.py::paged_attention):
//   * table entries < 0 are clamped to page 0 and NOT masked inside the
//     live range;
//   * live positions: p < seq_len and, with a window, p > seq_len - window;
//   * scores, exp (expf) and sums in f32, scale = 1 / sqrt(hd), f32
//     weights as above;
//   * out = acc * (1 / max(l, 1e-20)), rounded once to bf16; a slot with
//     seq_len = 0 gets finite output from the current token alone;
//   * any bt (64 need not be a multiple of it), hd a multiple of 8 up to
//     256 (padded to 16 with zero columns), G up to 32.

#include <cooperative_groups.h>

#include "paged_common.cuh"

namespace cg = cooperative_groups;


namespace {

typedef __nv_bfloat16 bf16;

using paged::kNegInf;
using paged::warp_max;
using paged::warp_sum;

constexpr int kThreads = 128;                // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;                    // keys per K/V tile
constexpr int kSpStride = kKeys + 8;         // f32 score row stride
constexpr int kMaxSplit = 8;                 // CTAs per cluster (portable)
constexpr int kMaxGroup = 32;                // ops.MAX_GROUP
constexpr int kMaxHd = 256;
constexpr int kFactors = kMaxSplit + 2;      // per row: S factors, new, 1 / l
constexpr int kSmemMax = 232448;             // opt-in shared memory a CTA

// S: CTAs per (slot, kv head), from the table width alone
__host__ __device__ inline int split_of(int nb, int bt) {
  const int tiles = (nb * bt + kKeys - 1) / kKeys;
  return tiles < 1 ? 1 : tiles > kMaxSplit ? kMaxSplit : tiles;
}
// hd padded to the mma depth, and the bf16 row stride of Q, K and V in
// shared memory: an odd number of 16-byte chunks, so the 8 rows of an
// ldmatrix phase hit 8 distinct bank groups
__host__ __device__ constexpr int padded_hd(int hd) {
  return (hd + 15) / 16 * 16;
}
__host__ __device__ constexpr int row_stride(int hd) {
  return (padded_hd(hd) / 8 + 1) * 8;
}
__host__ __device__ constexpr int m_tiles(int G) { return (G + 15) / 16; }

__host__ __device__ constexpr size_t smem_bytes(int G, int hd, int stages) {
  const size_t RS = row_stride(hd);
  const size_t rows = 16 * m_tiles(G);
  return sizeof(bf16) * (stages * 2 * kKeys + rows) * RS  // K/V ring, Q
         + sizeof(float) * ((size_t)G * hd            // O (unnormalised)
                            + (size_t)G * hd + 4 * kMaxSplit  // pushed O
                            + 2 * kMaxSplit * kMaxGroup       // pushed m, l
                            + rows * kSpStride        // scores / weights
                            + 4 * kMaxGroup           // m, l, alpha, s_new
                            + kMaxGroup * kFactors)   // merge factors
         + sizeof(bf16) * 2 * kMaxHd                  // k_new, v_new
         + sizeof(int) * 2 * kKeys;                   // row ids
}
static_assert(smem_bytes(kMaxGroup, kMaxHd, 2) <= kSmemMax,
              "two K/V stages must fit at every supported shape");
// K/V ring depth: 2 when a CTA's part can span more than one tile
__host__ __device__ inline int stages_of(int nb, int bt) {
  const int S = split_of(nb, bt);
  return (nb * bt + S - 1) / S > kKeys ? 2 : 1;
}
// column-tile pairs of O (16 columns each) a warp owns
__host__ __device__ inline int pairs_per_warp(int hd) {
  return (padded_hd(hd) / 16 + kWarps - 1) / kWarps;
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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

// two f32 weights -> their bf16 high parts (hi, one register, the first
// weight in the low half) and the bf16 rounding of what remains (lo)
__device__ __forceinline__ void split_bf16(float2 w, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(w.x, w.y);
  const float2 f = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(w.x - f.x, w.y - f.y));
}

// 4 bf16 (8 bytes, aligned) -> float4
__device__ __forceinline__ float4 widen4(const bf16* src) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void fma4(float4& o, float p, const float4& v) {
  o.x += p * v.x; o.y += p * v.y; o.z += p * v.z; o.w += p * v.w;
}

// Fragment layout of m16n8k16 (lane = 4 * group + quad): an accumulator
// tile holds rows group and group + 8, columns 2 * quad and 2 * quad + 1.
// MT: m-tiles of 16 query rows (G <= 16 * MT); PW: column-tile pairs of O
// a warp owns (pairs_per_warp(hd)).
template <int MT, int PW>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k_pages,
                             const bf16* __restrict__ v_pages,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ seq_lens,
                             const bf16* __restrict__ k_new,
                             const bf16* __restrict__ v_new,
                             bf16* __restrict__ out, int H, int K, int hd,
                             int bt, int nb, int window, float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = lane / 4, quad = lane % 4;
  const int RS = row_stride(hd);
  const int HDP = padded_hd(hd);
  const int CHP = HDP / 8;               // 16-byte chunks of a padded row
  const int CH = hd / 8;                 // ... of which hold data
  const int stages = stages_of(nb, bt);
  cluster_arrive_relaxed();              // waited on before the first push

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* skv = reinterpret_cast<bf16*>(smem_raw);  // [stage][k, v][kKeys][RS]
  bf16* sq = skv + (size_t)stages * 2 * kKeys * RS;  // [16 MT][RS]
  float* so = reinterpret_cast<float*>(sq + 16 * MT * RS);  // [G][hd]
  float* racc = so + G * hd;             // [S][share] quads pushed to here
  float* sp = racc + G * hd + 4 * kMaxSplit;  // [16 MT][kSpStride]
  float* sm = sp + 16 * MT * kSpStride;  // [G] running max
  float* sl = sm + kMaxGroup;            // [G] running sum
  float* salpha = sl + kMaxGroup;        // [32] this tile's rescale
  float* snew = salpha + kMaxGroup;      // [G] the current token's score
  float* rml = snew + kMaxGroup;         // [S][m, l][G] pushed to here
  float* sf = rml + 2 * kMaxSplit * kMaxGroup;  // [G][kFactors]
  bf16* skv_new = reinterpret_cast<bf16*>(sf + kMaxGroup * kFactors);
                                         // [k_new, v_new][kMaxHd]
  int* srow = reinterpret_cast<int*>(skv_new + 2 * kMaxHd);
                                         // [stage][kKeys] key row or -1

  // q and the current token in flight while seq_len is read
  const int L = seq_lens[b];
  const int* row_tab = block_tables + (size_t)b * nb;
  const size_t new_row = ((size_t)b * K + kvh) * hd;
  for (int i = tid; i < 16 * MT * CHP; i += kThreads) {
    const int r = i / CHP;
    const int c = (i - r * CHP) * 8;
    const bool ok = r < G && c < hd;
    cp_async16(smem_u32(sq + r * RS + c),
               ok ? q + ((size_t)b * H + (size_t)kvh * G + r) * hd + c : q,
               ok);
  }
  for (int i = tid; i < 2 * CH; i += kThreads) {
    const int w = i / CH;                      // 0: k_new, 1: v_new
    const int c = (i - w * CH) * 8;
    cp_async16(smem_u32(skv_new + w * kMaxHd + c),
               (w ? v_new : k_new) + new_row + c, true);
  }
  cp_async_commit();

  // this CTA's part [a, a + n_keys) of the live range [lo, hi)
  const int hi = min(L, nb * bt);
  const int lo = window ? max(0, L - window + 1) : 0;
  const int per = (max(hi - lo, 0) + S - 1) / S;
  const int a = lo + rank * per;
  const int n_keys = max(min(hi, a + per) - a, 0);
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  auto keys_of = [&](int j) { return min(kKeys, n_keys - j * kKeys); };

  // key t of tile j -> its row in the arena (page * bt + offset) or -1
  // past the tile's keys, up to a multiple of 16 (zero-filled rows)
  auto resolve = [&](int j, int slot) {
    const int T = keys_of(j);
    if (tid < ((T + 15) & ~15)) {
      int idx = -1;
      if (tid < T) {
        const int p = a + j * kKeys + tid;
        const int blk = p / bt;
        const int page = max(row_tab[blk], 0);
        idx = page * bt + (p - blk * bt);
      }
      srow[slot * kKeys + tid] = idx;
    }
  };
  // every 16-byte copy of tile j into stage ``slot``, one commit group;
  // thread tid copies chunk tid % CHP of rows tid / CHP + i * (kThreads /
  // CHP), so no index is divided per copy
  const int rpp = kThreads / CHP;
  const int my_row = tid / CHP, my_c = (tid - my_row * CHP) * 8;
  auto fetch = [&](int j, int slot) {
    const int T16 = (keys_of(j) + 15) & ~15;
    bf16* sk = skv + (size_t)slot * 2 * kKeys * RS;
    bf16* sv = sk + kKeys * RS;
    if (my_row < rpp) {
      for (int t = my_row; t < T16; t += rpp) {
        const int idx = srow[slot * kKeys + t];
        const bool ok = idx >= 0 && my_c < hd;
        const size_t off = ok ? ((size_t)idx * K + kvh) * hd + my_c : 0;
        cp_async16(smem_u32(sk + t * RS + my_c), k_pages + off, ok);
        cp_async16(smem_u32(sv + t * RS + my_c), v_pages + off, ok);
      }
    }
    cp_async_commit();
  };

  // ---- tile 0 on its way, then the current token's scores
  cp_async_wait_all();
  __syncthreads();                // q, k_new and v_new landed
  if (n_tiles) {
    resolve(0, 0);
    __syncthreads();
    fetch(0, 0);
  }
  for (int r = warp; r < G; r += kWarps) {
    float s = 0.f;
    for (int d = lane * 4; d < hd; d += 128) {
      const float4 x = widen4(sq + r * RS + d);
      const float4 k = widen4(skv_new + d);
      s += x.x * k.x + x.y * k.y + x.z * k.z + x.w * k.w;
    }
    s = warp_sum(s);
    if (lane == 0) snew[r] = s * scale;
  }
  for (int r = tid; r < kMaxGroup; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.f;
    salpha[r] = 0.f;
  }
  // weights of the padded rows stay 0
  for (int i = G * kSpStride + tid; i < 16 * MT * kSpStride; i += kThreads)
    sp[i] = 0.f;

  float o[MT][PW][2][4];                 // O: rows of m-tile, column tiles
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int pw = 0; pw < PW; ++pw)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        o[mt][pw][n][0] = o[mt][pw][n][1] = o[mt][pw][n][2] =
            o[mt][pw][n][3] = 0.f;

  // ---- walk this CTA's tiles: online softmax in f32
  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j & 1;               // j is 0 alone with one stage
    const bool ahead = j + 1 < n_tiles;
    if (ahead) resolve(j + 1, slot ^ 1);
    cp_async_wait_all();
    __syncthreads();              // tile j landed; tile j + 1's rows seen
    if (ahead) fetch(j + 1, slot ^ 1);
    const int T = keys_of(j);
    const int T16 = (T + 15) & ~15;
    const bf16* sk = skv + (size_t)slot * 2 * kKeys * RS;
    const bf16* sv = sk + kKeys * RS;

    // S = Q.K^T: warp w takes keys [16 w, 16 w + 16), all m-tiles
    if (warp * 16 < T16) {
      float s[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
      const int mat = lane >> 3;
      for (int kk = 0; kk < HDP / 16; ++kk) {
        // matrices: keys +0..7 at depth +0 / +8, then keys +8..15
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_u32(sk + (warp * 16 + (mat >> 1) * 8 +
                                       (lane & 7)) * RS +
                                 kk * 16 + (mat & 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t aq[4];
          ldmatrix_x4(aq, smem_u32(sq + (mt * 16 + (lane & 15)) * RS +
                                   kk * 16 + (lane >> 4) * 8));
          mma_bf16(s[mt][0], aq, bk[0], bk[1]);
          mma_bf16(s[mt][1], aq, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + group + (e >> 1) * 8;
            const int t = warp * 16 + n * 8 + quad * 2 + (e & 1);
            if (r < G) sp[r * kSpStride + t] = s[mt][n][e] * scale;
          }
    }
    __syncthreads();
    // online softmax: a warp per row, two keys a lane; weights stay f32
    for (int r = warp; r < G; r += kWarps) {
      float* pr = sp + r * kSpStride;
      const float x0 = lane < T ? pr[lane] : kNegInf;
      const float x1 = lane + 32 < T ? pr[lane + 32] : kNegInf;
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = lane < T ? expf(x0 - m_new) : 0.f;
      const float p1 = lane + 32 < T ? expf(x1 - m_new) : 0.f;
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        salpha[r] = alpha;
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();
    // O = alpha O + P_hi.V + P_lo.V: warp w owns column-tile pairs w,
    // w + 4, ..; V^T fragments by ldmatrix.trans
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float a0 = salpha[mt * 16 + group];
      const float a1 = salpha[mt * 16 + group + 8];
#pragma unroll
      for (int pw = 0; pw < PW; ++pw)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          o[mt][pw][n][0] *= a0; o[mt][pw][n][1] *= a0;
          o[mt][pw][n][2] *= a1; o[mt][pw][n][3] *= a1;
        }
    }
    for (int kk = 0; kk < T16 / 16; ++kk) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p0 = sp + (mt * 16 + group) * kSpStride + kk * 16 + quad * 2;
        const float* p1 = p0 + 8 * kSpStride;
        split_bf16(*reinterpret_cast<const float2*>(p0), ph[mt][0], pl[mt][0]);
        split_bf16(*reinterpret_cast<const float2*>(p1), ph[mt][1], pl[mt][1]);
        split_bf16(*reinterpret_cast<const float2*>(p0 + 8), ph[mt][2], pl[mt][2]);
        split_bf16(*reinterpret_cast<const float2*>(p1 + 8), ph[mt][3], pl[mt][3]);
      }
#pragma unroll
      for (int pw = 0; pw < PW; ++pw) {
        const int pair = warp + pw * kWarps;
        if (pair * 16 >= HDP) break;
        // matrices: keys +0 / +8 of column tile 2 pair, then of 2 pair + 1
        uint32_t bv[4];
        const int mat = lane >> 3;
        ldmatrix_x4_trans(bv, smem_u32(sv + (kk * 16 + (mat & 1) * 8 +
                                             (lane & 7)) * RS +
                                       pair * 16 + (mat >> 1) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][pw][0], pl[mt], bv[0], bv[1]);
          mma_bf16(o[mt][pw][1], pl[mt], bv[2], bv[3]);
          mma_bf16(o[mt][pw][0], ph[mt], bv[0], bv[1]);
          mma_bf16(o[mt][pw][1], ph[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();              // stage ``slot`` and sp free again
  }

  // O (rows < G, columns < hd) into shared memory for the merge
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int pw = 0; pw < PW; ++pw)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + group + h * 8;
          const int c = (warp + pw * kWarps) * 16 + n * 8 + quad * 2;
          if (r < G && c < hd)
            *reinterpret_cast<float2*>(so + r * hd + c) =
                make_float2(o[mt][pw][n][2 * h], o[mt][pw][n][2 * h + 1]);
        }
  __syncthreads();

  // ---- merge: push every part's state to the CTAs that own the outputs
  const int nq = hd / 4;
  const int share = (G * nq + S - 1) / S;    // output quads per CTA
  cluster_wait();                 // every peer has started
  for (int i = tid; i < S * G; i += kThreads) {
    const int j = i / G, r = i - j * G;
    float* dst = cluster.map_shared_rank(rml, j) + 2 * rank * kMaxGroup;
    dst[r] = sm[r];
    dst[kMaxGroup + r] = sl[r];
  }
  for (int i = tid; i < G * nq; i += kThreads) {
    const int j = i / share;
    float* dst = cluster.map_shared_rank(racc, j) +
                 (size_t)(rank * share + i - j * share) * 4;
    *reinterpret_cast<float4*>(dst) = reinterpret_cast<const float4*>(so)[i];
  }
  cluster.sync();                 // every push has landed
  // per row: m* = max(s_new, m_j), the factors exp(m_j - m*) (0 for an
  // empty part) and exp(s_new - m*), and 1 / max(l, 1e-20); a lane per
  // (row, part), the 8 lanes of a row reduced by shuffles
  for (int i = tid; i < (G * kMaxSplit + 31) / 32 * 32; i += kThreads) {
    const int r = i / kMaxSplit, j = i % kMaxSplit;
    const bool in = r < G && j < S;
    const float mj = in ? rml[2 * j * kMaxGroup + r] : kNegInf;
    const float sn = r < G ? snew[r] : 0.f;
    float m_star = fmaxf(mj, sn);
#pragma unroll
    for (int o = 1; o < kMaxSplit; o <<= 1)
      m_star = fmaxf(m_star, __shfl_xor_sync(0xffffffffu, m_star, o));
    const float f = in ? expf(mj - m_star) : 0.f;
    float l = in ? f * rml[(2 * j + 1) * kMaxGroup + r] : 0.f;
#pragma unroll
    for (int o = 1; o < kMaxSplit; o <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    if (r < G) {
      float* fr = sf + r * kFactors;
      fr[j] = f;
      if (j == 0) {
        const float f_new = expf(sn - m_star);
        fr[kMaxSplit] = f_new;
        fr[kMaxSplit + 1] = 1.f / fmaxf(l + f_new, 1e-20f);
      }
    }
  }
  __syncthreads();
  const int mine = min(share, G * nq - rank * share);
  for (int k = tid; k < mine; k += kThreads) {
    const int i = rank * share + k;
    const int r = i / nq;
    const int d = (i - r * nq) * 4;
    const float* f = sf + r * kFactors;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    fma4(acc, f[kMaxSplit], widen4(skv_new + kMaxHd + d));
    for (int j = 0; j < S; ++j)
      fma4(acc, f[j], reinterpret_cast<const float4*>(racc)[j * share + k]);
    const float inv = f[kMaxSplit + 1];
    uint2 pack;
    pack.x = as_u32(__floats2bfloat162_rn(acc.x * inv, acc.y * inv));
    pack.y = as_u32(__floats2bfloat162_rn(acc.z * inv, acc.w * inv));
    *reinterpret_cast<uint2*>(
        out + ((size_t)b * H + (size_t)kvh * G + r) * hd + d) = pack;
  }
}

typedef void (*Kernel)(const bf16*, const bf16*, const bf16*, const int*,
                       const int*, const bf16*, const bf16*, bf16*, int, int,
                       int, int, int, int, float);

// the instantiation for G query rows a kv head and head dim hd, with its
// once-per-device shared-memory opt-in
template <int MT, int PW>
cudaError_t instance(Kernel* kernel) {
  static std::atomic<unsigned long long> done{0};
  *kernel = paged_attention_split_kernel<MT, PW>;
  return paged::allow_max_smem(*kernel, done, kSmemMax);
}
cudaError_t kernel_for(int G, int hd, Kernel* kernel) {
  const int pw = pairs_per_warp(hd);
  if (m_tiles(G) == 1) {
    switch (pw) {
      case 1: return instance<1, 1>(kernel);
      case 2: return instance<1, 2>(kernel);
      case 3: return instance<1, 3>(kernel);
      case 4: return instance<1, 4>(kernel);
    }
  } else if (m_tiles(G) == 2) {
    switch (pw) {
      case 1: return instance<2, 1>(kernel);
      case 2: return instance<2, 2>(kernel);
      case 3: return instance<2, 3>(kernel);
      case 4: return instance<2, 4>(kernel);
    }
  }
  return cudaErrorInvalidValue;
}

cudaLaunchConfig_t launch_config(int B, int K, int smem, int S,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, K, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// bf16 only.  The grid and the ring depth come from nb and bt (host
// ints); seq_lens is read on the device only.  Returns the cudaError_t of
// the launch.
extern "C" int paged_attention_split_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, const void* k_new,
    const void* v_new, void* out, int B, int H, int K, int hd, int bt, int nb,
    int window, float scale, void* stream) {
  const int G = H / K;
  Kernel kernel = nullptr;
  cudaError_t err = kernel_for(G, hd, &kernel);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      B, K, (int)smem_bytes(G, hd, stages_of(nb, bt)),
      split_of(nb, bt), static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k_pages), static_cast<const bf16*>(v_pages),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens),
      static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
      static_cast<bf16*>(out), H, K, hd, bt, nb, window, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch geometry of a call with these shapes: S (CTAs per cluster),
// the ring depth, the dynamic shared memory of one CTA, and how many such
// clusters the card can hold at once (cudaOccupancyMaxActiveClusters; 0
// means the launch cannot run).  Returns the cudaError_t of the query.
extern "C" int paged_attention_split_geometry(int H, int K, int hd, int bt,
                                              int nb, int* geometry) {
  const int G = H / K;
  Kernel kernel = nullptr;
  cudaError_t err = kernel_for(G, hd, &kernel);
  if (err != cudaSuccess) return (int)err;
  const int S = split_of(nb, bt);
  const int stages = stages_of(nb, bt);
  const int smem = (int)smem_bytes(G, hd, stages);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, K, smem, S, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
  geometry[0] = S;
  geometry[1] = stages;
  geometry[2] = smem;
  geometry[3] = clusters;
  return (int)err;
}
