// Chunked Mamba2/SSD scan on Hopper's tensor cores (sm_90a), f32 contract.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:75 (ssd_scan ->
// _kernel, the pl.pallas_call over grid (B, h, n_chunks) with the (hd, S)
// state in VMEM scratch), and beyond it returns the final state, which
// mamba_apply(return_state=True) hands to the decode step.  It computes
// what kernels/ref.py::ssd_scan computes: per (batch row b, SSM head h),
// chunk by chunk in order, state st (hd, S) in f32, acs the inclusive
// cumsum of dt * A inside the chunk,
//   y_t = sum_{s<=t} exp(acs_t - acs_s) dt_s (C_t . B_s) x_s
//         + exp(acs_t) (C_t . st^T)
//   st <- st exp(acs_end) + sum_s exp(acs_end - acs_s) dt_s x_s B_s^T.
// The CUDA-core kernel of ssd_scan.cu computes the same; it stays in the
// library as the comparison of chip_smoke.py and nothing calls it on the
// main path.
//
// Bound on this card: bytes.  At zamba2's largest group call, x (4, 189,
// 112, 64) bf16, S 64, chunk 128, the call moves 40.6 MB (12.1 us at 3.35
// TB/s).  Its ~2.0 GFLOP of f32 arithmetic would take 29.9 us at 67
// TFLOP/s on the CUDA cores; run as below, three passes a product, it is
// ~3.8 GFLOP of bf16 passes and ~0.7 GFLOP of TF32 passes, ~5.3 us at the
// tensor cores' published peaks.
//
// What held the CUDA-core kernel back, and what this design does about it:
//   * C.B^T does not depend on the head, yet each of a row's h CTAs
//     recomputed it -> a first launch (ssd_cb_kernel, grid (16-row tiles
//     x chunks, B)) forms G = C.B^T once per (row, chunk), only the tiles
//     on and below the diagonal, and writes it, with C and B^T, as
//     ready-made mma A fragments into a scratch of the wrapper's (0.8 MB
//     at the call above: it stays in L2).  The scan reads each fragment
//     with one 16-byte load per lane and applies its head's decay and dt;
//   * scalar FMAs with both operands in shared memory -> every product on
//     the tensor cores with f32 accumulators, at f32 accuracy, never a
//     single rounded pass.  Products of two f32 operands (C.B^T, C.st^T,
//     and all of them with f32 x) run as mma.sync.m16n8k8 TF32 with each
//     operand split as hi + lo (hi its TF32 rounding, lo the TF32
//     rounding of the rest) and three products summed, lo.hi + hi.lo +
//     hi.hi: about 2^-21 relative per product.  With bf16 x the products
//     with x as an operand, M.x and (B^T w).x, run as mma.sync.m16n8k16
//     bf16: x is exact in bf16, the f32 A operand is split into three
//     bf16 parts (24 bits, as f32 has) and three passes are summed, with
//     x's B fragments read by ldmatrix.trans;
//   * one 8-warp CTA per SM (182,528 bytes of f32 shared memory) -> x
//     stays in its own dtype in shared memory, M is formed in registers
//     as the A fragment of its product, C, B^T and G come from the scratch
//     and only a 64-column tile of the old state is staged: 56,832 bytes
//     per 4-warp CTA with bf16 x (89,600 with f32 x), at most 128
//     registers (__launch_bounds__), so 4 CTAs fit an SM and the 448 CTAs
//     of zamba2's call (4 rows x 112 heads) are resident in one wave;
//   * synchronous, narrow staging -> C and B by 16-byte cp.async in the
//     first launch, x by 16-byte cp.async (dt by 4-byte) into a 2-stage
//     ring: chunk c + 1 is in flight while chunk c computes.  The scan is
//     a programmatic dependent launch: its first chunk's x and cumsum
//     overlap the C.B^T launch.
//
// The scan: one CTA of 4 warps per (b, h, slab of 64 columns of hd) walks
// the chunks in order (a loop inside the block replaces the TPU's
// sequential grid dimension); y[:, d] and st[d, :] depend on x[:, d]
// alone, so a wider hd is cut into slabs.  Per chunk warp 0 forms the
// cumsum, exp(acs) and the state weights w_s = exp(acs_end - acs_s) dt_s;
// then
//   phase Y: each warp takes 16-row tiles of y (tiles i and 7 - i go to
//     one warp, so the causal work is even), starts from C.st^T (the old
//     state is kept in the output tensor, its home, and staged into
//     shared memory 64 columns of S at a time: at S <= 64 once, before
//     the chunk's first barrier), scales its rows by exp(acs_t), and adds
//     M.x with M[t][s] = G[t][s] exp(acs_t - acs_s) dt_s formed per
//     fragment element; the mask comes before the exp: for s > t the
//     exponent is -inf, so exp(acs_t - acs_s) of a future step is never
//     evaluated;
//   phase S: each warp takes 16 rows of st^T, starts from exp(acs_end)
//     st and adds (B^T w).x, the weights folded into B^T's fragment, and
//     writes them back.  It touches only the output's elements each of
//     its threads owns, so at S <= 64 no barrier stands between the two
//     phases: a warp done with its rows of y goes on to its rows of st.
// The first chunk has no state: both phases skip it.  Ragged shapes are
// zero-filled: rows past the chunk's length, hd and S columns past their
// ends, in the scratch and in shared memory; a padded step has dt = 0, so
// it neither decays nor adds, as JAX's zero padding gives.  expf, not
// __expf, and no fast-math: the f32 tolerance of the JAX suite (1e-3)
// has to hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <cmath>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kMinBlocks = 4;   // CTAs per SM the register budget keeps
constexpr int kMaxChunk = 128;  // warp 0's cumsum: 4 steps a lane
constexpr int kSlab = 64;       // columns of hd per scan CTA
constexpr int kSTile = 64;      // columns of S per staged tile (first launch)
constexpr int kLdS = kSTile + 4;  // padded: fragment reads hit 32 banks

// Where the fragments of one (row, chunk) lie in the scratch.  A slot is
// one m16n8k8 A operand, 32 lanes x float4 (a0..a3); rt 16-row tiles of
// a chunk, ks64 8-wide k-steps over S and qs 16-row tiles over S, both
// padded to S tiles of 64.  With bf16 x, G and B^T are m16n8k16 A
// operands instead (a0..a7, two float4s a lane), each in the two slots
// of its key tiles 2 kk and 2 kk + 1.
struct Layout {
  int rt, nc, ks64, qs;
  long long per_chunk;
  // G = C.B^T, row tile i, key tile kt (8 wide), kt < 2 (i + 1)
  __host__ __device__ long long g_off(int i, int kt) const {
    return (long long)i * (i + 1) + kt;
  }
  // C as the A operand of C.st^T: row tile i, k-step ks over S
  __host__ __device__ long long c_off(int i, int ks) const {
    return (long long)rt * (rt + 1) + (long long)i * ks64 + ks;
  }
  // B^T as the A operand of (B^T w).x: row tile q over S, key tile kt
  __host__ __device__ long long bt_off(int q, int kt) const {
    return (long long)rt * (rt + 1) + (long long)rt * ks64 +
           (long long)q * 2 * rt + kt;
  }
};

Layout make_layout(int L, int S, int chunk) {
  Layout lay;
  const int stiles = (S + kSTile - 1) / kSTile;
  lay.rt = (chunk + 15) / 16;
  lay.nc = (L + chunk - 1) / chunk;
  lay.ks64 = stiles * (kSTile / 8);
  lay.qs = stiles * (kSTile / 16);
  lay.per_chunk = (long long)lay.rt * (lay.rt + 1) +
                  (long long)lay.rt * lay.ks64 +
                  (long long)lay.qs * 2 * lay.rt;
  return lay;
}

long long scratch_floats(int B, const Layout& lay) {
  return (long long)B * lay.nc * lay.per_chunk * 32 * 4;
}

size_t cb_smem_bytes(int rt) {
  return sizeof(float) * ((size_t)16 * kLdS + (size_t)16 * rt * kLdS +
                          (size_t)16 * (16 * rt + 4));
}

template <typename T>
int x_ld(int hd) {   // x row stride in shared memory: hd padded, + 16 bytes
  return 8 * ((std::min(hd, kSlab) + 7) / 8) + 16 / (int)sizeof(T);
}

template <typename T>
size_t scan_smem_bytes(int rt, int hd) {   // x ring, state tile, 5 vectors
  const size_t lp = 16 * (size_t)rt;
  const size_t hdp = 8 * ((std::min(hd, kSlab) + 7) / 8);
  return 2 * lp * x_ld<T>(hd) * sizeof(T) +
         sizeof(float) * (hdp * kLdS + 5 * lp);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (4) bytes global -> shared without blocking; !valid zero-fills the
// destination and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// TF32 rounding to nearest (ties away), kept in an f32 container whose
// low 13 bits are 0; v = hi + lo to within 2^-21 |v|
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(float4 v, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(v.x, hi[0], lo[0]);
  split(v.y, hi[1], lo[1]);
  split(v.z, hi[2], lo[2]);
  split(v.w, hi[3], lo[3]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b at f32 accuracy: the small products first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(d, al, h0, h1);
  mma(d, ah, l0, l1);
  mma(d, ah, h0, h1);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (a, b) = hi + mid + lo, three bf16 pairs: 24 bits of each, f32 accuracy
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 fh = __bfloat1622float2(h);
  const float ra = a - fh.x, rb = b - fh.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 fm = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(ra - fm.x, rb - fm.y));
}
// the A fragment of m16n8k16 from its 8 f32 values (a0..a7), in 3 parts
struct A3 {
  uint32_t hi[4], mid[4], lo[4];
};
__device__ __forceinline__ A3 split3x8(float4 u, float4 v) {
  A3 a;
  split3(u.x, u.y, a.hi[0], a.mid[0], a.lo[0]);
  split3(u.z, u.w, a.hi[1], a.mid[1], a.lo[1]);
  split3(v.x, v.y, a.hi[2], a.mid[2], a.lo[2]);
  split3(v.z, v.w, a.hi[3], a.mid[3], a.lo[3]);
  return a;
}
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a x for a bf16 x (exact): three passes, the small parts first
__device__ __forceinline__ void mma16x3(float (&d)[4], const A3& a,
                                        uint32_t b0, uint32_t b1) {
  mma16(d, a.lo, b0, b1);
  mma16(d, a.mid, b0, b1);
  mma16(d, a.hi, b0, b1);
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
// d[j] += a x[16 kk .. 16 kk + 16][8 j .. 8 j + 8] for the n-tiles j < nt
// of a bf16 x in shared memory (row stride ldx): B fragments of two
// n-tiles per ldmatrix.trans (keys +0 / +8 of tile j, then of j + 1)
__device__ __forceinline__ void mma_x16(float (&d)[8][4], const A3& a,
                                        const __nv_bfloat16* X, int ldx,
                                        int kk, int nt, int lane) {
  const int mat = lane >> 3;
  const __nv_bfloat16* row =
      X + (16 * kk + (mat & 1) * 8 + (lane & 7)) * ldx + (mat >> 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    if (j < nt) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, smem_u32(row + 8 * j));
      mma16x3(d[j], a, bv[0], bv[1]);
      if (j + 1 < nt) mma16x3(d[j + 1], a, bv[2], bv[3]);
    }
  }
}

// rows [0, nrows) x columns [s0, s0 + 64) of a (rows, S) f32 array into
// shared memory (row stride kLdS); rows >= valid and columns >= S are 0
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long row, int nrows,
                                           int valid, int s0, int S,
                                           bool vec) {
  if (vec) {   // S % 4 == 0, 16-byte aligned base
    for (int e = threadIdx.x; e < nrows * (kSTile / 4); e += kThreads) {
      const int r = e / (kSTile / 4), col = 4 * (e % (kSTile / 4));
      const bool ok = r < valid && s0 + col < S;
      cp_async16(smem_u32(dst + r * kLdS + col),
                 ok ? src + (row + r) * S + s0 + col : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * kSTile; e += kThreads) {
      const int r = e / kSTile, col = e % kSTile;
      dst[r * kLdS + col] =
          r < valid && s0 + col < S ? src[(row + r) * S + s0 + col] : 0.f;
    }
  }
}

// First launch: CTA (i, c, b) forms rows [16 i, 16 i + 16) of G = C.B^T
// for chunk c of row b, keys up to the band's diagonal (2 (i + 1) 8-wide
// key tiles, a warp taking every fourth), S tile by S tile; on the way
// it writes the A fragments of C (its row tile) and of B^T (key tiles
// 2 i and 2 i + 1).  Row tiles wholly past the chunk's length exit.
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float4* __restrict__ frags, Layout lay, int L, int S,
              int chunk, int vec, int k16) {
  extern __shared__ __align__(16) float smem[];
  // the scan may start now: its prologue reads no fragment (it waits for
  // this grid's end before its first one)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int i = blockIdx.x % lay.rt, c = blockIdx.x / lay.rt;
  const int b = blockIdx.y;
  const int t0 = c * chunk, Lc = min(chunk, L - t0);
  if (16 * i >= Lc) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int nkt = 2 * (i + 1);
  const int ldg = 16 * lay.rt + 4;
  float* sC = smem;                       // [16][kLdS]       C, band rows
  float* sB = sC + 16 * kLdS;             // [16 rt][kLdS]    B, rows 0..
  float* sG = sB + 16 * lay.rt * kLdS;    // [16][16 rt + 4]  the G band
  const long long row0 = (long long)b * L + t0;
  float4* F = frags + ((long long)b * lay.nc + c) * lay.per_chunk * 32;
  float acc[4][4] = {};
  for (int s0 = 0; s0 < S; s0 += kSTile) {
    stage_rows(sC, Cm, row0 + 16 * i, 16, Lc - 16 * i, s0, S, vec);
    stage_rows(sB, Bm, row0, 16 * (i + 1), Lc, s0, S, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kSTile / 8; ++ks) {
      const float* ca = sC + g * kLdS + 8 * ks + tq;
      uint32_t ah[4], al[4];
      split4(make_float4(ca[0], ca[8 * kLdS], ca[4], ca[8 * kLdS + 4]), ah,
             al);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kt = warp + 4 * u;
        if (kt < nkt) {
          const float* br = sB + (8 * kt + g) * kLdS + 8 * ks + tq;
          mma3(acc[u], ah, al, br[0], br[4]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int ks = 2 * warp + v;
      const float* ca = sC + g * kLdS + 8 * ks + tq;
      F[lay.c_off(i, s0 / 8 + ks) * 32 + lane] =
          make_float4(ca[0], ca[8 * kLdS], ca[4], ca[8 * kLdS + 4]);
    }
    // B^T[n][s] = B[s][n]: rows n = s0 + 16 warp + (g, g + 8), keys
    // s = 16 i + ...: as two m16n8k8 A fragments, or one of m16n8k16
    // (a0..a7 in two float4s of its lane) over both 8-key slots
    float4* fb = F + lay.bt_off(s0 / 16 + warp, 2 * i) * 32;
    if (k16) {
      const float* r0 = sB + (16 * i + 2 * tq) * kLdS + 16 * warp + g;
      const float* r8 = r0 + 8 * kLdS;
      fb[2 * lane] = make_float4(r0[0], r0[kLdS], r0[8], r0[kLdS + 8]);
      fb[2 * lane + 1] = make_float4(r8[0], r8[kLdS], r8[8], r8[kLdS + 8]);
    } else {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float* r0 = sB + (16 * i + 8 * v + tq) * kLdS + 16 * warp + g;
        const float* r1 = r0 + 4 * kLdS;
        fb[32 * v + lane] = make_float4(r0[0], r0[8], r1[0], r1[8]);
      }
    }
    __syncthreads();
  }
  // the G band, accumulator layout -> shared -> A-fragment order
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int kt = warp + 4 * u;
    if (kt < nkt) {
      float* p = sG + g * ldg + 8 * kt + 2 * tq;
      p[0] = acc[u][0];
      p[1] = acc[u][1];
      p[8 * ldg] = acc[u][2];
      p[8 * ldg + 1] = acc[u][3];
    }
  }
  __syncthreads();
  if (k16) {   // m16n8k16 fragments over key tiles 2 kk, 2 kk + 1
    for (int kk = warp; kk < i + 1; kk += 4) {
      const float* p = sG + g * ldg + 16 * kk + 2 * tq;
      float4* f = F + lay.g_off(i, 2 * kk) * 32 + 2 * lane;
      f[0] = make_float4(p[0], p[1], p[8 * ldg], p[8 * ldg + 1]);
      f[1] = make_float4(p[8], p[9], p[8 * ldg + 8], p[8 * ldg + 9]);
    }
  } else {
    for (int kt = warp; kt < nkt; kt += 4) {
      const float* p = sG + g * ldg + 8 * kt + tq;
      F[lay.g_off(i, kt) * 32 + lane] =
          make_float4(p[0], p[8 * ldg], p[4], p[8 * ldg + 4]);
    }
  }
}

// x rows [0, lp) of one chunk (its own dtype, columns [d0, d0 + hdp) of
// head hh) and dt into one stage of the ring; rows >= Lc and columns >=
// hdt are 0
template <typename T>
__device__ __forceinline__ void stage_chunk(T* sx, float* sdt, const T* x,
                                            const float* dt, long long row0,
                                            int Lc, int lp, int H, int hh,
                                            int hd, int d0, int hdt, int hdp,
                                            int ldx, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {   // hd * sizeof(T) % 16 == 0, 16-byte aligned base
    const int per = hdp / kVec;
    for (int e = threadIdx.x; e < lp * per; e += kThreads) {
      const int r = e / per, col = kVec * (e % per);
      const bool ok = r < Lc && col < hdt;
      cp_async16(smem_u32(sx + r * ldx + col),
                 ok ? x + ((row0 + r) * H + hh) * hd + d0 + col : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < lp * hdp; e += kThreads) {
      const int r = e / hdp, col = e % hdp;
      sx[r * ldx + col] = r < Lc && col < hdt
                              ? x[((row0 + r) * H + hh) * hd + d0 + col]
                              : zero<T>();
    }
  }
  for (int r = threadIdx.x; r < lp; r += kThreads)
    cp_async4(smem_u32(sdt + r), r < Lc ? dt + (row0 + r) * H + hh : dt,
              r < Lc);
}

// columns [n0, n0 + 64) of the old state's rows d0 .. d0 + hdp of one
// (row, head) into shared memory, [d][kLdS]; rows >= hdt and columns >= S
// are 0.  Read through L2 (ld.global.cg): this CTA wrote them.
__device__ __forceinline__ void stage_state(float* sst, const float* st,
                                            int n0, int hd, int d0, int hdt,
                                            int hdp, int S) {
  if (S % 4 == 0) {   // 16-byte rows (the output is 256-byte aligned)
    for (int e = threadIdx.x; e < hdp * (kSTile / 4); e += kThreads) {
      const int dl = e / (kSTile / 4), col = 4 * (e % (kSTile / 4));
      const bool ok = dl < hdt && n0 + col < S;
      *reinterpret_cast<float4*>(sst + dl * kLdS + col) =
          ok ? __ldcg(reinterpret_cast<const float4*>(
                   st + (long long)(d0 + dl) * S + n0 + col))
             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < hdp * kSTile; e += kThreads) {
      const int dl = e / kSTile, col = e % kSTile;
      sst[dl * kLdS + col] = dl < hdt && n0 + col < S
                                 ? __ldcg(st + (long long)(d0 + dl) * S + n0 + col)
                                 : 0.f;
    }
  }
}

// columns o and o + 1 of a row whose first dlim columns exist; a row
// start at an even column of an even-width row is 8-byte aligned
__device__ __forceinline__ void store2(float* p, float v0, float v1, int o,
                                       int dlim) {
  if (o + 1 < dlim && !(dlim & 1)) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (o < dlim) p[0] = v0;
    if (o + 1 < dlim) p[1] = v1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_scan_mma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ Avec,
                    const float4* __restrict__ frags, float* __restrict__ y,
                    float* state, Layout lay, int L, int H, int hd, int S,
                    int chunk, int nslab, int hdp, int ldx, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hh = blockIdx.x / nslab, d0 = kSlab * (blockIdx.x % nslab);
  const int b = blockIdx.y;
  const int hdt = min(kSlab, hd - d0), nt = (hdt + 7) / 8;
  const int dlim = hdt - 2 * (threadIdx.x % 4);   // columns from 2 tq on
  const int lp = 16 * lay.rt;
  T* sX = reinterpret_cast<T*>(smem_raw);                      // [2][lp][ldx]
  float* sST = reinterpret_cast<float*>(sX + 2 * lp * ldx);    // [hdp][kLdS]
  float* sdt = sST + hdp * kLdS;                               // [2][lp]
  float* sacs = sdt + 2 * lp;   // [lp] inclusive cumsum of dt A
  float* sea = sacs + lp;       // [lp] exp(acs)
  float* sw = sea + lp;         // [lp] exp(acs_end - acs_s) dt_s
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const float A = __ldg(Avec + hh);
  // the state's home is the output: read back through L2 (ld.global.cg),
  // never through the non-coherent path, since this CTA writes it
  const long long st0 = ((long long)b * H + hh) * hd * S;
  const long long rowb = (long long)b * L;
  const int nks = (S + 7) / 8, nq = (S + 15) / 16;
  const int nst = (S + kSTile - 1) / kSTile;

  stage_chunk(sX, sdt, x, dt, rowb, min(chunk, L), lp, H, hh, hd, d0, hdt,
              hdp, ldx, vec);
  cp_async_commit();
#pragma unroll 1
  for (int c = 0; c < lay.nc; ++c) {
    const int t0 = c * chunk, Lc = min(chunk, L - t0);
    if (c + 1 < lay.nc) {   // the next chunk flies while this one computes
      const int nb = (c + 1) & 1;
      stage_chunk(sX + nb * lp * ldx, sdt + nb * lp, x, dt, rowb + t0 + chunk,
                  min(chunk, L - t0 - chunk), lp, H, hh, hd, d0, hdt, hdp,
                  ldx, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* X = sX + (c & 1) * lp * ldx;
    const float* DT = sdt + (c & 1) * lp;
    if (warp == 0) {   // inclusive cumsum of dt * A, 4 steps a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        run += t < lp ? DT[t] * A : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        if (t < lp) {
          sacs[t] = v[k] + excl;
          sea[t] = expf(v[k] + excl);
        }
      }
      __syncwarp();
      const float aend = sacs[Lc - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        if (t < lp) sw[t] = expf(aend - sacs[t]) * DT[t];
      }
    }
    const bool carry = c > 0;   // the first chunk starts from st = 0
    if (carry && nst == 1)
      stage_state(sST, state + st0, 0, hd, d0, hdt, hdp, S);
    __syncthreads();
    // the C.B^T launch has written every fragment (and its writes are
    // visible) once this returns; later chunks pass at once
    if (c == 0) asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const float4* Fc0 =
        frags + ((long long)b * lay.nc + c) * lay.per_chunk * 32;
    const float4* Fc = Fc0 + lane;
    const int nrt = (Lc + 15) / 16, nkc = (Lc + 7) / 8;

    // ---- phase Y: y = exp(acs_t) (C . st^T) + M . x, 16 rows a tile, in
    // one or two rounds: warp w takes tile w, then tile 7 - w (so the
    // causal work is even)
    const int rounds = nrt > 4 ? 2 : 1;
#pragma unroll 1
    for (int rd = 0; rd < rounds; ++rd) {
      const int i = rd == 0 ? warp : 7 - warp;
      const bool mine = i < nrt;
      float acc[8][4] = {};
      const int ra = 16 * i + g, rb = ra + 8;
      if (carry) {
#pragma unroll 1
        for (int tile = 0; tile < nst; ++tile) {
          if (nst > 1) {   // one 64-column tile of the old state at a time
            __syncthreads();
            stage_state(sST, state + st0, kSTile * tile, hd, d0, hdt, hdp,
                        S);
            __syncthreads();
          }
          const int nk = min(kSTile / 8, nks - tile * (kSTile / 8));
          if (!mine) continue;
          float4 next = __ldg(Fc + lay.c_off(i, tile * (kSTile / 8)) * 32);
#pragma unroll 1
          for (int ks = 0; ks < nk; ++ks) {
            uint32_t ah[4], al[4];
            split4(next, ah, al);
            if (ks + 1 < nk)
              next = __ldg(Fc + lay.c_off(i, tile * (kSTile / 8) + ks + 1) *
                                    32);
            // st^T[n][d] = st[d][n]: rows d of the slab, n = 8 ks + tq
            const float* p = sST + g * kLdS + 8 * ks + tq;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j < nt) mma3(acc[j], ah, al, p[8 * j * kLdS],
                               p[8 * j * kLdS + 4]);
          }
        }
        if (!mine) continue;
        const float ea = sea[ra], eb = sea[rb];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[j][0] *= ea;
          acc[j][1] *= ea;
          acc[j][2] *= eb;
          acc[j][3] *= eb;
        }
      }
      if (!mine) continue;
      const float aa = sacs[ra], ab = sacs[rb];
      if constexpr (sizeof(T) == 2) {
        // M.x as m16n8k16: key tiles of 16, x's B fragments by
        // ldmatrix.trans, M in three bf16 parts
        const float4* Fg = Fc0 + 2 * lane;
        float4 nu = __ldg(Fg + lay.g_off(i, 0) * 32);
        float4 nv = __ldg(Fg + lay.g_off(i, 0) * 32 + 1);
#pragma unroll 1
        for (int kk = 0; kk <= i; ++kk) {
          // G at rows (ra, rb) x keys (c, c + 1, c + 8, c + 9)
          const float4 gu = nu, gv = nv;
          if (kk < i) {
            nu = __ldg(Fg + lay.g_off(i, 2 * kk + 2) * 32);
            nv = __ldg(Fg + lay.g_off(i, 2 * kk + 2) * 32 + 1);
          }
          const int c0 = 16 * kk + 2 * tq;
          const float2 ca = *reinterpret_cast<const float2*>(sacs + c0);
          const float2 cb = *reinterpret_cast<const float2*>(sacs + c0 + 8);
          const float2 da = *reinterpret_cast<const float2*>(DT + c0);
          const float2 db = *reinterpret_cast<const float2*>(DT + c0 + 8);
          // mask before exp: the decay of s > t is never evaluated
          const float4 mu = make_float4(
              gu.x * expf(c0 <= ra ? aa - ca.x : -INFINITY) * da.x,
              gu.y * expf(c0 + 1 <= ra ? aa - ca.y : -INFINITY) * da.y,
              gu.z * expf(c0 <= rb ? ab - ca.x : -INFINITY) * da.x,
              gu.w * expf(c0 + 1 <= rb ? ab - ca.y : -INFINITY) * da.y);
          const float4 mv = make_float4(
              gv.x * expf(c0 + 8 <= ra ? aa - cb.x : -INFINITY) * db.x,
              gv.y * expf(c0 + 9 <= ra ? aa - cb.y : -INFINITY) * db.y,
              gv.z * expf(c0 + 8 <= rb ? ab - cb.x : -INFINITY) * db.x,
              gv.w * expf(c0 + 9 <= rb ? ab - cb.y : -INFINITY) * db.y);
          mma_x16(acc, split3x8(mu, mv), X, ldx, kk, nt, lane);
        }
      } else {
        const int nkt = min(2 * i + 2, nkc);
        float4 next = __ldg(Fc + lay.g_off(i, 0) * 32);
#pragma unroll 1
        for (int kt = 0; kt < nkt; ++kt) {
          // G[ra][sa], G[rb][sa], G[ra][sb], G[rb][sb]
          const float4 gv = next;
          if (kt + 1 < nkt) next = __ldg(Fc + lay.g_off(i, kt + 1) * 32);
          const int sa = 8 * kt + tq, sb = sa + 4;
          const float ca = sacs[sa], cb = sacs[sb], da = DT[sa], db = DT[sb];
          // mask before exp: the decay of s > t is never evaluated
          float4 mv;
          mv.x = gv.x * expf(sa <= ra ? aa - ca : -INFINITY) * da;
          mv.y = gv.y * expf(sa <= rb ? ab - ca : -INFINITY) * da;
          mv.z = gv.z * expf(sb <= ra ? aa - cb : -INFINITY) * db;
          mv.w = gv.w * expf(sb <= rb ? ab - cb : -INFINITY) * db;
          uint32_t ah[4], al[4];
          split4(mv, ah, al);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j < nt)
              mma3(acc[j], ah, al, X[sa * ldx + 8 * j + g],
                   X[sb * ldx + 8 * j + g]);
        }
      }
      // rows ra, rb of y from this thread's first column on; n-tile j
      // is 8 j columns on, and dlim columns are left before hd ends
      float* ya = y + ((rowb + t0 + ra) * H + hh) * hd + d0 + 2 * tq;
      float* yb = ya + (long long)8 * H * hd;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (ra < Lc) store2(ya + 8 * j, acc[j][0], acc[j][1], 8 * j, dlim);
        if (rb < Lc) store2(yb + 8 * j, acc[j][2], acc[j][3], 8 * j, dlim);
      }
    }
    // phase Y read the old state from shared memory, phase S reads and
    // writes the output's own elements: only restaged tiles need a barrier
    if (carry && nst > 1) __syncthreads();

    // ---- phase S: st^T = exp(acs_end) st^T + B^T . (w x), 16 rows a tile
    const float dec = expf(sacs[Lc - 1]);
#pragma unroll 1
    for (int q = warp; q < nq; q += 4) {
      float acc[8][4] = {};
      const int na = 16 * q + g;
      const bool aok = na < S, bok = na + 8 < S;
      // st[d][na] for d = d0 + 2 tq + 8 j (+ 1); rows na + 8 are 8 on
      float* ps = state + st0 + (long long)(d0 + 2 * tq) * S + na;
      if (carry) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* p = ps + 8 * j * S;
          const bool c0 = 8 * j < dlim, c1 = 8 * j + 1 < dlim;
          acc[j][0] = c0 && aok ? dec * __ldcg(p) : 0.f;
          acc[j][1] = c1 && aok ? dec * __ldcg(p + S) : 0.f;
          acc[j][2] = c0 && bok ? dec * __ldcg(p + 8) : 0.f;
          acc[j][3] = c1 && bok ? dec * __ldcg(p + S + 8) : 0.f;
        }
      }
      if constexpr (sizeof(T) == 2) {
        // (B^T w).x as m16n8k16 over keys of 16, B^T w in three bf16 parts
        const float4* Fb = Fc0 + 2 * lane;
        float4 nu = __ldg(Fb + lay.bt_off(q, 0) * 32);
        float4 nv = __ldg(Fb + lay.bt_off(q, 0) * 32 + 1);
#pragma unroll 1
        for (int kk = 0; kk < nrt; ++kk) {
          // B^T at rows (na, na + 8) x keys (c, c + 1, c + 8, c + 9)
          const float4 bu = nu, bv = nv;
          if (kk + 1 < nrt) {
            nu = __ldg(Fb + lay.bt_off(q, 2 * kk + 2) * 32);
            nv = __ldg(Fb + lay.bt_off(q, 2 * kk + 2) * 32 + 1);
          }
          const int c0 = 16 * kk + 2 * tq;
          const float2 wa = *reinterpret_cast<const float2*>(sw + c0);
          const float2 wb = *reinterpret_cast<const float2*>(sw + c0 + 8);
          mma_x16(acc,
                  split3x8(make_float4(bu.x * wa.x, bu.y * wa.y, bu.z * wa.x,
                                       bu.w * wa.y),
                           make_float4(bv.x * wb.x, bv.y * wb.y, bv.z * wb.x,
                                       bv.w * wb.y)),
                  X, ldx, kk, nt, lane);
        }
      } else {
        float4 next = __ldg(Fc + lay.bt_off(q, 0) * 32);
#pragma unroll 1
        for (int kt = 0; kt < nkc; ++kt) {
          // B^T[n][s] w_s for n = na, na + 8 and s = sa, sb: the weights
          // ride on the A operand, so x stays as it is
          const float4 bt = next;
          if (kt + 1 < nkc) next = __ldg(Fc + lay.bt_off(q, kt + 1) * 32);
          const int sa = 8 * kt + tq, sb = sa + 4;
          const float wa = sw[sa], wb = sw[sb];
          uint32_t ah[4], al[4];
          split4(make_float4(bt.x * wa, bt.y * wa, bt.z * wb, bt.w * wb), ah,
                 al);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j < nt)
              mma3(acc[j], ah, al, X[sa * ldx + 8 * j + g],
                   X[sb * ldx + 8 * j + g]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* p = ps + 8 * j * S;
        const bool c0 = 8 * j < dlim, c1 = 8 * j + 1 < dlim;
        if (c0 && aok) p[0] = acc[j][0];
        if (c1 && aok) p[S] = acc[j][1];
        if (c0 && bok) p[8] = acc[j][2];
        if (c1 && bok) p[S + 8] = acc[j][3];
      }
    }
    __syncthreads();   // the new state and the free stage, for chunk c + 1
  }
}

// Once per device and kernel: the opt-in shared memory and the largest
// shared-memory carveout, so 4 CTAs fit an SM (attribute calls kept off
// the per-launch path).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

std::atomic<unsigned long long> g_cb_ready{0};

template <typename T>
std::atomic<unsigned long long>& scan_ready() {
  static std::atomic<unsigned long long> done{0};
  return done;
}

template <typename T>
int launch(const void* x, const void* Bm, const void* Cm, const void* dt,
           const void* A, void* y, void* state, void* scratch,
           long long scratch_len, int B, int L, int H, int hd, int S,
           int chunk, cudaStream_t stream) {
  cudaError_t err = prepare(ssd_cb_kernel, g_cb_ready);
  if (err != cudaSuccess) return (int)err;
  err = prepare(ssd_scan_mma_kernel<T>, scan_ready<T>());
  if (err != cudaSuccess) return (int)err;
  const Layout lay = make_layout(L, S, chunk);
  if (scratch_len < scratch_floats(B, lay)) return (int)cudaErrorInvalidValue;
  const bool vec_bc = S % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(Bm) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(Cm) % 16 == 0;
  ssd_cb_kernel<<<dim3((unsigned)(lay.rt * lay.nc), (unsigned)B), kThreads,
                  cb_smem_bytes(lay.rt), stream>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float4*>(scratch), lay, L, S, chunk, (int)vec_bc,
      (int)(sizeof(T) == 2));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nslab = (hd + kSlab - 1) / kSlab;
  const int hdp = 8 * ((std::min(hd, kSlab) + 7) / 8);
  const bool vec_x = (hd * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // programmatic dependent launch: the scan's CTAs start while the C.B^T
  // grid runs, stage their first chunk and its cumsum, and wait
  // (griddepcontrol.wait) before they read a fragment
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(H * nslab), (unsigned)B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = scan_smem_bytes<T>(lay.rt, hd);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, ssd_scan_mma_kernel<T>, static_cast<const T*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float4*>(scratch), static_cast<float*>(y),
      static_cast<float*>(state), lay, L, H, hd, S, chunk, nslab, hdp,
      x_ld<T>(hd), (int)vec_x);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int geometry(int B, int L, int H, int hd, int S, int chunk, long long* out) {
  cudaError_t err = prepare(ssd_scan_mma_kernel<T>, scan_ready<T>());
  if (err != cudaSuccess) return (int)err;
  const Layout lay = make_layout(L, S, chunk);
  const size_t smem = scan_smem_bytes<T>(lay.rt, hd);
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, ssd_scan_mma_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, ssd_scan_mma_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  out[0] = scratch_floats(B, lay);
  out[1] = (long long)smem;
  out[2] = (long long)cb_smem_bytes(lay.rt);
  out[3] = (long long)H * ((hd + kSlab - 1) / kSlab);
  out[4] = B;
  out[5] = (long long)lay.rt * lay.nc;
  out[6] = ctas;
  out[7] = attr.numRegs;
  out[8] = (long long)attr.localSizeBytes;
  return 0;
}

bool valid_shape(int B, int L, int H, int hd, int S, int chunk) {
  return B > 0 && B <= 65535 && L > 0 && H > 0 && hd > 0 && S > 0 &&
         chunk >= 1 && chunk <= kMaxChunk;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x only; Bm, Cm, dt, A, y and state are
// float32).  x (B, L, H, hd), Bm/Cm (B, L, S), dt (B, L, H), A (H,), y
// (B, L, H, hd), state (B, H, hd, S); all contiguous.  scratch: at least
// geometry's out[0] floats, 16-byte aligned.  1 <= chunk <= 128, B, L, H,
// hd, S > 0, B <= 65535.  Two launches on the stream (C.B^T, then the
// scan).  Returns the cudaError_t of the launches.
extern "C" int ssd_scan_mma_launch(int dtype, const void* x, const void* Bm,
                                   const void* Cm, const void* dt,
                                   const void* A, void* y, void* state,
                                   void* scratch, long long scratch_len,
                                   int B, int L, int H, int hd, int S,
                                   int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_shape(B, L, H, hd, S, chunk) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, Bm, Cm, dt, A, y, state, scratch, scratch_len, B,
                         L, H, hd, S, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, Bm, Cm, dt, A, y, state, scratch,
                                 scratch_len, B, L, H, hd, S, chunk, st);
  return (int)cudaErrorInvalidValue;
}

// The launch at these shapes, as the card runs it: out[0] scratch floats,
// [1] scan shared memory bytes a CTA, [2] the C.B^T launch's, [3], [4]
// the scan grid, [5] the C.B^T grid's x (its y is B), [6] scan CTAs an SM
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), [7] registers a
// thread and [8] local (spill) bytes of the scan kernel.
extern "C" int ssd_scan_mma_geometry(int dtype, int B, int L, int H, int hd,
                                     int S, int chunk, long long* out) {
  if (!valid_shape(B, L, H, hd, S, chunk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return geometry<float>(B, L, H, hd, S, chunk, out);
  if (dtype == 1) return geometry<__nv_bfloat16>(B, L, H, hd, S, chunk, out);
  return (int)cudaErrorInvalidValue;
}
