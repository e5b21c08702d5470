// RAO scatter-add (the paper's fetch-and-add over rows) for Hopper
// (sm_90a), one launch with the f32 sums on chip: table[idx[m], :] +=
// vals[m, :] for m in [0, M), bf16 table and vals, in place.  On the MoE
// path this is the gated combine: every dispatch row's expert output
// lands on its token's row, and all padding rows land on the pad row
// N - 1 (with dropless routing 80% of a chunk tick's updates).
//
// Replaces the TPU kernel src/repro/kernels/rao_scatter.py
// (rao_scatter_add -> _kernel, the pl.pallas_call over grid (M / bm,) with
// the table aliased in and out).  It takes every bf16 card call of
// ops.rao_scatter_add; csrc/rao_scatter.cu (f32 atomics in the L2; for
// bf16 three launches around an N x D f32 scratch) keeps the f32 calls
// and stays in the library for comparison.
//
// Bound on this card: HBM bytes — vals (M x D) and idx read once, the
// table (N x D) read and written once, for one add per value read.
//
// Contract (kernels/ref.py rao_scatter_add, the MoE combine): duplicate
// ids are summed; each row's sum is taken in f32 over the table's old
// value and every update and rounded to bf16 once; ids outside [0, N)
// are dropped.
//
// Design: a grid of thread-block clusters (ops.rao_scatter_onchip_geometry
// picks the sizes).  A cluster owns one tile of ``rows`` table rows by
// ``cols`` columns; its ``split`` CTAs take equal, contiguous parts of the
// M updates:
//   * each CTA keeps an f32 slab of the tile in shared memory (cols
//     floats a row), zeroed at the start — the sums never leave the chip,
//     and no N x D scratch exists;
//   * a CTA is 256 threads (small calls) or 512 (large ones): cols / 8
//     lanes (16-byte loads of vals, 8 bf16 a load) times threads / lanes
//     groups; each group walks its own
//     contiguous run of updates, 4 at a time (4 idx and 4 vals loads in
//     flight, vals streamed past L1), sums runs of equal row ids in
//     registers and adds a run into the slab with one shared-memory atomic
//     per column (a compare-and-swap loop on this card), the 8 groups of a
//     warp rotated onto 32 distinct banks.  Runs are long exactly where
//     contention is worst (the pad row, CENTRAL), so a hot row costs few
//     atomics and is spread over every group of every CTA of the cluster,
//     never serialised on one owner;
//   * after one cluster.sync() CTA r of the cluster owns an equal share of
//     the tile's rows: per 4 columns it loads every peer's slab through
//     distributed shared memory (all loads in flight, then summed in rank
//     order, so the merge order is fixed), adds the table's old value
//     (loaded before the walk) and rounds to bf16 once; a second
//     cluster.sync() keeps every slab alive until its peers have read it;
//   * more rows than one slab holds take several row tiles; a CTA then
//     loads the vals of its own rows only (the idx of its part are read
//     by every row tile);
//   * where D is not a multiple of 8 or a base is not 16-byte aligned, a
//     lane takes one column (2-byte loads) and a tile 32 columns.
// Within a CTA the f32 adds into one slab cell arrive in the order the
// atomics land, so the last bits of a sum can differ from run to run (and
// from the plain version), within f32 rounding.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kUnroll = 4;          // updates a group has in flight
constexpr int kMaxSplit = 8;        // CTAs a cluster (portable size)
constexpr int kSmemMax = 232448;    // opt-in shared memory of one CTA

// kV columns of bf16: 16 bytes (kV = 8) or one element
template <int kV> struct Cols;
template <> struct Cols<8> {
  using Raw = uint4;
  using Quad = uint2;               // 4 columns of the merge
  static __device__ void add(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] += v.x;
      f[2 * i + 1] += v.y;
    }
  }
  static __device__ Raw pack(const float* f) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return r;
  }
  static __device__ float4 widen(const Quad& q) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ Quad narrow(const float4& f) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f.x, f.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.z, f.w);
    return make_uint2(*reinterpret_cast<const unsigned*>(&a),
                      *reinterpret_cast<const unsigned*>(&b));
  }
  static __device__ float4 slab(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};
template <> struct Cols<1> {
  using Raw = bf16;
  using Quad = bf16;                // 1 column of the merge
  static __device__ void add(const Raw& r, float* f) {
    f[0] += __bfloat162float(r);
  }
  static __device__ float4 widen(const Quad& q) {
    return make_float4(__bfloat162float(q), 0.f, 0.f, 0.f);
  }
  static __device__ Quad narrow(const float4& f) {
    return __float2bfloat16(f.x);
  }
  static __device__ float4 slab(const float* p) {
    return make_float4(*p, 0.f, 0.f, 0.f);
  }
};

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}


// kTiled: the table takes more than one row tile, so a CTA loads the vals
// of its own rows only (the load then waits for its idx).  kThreads: 256
// (3 CTAs an SM) for small calls, 512 (2 CTAs an SM, 64 registers) for
// large ones, where the wider CTA keeps more loads in flight per slab
template <int kV, bool kTiled, int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == 512 ? 2 : 3)
rao_scatter_onchip_kernel(bf16* __restrict__ table,
                          const int* __restrict__ idx,
                          const bf16* __restrict__ vals, int N, long long M,
                          int D, int cols, int rows, long long per_cta) {
  using C = Cols<kV>;
  using Raw = typename C::Raw;
  using Quad = typename C::Quad;
  constexpr int kQ = kV == 8 ? 4 : 1;       // columns a merge item
  extern __shared__ __align__(16) float slab[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lanes = cols / kV;
  const int groups = kThreads / lanes;
  const int lane = threadIdx.x % lanes;
  const int group = threadIdx.x / lanes;
  const int r0 = (int)(blockIdx.x / split) * rows;
  const int rn = min(rows, N - r0);
  const int c0 = blockIdx.y * cols;

  // the rows this CTA merges, in items of kQ columns, and the old table
  // value of its first item, loaded now so that its latency hides
  const int quads = cols / kQ;
  const int share = (rn + split - 1) / split;
  const int o0 = rank * share;
  const int items = max(0, min(share, rn - o0)) * quads;
  Quad old0{};
  if (threadIdx.x < items && c0 + (int)(threadIdx.x % quads) * kQ < D)
    old0 = *reinterpret_cast<const Quad*>(
        table + (size_t)(r0 + o0 + threadIdx.x / quads) * D + c0 +
        (threadIdx.x % quads) * kQ);

  for (int i = threadIdx.x * 4; i < rn * cols; i += kThreads * 4)
    *reinterpret_cast<float4*>(slab + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // this group's contiguous run of this CTA's part of the updates
  const long long m0 = rank * per_cta;
  const long long mn = max(0LL, min(per_cta, M - m0));
  const long long each = (mn + groups - 1) / groups;
  const long long gb = m0 + min(mn, group * each);
  const long long ge = m0 + min(mn, (group + 1) * each);
  const int col = c0 + lane * kV;
  const bool col_live = col < D;
  // a flush adds column (j + rot) % kV at its j-th atomic: the 8 groups of
  // a warp (4 lanes of 8 columns each) then hit 32 distinct banks, whatever
  // rows they add to (a row is cols = 32 floats, 32 banks); the run's sums
  // are rotated by rot first (a barrel shifter: log2 kV steps of selects)
  const int rot = group % kV;
  int cur = -1;                 // the slab row of the open run; -1: dropped
  float acc[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) acc[j] = 0.f;
  auto flush = [&]() {
    if (cur >= 0 && col_live) {
      float* cell = slab + cur * cols + lane * kV;
#pragma unroll
      for (int s = 1; s < kV; s *= 2) {     // acc[j] <- acc[(j + rot) % kV]
        float t[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j)
          t[j] = rot & s ? acc[(j + s) % kV] : acc[j];
#pragma unroll
        for (int j = 0; j < kV; ++j) acc[j] = t[j];
      }
#pragma unroll
      for (int j = 0; j < kV; ++j) atomicAdd(cell + (j + rot) % kV, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) acc[j] = 0.f;
  };
  for (long long m = gb; m < ge; m += kUnroll) {
    int r[kUnroll];
    Raw v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = m + u < ge ? idx[m + u] : -1;
      r[u] = row >= r0 && row < r0 + rn ? row - r0 : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = Raw{};
      if (m + u < ge && col_live && (!kTiled || r[u] >= 0))   // streamed
        v[u] = __ldcs(reinterpret_cast<const Raw*>(vals + (size_t)(m + u) * D +
                                                   col));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (m + u >= ge) break;
      if (r[u] != cur) {
        flush();
        cur = r[u];
      }
      C::add(v[u], acc);
    }
  }
  flush();

  cluster.sync();               // every slab of the cluster is complete
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int row = o0 + it / quads;
    const int c = c0 + (it % quads) * kQ;
    if (c >= D) continue;
    Quad* dst = reinterpret_cast<Quad*>(table + (size_t)(r0 + row) * D + c);
    const int off = row * cols + (it % quads) * kQ;
    float4 part[kMaxSplit];     // every peer's load in flight at once
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p)
      if (p < split) part[p] = C::slab(cluster.map_shared_rank(slab, p) + off);
    float4 sum = C::widen(it == (int)threadIdx.x ? old0 : *dst);
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p)  // ranks in order: a fixed order
      if (p < split) add4(sum, part[p]);
    *dst = C::narrow(sum);
  }
  cluster.sync();               // no slab is freed while a peer reads it
}

typedef void (*Kernel)(bf16*, const int*, const bf16*, int, long long, int,
                       int, int, long long);

// the instantiation, with its once-per-device shared-memory opt-in
template <int kV, bool kTiled, int kThreads>
cudaError_t instance(Kernel* kernel) {
  static std::atomic<unsigned long long> done{0};
  *kernel = rao_scatter_onchip_kernel<kV, kTiled, kThreads>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(*kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int kV, bool kTiled>
cudaError_t instance_of(int threads, Kernel* kernel) {
  if (threads == 256) return instance<kV, kTiled, 256>(kernel);
  if (threads == 512) return instance<kV, kTiled, 512>(kernel);
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16 only.  table (N, D) is updated in place; idx (M,) int32; vals
// (M, D).  The geometry comes from ops.rao_scatter_onchip_geometry:
// ``vec`` columns a lane (8: 16-byte loads, D % 8 == 0 and 16-byte
// aligned table and vals; or 1), ``cols`` columns a tile (a multiple of
// 32; cols / vec lanes, a power of two dividing 256), ``rows`` rows a
// tile (cols * rows floats of shared memory a CTA), ``split`` CTAs a
// cluster (1-8) sharing the M updates and ``threads`` a CTA (256 or
// 512).  N, M, D > 0.  Returns the cudaError_t of the launch.
extern "C" int rao_scatter_add_onchip_launch(void* table, const void* idx,
                                             const void* vals, int N,
                                             long long M, int D, int vec,
                                             int cols, int rows, int split,
                                             int threads, void* stream) {
  if (N <= 0 || M <= 0 || D <= 0 || rows <= 0 || split < 1 ||
      split > kMaxSplit || cols <= 0 || cols % 32 || (vec != 1 && vec != 8))
    return (int)cudaErrorInvalidValue;
  const int lanes = cols / vec;
  if (lanes > 256 || 256 % lanes ||
      (long long)rows * cols * sizeof(float) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (vec == 8 && (D % 8 || ((uintptr_t)table | (uintptr_t)vals) % 16))
    return (int)cudaErrorInvalidValue;
  const long long row_tiles = (N + rows - 1) / rows;
  const long long col_tiles = (D + cols - 1) / cols;
  if (row_tiles * split > 0x7fffffffLL || col_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const bool tiled = row_tiles > 1;
  Kernel kernel = nullptr;
  cudaError_t err = vec == 8
      ? (tiled ? instance_of<8, true>(threads, &kernel)
               : instance_of<8, false>(threads, &kernel))
      : (tiled ? instance_of<1, true>(threads, &kernel)
               : instance_of<1, false>(threads, &kernel));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(row_tiles * split), (unsigned)col_tiles);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)rows * cols * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const long long per_cta = (M + split - 1) / split;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<bf16*>(table),
                           static_cast<const int*>(idx),
                           static_cast<const bf16*>(vals), N, M, D, cols,
                           rows, per_cta);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
