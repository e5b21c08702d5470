// Grouped expert matmul (the MoE FFN) in bf16 on Hopper's tensor cores
// (sm_90a): out[e] = xe[e] @ w[e] for every expert e, xe (E, C, D),
// w (E, D, F), out (E, C, F), summed in f32 and rounded once to bf16.
// Every row is computed, the zero rows of dropless dispatch padding
// included, as the reference does; no per-expert count enters.
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py:62 (moe_gmm ->
// _kernel, the pl.pallas_call over grid (E, C/bc, F/bf, D/bd)) for bf16
// with D and F multiples of 8 and 16-byte aligned bases (TMA's rules);
// other bf16 shapes and f32 stay on moe_gmm.cu (WMMA / FMA).
//
// Bound on this card: bytes at both shapes of the serving path.  At
// granite's largest chunk tick, (40, 512, 1536) x (40, 1536, 512), a call
// moves 146.8 MB (xe 62.9, w 62.9, out 21.0) -> 0.0438 ms at 3.35 TB/s,
// against 32.2 GFLOP -> 0.0326 ms at 989 TFLOP/s; the down projection
// (40, 512, 512) x (40, 512, 1536) moves the same bytes.  At decode
// (C = 8) a call streams one projection's weights: 64.2 MB -> 0.0192 ms.
//
// What held the WMMA kernel (moe_gmm.cu) back, and what this design does:
//   * L2-to-SM traffic at the chunk tick.  64 x 64 output tiles read each
//     xe panel F / 64 times and each w panel C / 64 times: ~1.0 GB through
//     L2 per call for 147 MB of unique bytes.  Here a CTA owns a 128-row
//     tile (two consumer warpgroups of 64 rows) 128, 192 or 256 wide
//     (wgmma m64nNk16), which cuts that to 0.50 GB at the gate's 128 and
//     0.42 GB at the down projection's 192;
//   * a single shared-memory stage filled from registers behind two
//     __syncthreads per step -> a ring of stages filled by TMA from one
//     producer thread, with a full and an empty mbarrier per stage: the
//     consumers wait only for data, and a stage is refilled as soon as the
//     wgmma that read it has retired (one wgmma group stays in flight);
//   * the f32 tile went through shared memory to bounds-checked stores ->
//     the accumulators are rounded to bf16 in registers, written to a
//     128-byte-swizzled output tile in shared memory and stored by TMA
//     (which drops the C and F tails), so the consumers go on to their
//     next tile while the store drains.  (Stores straight from registers,
//     4 bytes a thread, were the largest cost of the down projection in
//     a split on the card);
//   * too few weight bytes in flight at decode (8 x 16 B per thread behind
//     one barrier per stage) -> 64-row tiles, one consumer warpgroup, 256
//     wide: each stage streams 64 rows x 512 contiguous bytes of w, four
//     stages deep.  Rows past C are TMA zeros whose products are wasted
//     (~4 us of tensor time against the 19 us byte bound).  A weight that
//     no other tile reads (C within one tile) is loaded with an L2
//     evict-first policy, so streaming it does not evict other lines;
//   * waves: the grid is persistent (one CTA per SM walking tiles
//     blockIdx.x, + gridDim.x, ...), F tiles fastest, so the CTAs in
//     flight share xe panels and each expert's weights in L2, and the
//     producer fetches the next tile while the consumers store this one.
//     The 128-row tile's width is the one of 128, 192 and 256 whose
//     busiest CTA walks the fewest columns (rounds x width), ties to the
//     wider: 128 for F = 512 (640 tiles, 5 rounds on 132 SMs), 192 for
//     F = 1536 (1,280 tiles, 10 rounds).
//
// Operands.  xe and w are read through 3-D tensor maps, (D, C, E) and
// (F, D, E) innermost first, one expert per box, so TMA zero-fills every
// C, D and F tail inside an expert (a 2-D map over (E * D, F) would add
// the next expert's weights to a D tail); out is written through a third,
// (F, C, E).  128-byte swizzle: a box is 64 bf16 wide, a 192-wide w tile
// three boxes.  A (xe) is K-major; B (w) is stored (D, F) with F
// contiguous, so it is MN-major and wgmma reads it with the transpose-B
// immediate: the weights are never copied.

#include <cuda.h>   // CUtensorMap and its enums only: no -lcuda (the
                    // encoder comes through cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBK = 64;                  // D per stage
constexpr int kBox = 64;                 // bf16 values per box row
constexpr int kRowBytes = kBox * 2;      // 128: the swizzle span
constexpr int kBoxBytes = 64 * kRowBytes;   // a 64 x 64 box, 8 KB
constexpr int kSmemBudget = 225 * 1024;  // ring + output tile of a CTA

// One instantiation per tile shape: BM rows of C (64 per consumer
// warpgroup), BN columns of F, as many stages of kBK as the budget holds
// beside the bf16 output tile.  A stage is an xe box (BM rows x 128
// bytes) and BN / 64 w boxes (kBK rows x 128 bytes); the output tile is
// BM / 64 x BN / 64 boxes of 64 x 64.  Every box is 1024-byte aligned and
// 128-byte swizzled.
template <int BM, int BN>
struct Tile {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kABytes = BM * kRowBytes;
  static constexpr int kStageBytes = kABytes + BN / kBox * kBoxBytes;
  static constexpr int kOutBytes = BM * BN * 2;
  static constexpr int kStages = (kSmemBudget - kOutBytes) / kStageBytes;
  // + 1 KB to align the ring to the 1024-byte swizzle atom, + barriers
  static constexpr size_t kSmem = (size_t)kStages * kStageBytes +
                                  kOutBytes + 1024 + 2 * 8 * kStages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// one arrival that also announces the bytes the stage's TMA loads bring
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// ------------------------------------------------------------------ TMA
// one box of a 3-D map (coordinates innermost first) into shared memory;
// its bytes count down the barrier's expected transaction count.  With
// `evict_first` its lines are the first L2 evicts (data this call reads
// once), else they enter L2 as any load's do.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, bool evict_first) {
  if (evict_first) {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2],"
        " %6;\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "l"(policy)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  }
}
// shared -> global: one box of a 3-D map; TMA drops what lies outside it
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have read their shared memory (Read) or finished
template <bool Read>
__device__ __forceinline__ void bulk_wait_all() {
  if (Read)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, visible to the TMA (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier of the `threads` threads that use `id` (0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v)
               : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor with 128-byte swizzle: start address,
// LBO and SBO in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (it sees no dependence through wgmma.wait_group)
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x N, f32) (+)= A (64 x 16, K-major) . B (16 x N, MN-major: the
// transpose-B immediate is 1); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, int scale_d) {
  if constexpr (N == 128) wgmma_n128(d, a, b, scale_d);
  else if constexpr (N == 192) wgmma_n192(d, a, b, scale_d);
  else wgmma_n256(d, a, b, scale_d);
}

// Tile t is (F tile t % n_f, C tile t / n_f % n_c, expert t / (n_f n_c)).
// Warpgroup 0 produces: its first thread walks this CTA's tiles and their
// D steps, waits for a stage to be empty and loads one 64-wide box of xe
// (BM rows) and BN / 64 boxes of w (64 rows of D) into it.  Warpgroups
// 1.. consume: each multiplies its 64 rows of the stage's xe by the w
// tile into BN / 2 f32 registers per thread, frees the stage of the
// previous step once that step's wgmma group has retired, and after the
// last D step rounds its 64 x BN block to bf16 into its part of the
// output tile in shared memory, from where one thread stores it with TMA
// while the warpgroup goes on to its next tile.
template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, 1)
moe_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_out, int C,
                     int F, int n_k, int n_c, int n_f, int n_tiles,
                     int stream_w) {
  using T = Tile<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  // stage s: xe at ring + s * kStageBytes, w kABytes after it; then the
  // output tile; then the full and the empty barrier of each stage
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t out_tile = ring + T::kStages * T::kStageBytes;
  const uint32_t full0 = out_tile + T::kOutBytes;
  const uint32_t empty0 = full0 + 8 * T::kStages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrival
      mbar_init(empty0 + 8 * s, T::kConsumers);    // one per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (T::kConsumers > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int f0 = t % n_f * BN;
      const int c0 = t / n_f % n_c * BM;
      const int e = t / (n_f * n_c);
      for (int kb = 0; kb < n_k; ++kb) {
        const uint32_t a = ring + s * T::kStageBytes;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, phase ^ 1);      // passes on the first lap
        mbar_expect_tx(full, T::kStageBytes);
        tma_load_3d(a, &map_x, full, kb * kBK, c0, e, false);
#pragma unroll
        for (int j = 0; j < BN / kBox; ++j)
          tma_load_3d(a + T::kABytes + j * kBoxBytes, &map_w, full,
                      f0 + j * kBox, kb * kBK, e, stream_w);
        if (++s == T::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    if constexpr (T::kConsumers > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128;
    const int g = wg - 1;                          // rows 64 g .. 64 g + 63
    // accumulator layout of m64nN: warp w of the group holds rows 16 w ..
    // 16 w + 15; register 4 j + 2 h + i is row lane / 4 + 8 h, column
    // 8 j + 2 (lane % 4) + i
    const int row_in = tid / 32 * 16 + tid % 32 / 4;
    const uint32_t my_out = out_tile + g * BN / kBox * kBoxBytes;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int f0 = t % n_f * BN;
      const int c0 = t / n_f % n_c * BM;
      const int e = t / (n_f * n_c);
      int prev = -1;
      for (int kb = 0; kb < n_k; ++kb) {
        const uint32_t a = ring + s * T::kStageBytes + g * 64 * kRowBytes;
        const uint32_t b = ring + s * T::kStageBytes + T::kABytes;
        mbar_wait(full0 + 8 * s, phase);
        wgmma_fence();
        // A: 8-row groups 1024 bytes apart, a k16 step 32 bytes along the
        // swizzled row.  B: 8-row groups (of D) 1024 bytes apart, 64-wide
        // boxes (of F) one box apart, a k16 step 16 rows
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma<BN>(acc, gmma_desc(a + kk * 32, 16, 8 * kRowBytes),
                    gmma_desc(b + kk * 16 * kRowBytes, kBoxBytes,
                              8 * kRowBytes),
                    kb | kk);
        wgmma_commit();
        wgmma_wait<1>();                           // step kb - 1 retired
        if (prev >= 0 && tid == 0) mbar_arrive(empty0 + 8 * prev);
        prev = s;
        if (++s == T::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (tid == 0) mbar_arrive(empty0 + 8 * prev);
      // the previous tile's stores have read this warpgroup's output boxes
      if (tid == 0) bulk_wait_all<true>();
      named_sync(1 + g, 128);
      // row r, 16-byte chunk c of a box sits at r * 128 + ((c ^ r % 8) *
      // 16): a warp's 8 rows of one chunk hit 8 distinct bank groups
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t box = my_out + j / 8 * kBoxBytes;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row_in + 8 * h;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          st_shared_u32(box + r * kRowBytes + ((j % 8 ^ r % 8) << 4) +
                            4 * (tid % 4),
                        *reinterpret_cast<const uint32_t*>(&v));
        }
      }
      fence_async_shared();
      named_sync(1 + g, 128);
      if (tid == 0 && c0 + 64 * g < C) {
#pragma unroll
        for (int jb = 0; jb < BN / kBox; ++jb)
          if (f0 + jb * kBox < F)
            tma_store_3d(&map_out, my_out + jb * kBoxBytes, f0 + jb * kBox,
                         c0 + 64 * g, e);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_all<false>();
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 tensor (outer, mid, inner), inner contiguous, as a 3-D map with
// (64, box_mid, 1) boxes, 128-byte swizzle, zeros past every edge.
bool encode_3d(EncodeTiled encode, CUtensorMap* map, const void* base,
               int inner, int mid, int outer, int box_mid) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)mid,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * mid * 2};   // bytes
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)box_mid, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

long long n_tiles(int E, int C, int F, int BM, int BN) {
  return (long long)E * ((C + BM - 1) / BM) * ((F + BN - 1) / BN);
}

// The 128-row tile's width: of 256, 192 and 128, the one whose busiest
// CTA walks the fewest columns (rounds of the persistent grid x width),
// ties to the wider (fewer bytes through L2 per product).
int tile_width(int E, int C, int F, int sms) {
  int best = 256;
  long long best_cols = -1;
  for (const int bn : {256, 192, 128}) {
    const long long cols = (n_tiles(E, C, F, 128, bn) + sms - 1) / sms * bn;
    if (best_cols < 0 || cols < best_cols) {
      best = bn;
      best_cols = cols;
    }
  }
  return best;
}

template <int BM, int BN>
int launch(const void* xe, const void* w, void* out, int E, int C, int D,
           int F, int dev, int sms, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  const EncodeTiled encode = encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  // raise the dynamic shared-memory limit once per device (one bit each)
  static std::atomic<unsigned long long> allowed{0};
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_wgmma_kernel<BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (err != cudaSuccess) return (int)err;
    allowed.fetch_or(bit, std::memory_order_release);
  }
  CUtensorMap map_x, map_w, map_out;
  if (!encode_3d(encode, &map_x, xe, D, C, E, BM) ||
      !encode_3d(encode, &map_w, w, F, D, E, kBK) ||
      !encode_3d(encode, &map_out, out, F, C, E, 64))
    return (int)cudaErrorInvalidValue;
  const int n_c = (C + BM - 1) / BM, n_f = (F + BN - 1) / BN;
  const long long tiles = n_tiles(E, C, F, BM, BN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);   // persistent
  // with one C tile no other tile reads an expert's weights: stream them
  moe_gmm_wgmma_kernel<BM, BN><<<grid, T::kThreads, T::kSmem, stream>>>(
      map_x, map_w, map_out, C, F, (D + kBK - 1) / kBK, n_c, n_f,
      (int)tiles, (int)(n_c == 1));
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only.  xe (E, C, D), w (E, D, F), out (E, C, F), all contiguous
// and 16-byte aligned; every dimension > 0, D % 8 == 0 and F % 8 == 0
// (TMA's 16-byte strides).  Decode-sized C (<= 64) takes 64 x 256 tiles;
// larger C 128-row tiles of the width `tile_width` picks.  Returns the
// cudaError_t of the launch.
extern "C" int moe_gmm_wgmma_launch(const void* xe, const void* w,
                                    void* out, int E, int C, int D, int F,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8 ||
      reinterpret_cast<uintptr_t>(xe) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (C <= 64)
    return launch<64, 256>(xe, w, out, E, C, D, F, dev, sms, st);
  switch (tile_width(E, C, F, sms)) {
    case 256:
      return launch<128, 256>(xe, w, out, E, C, D, F, dev, sms, st);
    case 192:
      return launch<128, 192>(xe, w, out, E, C, D, F, dev, sms, st);
    default:
      return launch<128, 128>(xe, w, out, E, C, D, F, dev, sms, st);
  }
}
