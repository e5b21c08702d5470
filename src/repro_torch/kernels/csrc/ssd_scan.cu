// Chunked Mamba2/SSD scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan ->
// _kernel, the pl.pallas_call over grid (B, h, n_chunks) with the (hd, S)
// state in VMEM scratch), and beyond it returns the final state, which
// mamba_apply(return_state=True) hands to the decode step.
//
// Per (batch row b, SSM head h), chunk by chunk in order, state st (hd, S)
// in f32, acs the inclusive cumsum of dt * A inside the chunk:
//   y_t = sum_{s<=t} exp(acs_t - acs_s) dt_s (C_t . B_s) x_s
//         + exp(acs_t) (C_t . st^T)
//   st <- st exp(acs_end) + sum_s exp(acs_end - acs_s) dt_s x_s B_s^T
//
// Bound on this card: f32 operations, not bytes.  Per (b, h, chunk of C)
// the work is ~C^2 S (C.B^T) + C^2 hd (intra) + 2 C hd S (inter, state)
// multiply-adds against (C hd) elements of x and y; at zamba2's hd = S = 64
// and C = 128 that is ~60 flops per byte moved, above the card's ~20 for
// f32 outside the tensor cores.  The contract is f32 (no TF32), so the
// products run as f32 FMA on the CUDA cores.
//
// Design: one CTA of 256 threads per (b, h) walks the chunks in order (a
// loop inside the block replaces the TPU's sequential grid dimension).
// The state lives in shared memory for the whole walk, transposed to
// (S, hd).  Per chunk the CTA stages C (C x S), B^T (S x C), x (C x hd,
// read in its own dtype straight from the (B, L, h, hd) layout and
// widened) and dt; warp 0 forms the cumsum; then four small matmuls run
// out of shared memory, each thread owning a 4 x 4 register tile of a
// 64 x 64 output tile (rows ty + 16 i, columns tx + 16 j): M = C.B^T with
// the decay and dt applied and the upper triangle set to 0 WITHOUT
// evaluating its exp (exp(acs_t - acs_s) for s > t can overflow); y =
// exp(acs) (C.st^T) + M.x; x scaled by exp(acs_end - acs_s) dt_s in
// place; st = st exp(acs_end) + B^T.x.  Shared rows are padded by one
// word so the strided operand of each product hits distinct banks.  A
// ragged last chunk is handled by bounding every loop at its length: a
// step past L neither decays nor adds, as JAX's zero padding (dt = 0)
// gives.  expf, not __expf, and no fast-math: the f32 tolerance of the
// JAX suite (1e-3) has to hold.  Tensor cores, wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxChunk = 128;  // warp 0's cumsum: 4 steps a lane

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc[i][j] += sum_{k < K} A[r_i * lda + k] * B[k * ldb + c_j] with
// r_i = r0 + ty + 16 i, c_j = c0 + tx + 16 j, rows clamped below rmax and
// columns below cmax (the clamped lanes compute values nobody stores).
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], const float* A,
                                         int lda, const float* B, int ldb,
                                         int K, int r0, int c0, int rmax,
                                         int cmax) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* arow[4];
  int col[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) arow[i] = A + min(r0 + ty + 16 * i, rmax - 1) * lda;
#pragma unroll
  for (int j = 0; j < 4; ++j) col[j] = min(c0 + tx + 16 * j, cmax - 1);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = arow[i][k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[k * ldb + col[j]];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ Avec, float* __restrict__ y,
                float* __restrict__ state, int L, int H, int hd, int S,
                int chunk) {
  extern __shared__ float smem[];
  const int hh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ldc = S + 1, ldbt = chunk + 1, ldm = chunk + 1;
  float* sST = smem;                       // [S][hd]  state, transposed
  float* sC = sST + S * hd;                // [chunk][S + 1]
  float* sBT = sC + chunk * ldc;           // [S][chunk + 1]
  float* sX = sBT + S * ldbt;              // [chunk][hd]
  float* sM = sX + chunk * hd;             // [chunk][chunk + 1]
  float* sdt = sM + chunk * ldm;           // [chunk]
  float* sacs = sdt + chunk;               // [chunk]
  const float A = Avec[hh];

  for (int e = tid; e < S * hd; e += kThreads) sST[e] = 0.f;

  for (int t0 = 0; t0 < L; t0 += chunk) {
    const int Lc = min(chunk, L - t0);
    const long long row0 = (long long)b * L + t0;
    // ---- stage the chunk
    for (int e = tid; e < Lc * S; e += kThreads) {
      const int t = e / S, n = e - t * S;
      const long long g = (row0 + t) * S + n;
      sC[t * ldc + n] = Cm[g];
      sBT[n * ldbt + t] = Bm[g];
    }
    for (int e = tid; e < Lc * hd; e += kThreads) {
      const int t = e / hd, d = e - t * hd;
      sX[e] = widen(x[((row0 + t) * H + hh) * hd + d]);
    }
    for (int t = tid; t < Lc; t += kThreads) sdt[t] = dt[(row0 + t) * H + hh];
    __syncthreads();
    // ---- inclusive cumsum of dt * A (warp 0, 4 consecutive steps a lane)
    if (tid < 32) {
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tid * 4 + k;
        run += t < Lc ? sdt[t] * A : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tid * 4 + k;
        if (t < Lc) sacs[t] = v[k] + excl;
      }
    }
    __syncthreads();
    const float acs_end = sacs[Lc - 1];
    // ---- M[t][s] = (C_t . B_s) exp(acs_t - acs_s) dt_s for s <= t, else 0
    for (int r0 = 0; r0 < Lc; r0 += 64) {
      for (int c0 = 0; c0 < Lc; c0 += 64) {
        float acc[4][4] = {};
        if (c0 <= r0 + 63)   // tiles wholly above the diagonal stay 0
          tile_mma(acc, sC, ldc, sBT, ldbt, S, r0, c0, Lc, Lc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = r0 + ty + 16 * i;
          if (t >= Lc) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = c0 + tx + 16 * j;
            if (s >= Lc) continue;
            // mask before exp: the decay of s > t is never evaluated
            sM[t * ldm + s] =
                s <= t ? acc[i][j] * expf(sacs[t] - sacs[s]) * sdt[s] : 0.f;
          }
        }
      }
    }
    __syncthreads();
    // ---- y = exp(acs_t) (C . st^T) + M . x
    for (int r0 = 0; r0 < Lc; r0 += 64) {
      for (int c0 = 0; c0 < hd; c0 += 64) {
        float acc[4][4] = {};
        tile_mma(acc, sC, ldc, sST, hd, S, r0, c0, Lc, hd);
        float inter[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          inter[i] = expf(sacs[min(r0 + ty + 16 * i, Lc - 1)]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= inter[i];
        // M is 0 right of the diagonal: keys past the tile's last row skip
        tile_mma(acc, sM, ldm, sX, hd, min(Lc, r0 + 64), r0, c0, Lc, hd);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = r0 + ty + 16 * i;
          if (t >= Lc) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = c0 + tx + 16 * j;
            if (d < hd) y[((row0 + t) * H + hh) * hd + d] = acc[i][j];
          }
        }
      }
    }
    __syncthreads();
    // ---- x_s *= exp(acs_end - acs_s) dt_s, then st = st exp(acs_end) + B^T x
    for (int e = tid; e < Lc * hd; e += kThreads) {
      const int s = e / hd;
      sX[e] *= expf(acs_end - sacs[s]) * sdt[s];
    }
    __syncthreads();
    const float dec = expf(acs_end);
    for (int r0 = 0; r0 < S; r0 += 64) {
      for (int c0 = 0; c0 < hd; c0 += 64) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = min(r0 + ty + 16 * i, S - 1);
            const int d = min(c0 + tx + 16 * j, hd - 1);
            acc[i][j] = sST[n * hd + d] * dec;
          }
        tile_mma(acc, sBT, ldbt, sX, hd, Lc, r0, c0, S, hd);
        // each (n, d) is read and written by its own thread only
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = r0 + ty + 16 * i;
          if (n >= S) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = c0 + tx + 16 * j;
            if (d < hd) sST[n * hd + d] = acc[i][j];
          }
        }
      }
    }
    __syncthreads();
  }
  // ---- final state, (hd, S) row-major per (b, h)
  float* out = state + ((long long)b * H + hh) * hd * S;
  for (int e = tid; e < hd * S; e += kThreads) {
    const int d = e / S, n = e - d * S;
    out[e] = sST[n * hd + d];
  }
}

size_t smem_bytes(int chunk, int hd, int S) {
  return sizeof(float) *
         ((size_t)S * hd + (size_t)chunk * (S + 1) + (size_t)S * (chunk + 1) +
          (size_t)chunk * hd + (size_t)chunk * (chunk + 1) + 2 * (size_t)chunk);
}

// Raise the kernel's dynamic shared-memory limit to the device's opt-in
// maximum once per device (a driver call kept off the per-launch path).
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, std::atomic<unsigned long long>& done) {
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
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T>
int launch(const void* x, const void* Bm, const void* Cm, const void* dt,
           const void* A, void* y, void* state, int B, int L, int H, int hd,
           int S, int chunk, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  cudaError_t err = allow_max_smem(ssd_scan_kernel<T>, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  ssd_scan_kernel<T><<<grid, kThreads, smem_bytes(chunk, hd, S), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<float*>(y),
      static_cast<float*>(state), L, H, hd, S, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x only; Bm, Cm, dt, A, y and state are
// float32).  x (B, L, H, hd), Bm/Cm (B, L, S), dt (B, L, H), A (H,), y
// (B, L, H, hd), state (B, H, hd, S); all contiguous.  1 <= chunk <= 128,
// B, L, H, hd, S > 0, B <= 65535.  Returns the cudaError_t of the launch.
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* Bm,
                               const void* Cm, const void* dt, const void* A,
                               void* y, void* state, int B, int L, int H,
                               int hd, int S, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || L <= 0 || H <= 0 || hd <= 0 || S <= 0 ||
      chunk < 1 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, Bm, Cm, dt, A, y, state, B, L, H, hd, S, chunk, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, Bm, Cm, dt, A, y, state, B, L, H, hd, S,
                                 chunk, st);
  return (int)cudaErrorInvalidValue;
}
