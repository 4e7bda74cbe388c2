// Simple-lattice scoring of the pruned RNN-T loss, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// conformer_tpu/ops/pallas/simple_lattice_kernel.py (_forward / _fwd_kernel
// and _backward / _bwd_kernel). For the additive "simple" joint
// logits[b,t,u,v] = am[b,t,v] + lm[b,u,v] the forward gives, per (b, t, u),
//
//   logZ = logsumexp_v logits,  lp_blank = logits[.., blank] - logZ,
//   lp_emit = logits[.., lab[u]] - logZ,
//
// and the backward, from the saved logZ and the cotangents g_b, g_e,
//
//   dl[t,u,v] = -(g_b+g_e) p + g_b [v=blank] + g_e [v=lab_u],  p = exp(logits - logZ)
//   d am[t,v] = sum_u dl,   d lm[u,v] = sum_t dl.
//
// No [B,T,U+1,V] tensor exists at any point. Inputs are float32; lab[u] is
// blank at u = U (the caller pads it), a label outside [0, V) picks 0.
//
// Bound: the function's least work is its factored form, logZ = max_am +
// max_lm + log(exp(am - max_am) @ exp(lm - max_lm)^T), one float32 product
// of 2 B T (U+1) V flops: 7.8 GFLOP at the training shape (B=32, T'=374,
// U+1=65, V=5002), 0.12 ms at 67 TFLOP/s; the backward's d am = exp(am) *
// (W @ exp(lm)) and d lm = exp(lm) * (W^T @ exp(am)), W = (g_b+g_e)/Z, are
// two such products, 0.23 ms. The bytes (am 239 MB, lm 42 MB) take ~0.09 ms.
// These kernels do not take that form: they spend one exp per (b, t, u, v)
// in each direction, 3.9e9 (0.93 ms at the card's 16 exp/clock/SM), and keep
// the other work per exp small: inputs are pre-scaled by log2(e) once per
// staged tile, so each element costs two adds, one exp2 and one add
// (forward) or three FMAs (backward). A product-based design is the way to
// the bound (ROADMAP.md queue B).
//
// Forward design: one block per (b, tile of t rows, tile of u rows). A u
// tile holds at most FWD_MAX_UG * 4 = 128 rows, so the block's shape and
// shared memory never depend on U: up to U+1 = 128 one tile covers u, above
// it the rows are cut into equal tiles (the grid's third dimension). Each
// thread owns a 4x4 register tile of (t, u) pairs; rows of u are
// interleaved across threads so that neighbouring threads read
// neighbouring rows of the staged lm tile (row stride padded to 36 floats:
// conflict-free float4 reads). V streams through shared memory in tiles of
// 32: a max pass, one rescale of the running sum per pair and tile, then
// an exp-sum pass (online logsumexp with one extra exp per 32 elements).
// The blank and label picks are two gathers at the end.
//
// Backward design: one block per (b, tile of 64 v) loops over every t, so
// both sums are complete inside the block and nothing needs atomics (the
// result is deterministic): warp w owns u rows [u0+8w, u0+8w+8), lane l
// the columns v0+l and v0+32+l. lm's values for the block's (u, v) stay in
// registers, as does the d lm accumulator; per t the per-(t,u) constants
// (logZ, g_b, g_e) are one broadcast float4 read from shared memory, and
// d am[t, v] is the sum of the warps' partial sums over their u rows,
// reduced through shared memory per tile of 8 t rows. A block has at most
// 12 warps: up to U+1 = 96 one launch covers u; above, one launch per
// equal chunk of u (three at the recipe's 200 padded labels), each adding
// its d am to the previous chunk's, in stream order. (One warp per 8 rows
// of all of u asked 832 threads at U+1 = 201, more registers than an SM
// has: the launch was refused.)
//
// Limits: none from shared memory in either direction. The forward's grid
// has at most 65535 u tiles (U+1 <= 65535 * 128, ops/simple_lattice.py
// max_u1); the backward runs one grid per chunk of 96 u rows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int FWD_RT = 4;            // t rows per thread
constexpr int FWD_RU = 4;            // u rows per thread
constexpr int FWD_VT = 32;           // v columns per staged tile
constexpr int FWD_LD = FWD_VT + 4;   // padded row stride of the staged tiles
constexpr int FWD_MAX_UG = 32;       // threads over u per block, at most (128 u rows)

__global__ void simple_lattice_fwd_kernel(const float* __restrict__ am,
                                          const float* __restrict__ lm,
                                          const int* __restrict__ lab,
                                          float* __restrict__ lpb, float* __restrict__ lpe,
                                          float* __restrict__ logz, int T, int U1, int V,
                                          int blank, int n_ug, int n_tg) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tt = n_tg * FWD_RT;
  const int up = n_ug * FWD_RU;
  float* am_s = smem;                  // [tt][FWD_LD], log2 units
  float* lm_s = smem + tt * FWD_LD;    // [up][FWD_LD], log2 units
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tt;
  const int u0 = blockIdx.z * up;   // this block's first u row
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int ug = tid % n_ug;
  const int tg = tid / n_ug;
  const float* amb = am + (size_t)b * T * V;
  const float* lmb = lm + (size_t)b * U1 * V + (size_t)u0 * V;

  float m[FWD_RT][FWD_RU], s[FWD_RT][FWD_RU];
#pragma unroll
  for (int r = 0; r < FWD_RT; ++r)
#pragma unroll
    for (int q = 0; q < FWD_RU; ++q) {
      m[r][q] = -INFINITY;
      s[r][q] = 0.f;
    }

  for (int v0 = 0; v0 < V; v0 += FWD_VT) {
    for (int i = tid; i < tt * FWD_VT; i += nthr) {
      const int r = i / FWD_VT, c = i % FWD_VT, t = t0 + r, v = v0 + c;
      am_s[r * FWD_LD + c] = (t < T && v < V) ? amb[(size_t)t * V + v] * kLog2e : kNeg;
    }
    for (int i = tid; i < up * FWD_VT; i += nthr) {
      const int r = i / FWD_VT, c = i % FWD_VT, v = v0 + c;
      lm_s[r * FWD_LD + c] = (u0 + r < U1 && v < V) ? lmb[(size_t)r * V + v] * kLog2e : kNeg;
    }
    __syncthreads();
    if (tg < n_tg) {
      float mt[FWD_RT][FWD_RU];
#pragma unroll
      for (int r = 0; r < FWD_RT; ++r)
#pragma unroll
        for (int q = 0; q < FWD_RU; ++q) mt[r][q] = -INFINITY;
#pragma unroll 2
      for (int c = 0; c < FWD_VT; c += 4) {
        float4 a[FWD_RT], l[FWD_RU];
#pragma unroll
        for (int r = 0; r < FWD_RT; ++r)
          a[r] = *reinterpret_cast<const float4*>(&am_s[(tg + r * n_tg) * FWD_LD + c]);
#pragma unroll
        for (int q = 0; q < FWD_RU; ++q)
          l[q] = *reinterpret_cast<const float4*>(&lm_s[(ug + q * n_ug) * FWD_LD + c]);
#pragma unroll
        for (int r = 0; r < FWD_RT; ++r)
#pragma unroll
          for (int q = 0; q < FWD_RU; ++q)
            mt[r][q] = fmaxf(mt[r][q], fmaxf(fmaxf(a[r].x + l[q].x, a[r].y + l[q].y),
                                             fmaxf(a[r].z + l[q].z, a[r].w + l[q].w)));
      }
#pragma unroll
      for (int r = 0; r < FWD_RT; ++r)
#pragma unroll
        for (int q = 0; q < FWD_RU; ++q) {
          const float mn = fmaxf(m[r][q], mt[r][q]);
          s[r][q] *= exp2f(m[r][q] - mn);
          m[r][q] = mn;
        }
#pragma unroll 2
      for (int c = 0; c < FWD_VT; c += 4) {
        float4 a[FWD_RT], l[FWD_RU];
#pragma unroll
        for (int r = 0; r < FWD_RT; ++r)
          a[r] = *reinterpret_cast<const float4*>(&am_s[(tg + r * n_tg) * FWD_LD + c]);
#pragma unroll
        for (int q = 0; q < FWD_RU; ++q)
          l[q] = *reinterpret_cast<const float4*>(&lm_s[(ug + q * n_ug) * FWD_LD + c]);
#pragma unroll
        for (int r = 0; r < FWD_RT; ++r)
#pragma unroll
          for (int q = 0; q < FWD_RU; ++q) {
            const float mm = m[r][q];
            s[r][q] += exp2f(a[r].x + l[q].x - mm) + exp2f(a[r].y + l[q].y - mm) +
                       exp2f(a[r].z + l[q].z - mm) + exp2f(a[r].w + l[q].w - mm);
          }
      }
    }
    __syncthreads();
  }
  if (tg >= n_tg) return;
#pragma unroll
  for (int r = 0; r < FWD_RT; ++r) {
    const int t = t0 + tg + r * n_tg;
    if (t >= T) continue;
    const float a_blank = amb[(size_t)t * V + blank];
#pragma unroll
    for (int q = 0; q < FWD_RU; ++q) {
      const int ul = ug + q * n_ug, u = u0 + ul;   // row in the tile, row of the lattice
      if (u >= U1) continue;
      const float lz = (m[r][q] + log2f(s[r][q])) * kLn2;
      const float bl = a_blank + lmb[(size_t)ul * V + blank];
      const int lb = lab[(size_t)b * U1 + u];
      const float em = (lb >= 0 && lb < V) ? amb[(size_t)t * V + lb] + lmb[(size_t)ul * V + lb] : 0.f;
      const size_t o = ((size_t)b * T + t) * U1 + u;
      lpb[o] = bl - lz;
      lpe[o] = em - lz;
      logz[o] = lz;
    }
  }
}

constexpr int BWD_UPW = 8;               // u rows per warp
constexpr int BWD_RV = 2;                // v columns per lane
constexpr int BWD_VT = 32 * BWD_RV;      // v columns per block
constexpr int BWD_TT = 8;                // t rows per staged tile
constexpr int BWD_MAXW = 12;             // warps per block at most

// rows u0 .. u0 + 8 * warps of u; kAccumulate adds d am to the previous
// chunk's instead of writing it
template <bool kAccumulate>
__global__ void __launch_bounds__(BWD_MAXW * 32)
simple_lattice_bwd_kernel(const float* __restrict__ am, const float* __restrict__ lm,
                          const int* __restrict__ lab, const float* __restrict__ logz,
                          const float* __restrict__ gb, const float* __restrict__ ge,
                          float* __restrict__ dam, float* __restrict__ dlm, int T, int U1,
                          int V, int blank, int u0) {
  extern __shared__ float4 smem4[];
  const int nw = blockDim.x / 32;
  const int up = nw * BWD_UPW;
  float4* cst = smem4;                                          // [TT][up]: logZ*log2e, g_b, g_e
  float* a_s = reinterpret_cast<float*>(smem4 + BWD_TT * up);   // [TT][VT], log2 units
  float* part = a_s + BWD_TT * BWD_VT;                          // [nw][TT][VT]
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * BWD_VT;
  const float* amb = am + (size_t)b * T * V;
  const float* lmb = lm + (size_t)b * U1 * V;
  const size_t lat0 = (size_t)b * T * U1;

  float l2[BWD_UPW][BWD_RV], acc[BWD_UPW][BWD_RV], ml[BWD_UPW][BWD_RV], mb[BWD_RV];
#pragma unroll
  for (int j = 0; j < BWD_RV; ++j) mb[j] = (v0 + lane + 32 * j == blank) ? 1.f : 0.f;
#pragma unroll
  for (int q = 0; q < BWD_UPW; ++q) {
    const int u = u0 + w * BWD_UPW + q;
    const int lb = u < U1 ? lab[(size_t)b * U1 + u] : -1;
#pragma unroll
    for (int j = 0; j < BWD_RV; ++j) {
      const int v = v0 + lane + 32 * j;
      const bool ok = u < U1 && v < V;
      l2[q][j] = ok ? lmb[(size_t)u * V + v] * kLog2e : kNeg;
      ml[q][j] = (ok && lb == v) ? 1.f : 0.f;
      acc[q][j] = 0.f;
    }
  }

  for (int t0 = 0; t0 < T; t0 += BWD_TT) {
    for (int i = tid; i < BWD_TT * up; i += blockDim.x) {
      const int r = i / up, u = u0 + i % up, t = t0 + r;
      float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T && u < U1) {
        const size_t o = lat0 + (size_t)t * U1 + u;
        c = make_float4(logz[o] * kLog2e, gb[o], ge[o], 0.f);
      }
      cst[i] = c;
    }
    for (int i = tid; i < BWD_TT * BWD_VT; i += blockDim.x) {
      const int r = i / BWD_VT, c = i % BWD_VT, t = t0 + r, v = v0 + c;
      a_s[i] = (t < T && v < V) ? amb[(size_t)t * V + v] * kLog2e : kNeg;
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < BWD_TT; ++r) {
      float a[BWD_RV], dp[BWD_RV];
#pragma unroll
      for (int j = 0; j < BWD_RV; ++j) {
        a[j] = a_s[r * BWD_VT + lane + 32 * j];
        dp[j] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < BWD_UPW; ++q) {
        const float4 c = cst[r * up + w * BWD_UPW + q];
        const float g = c.y + c.z;
#pragma unroll
        for (int j = 0; j < BWD_RV; ++j) {
          const float p = exp2f(a[j] + l2[q][j] - c.x);
          const float dl = fmaf(-g, p, fmaf(mb[j], c.y, ml[q][j] * c.z));
          acc[q][j] += dl;
          dp[j] += dl;
        }
      }
#pragma unroll
      for (int j = 0; j < BWD_RV; ++j) part[(w * BWD_TT + r) * BWD_VT + lane + 32 * j] = dp[j];
    }
    __syncthreads();
    for (int i = tid; i < BWD_TT * BWD_VT; i += blockDim.x) {
      const int r = i / BWD_VT, c = i % BWD_VT, t = t0 + r, v = v0 + c;
      if (t < T && v < V) {
        float sum = 0.f;
        for (int k = 0; k < nw; ++k) sum += part[(k * BWD_TT + r) * BWD_VT + c];
        float* d = dam + (size_t)b * T * V + (size_t)t * V + v;
        if (kAccumulate)
          *d += sum;
        else
          *d = sum;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < BWD_UPW; ++q) {
    const int u = u0 + w * BWD_UPW + q;
    if (u >= U1) continue;
#pragma unroll
    for (int j = 0; j < BWD_RV; ++j) {
      const int v = v0 + lane + 32 * j;
      if (v < V) dlm[(size_t)b * U1 * V + (size_t)u * V + v] = acc[q][j];
    }
  }
}

}  // namespace

// Block shape of the forward: n_ug <= FWD_MAX_UG threads over u (4 rows
// each), n_tg over t (4 rows each), about 128 threads in all; n_ut tiles of
// u, equal but for the last.
extern "C" int simple_lattice_fwd(const void* am, const void* lm, const void* lab, void* lpb,
                                  void* lpe, void* logz, void* stream, int B, int T, int U1,
                                  int V, int blank) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ut = (U1 + FWD_MAX_UG * FWD_RU - 1) / (FWD_MAX_UG * FWD_RU);
  if (n_ut > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ug = ((U1 + n_ut - 1) / n_ut + FWD_RU - 1) / FWD_RU;
  int n_tg = 128 / n_ug;
  if (n_tg < 1) n_tg = 1;
  if (n_tg > 8) n_tg = 8;
  const int tt = n_tg * FWD_RT;
  const size_t smem = sizeof(float) * (size_t)(tt + n_ug * FWD_RU) * FWD_LD;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(simple_lattice_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((T + tt - 1) / tt, B, n_ut);
  simple_lattice_fwd_kernel<<<grid, n_ug * n_tg, smem, st>>>(
      static_cast<const float*>(am), static_cast<const float*>(lm), static_cast<const int*>(lab),
      static_cast<float*>(lpb), static_cast<float*>(lpe), static_cast<float*>(logz), T, U1, V,
      blank, n_ug, n_tg);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <bool kAccumulate>
cudaError_t launch_bwd(const void* am, const void* lm, const void* lab, const void* logz,
                       const void* gb, const void* ge, void* dam, void* dlm, cudaStream_t st,
                       int B, int T, int U1, int V, int blank, int nw, int u0) {
  const size_t smem = sizeof(float4) * BWD_TT * nw * BWD_UPW +
                      sizeof(float) * BWD_TT * BWD_VT * (1 + nw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(simple_lattice_bwd_kernel<kAccumulate>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((V + BWD_VT - 1) / BWD_VT, B);
  simple_lattice_bwd_kernel<kAccumulate><<<grid, nw * 32, smem, st>>>(
      static_cast<const float*>(am), static_cast<const float*>(lm), static_cast<const int*>(lab),
      static_cast<const float*>(logz), static_cast<const float*>(gb),
      static_cast<const float*>(ge), static_cast<float*>(dam), static_cast<float*>(dlm), T, U1,
      V, blank, u0);
  return cudaGetLastError();
}

}  // namespace

// *grids: the number of grids launched (one per chunk of u).
extern "C" int simple_lattice_bwd(const void* am, const void* lm, const void* lab,
                                  const void* logz, const void* gb, const void* ge, void* dam,
                                  void* dlm, void* grids, void* stream, int B, int T, int U1,
                                  int V, int blank) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int need = (U1 + BWD_UPW - 1) / BWD_UPW;          // warps for every u row
  const int chunks = (need + BWD_MAXW - 1) / BWD_MAXW;
  const int nw = (need + chunks - 1) / chunks;
  int* launched = static_cast<int*>(grids);
  for (int c = 0; c < chunks; ++c) {
    *launched = c;
    const int u0 = c * nw * BWD_UPW;
    cudaError_t e = c == 0 ? launch_bwd<false>(am, lm, lab, logz, gb, ge, dam, dlm, st, B, T,
                                               U1, V, blank, nw, u0)
                           : launch_bwd<true>(am, lm, lab, logz, gb, ge, dam, dlm, st, B, T,
                                              U1, V, blank, nw, u0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *launched = chunks;
  return 0;
}
