// Transducer lattice DP (alpha forward, beta backward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/rnnt_kernel.py
// (_forward / _fwd_kernel and _backward / _bwd_kernel). Input: the lattice
// log-probs lp_blank, lp_emit [B,T,U+1] (float32), lengths t_len, u_len [B].
// Forward, per row, over the anti-diagonals d = t + u:
//
//   alpha[0,0] = 0,
//   alpha[t,u] = max(logaddexp(alpha[t-1,u] + lp_blank[t-1,u],
//                              alpha[t,u-1] + lp_emit[t,u-1]), -1e30),
//   nll = -(alpha[t_len-1, u_len] + lp_blank[t_len-1, u_len]),
//
// saving alpha [B,T,U+1]. Backward, from the upstream g [B]:
//
//   beta[t,u] = max(logaddexp(lp_blank[t,u] + beta'[t+1,u],
//                             lp_emit[t,u] + beta[t,u+1]), -1e30),
//   beta'[t+1,u] = 0 at the terminal cell (t_len-1, u_len), else beta[t+1,u],
//   ob[t,u] = exp(alpha + lp_blank + beta'[t+1,u] - logZ),
//   oe[t,u] = exp(alpha + lp_emit + beta[t,u+1] - logZ),   logZ = -nll,
//   g_blank[t,u] = -g ob[t,u] / sum_u' ob[t,u'] for t < t_len, else 0,
//   g_emit[t,u]  = -g oe[t,u] / sum_t' oe[t',u] for u < u_len, else 0.
//
// The forward and beta are the TPU kernel's semantics exactly: the -1e30
// sentinel outside the lattice, the clamp after every logaddexp, cells past
// t_len computed but never read out. The TPU kernel's gradients are -g ob
// and -g oe. Every path takes one blank out of each frame t < t_len and
// emits each label u < u_len once, so in exact arithmetic each such row of
// ob and column of oe sums to 1 and the two agree. In float32 alpha + beta
// - logZ is a difference of numbers in the thousands, so ob and oe carry an
// error of ~1e-3 common to a row (column); dividing by the row's (column's)
// own sum removes it, and the gradients are then as exact as autograd
// through the forward.
//
// Bound: a few MB move (at B=32, T'=374, U+1=65: 6.2 MB in, 3.1 MB of
// alpha out), and the work is a chain of T+U dependent steps (438 at that
// shape), each a logaddexp and a barrier, so the chain's latency and not
// the card's rates sets the time.
//
// Design: the TPU kernel skews the lattice to diagonal-major order in
// memory and runs the wavefront on (8, 128)-lane slabs through a
// barrel shifter; none of that is needed here. One block per batch row,
// one thread per u: at diagonal d, thread u holds cell (d-u, u), reads it
// straight from [B,T,U+1], and takes its left neighbour's value through a
// double-buffered shared array (one barrier per diagonal). The cells of the
// next 16 diagonals are loaded into registers while the current 16 are
// computed, which hides the loads' latency behind the chain. In the
// backward, thread u keeps its column's sum of oe in a register and adds
// ob into a shared row sum (the threads of one diagonal touch distinct
// rows, and a barrier separates diagonals); a last pass over the lattice,
// coalesced over u, scales both outputs. T + 2(U+1) floats of shared
// memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int CH = 16;   // diagonals per register-staged chunk

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ void load_chunk(const float* __restrict__ x,
                                           const float* __restrict__ y, int d0, int u, int T,
                                           int U1, float (&xs)[CH], float (&ys)[CH]) {
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int t = d0 + k - u;
    const bool ok = u < U1 && t >= 0 && t < T;
    xs[k] = ok ? x[(size_t)t * U1 + u] : kNeg;
    ys[k] = ok ? y[(size_t)t * U1 + u] : kNeg;
  }
}

__global__ void rnnt_lattice_fwd_kernel(const float* __restrict__ lpb,
                                        const float* __restrict__ lpe,
                                        const int* __restrict__ tlen,
                                        const int* __restrict__ ulen, float* __restrict__ nll,
                                        float* __restrict__ alpha, int T, int U1) {
  extern __shared__ float sh[];     // [2][U1] neighbour exchange, then [1] readout
  const int b = blockIdx.x, u = threadIdx.x;
  const int tl = tlen[b], ul = ulen[b];
  const int dterm = tl + ul - 1;
  const int D = T + U1 - 1;
  const float* xb = lpb + (size_t)b * T * U1;
  const float* xe = lpe + (size_t)b * T * U1;
  float* ab = alpha + (size_t)b * T * U1;
  float* fin = sh + 2 * U1;
  if (u == 0) *fin = kNeg;
  float al = (u == 0) ? 0.f : kNeg;
  float cb[CH], ce[CH], nb[CH], ne[CH];
  load_chunk(xb, xe, 0, u, T, U1, cb, ce);
  for (int d0 = 0; d0 < D; d0 += CH) {
    load_chunk(xb, xe, d0 + CH, u, T, U1, nb, ne);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int d = d0 + k;
      if (d >= D) break;
      const int t = d - u;
      const bool ok = u < U1 && t >= 0 && t < T;
      if (ok) ab[(size_t)t * U1 + u] = al;
      const float cand = al + cb[k];
      if (u < U1) sh[(d & 1) * U1 + u] = al + ce[k];
      if (d == dterm && u == ul) *fin = cand;
      __syncthreads();
      const float left = (u > 0 && u < U1) ? sh[(d & 1) * U1 + u - 1] : kNeg;
      al = fmaxf(lae(cand, left), kNeg);
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      cb[k] = nb[k];
      ce[k] = ne[k];
    }
  }
  __syncthreads();
  if (u == 0) nll[b] = -*fin;
}

__global__ void rnnt_lattice_bwd_kernel(const float* __restrict__ lpb,
                                        const float* __restrict__ lpe,
                                        const float* __restrict__ alpha,
                                        const int* __restrict__ tlen,
                                        const int* __restrict__ ulen,
                                        const float* __restrict__ nll,
                                        const float* __restrict__ g, float* __restrict__ gblank,
                                        float* __restrict__ gemit, int T, int U1) {
  extern __shared__ float sh[];     // [2][U1] neighbour exchange, then [T] row sums
  float* srow = sh + 2 * U1;
  const int b = blockIdx.x, u = threadIdx.x;
  const int tl = tlen[b], ul = ulen[b];
  const int dterm = tl + ul - 1;
  const int D = T + U1 - 1;
  const float logz = -nll[b];
  const float gg = g[b];
  const size_t base = (size_t)b * T * U1;
  // zeroed before any thread's first barrier, added to only after it
  for (int t = u; t < T; t += blockDim.x) srow[t] = 0.f;
  float csum = 0.f;                 // this thread's column sum of oe
  float be = kNeg;                  // beta of this thread's cell on diagonal d+1
  float cb[CH], ce[CH], ca[CH], nb[CH], ne[CH], na[CH];
  // chunks walk the diagonals downwards: slot k holds diagonal d0 - k
  auto load_rev = [&](int d0, float (&xs)[CH], float (&ys)[CH], float (&zs)[CH]) {
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int t = d0 - k - u;
      const bool ok = u < U1 && t >= 0 && t < T;
      xs[k] = ok ? lpb[base + (size_t)t * U1 + u] : kNeg;
      ys[k] = ok ? lpe[base + (size_t)t * U1 + u] : kNeg;
      zs[k] = ok ? alpha[base + (size_t)t * U1 + u] : kNeg;
    }
  };
  load_rev(D - 1, cb, ce, ca);
  for (int d0 = D - 1; d0 >= 0; d0 -= CH) {
    load_rev(d0 - CH, nb, ne, na);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int d = d0 - k;
      if (d < 0) break;
      const int t = d - u;
      const bool ok = u < U1 && t >= 0 && t < T;
      if (u < U1) sh[(d & 1) * U1 + u] = be;
      __syncthreads();
      const float b1 = (d == dterm && u == ul) ? 0.f : be;
      const float b2 = (u + 1 < U1) ? sh[(d & 1) * U1 + u + 1] : kNeg;
      be = fmaxf(lae(cb[k] + b1, ce[k] + b2), kNeg);
      if (ok) {
        const float ob = expf(ca[k] + cb[k] + b1 - logz);
        const float oe = expf(ca[k] + ce[k] + b2 - logz);
        gblank[base + (size_t)t * U1 + u] = ob;
        gemit[base + (size_t)t * U1 + u] = oe;
        srow[t] += ob;
        csum += oe;
      }
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      cb[k] = nb[k];
      ce[k] = ne[k];
      ca[k] = na[k];
    }
  }
  // row and column sums -> scales, then one coalesced pass over the lattice
  __syncthreads();
  for (int t = u; t < T; t += blockDim.x)
    srow[t] = (t < tl && srow[t] > 0.f) ? -gg / srow[t] : 0.f;
  __syncthreads();
  if (u >= U1) return;
  const float sc_e = (u < ul && csum > 0.f) ? -gg / csum : 0.f;
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const size_t o = base + (size_t)t * U1 + u;
    gblank[o] *= srow[t];
    gemit[o] *= sc_e;
  }
}

int threads_for(int U1) { return ((U1 + 31) / 32) * 32; }

}  // namespace

extern "C" int rnnt_lattice_fwd(const void* lpb, const void* lpe, const void* tlen,
                                const void* ulen, void* nll, void* alpha, void* stream, int B,
                                int T, int U1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rnnt_lattice_fwd_kernel<<<B, threads_for(U1), sizeof(float) * (2 * U1 + 1), st>>>(
      static_cast<const float*>(lpb), static_cast<const float*>(lpe),
      static_cast<const int*>(tlen), static_cast<const int*>(ulen), static_cast<float*>(nll),
      static_cast<float*>(alpha), T, U1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rnnt_lattice_bwd(const void* lpb, const void* lpe, const void* alpha,
                                const void* tlen, const void* ulen, const void* nll,
                                const void* g, void* gblank, void* gemit, void* stream, int B,
                                int T, int U1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (2 * (size_t)U1 + T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rnnt_lattice_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rnnt_lattice_bwd_kernel<<<B, threads_for(U1), smem, st>>>(
      static_cast<const float*>(lpb), static_cast<const float*>(lpe),
      static_cast<const float*>(alpha), static_cast<const int*>(tlen),
      static_cast<const int*>(ulen), static_cast<const float*>(nll),
      static_cast<const float*>(g), static_cast<float*>(gblank), static_cast<float*>(gemit), T,
      U1);
  return static_cast<int>(cudaGetLastError());
}
