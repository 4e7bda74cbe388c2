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
// barrel shifter; none of that is needed here. One block per batch row;
// its threads (at most 512) walk u with a block stride: thread tid owns
// u = tid + i * blockDim for i < NS, so any U+1 whose shared arrays fit in
// shared memory runs. At diagonal d the thread holds cells (d-u, u), reads
// them straight from [B,T,U+1], and takes each left neighbour's value
// through a double-buffered shared array (one barrier per diagonal). The
// cells of the next CH = 16 / NS diagonals are loaded into registers while
// the current CH are computed, which hides the loads' latency behind the
// chain (16 diagonals at NS = 1, the recipe's U+1 <= 512). In the
// backward, each thread keeps its columns' sums of oe in registers and
// adds ob into a shared row sum (the cells of one diagonal lie in distinct
// rows, and a barrier separates diagonals); a last pass over the lattice,
// coalesced over u, scales both outputs. 2(U+1) + 1 floats of shared
// memory in the forward, 2(U+1) + T in the backward.

#include "lattice_dp_common.cuh"

namespace {

using namespace lattice_dp;

template <int NS>
__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_lattice_fwd_kernel(const float* __restrict__ lpb, const float* __restrict__ lpe,
                            const int* __restrict__ tlen, const int* __restrict__ ulen,
                            float* __restrict__ nll, float* __restrict__ alpha, int T, int U1) {
  constexpr int CH = chunk<NS>();
  extern __shared__ float sh[];     // [2][U1] neighbour exchange, then [1] readout
  const int b = blockIdx.x, nt = blockDim.x;
  const int tl = tlen[b], ul = ulen[b];
  const int dterm = tl + ul - 1;
  const int D = T + U1 - 1;
  const float* xb = lpb + (size_t)b * T * U1;
  const float* xe = lpe + (size_t)b * T * U1;
  float* ab = alpha + (size_t)b * T * U1;
  float* fin = sh + 2 * U1;
  if (threadIdx.x == 0) *fin = kNeg;
  int us[NS];
  float al[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    us[i] = threadIdx.x + i * nt;
    al[i] = us[i] == 0 ? 0.f : kNeg;
  }
  float cb[NS][CH], ce[NS][CH], nb[NS][CH], ne[NS][CH];
  auto load = [&](int d0, float (&xs)[NS][CH], float (&ys)[NS][CH]) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int u = us[i], t = d0 + k - u;
        const bool ok = u < U1 && t >= 0 && t < T;
        xs[i][k] = ok ? xb[(size_t)t * U1 + u] : kNeg;
        ys[i][k] = ok ? xe[(size_t)t * U1 + u] : kNeg;
      }
  };
  load(0, cb, ce);
  for (int d0 = 0; d0 < D; d0 += CH) {
    load(d0 + CH, nb, ne);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int d = d0 + k;
      if (d >= D) break;
      float* cur = sh + (d & 1) * U1;
      float cand[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int u = us[i], t = d - u;
        if (u < U1 && t >= 0 && t < T) ab[(size_t)t * U1 + u] = al[i];
        cand[i] = al[i] + cb[i][k];
        if (u < U1) cur[u] = al[i] + ce[i][k];
        if (d == dterm && u == ul) *fin = cand[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int u = us[i];
        const float left = (u > 0 && u < U1) ? cur[u - 1] : kNeg;
        al[i] = fmaxf(lae(cand[i], left), kNeg);
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        cb[i][k] = nb[i][k];
        ce[i][k] = ne[i][k];
      }
  }
  __syncthreads();
  if (threadIdx.x == 0) nll[b] = -*fin;
}

template <int NS>
__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_lattice_bwd_kernel(const float* __restrict__ lpb, const float* __restrict__ lpe,
                            const float* __restrict__ alpha, const int* __restrict__ tlen,
                            const int* __restrict__ ulen, const float* __restrict__ nll,
                            const float* __restrict__ g, float* __restrict__ gblank,
                            float* __restrict__ gemit, int T, int U1) {
  constexpr int CH = chunk<NS>();
  extern __shared__ float sh[];     // [2][U1] neighbour exchange, then [T] row sums
  float* srow = sh + 2 * U1;
  const int b = blockIdx.x, nt = blockDim.x;
  const int tl = tlen[b], ul = ulen[b];
  const int dterm = tl + ul - 1;
  const int D = T + U1 - 1;
  const float logz = -nll[b];
  const float gg = g[b];
  const size_t base = (size_t)b * T * U1;
  // zeroed before any thread's first barrier, added to only after it
  for (int t = threadIdx.x; t < T; t += nt) srow[t] = 0.f;
  int us[NS];
  float csum[NS], be[NS];           // column sums of oe; beta on diagonal d+1
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    us[i] = threadIdx.x + i * nt;
    csum[i] = 0.f;
    be[i] = kNeg;
  }
  float cb[NS][CH], ce[NS][CH], ca[NS][CH], nb[NS][CH], ne[NS][CH], na[NS][CH];
  // chunks walk the diagonals downwards: slot k holds diagonal d0 - k
  auto load_rev = [&](int d0, float (&xs)[NS][CH], float (&ys)[NS][CH],
                      float (&zs)[NS][CH]) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int u = us[i], t = d0 - k - u;
        const bool ok = u < U1 && t >= 0 && t < T;
        xs[i][k] = ok ? lpb[base + (size_t)t * U1 + u] : kNeg;
        ys[i][k] = ok ? lpe[base + (size_t)t * U1 + u] : kNeg;
        zs[i][k] = ok ? alpha[base + (size_t)t * U1 + u] : kNeg;
      }
  };
  load_rev(D - 1, cb, ce, ca);
  for (int d0 = D - 1; d0 >= 0; d0 -= CH) {
    load_rev(d0 - CH, nb, ne, na);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int d = d0 - k;
      if (d < 0) break;
      float* cur = sh + (d & 1) * U1;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (us[i] < U1) cur[us[i]] = be[i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int u = us[i], t = d - u;
        const float b1 = (d == dterm && u == ul) ? 0.f : be[i];
        const float b2 = (u + 1 < U1) ? cur[u + 1] : kNeg;
        be[i] = fmaxf(lae(cb[i][k] + b1, ce[i][k] + b2), kNeg);
        if (u < U1 && t >= 0 && t < T) {
          const float ob = expf(ca[i][k] + cb[i][k] + b1 - logz);
          const float oe = expf(ca[i][k] + ce[i][k] + b2 - logz);
          gblank[base + (size_t)t * U1 + u] = ob;
          gemit[base + (size_t)t * U1 + u] = oe;
          srow[t] += ob;
          csum[i] += oe;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        cb[i][k] = nb[i][k];
        ce[i][k] = ne[i][k];
        ca[i][k] = na[i][k];
      }
  }
  // row and column sums -> scales, then one coalesced pass over the lattice
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += nt)
    srow[t] = (t < tl && srow[t] > 0.f) ? -gg / srow[t] : 0.f;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int u = us[i];
    if (u >= U1) continue;
    const float sc_e = (u < ul && csum[i] > 0.f) ? -gg / csum[i] : 0.f;
#pragma unroll 8
    for (int t = 0; t < T; ++t) {
      const size_t o = base + (size_t)t * U1 + u;
      gblank[o] *= srow[t];
      gemit[o] *= sc_e;
    }
  }
}

}  // namespace

// Shared memory of one block, the limit on U1 that the wrapper checks
// (ops/rnnt_lattice.py): 2 U1 + 1 floats forward, 2 U1 + T backward.
extern "C" int rnnt_lattice_fwd(const void* lpb, const void* lpe, const void* tlen,
                                const void* ulen, void* nll, void* alpha, void* stream, int B,
                                int T, int U1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int ns, threads;
  shape_for(U1, &ns, &threads);
  const size_t smem = sizeof(float) * (2 * (size_t)U1 + 1);
  auto run = [&](auto kernel) {
    return run_kernel(kernel, B, threads, smem, st, static_cast<const float*>(lpb),
                      static_cast<const float*>(lpe), static_cast<const int*>(tlen),
                      static_cast<const int*>(ulen), static_cast<float*>(nll),
                      static_cast<float*>(alpha), T, U1);
  };
  auto dispatch = [&]() -> cudaError_t { LATTICE_DP_DISPATCH(rnnt_lattice_fwd_kernel) };
  return static_cast<int>(dispatch());
}

extern "C" int rnnt_lattice_bwd(const void* lpb, const void* lpe, const void* alpha,
                                const void* tlen, const void* ulen, const void* nll,
                                const void* g, void* gblank, void* gemit, void* stream, int B,
                                int T, int U1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int ns, threads;
  shape_for(U1, &ns, &threads);
  const size_t smem = sizeof(float) * (2 * (size_t)U1 + T);
  auto run = [&](auto kernel) {
    return run_kernel(kernel, B, threads, smem, st, static_cast<const float*>(lpb),
                      static_cast<const float*>(lpe), static_cast<const float*>(alpha),
                      static_cast<const int*>(tlen), static_cast<const int*>(ulen),
                      static_cast<const float*>(nll), static_cast<const float*>(g),
                      static_cast<float*>(gblank), static_cast<float*>(gemit), T, U1);
  };
  auto dispatch = [&]() -> cudaError_t { LATTICE_DP_DISPATCH(rnnt_lattice_bwd_kernel) };
  return static_cast<int>(dispatch());
}
