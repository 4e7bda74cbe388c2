// CTC DP (alpha forward, beta backward) over extended labels for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/ctc_kernel.py
// (_forward / _fwd_kernel and _backward / _bwd_kernel). Input: the
// emissions of the extended labels emit [B,T,S] (S = 2U+1, blank at even
// s; selected from the log-probs beforehand), skip [B,S] (0 where the
// s-2 -> s transition is allowed, else -1e30), lengths t_len, u_len [B].
// Forward, per row:
//
//   alpha[0,s] = emit[0,s] for s = 0, and s = 1 when u_len > 0; else -1e30,
//   alpha[t,s] = max(logaddexp(logaddexp(alpha[t-1,s], alpha[t-1,s-1]),
//                              alpha[t-1,s-2] + skip[s]) + emit[t,s], -1e30)
//                for t < t_len, frozen (= alpha[t-1,s]) for t >= t_len,
//   nll = -logaddexp(alpha[T-1, 2u_len], alpha[T-1, 2u_len-1] if u_len > 0),
//
// saving alpha [B,T,S]. Backward, from the upstream g [B]:
//
//   bh[t,s] = 0 / -1e30 at the terminal lanes {2u_len, 2u_len-1} when
//             t >= t_len-1, else the carried beta[t],
//   occ[t,s]    = exp(alpha[t,s] + bh[t,s] - logZ) for t < t_len, else 0,
//   g_emit[t,s] = -g occ[t,s] / sum_s' occ[t,s'],
//   beta[t-1,s] = max(logaddexp(logaddexp(v[s], v[s+1]), v[s+2] + skip[s+2]),
//                     -1e30),   v = emit[t] + bh[t],   logZ = -nll.
//
// Every path passes one state per frame, so each live frame's occupancies
// sum to 1 in exact arithmetic, and the TPU kernel's g_emit is -g occ. In
// float32 alpha + bh - logZ is a difference of numbers in the thousands
// (|logZ| ~ 2500 at T' = 374, V = 5002), so occ carries an error of ~1e-3
// common to a frame; dividing by the frame's own sum removes it, and the
// gradient is then as exact as autograd through the forward.
//
// Bound: a few MB move (at B=32, T'=374, S=129: 6.2 MB of emit in, 6.2 MB
// of alpha out), and the work is a chain of T dependent steps, each a few
// logaddexps and a barrier: the chain's latency sets the time.
//
// Design: the TPU kernel streams time-major [T_TILE, 8|32, 128-lane] slabs
// with the wavefront carried across sequential grid steps. Here one block
// per batch row walks all of T with one thread per state s, reading
// emit[b,t,:] straight from [B,T,S] (coalesced over s) and exchanging the
// s-1 and s-2 neighbours through a double-buffered shared array, one
// barrier per step. The next 16 steps' emissions are loaded into
// registers while the current 16 are computed. S <= 1024. After the beta
// walk, a second pass gives each thread whole frames: it sums the frame's
// S occupancies and scales them by -g / sum.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int CH = 16;   // time steps per register-staged chunk

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void ctc_dp_fwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                                  const int* __restrict__ tlen, const int* __restrict__ ulen,
                                  float* __restrict__ nll, float* __restrict__ alpha, int T,
                                  int S) {
  extern __shared__ float sh[];     // [2][S]
  const int b = blockIdx.x, s = threadIdx.x;
  const bool live = s < S;
  const int tl = tlen[b], ul = ulen[b];
  const size_t base = (size_t)b * T * S;
  const float sk = live ? skip[(size_t)b * S + s] : kNeg;
  float ce[CH], ne[CH];
  auto load = [&](int t0, float (&xs)[CH]) {
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int t = t0 + k;
      xs[k] = (live && t < T) ? emit[base + (size_t)t * S + s] : kNeg;
    }
  };
  load(0, ce);
  float al = kNeg;
  for (int t0 = 0; t0 < T; t0 += CH) {
    load(t0 + CH, ne);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int t = t0 + k;
      if (t >= T) break;
      if (t == 0) {
        al = (s < 2 && !(s == 1 && ul == 0)) ? ce[k] : kNeg;
      } else {
        if (live) sh[(t & 1) * S + s] = al;
        __syncthreads();
        const float f1 = (live && s >= 1) ? sh[(t & 1) * S + s - 1] : kNeg;
        const float f2 = (live && s >= 2) ? sh[(t & 1) * S + s - 2] + sk : kNeg;
        const float upd = fmaxf(lae(lae(al, f1), f2) + ce[k], kNeg);
        if (t < tl) al = upd;
      }
      if (live) alpha[base + (size_t)t * S + s] = al;
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) ce[k] = ne[k];
  }
  __syncthreads();
  if (live) sh[s] = al;
  __syncthreads();
  if (s == 0) {
    const float fb = sh[2 * ul];
    const float fl = ul > 0 ? sh[2 * ul - 1] : kNeg;
    nll[b] = -lae(fb, fl);
  }
}

__global__ void ctc_dp_bwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                                  const float* __restrict__ alpha, const int* __restrict__ tlen,
                                  const int* __restrict__ ulen, const float* __restrict__ nll,
                                  const float* __restrict__ g, float* __restrict__ gemit, int T,
                                  int S) {
  extern __shared__ float sh[];     // [2][S]
  const int b = blockIdx.x, s = threadIdx.x;
  const bool live = s < S;
  const int tl = tlen[b], ul = ulen[b];
  const size_t base = (size_t)b * T * S;
  const float logz = -nll[b];
  const float gg = g[b];
  const float sk2 = (s + 2 < S) ? skip[(size_t)b * S + s + 2] : kNeg;
  const float term = (s == 2 * ul || (s == 2 * ul - 1 && ul > 0)) ? 0.f : kNeg;
  float ce[CH], ca[CH], ne[CH], na[CH];
  // chunks walk time downwards: slot k holds step t0 - k
  auto load = [&](int t0, float (&xs)[CH], float (&ys)[CH]) {
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int t = t0 - k;
      const bool ok = live && t >= 0;
      xs[k] = ok ? emit[base + (size_t)t * S + s] : kNeg;
      ys[k] = ok ? alpha[base + (size_t)t * S + s] : kNeg;
    }
  };
  load(T - 1, ce, ca);
  float beta = kNeg;
  for (int t0 = T - 1; t0 >= 0; t0 -= CH) {
    load(t0 - CH, ne, na);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int t = t0 - k;
      if (t < 0) break;
      const float bh = (t >= tl - 1) ? term : beta;
      if (live) gemit[base + (size_t)t * S + s] = t < tl ? expf(ca[k] + bh - logz) : 0.f;
      const float v = ce[k] + bh;
      if (live) sh[(t & 1) * S + s] = v;
      __syncthreads();
      const float n1 = (s + 1 < S) ? sh[(t & 1) * S + s + 1] : kNeg;
      const float n2 = (s + 2 < S) ? sh[(t & 1) * S + s + 2] + sk2 : kNeg;
      beta = fmaxf(lae(lae(v, n1), n2), kNeg);
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      ce[k] = ne[k];
      ca[k] = na[k];
    }
  }
  // each live frame's occupancies, divided by their sum, times -g
  __syncthreads();
  for (int t = threadIdx.x; t < tl && t < T; t += blockDim.x) {
    float* row = gemit + base + (size_t)t * S;
    float sum = 0.f;
#pragma unroll 8
    for (int j = 0; j < S; ++j) sum += row[j];
    const float sc = sum > 0.f ? -gg / sum : 0.f;
#pragma unroll 8
    for (int j = 0; j < S; ++j) row[j] *= sc;
  }
}

int threads_for(int S) { return ((S + 31) / 32) * 32; }

}  // namespace

extern "C" int ctc_dp_fwd(const void* emit, const void* skip, const void* tlen, const void* ulen,
                          void* nll, void* alpha, void* stream, int B, int T, int S) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ctc_dp_fwd_kernel<<<B, threads_for(S), sizeof(float) * 2 * S, st>>>(
      static_cast<const float*>(emit), static_cast<const float*>(skip),
      static_cast<const int*>(tlen), static_cast<const int*>(ulen), static_cast<float*>(nll),
      static_cast<float*>(alpha), T, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctc_dp_bwd(const void* emit, const void* skip, const void* alpha,
                          const void* tlen, const void* ulen, const void* nll, const void* g,
                          void* gemit, void* stream, int B, int T, int S) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ctc_dp_bwd_kernel<<<B, threads_for(S), sizeof(float) * 2 * S, st>>>(
      static_cast<const float*>(emit), static_cast<const float*>(skip),
      static_cast<const float*>(alpha), static_cast<const int*>(tlen),
      static_cast<const int*>(ulen), static_cast<const float*>(nll),
      static_cast<const float*>(g), static_cast<float*>(gemit), T, S);
  return static_cast<int>(cudaGetLastError());
}
