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
// shape), each a logaddexp and an exchange between neighbouring u, so the
// chain's latency and not the card's rates sets the time. Its floor (the
// same grid and exchanges, one logaddexp a step on every cell, no loads or
// stores) is measured by scripts/torch_rnnt_lattice_ablation.py.
//
// Design, U+1 <= 320 (every shipped bucket: the recipe's 65, the fit's
// padded 201; above it these kernels measured slower than the block path
// below): one block per batch row, 16 warps where U+1 <= 128, else 8.
//  - Warp 0 runs the wavefront alone, so no step needs a block barrier.
//    Lane l owns the run of C = ceil((U+1)/32) consecutive cells u = l*C +
//    j; the cells of one diagonal do not depend on each other, so a lane's
//    C cells are parallel work, and only the neighbour across a lane edge
//    moves, by one __shfl_up_sync (forward) or __shfl_down_sync (backward)
//    a diagonal. A step has no branch (the last block's steps past the
//    lattice meet only sentinels), so the compiler lays steps over each
//    other.
//  - The warps on the other three schedulers feed it through shared
//    memory (the ones that share warp 0's only meet the barriers). The
//    diagonals go in blocks of R (32 at C <= 4, 16 at C <= 8, else 8):
//    while warp 0 walks block k, they copy block k+2's cells in (4-byte
//    cp.async: a frame of a row starts at float (b T + t)(U+1), which is
//    not 16-byte aligned where U+1 is odd) and write block k-1's outputs
//    out; one __syncthreads a block hands both over, and block k+1's
//    copies have had a whole block to land. The cells of R diagonals are,
//    frame by frame, runs of up to R consecutive u: each warp instruction
//    reads or writes whole runs, coalesced, where the wavefront's own
//    order (one cell per frame, U+1 floats apart) would touch a sector per
//    lane. In shared memory the cells sit diagonal-major ([R][32C+1], cell
//    u at (u % C) * 32 + u / C), so warp 0 reads a diagonal without bank
//    conflicts. Staging whole frames instead would hold the U+1 frames a
//    diagonal spans: 2(U+1)^2 floats, 323 KB at U+1 = 201. The copies, not
//    the chain, bound these kernels (the ablation script's "copies
//    alone"): on an H100 the recipe's forward took 44 us with 6 copy
//    warps, 32 us with 12.
//  - logaddexp(a, b) = max + lg2(1 + ex2(-|a - b| log2 e)) ln 2, on the
//    MUFU approximations behind __expf and __logf: two MUFU operations
//    where expf and log1pf are library sequences on the chain. Its error
//    against the accurate form is at most ~6.6e-7 a step (the CUDA Math
//    API's bounds of __expf and __logf on [1, 2], plus the rounding of 1 +
//    y); tests/test_torch_losses.py holds that arithmetic, emulated, to
//    the float64 gradient and JAX's NLL at |logZ| ~ 2700. The occupancies
//    use ex2 too (relative error (2 + 1.173 |x|) ulp, as __expf).
//  - Forward: alpha goes to a diagonal-major ring and out as runs. The
//    NLL is kept by the lane that owns u_len.
//  - Backward: the row sum of ob travels with the wavefront (cell (t,u)
//    adds its ob to the sum handed over by (t,u+1), the same shuffle
//    direction as beta), so row t's sum is complete in lane 0 at diagonal
//    t; each lane keeps its columns' sums of oe. ob and oe go out unscaled
//    as runs; a last pass of all warps scales both, coalesced over u.
//    Storing a row of g_blank once, scaled, would hold each ob for up to
//    U+1 diagonals, (U+1 + 2R)(32C+1) floats: more than a block has at
//    U+1 = 201.
//  Shared memory: input rings of 3 blocks, output rings of 2: 8 R (32C+1)
//  floats forward (<= 132 KB), 13 R (32C+1) + 32C + T backward (<= 215
//  KB + 4T bytes).
//
// Above U+1 = 320, or where the backward's rings and row sums do not fit,
// the first design runs: one block per row whose threads (at most 512)
// walk u with a block stride, NS cells a thread; each left (right)
// neighbour through a double-buffered shared array, one barrier a
// diagonal; the cells of the next CH = 16 / NS diagonals prefetched into
// registers straight from [B,T,U+1]; the accurate logaddexp; the
// backward's row sums in shared memory and a last pass scaling both
// outputs. 2(U+1) + 1 floats of shared memory forward, 2(U+1) + T
// backward: that is the limit the wrappers check (ops/rnnt_lattice.py
// max_u1).

#include "lattice_dp_common.cuh"

namespace {

using namespace lattice_dp;

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_MAX_C = 10;            // cells a lane: U+1 <= 320
// Threads of a block at C cells a lane. Warp 0 runs the wavefront; the
// warps that share its scheduler (warp % 4 == 0) only meet the barriers;
// the others copy.
__host__ __device__ constexpr int wf_threads(int c) { return c <= 4 ? 512 : 256; }
__host__ __device__ constexpr int ncopy(int c) { return wf_threads(c) / 32 / 4 * 3; }
__device__ __forceinline__ int copy_warp(int warp) { return warp - 1 - warp / 4; }

// diagonals a ring block holds, and floats a diagonal's slot holds, at C
// cells a lane
__host__ __device__ constexpr int ring_r(int c) { return c <= 4 ? 32 : c <= 8 ? 16 : 8; }
__host__ __device__ constexpr int ring_s(int c) { return 32 * c + 1; }

// shared memory of the one-warp kernels (bytes): inputs in rings of 3
// blocks, outputs in rings of 2
size_t fwd_warp_smem(int c) { return sizeof(float) * 8 * ring_r(c) * ring_s(c); }
size_t bwd_warp_smem(int c, int T) {
  return sizeof(float) * (13 * (size_t)ring_r(c) * ring_s(c) + 32 * c + T);
}

// wait until at most the newest group of copies is in flight
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The cells (t, u) of diagonals lo .. lo+R-1 go frame by frame: run w
// holds t = lo - (U1-1) + w and u = U1-1-w+v for v < R (diagonal lo + v),
// so a warp's lanes take consecutive u of one frame (32 / R frames at
// once). Copy warp cw takes runs cw * 32 / R + lane / R + m * STEP, m < M,
// G of them at a time, so that G copies of a thread are in flight together.
template <int C>
struct Runs {
  static constexpr int R = ring_r(C), S = ring_s(C), STEP = ncopy(C) * (32 / R), G = 4;
  static constexpr int M = (32 * C + R - 1 + G * STEP - 1) / (G * STEP) * G;   // runs a thread takes, at most
  int v, w0;
  __device__ __forceinline__ Runs(int cw, int lane) : v(lane % R), w0(cw * (32 / R) + lane / R) {}
  // run m: u (outside [0, U1) where the run has no cell for this lane), t
  // and the cell's slot offset
  __device__ __forceinline__ int u(int m, int U1) const { return U1 - 1 - (w0 + m * STEP) + v; }
  __device__ __forceinline__ int t(int m, int lo, int U1) const {
    return lo - (U1 - 1) + w0 + m * STEP;
  }
  __device__ __forceinline__ int slot(int u) const { return v * S + (u % C) * 32 + u / C; }
};

// copy the inputs of diagonals lo .. lo+R-1 into their ring block; cells
// outside 0 <= t < T get the sentinel
template <int C, int N>
__device__ __forceinline__ void stage_inputs(float* const (&dst)[N], const float* const (&src)[N],
                                             int lo, int T, int U1, int cw, int lane) {
  using Rs = Runs<C>;
  const Rs runs(cw, lane);
  uint32_t sd[N];
#pragma unroll
  for (int a = 0; a < N; ++a) sd[a] = smem_addr(dst[a]);
  for (int m0 = 0; m0 < Rs::M; m0 += Rs::G) {
#pragma unroll
    for (int i = 0; i < Rs::G; ++i) {
      const int u = runs.u(m0 + i, U1), t = runs.t(m0 + i, lo, U1);
      if (u < 0 || u >= U1) continue;
      const int o = runs.slot(u);
#pragma unroll
      for (int a = 0; a < N; ++a) {
        if (t >= 0 && t < T)
          cp_async4(sd[a] + 4 * o, src[a] + t * U1 + u);
        else
          dst[a][o] = kNeg;
      }
    }
  }
}

// write the outputs of diagonals lo .. lo+R-1 from their ring block, G
// runs' reads before their writes
template <int C, int N>
__device__ __forceinline__ void flush_outputs(float* const (&dst)[N], const float* const (&src)[N],
                                              int lo, int T, int U1, int cw, int lane) {
  using Rs = Runs<C>;
  const Rs runs(cw, lane);
  for (int m0 = 0; m0 < Rs::M; m0 += Rs::G) {
    float x[Rs::G][N];
#pragma unroll
    for (int i = 0; i < Rs::G; ++i) {
      const int u = runs.u(m0 + i, U1), t = runs.t(m0 + i, lo, U1);
      if (u >= 0 && u < U1 && t >= 0 && t < T) {
#pragma unroll
        for (int a = 0; a < N; ++a) x[i][a] = src[a][runs.slot(u)];
      }
    }
#pragma unroll
    for (int i = 0; i < Rs::G; ++i) {
      const int u = runs.u(m0 + i, U1), t = runs.t(m0 + i, lo, U1);
      if (u >= 0 && u < U1 && t >= 0 && t < T) {
#pragma unroll
        for (int a = 0; a < N; ++a) dst[a][t * U1 + u] = x[i][a];
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(wf_threads(C), 1)
    rnnt_lattice_fwd_warp(const float* __restrict__ lpb, const float* __restrict__ lpe,
                          const int* __restrict__ tlen, const int* __restrict__ ulen,
                          float* __restrict__ nll, float* __restrict__ alpha, int T, int U1) {
  constexpr int R = ring_r(C), S = ring_s(C), BLK = R * S;
  extern __shared__ float sh[];     // rings [3][R][S]: lp_blank, lp_emit; [2][R][S]: alpha
  float* rb = sh;
  float* re = sh + 3 * BLK;
  float* ra = sh + 6 * BLK;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool copier = warp % 4 != 0;
  const int cw = copy_warp(warp);
  const int D = T + U1 - 1, nblk = (D + R - 1) / R;
  const size_t base = (size_t)b * T * U1;
  const float* const src[2] = {lpb + base, lpe + base};
  float* const out[1] = {alpha + base};
  // padding cells (u >= U1) are never copied: they keep the sentinel
  for (int i = tid; i < 6 * BLK; i += wf_threads(C)) sh[i] = kNeg;
  __syncthreads();
  if (copier) {         // blocks 0 and 1 in flight, block 0 landed
    for (int k = 0; k < 2; ++k) {
      float* const dst[2] = {rb + k * BLK, re + k * BLK};
      if (k < nblk) stage_inputs<C>(dst, src, k * R, T, U1, cw, lane);
      cp_async_commit();
    }
    cp_async_wait_but_newest();
  }
  __syncthreads();

  const int ul = ulen[b];
  const int dterm = tlen[b] + ul - 1;
  const int jfin = ul - lane * C;   // the NLL's cell in this lane, if in [0, C)
  float al[C];
#pragma unroll
  for (int j = 0; j < C; ++j) al[j] = (lane == 0 && j == 0) ? 0.f : kNeg;
  float fin = kNeg;

  for (int k = 0; k < nblk; ++k) {
    const int lo = k * R;
    if (tid < 32) {
      const float* pb = rb + (k % 3) * BLK + lane;
      const float* pe = re + (k % 3) * BLK + lane;
      float* pa = ra + (k & 1) * BLK + lane;
      float nb[C], ne[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        nb[j] = pb[j * 32];
        ne[j] = pe[j * 32];
      }
      // no branch in a step, so that the compiler can lay the steps over
      // each other: the last block's steps past D meet only sentinels, and
      // the last step's read of the next slot wraps to an unused one
#pragma unroll 4
      for (int s = 0; s < R; ++s) {
        float cb[C], ce[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          cb[j] = nb[j];
          ce[j] = ne[j];
        }
        const int sn = (s + 1) & (R - 1);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          nb[j] = pb[sn * S + j * 32];
          ne[j] = pe[sn * S + j * 32];
        }
        float cand[C], e[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          cand[j] = al[j] + cb[j];
          e[j] = al[j] + ce[j];
          pa[s * S + j * 32] = al[j];
        }
        const bool term = lo + s == dterm;
#pragma unroll
        for (int j = 0; j < C; ++j) fin = (term && j == jfin) ? cand[j] : fin;
        // the left neighbour across the lane edge; the cells that do not
        // wait for it first, the last (the next exchange's source) leading
        float left = __shfl_up_sync(FULL, e[C - 1], 1);
        left = lane == 0 ? kNeg : left;
#pragma unroll
        for (int j = C - 1; j > 0; --j) al[j] = fmaxf(lae_fast(cand[j], e[j - 1]), kNeg);
        al[0] = fmaxf(lae_fast(cand[0], left), kNeg);
      }
    } else if (copier) {  // block k+2 in, block k-1 out; block k+1 landed
      if (k + 2 < nblk) {
        float* const dst[2] = {rb + (k + 2) % 3 * BLK, re + (k + 2) % 3 * BLK};
        stage_inputs<C>(dst, src, lo + 2 * R, T, U1, cw, lane);
      }
      cp_async_commit();
      if (k > 0) {
        const float* const from[1] = {ra + ((k - 1) & 1) * BLK};
        flush_outputs<C>(out, from, lo - R, T, U1, cw, lane);
      }
      cp_async_wait_but_newest();
    }
    __syncthreads();
  }
  if (copier) {
    const float* const from[1] = {ra + ((nblk - 1) & 1) * BLK};
    flush_outputs<C>(out, from, (nblk - 1) * R, T, U1, cw, lane);
  } else if (tid < 32 && lane == min(ul / C, 31)) {
    nll[b] = -fin;
  }
}

template <int C>
__global__ void __launch_bounds__(wf_threads(C), 1)
    rnnt_lattice_bwd_warp(const float* __restrict__ lpb, const float* __restrict__ lpe,
                          const float* __restrict__ alpha, const int* __restrict__ tlen,
                          const int* __restrict__ ulen, const float* __restrict__ nll,
                          const float* __restrict__ g, float* __restrict__ gblank,
                          float* __restrict__ gemit, int T, int U1) {
  constexpr int R = ring_r(C), S = ring_s(C), BLK = R * S;
  // rings [3][R][S]: lp_blank, lp_emit, alpha in; [2][R][S]: ob, oe out;
  // then the column scales [32C] and the row sums, then scales, [T]
  extern __shared__ float sh[];
  float* rb = sh;
  float* re = sh + 3 * BLK;
  float* ra = sh + 6 * BLK;
  float* rob = sh + 9 * BLK;
  float* roe = sh + 11 * BLK;
  float* scol = sh + 13 * BLK;
  float* srow = scol + 32 * C;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool copier = warp % 4 != 0;
  const int cw = copy_warp(warp);
  const int D = T + U1 - 1, nblk = (D + R - 1) / R;
  const size_t base = (size_t)b * T * U1;
  const float* const src[3] = {lpb + base, lpe + base, alpha + base};
  float* const out[2] = {gblank + base, gemit + base};
  // blocks walk the diagonals downwards: block k holds lo(k) .. lo(k)+R-1
  auto lo_of = [&](int k) { return D - (k + 1) * R; };
  for (int i = tid; i < 9 * BLK; i += wf_threads(C)) sh[i] = kNeg;
  __syncthreads();
  if (copier) {         // blocks 0 and 1 in flight, block 0 landed
    for (int k = 0; k < 2; ++k) {
      float* const dst[3] = {rb + k * BLK, re + k * BLK, ra + k * BLK};
      if (k < nblk) stage_inputs<C>(dst, src, lo_of(k), T, U1, cw, lane);
      cp_async_commit();
    }
    cp_async_wait_but_newest();
  }
  __syncthreads();

  const int tl = tlen[b], ul = ulen[b];
  const int dterm = tl + ul - 1;
  const int jterm = ul - lane * C;  // the terminal cell in this lane, if in [0, C)
  const float logz = -nll[b];
  const float gg = g[b];
  float be[C], rs[C], csum[C];      // beta on diagonal d+1; row sums of ob; column sums of oe
#pragma unroll
  for (int j = 0; j < C; ++j) {
    be[j] = kNeg;
    rs[j] = 0.f;
    csum[j] = 0.f;
  }

  for (int k = 0; k < nblk; ++k) {
    const int lo = lo_of(k);
    if (tid < 32) {
      const float* pb = rb + (k % 3) * BLK + lane;
      const float* pe = re + (k % 3) * BLK + lane;
      const float* pa = ra + (k % 3) * BLK + lane;
      float* pob = rob + (k & 1) * BLK + lane;
      float* poe = roe + (k & 1) * BLK + lane;
      float nb[C], ne[C], na[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        nb[j] = pb[(R - 1) * S + j * 32];
        ne[j] = pe[(R - 1) * S + j * 32];
        na[j] = pa[(R - 1) * S + j * 32];
      }
      // no branch in a step (as in the forward): the last block's steps
      // below 0 meet only sentinels and add nothing to the sums
#pragma unroll 4
      for (int s = R - 1; s >= 0; --s) {
        const int d = lo + s;
        float cb[C], ce[C], ca[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          cb[j] = nb[j];
          ce[j] = ne[j];
          ca[j] = na[j];
        }
        const int sp = (s - 1) & (R - 1);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          nb[j] = pb[sp * S + j * 32];
          ne[j] = pe[sp * S + j * 32];
          na[j] = pa[sp * S + j * 32];
        }
        const bool term = d == dterm;
        float b1[C], b2[C];
#pragma unroll
        for (int j = 0; j < C; ++j) b1[j] = (term && j == jterm) ? 0.f : be[j];
        float right = __shfl_down_sync(FULL, be[0], 1);
        float rright = __shfl_down_sync(FULL, rs[0], 1);
        right = lane == 31 ? kNeg : right;
        rright = lane == 31 ? 0.f : rright;
#pragma unroll
        for (int j = 0; j < C; ++j) b2[j] = j + 1 < C ? be[j + 1] : right;
        // the first cell (the next exchange's source) leading, the one that
        // waits for the right neighbour across the lane edge last
#pragma unroll
        for (int j = 0; j < C; ++j) be[j] = fmaxf(lae_fast(cb[j] + b1[j], ce[j] + b2[j]), kNeg);
        // the occupancies, each row's sum carried towards u = 0, the columns' sums
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float ob = exp_fast(ca[j] + cb[j] + b1[j] - logz);
          const float oe = exp_fast(ca[j] + ce[j] + b2[j] - logz);
          pob[s * S + j * 32] = ob;
          poe[s * S + j * 32] = oe;
          rs[j] = (j + 1 < C ? rs[j + 1] : rright) + ob;
          csum[j] += oe;
        }
        if (lane == 0 && d >= 0 && d < T) srow[d] = rs[0];
      }
    } else if (copier) {  // block k+2 in, block k-1 out; block k+1 landed
      if (k + 2 < nblk) {
        const int in = (k + 2) % 3 * BLK;
        float* const dst[3] = {rb + in, re + in, ra + in};
        stage_inputs<C>(dst, src, lo - 2 * R, T, U1, cw, lane);
      }
      cp_async_commit();
      if (k > 0) {
        const float* const from[2] = {rob + ((k - 1) & 1) * BLK, roe + ((k - 1) & 1) * BLK};
        flush_outputs<C>(out, from, lo + R, T, U1, cw, lane);
      }
      cp_async_wait_but_newest();
    }
    __syncthreads();
  }
  if (copier) {
    const int last = (nblk - 1) & 1;
    const float* const from[2] = {rob + last * BLK, roe + last * BLK};
    flush_outputs<C>(out, from, lo_of(nblk - 1), T, U1, cw, lane);
  } else if (tid < 32) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int u = lane * C + j;
      scol[u] = (u < ul && csum[j] > 0.f) ? -gg / csum[j] : 0.f;
    }
  }
  for (int t = tid; t < T; t += wf_threads(C))
    srow[t] = (t < tl && srow[t] > 0.f) ? -gg / srow[t] : 0.f;
  __syncthreads();
  // scale both outputs of this row in one pass, coalesced over u: each
  // warp takes 4 frames at a time, each lane the cells u = lane + 32 q
  float sc[C];
#pragma unroll
  for (int q = 0; q < C; ++q) sc[q] = scol[lane + 32 * q];
  float* ob_row = gblank + base;
  float* oe_row = gemit + base;
  for (int t0 = (tid >> 5) * 4; t0 < T; t0 += wf_threads(C) / 8) {
    float xb[4][C], xe[4][C];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int t = t0 + r, u = lane + 32 * q;
        if (t < T && u < U1) {
          xb[r][q] = ob_row[t * U1 + u];
          xe[r][q] = oe_row[t * U1 + u];
        }
      }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float sr = srow[min(t0 + r, T - 1)];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int t = t0 + r, u = lane + 32 * q;
        if (t < T && u < U1) {
          ob_row[t * U1 + u] = xb[r][q] * sr;
          oe_row[t * U1 + u] = xe[r][q] * sc[q];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- block path

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


// returns run(KERNEL<c>) for the cells a lane, c = 1 .. WARP_MAX_C
#define RNNT_WARP_DISPATCH(KERNEL)              \
  switch (c) {                                  \
    case 1: return run(KERNEL<1>);              \
    case 2: return run(KERNEL<2>);              \
    case 3: return run(KERNEL<3>);              \
    case 4: return run(KERNEL<4>);              \
    case 5: return run(KERNEL<5>);              \
    case 6: return run(KERNEL<6>);              \
    case 7: return run(KERNEL<7>);              \
    case 8: return run(KERNEL<8>);              \
    case 9: return run(KERNEL<9>);              \
    case 10: return run(KERNEL<10>);            \
    default: return cudaErrorInvalidValue;      \
  }

}  // namespace

// The one-warp kernels where U1 <= 512 and their shared memory fits a
// block, else the block path, whose 2 U1 + 1 floats (forward) and 2 U1 + T
// (backward) are the limit the wrapper checks (ops/rnnt_lattice.py).
extern "C" int rnnt_lattice_fwd(const void* lpb, const void* lpe, const void* tlen,
                                const void* ulen, void* nll, void* alpha, void* stream, int B,
                                int T, int U1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xb = static_cast<const float*>(lpb);
  const float* xe = static_cast<const float*>(lpe);
  const int* tl = static_cast<const int*>(tlen);
  const int* ul = static_cast<const int*>(ulen);
  float* out_nll = static_cast<float*>(nll);
  float* out_alpha = static_cast<float*>(alpha);
  const int c = (U1 + 31) / 32;
  if (c <= WARP_MAX_C) {
    auto run = [&](auto kernel) {
      return run_kernel(kernel, B, wf_threads(c), fwd_warp_smem(c), st, xb, xe, tl, ul, out_nll,
                        out_alpha, T, U1);
    };
    auto dispatch = [&]() -> cudaError_t { RNNT_WARP_DISPATCH(rnnt_lattice_fwd_warp) };
    return static_cast<int>(dispatch());
  }
  int ns, threads;
  shape_for(U1, &ns, &threads);
  const size_t smem = sizeof(float) * (2 * (size_t)U1 + 1);
  auto run = [&](auto kernel) {
    return run_kernel(kernel, B, threads, smem, st, xb, xe, tl, ul, out_nll, out_alpha, T, U1);
  };
  auto dispatch = [&]() -> cudaError_t { LATTICE_DP_DISPATCH(rnnt_lattice_fwd_kernel) };
  return static_cast<int>(dispatch());
}

extern "C" int rnnt_lattice_bwd(const void* lpb, const void* lpe, const void* alpha,
                                const void* tlen, const void* ulen, const void* nll,
                                const void* g, void* gblank, void* gemit, void* stream, int B,
                                int T, int U1) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xb = static_cast<const float*>(lpb);
  const float* xe = static_cast<const float*>(lpe);
  const float* xa = static_cast<const float*>(alpha);
  const int* tl = static_cast<const int*>(tlen);
  const int* ul = static_cast<const int*>(ulen);
  const float* xn = static_cast<const float*>(nll);
  const float* xg = static_cast<const float*>(g);
  float* ob = static_cast<float*>(gblank);
  float* oe = static_cast<float*>(gemit);
  const int c = (U1 + 31) / 32;
  if (c <= WARP_MAX_C && bwd_warp_smem(c, T) <= (size_t)SMEM_OPT_IN) {
    auto run = [&](auto kernel) {
      return run_kernel(kernel, B, wf_threads(c), bwd_warp_smem(c, T), st, xb, xe, xa, tl, ul, xn,
                        xg, ob, oe, T, U1);
    };
    auto dispatch = [&]() -> cudaError_t { RNNT_WARP_DISPATCH(rnnt_lattice_bwd_warp) };
    return static_cast<int>(dispatch());
  }
  int ns, threads;
  shape_for(U1, &ns, &threads);
  const size_t smem = sizeof(float) * (2 * (size_t)U1 + T);
  auto run = [&](auto kernel) {
    return run_kernel(kernel, B, threads, smem, st, xb, xe, xa, tl, ul, xn, xg, ob, oe, T, U1);
  };
  auto dispatch = [&]() -> cudaError_t { LATTICE_DP_DISPATCH(rnnt_lattice_bwd_kernel) };
  return static_cast<int>(dispatch());
}
