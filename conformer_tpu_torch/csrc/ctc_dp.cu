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
// of alpha out), and the work is a chain of T dependent steps, each two
// nested logaddexps on every state and an exchange between neighbouring s:
// the chain's latency, not the card's rates, sets the time. Its floor (the
// same grid, exchanges and waits, each state's update as the kernel
// computes it, no loads or stores) is measured by
// scripts/torch_ctc_dp_ablation.py.
//
// Design, S <= 512 (every shipped label length: the recipe's S = 129, the
// fit's padded 401): the chain kernels, one block per batch row.
//  - W <= 4 chain warps (W = ceil(S / 32C)) hold the states: lane l of warp
//    w owns the C = ceil(S / 128) consecutive states s = (32w + l) C + j.
//    CTC's dependency runs one way in s (forward: s reads s-1 and s-2;
//    backward: s+1 and s+2), so the chain warps form a pipeline with no
//    block barrier: warp w needs only warp w-1's top two alphas of each step
//    (backward: warp w+1's bottom two v). Steps go in chunks of K (8 at C
//    <= 2, else 4): a warp writes its pair of every step of a chunk to a
//    slot, then posts a flag (a shared int: the chunks it has done, after a
//    __syncwarp and a block fence); its neighbour polls the flag once a chunk
//    and reads the chunk's K pairs. The warps skew by a chunk each, and the
//    steps inside a chunk have no branch. Inside a warp the neighbours
//    across a lane edge come by two shuffles; a lane's C states are parallel
//    work. Four warps sit on the four schedulers: the special-function work
//    (two ex2 and two lg2 a state) spreads over all four quarters of the SM,
//    where one warp alone holds 5 states a lane at S = 129 and 13 at 401
//    (one and two warps measured slower at both; PERF.md, PR 12).
//  - Helper warps do every global access, so that no load or store stalls
//    a chain warp, which has its scheduler to itself or nearly so.
//    Stager warps copy each chunk's frames, K contiguous runs of S floats,
//    into rings in shared memory with 4-byte cp.async (a frame starts at
//    float (bT + t) S, not 16-byte aligned for odd S), four chunks in
//    flight. The chain warps write alpha (forward) or the occupancies
//    (backward) to an output ring; storer warps write each chunk's frames
//    out, coalesced over s. A frame slot holds the frame as it lies in
//    memory, so the copies and the storers' reads move whole 128-byte runs
//    and a chain lane reads and writes its C states as one vector. Flags in
//    both directions keep every ring chunk in use until its readers are
//    done; the rings hold W+5 and W+1 chunks, as the last chain warp runs up
//    to W-1 chunks behind the first. The helper counts (4 stagers and 2
//    storers forward, 4 storers at C > 2; 2 and 2 backward) are the ones
//    the ablation script measured best.
//  - logaddexp(a, b) = max + lg2(1 + ex2(-|a - b| log2 e)) ln 2 on the MUFU
//    ex2 / lg2 behind __expf / __logf, as the RNN-T lattice's one-warp
//    kernels (lattice_dp_common.cuh lae_fast: within ~6.6e-7 a call), nested
//    in the plain version's order, so that alpha and beta round where the
//    plain version's do: at |logZ| in the thousands a float32 rounding of
//    alpha is ~1e-4, and a three-way form, hi + ln(1 + e^(mid-hi) +
//    e^(lo-hi)) (two ex2, one lg2, half the dependent path), which rounds
//    once a step where the plain version rounds twice, left the backward
//    beyond the smoke's tolerance in a trial. The occupancies use ex2 too
//    (relative error (2 + 1.173 |x|) ulp, as __expf).
//  - Forward: walks t = 1 .. t_len-1 only; the frozen tail t >= t_len is
//    stores only. The NLL's two alphas meet in shared memory.
//  - Backward: walks t = t_len-1 .. 0 only (the betas of steps t >= t_len
//    are never read: bh is the terminal init at t_len-1); the storers zero
//    the dead frames t >= t_len, one contiguous run of the row, first. Each
//    frame's occupancies sit whole in the output ring once every chain warp
//    has posted the chunk, so the storer sums the frame there (its frames of
//    a chunk together) and writes it once, scaled by -g / sum: no pass
//    re-reads g_emit.
//  Shared memory: (W+5) K C 32W floats a ring of inputs (one forward, two
//  backward), (W+1) K C 32W of outputs, 8 W K of slots (<= 190 KB).
//  A thread that polls a flag 2^24 times traps: a fault, not a hang.
//
// Above S = 512 the first design runs (block path): one block per row
// whose threads (at most 512) walk the states with a block stride, NS a
// thread, so any S whose two shared rows fit in shared memory runs (S <=
// 29056, the limit ops/ctc_dp.py max_states checks). Each step reads
// emit[b,t,:] straight from [B,T,S] into registers, CH = 16 / NS steps
// ahead, and exchanges the s-1 and s-2 neighbours through a double-buffered
// shared array, one barrier a step; the accurate logaddexp; after the beta
// walk a second pass gives each thread whole frames, sums the frame's S
// occupancies and scales them by -g / sum.

#include <type_traits>

#include "lattice_dp_common.cuh"

namespace {

using namespace lattice_dp;

constexpr unsigned FULL = 0xffffffffu;
constexpr int CHAIN_WARPS = 4;     // warps a row's states are cut into, at most
constexpr int CHAIN_MAX_C = 4;     // states a lane: the chain kernels take S <= 32 * 4 * 4
constexpr int NR = 4;              // chunks in each warp's ring of hand-over slots
// helper warps at C states a lane: stagers copy the inputs into their
// rings, storers write the outputs out of theirs (the counts measured best,
// scripts/torch_ctc_dp_ablation.py)
constexpr int FWD_STAGERS = 4;
__host__ __device__ constexpr int fwd_storers(int c) { return c <= 2 ? 2 : 4; }
constexpr int BWD_STAGERS = 2;
constexpr int BWD_STORERS = 2;
constexpr int SPIN_LIMIT = 1 << 24;   // polls of a flag before the kernel traps, not hangs

// states a lane, and warps a row, for S states
__host__ __device__ constexpr int chain_c(int S) { return (S + 32 * CHAIN_WARPS - 1) / (32 * CHAIN_WARPS); }
__host__ __device__ constexpr int chain_w(int S, int c) { return (S + 32 * c - 1) / (32 * c); }
// steps a chunk: the unit of copies, stores and hand-overs
__host__ __device__ constexpr int chunk_k(int c) { return c <= 2 ? 8 : 4; }
// chunks in each input ring and in the output ring: the last chain warp
// runs up to W-1 chunks behind the first
__host__ __device__ inline int in_chunks(int w) { return w + 5; }
__host__ __device__ inline int out_chunks(int w) { return w + 1; }

// shared memory (bytes): n_in input rings and an output ring of K-frame
// chunks (C 32W floats a frame), the hand-over slots, the flags, 2 floats
size_t chain_smem(int c, int w, int n_in, int stagers, int storers) {
  const size_t fs = (size_t)c * 32 * w, k = chunk_k(c);
  return sizeof(float) * ((n_in * in_chunks(w) + out_chunks(w)) * k * fs + 2 * w * NR * k + w +
                          stagers + storers + 2);
}

__device__ __forceinline__ int ld_volatile(const int* p) {
  int v;
  asm volatile("ld.volatile.shared.s32 %0, [%1];" : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}
__device__ __forceinline__ void st_volatile(int* p, int v) {
  asm volatile("st.volatile.shared.s32 [%0], %1;" ::"r"(smem_addr(p)), "r"(v) : "memory");
}

// a helper warp's wait until every chain warp's flag is >= v
__device__ __forceinline__ void wait_chain(const int* flag, int W, int v) {
  for (int w = 0; w < W; ++w)
    for (int n = 0; ld_volatile(flag + w) < v; ++n)
      if (n == SPIN_LIMIT) __trap();
  __threadfence_block();
}

// every lane's earlier shared-memory writes, then *flag = v
__device__ __forceinline__ void post_flag(int* flag, int v, int lane) {
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();
    st_volatile(flag, v);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A chain warp's waits before chunk k, polled together: the stagers have
// landed it, the storers have emptied its output ring chunk, the producer
// warp has handed over its steps, the consumer has read the slots about
// to be reused (producer / consumer: -1 for none)
template <int STAGERS, int STORERS>
__device__ __forceinline__ void wait_chunk(const int* staged, const int* stored, const int* flag,
                                           int producer, int consumer, int k, int OC) {
  for (int n = 0;; ++n) {
    bool ok = true;
#pragma unroll
    for (int h = 0; h < STAGERS; ++h) ok &= ld_volatile(staged + h) >= k + 1;
#pragma unroll
    for (int h = 0; h < STORERS; ++h) ok &= ld_volatile(stored + h) >= k - OC + 1;
    if (producer >= 0) ok &= ld_volatile(flag + producer) >= k + 1;
    if (consumer >= 0) ok &= ld_volatile(flag + consumer) >= k - NR + 1;
    if (ok) break;
    if (n == SPIN_LIMIT) __trap();
  }
  __threadfence_block();
}

// A stager warp: copies frame(c, i) (i = sid, sid + STAGERS, ... < K; -1
// for none) of each of the N inputs into its frame slot of ring chunk c %
// IC, once every chain warp has left that ring chunk; keeps four chunks in
// flight and posts the chunks that have landed.
// Frame slots hold the frame as it is in memory (C 32W floats, state s at
// s), so the copies and the storers' reads are whole 128-byte runs, and a
// chain lane reads or writes its C consecutive states as one vector.
template <int C, int K, int N, int STAGERS, typename Frame>
__device__ __forceinline__ void stage_inputs(const float* const (&src)[N], float* const (&ring)[N],
                                             int* staged, const int* flag, int W, int IC, int nch,
                                             int S, int sid, int lane, Frame frame) {
  const int nc = 32 * W, FS = C * nc;
  for (int c = 0; c < nch; ++c) {
    if (c >= IC) wait_chain(flag, W, c - IC + 1);
    for (int i = sid; i < K; i += STAGERS) {
      const int f = frame(c, i);
      if (f < 0) continue;
      uint32_t d[N];
#pragma unroll
      for (int a = 0; a < N; ++a) d[a] = smem_addr(ring[a] + ((c % IC) * K + i) * FS);
      for (int s = lane; s < S; s += 32) {
#pragma unroll
        for (int a = 0; a < N; ++a) cp_async4(d[a] + 4 * s, src[a] + (size_t)f * S + s);
      }
    }
    cp_async_commit();
    cp_async_wait<3>();
    post_flag(staged + sid, c - 2, lane);   // chunks before c - 2 have landed
  }
  cp_async_wait<0>();
  post_flag(staged + sid, nch, lane);
}

// A storer warp: once every chain warp is done with chunk d, writes
// frame(d, i) (i = oid, oid + STORERS, ... < K) out of ring chunk d % OC,
// coalesced over s, scaled by -g / the frame's sum where NORM; its F frames
// go together (sums, shuffles and stores interleaved); posts the chunks it
// has emptied.
template <int C, int K, int STORERS, bool NORM, typename Frame>
__device__ __forceinline__ void store_outputs(const float* ring, float* out, int* stored,
                                              const int* flag, int W, int OC, int nch, int S,
                                              int oid, int lane, float gg, Frame frame) {
  constexpr int F = K / STORERS;
  const int nc = 32 * W, FS = C * nc;
  for (int d = 0; d < nch; ++d) {
    wait_chain(flag, W, d + 1);
    int f[F];
    const float* fr[F];
    float sc[F];
#pragma unroll
    for (int q = 0; q < F; ++q) {
      f[q] = frame(d, oid + q * STORERS);
      fr[q] = ring + ((d % OC) * K + oid + q * STORERS) * FS;
      sc[q] = 1.f;
    }
    if (NORM) {
      float sum[F];
#pragma unroll
      for (int q = 0; q < F; ++q) sum[q] = 0.f;
#pragma unroll 4
      for (int s = lane; s < S; s += 32) {
#pragma unroll
        for (int q = 0; q < F; ++q) sum[q] += fr[q][s];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < F; ++q) sum[q] += __shfl_xor_sync(FULL, sum[q], o);
#pragma unroll
      for (int q = 0; q < F; ++q) sc[q] = sum[q] > 0.f ? -gg / sum[q] : 0.f;
    }
#pragma unroll 4
    for (int s = lane; s < S; s += 32) {
#pragma unroll
      for (int q = 0; q < F; ++q)
        if (f[q] >= 0) out[(size_t)f[q] * S + s] = fr[q][s] * sc[q];
    }
    post_flag(stored + oid, d + 1, lane);
  }
}

// one state's update from its three predecessors, in the plain version's
// order: logaddexp(logaddexp(x, n1), n2)
__device__ __forceinline__ float lae3(float x, float n1, float n2) {
  return lae_fast(lae_fast(x, n1), n2);
}

// a lane's C consecutive states of a frame slot, as one vector where C is 2
// or 4 (the slot and the lane's run are then 8- or 16-byte aligned)
template <int C>
__device__ __forceinline__ void load_states(const float* p, float (&x)[C]) {
  if constexpr (C == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else if constexpr (C == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) x[j] = p[j];
  }
}
template <int C>
__device__ __forceinline__ void store_states(float* p, const float (&x)[C]) {
  if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else if constexpr (C == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) p[j] = x[j];
  }
}

template <int C>
__global__ void __launch_bounds__(32 * (CHAIN_WARPS + FWD_STAGERS + fwd_storers(C)), 1)
    ctc_dp_fwd_chain(const float* __restrict__ emit, const float* __restrict__ skip,
                     const int* __restrict__ tlen, const int* __restrict__ ulen,
                     float* __restrict__ nll, float* __restrict__ alpha, int T, int S) {
  constexpr int K = chunk_k(C), STAGERS = FWD_STAGERS, STORERS = fwd_storers(C);
  extern __shared__ float sh[];
  const int W = (blockDim.x >> 5) - STAGERS - STORERS, nc = 32 * W, FS = C * nc;
  const int IC = in_chunks(W), OC = out_chunks(W);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* rin = sh;                         // [IC][K][FS]: emit
  float* rout = rin + IC * K * FS;         // [OC][K][FS]: alpha
  float* edge = rout + OC * K * FS;        // [W][NR K][2]: each warp's top two alphas a step
  int* flag = reinterpret_cast<int*>(edge + 2 * W * NR * K);   // [W]: chunks each warp has done
  int* staged = flag + W;                  // [STAGERS]: chunks each stager has landed
  int* stored = staged + STAGERS;          // [STORERS]: chunks each storer has emptied
  float* fin = reinterpret_cast<float*>(stored + STORERS);     // [2]: the NLL's two alphas
  if (tid < W + STAGERS + STORERS) flag[tid] = 0;
  if (tid < 2) fin[tid] = kNeg;
  const int tl = tlen[b], ul = ulen[b];
  const int tmax = max(min(tl, T), 1);     // steps 1 .. tmax-1 update alpha, later ones keep it
  const int nch = (tmax + K - 1) / K;
  const size_t base = (size_t)b * T * S;
  float* out = alpha + base;
  __syncthreads();

  if (warp >= W) {
    const int h = warp - W;
    if (h < STAGERS) {
      const float* const src[1] = {emit + base};
      float* const ring[1] = {rin};
      stage_inputs<C, K, 1, STAGERS>(src, ring, staged, flag, W, IC, nch, S, h, lane,
                            [&](int c, int i) { return c * K + i < tmax ? c * K + i : -1; });
    } else {
      store_outputs<C, K, STORERS, false>(rout, out, stored, flag, W, OC, nch, S, h - STAGERS, lane, 0.f,
                                 [&](int d, int i) { return d * K + i < T ? d * K + i : -1; });
    }
    return;
  }

  int st[C];
  bool live[C];
  float sk[C], al[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    st[j] = tid * C + j;
    live[j] = st[j] < S;
    sk[j] = live[j] ? skip[(size_t)b * S + st[j]] : kNeg;
    al[j] = kNeg;
  }
  float* mine = edge + 2 * NR * K * warp;
  const float* below = edge + 2 * NR * K * (warp - 1);

  for (int k = 0; k < nch; ++k) {
    wait_chunk<STAGERS, STORERS>(staged, stored, flag, warp - 1, warp + 1 < W ? warp + 1 : -1, k, OC);
    float2 xs[K];     // warp - 1's top two alphas of steps t-1, this chunk
#pragma unroll
    for (int i = 0; i < K; ++i)
      xs[i] = warp > 0 ? *reinterpret_cast<const float2*>(below + 2 * ((k % NR) * K + i))
                       : make_float2(kNeg, kNeg);
    const float* rk = rin + (k % IC) * K * FS + tid * C;
    float* ok = rout + (k % OC) * K * FS + tid * C;
    float* ek = mine + 2 * (k % NR) * K;
    // the chunk's inputs first: a step's ring reads may not pass the last
    // step's ring writes, which the compiler cannot tell apart
    float ein[K][C];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      load_states<C>(rk + i * FS, ein[i]);
#pragma unroll
      for (int j = 0; j < C; ++j) ein[i][j] = live[j] ? ein[i][j] : kNeg;
    }
    // a step; the first and the last chunk also select the initial states
    // and freeze alpha at t >= t_len
    auto step = [&](int i, auto edge) {
      const int t = k * K + i;
      float nx[C];
      // alpha[t-1]'s top two states of this warp, for warp + 1
      if (C >= 2 && lane == 31)
        *reinterpret_cast<float2*>(ek + 2 * i) = make_float2(al[C >= 2 ? C - 2 : 0], al[C - 1]);
      if (C == 1 && lane >= 30) ek[2 * i + lane - 30] = al[0];
      float up1 = __shfl_up_sync(FULL, al[C - 1], 1);
      float up2 = C >= 2 ? __shfl_up_sync(FULL, al[C >= 2 ? C - 2 : 0], 1)
                         : __shfl_up_sync(FULL, al[0], 2);
      if (lane == 0) {
        up1 = xs[i].y;
        up2 = xs[i].x;
      }
      if (C == 1 && lane == 1) up2 = xs[i].y;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float f1 = j >= 1 ? al[j >= 1 ? j - 1 : 0] : up1;
        const float f2 = j >= 2 ? al[j >= 2 ? j - 2 : 0] : j == 1 ? up1 : up2;
        nx[j] = fmaxf(lae3(al[j], f1, f2 + sk[j]) + ein[i][j], kNeg);
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (decltype(edge)::value) {
          const float init = (st[j] < 2 && !(st[j] == 1 && ul == 0)) ? ein[i][j] : kNeg;
          al[j] = t == 0 ? init : t < tmax ? nx[j] : al[j];
        } else {
          al[j] = nx[j];
        }
      }
      store_states<C>(ok + i * FS, al);
    };
    if (k > 0 && (k + 1) * K <= tmax) {
#pragma unroll
      for (int i = 0; i < K; ++i) step(i, std::false_type{});
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) step(i, std::true_type{});
    }
    post_flag(flag + warp, k + 1, lane);
  }
  // the frozen tail: stores only
  for (int t = nch * K; t < T; ++t) {
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (live[j]) out[(size_t)t * S + st[j]] = al[j];
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (st[j] == 2 * ul) fin[0] = al[j];
    if (ul > 0 && st[j] == 2 * ul - 1) fin[1] = al[j];
  }
  asm volatile("bar.sync 1, %0;" ::"r"(nc) : "memory");   // the chain warps only
  if (tid == 0) nll[b] = -lae(fin[0], fin[1]);
}

template <int C>
__global__ void __launch_bounds__(32 * (CHAIN_WARPS + BWD_STAGERS + BWD_STORERS), 1)
    ctc_dp_bwd_chain(const float* __restrict__ emit, const float* __restrict__ skip,
                     const float* __restrict__ alpha, const int* __restrict__ tlen,
                     const int* __restrict__ ulen, const float* __restrict__ nll,
                     const float* __restrict__ g, float* __restrict__ gemit, int T, int S) {
  constexpr int K = chunk_k(C), STAGERS = BWD_STAGERS, STORERS = BWD_STORERS;
  extern __shared__ float sh[];
  const int W = (blockDim.x >> 5) - STAGERS - STORERS, nc = 32 * W, FS = C * nc;
  const int IC = in_chunks(W), OC = out_chunks(W);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* re = sh;                          // [IC][K][FS]: emit
  float* ra = re + IC * K * FS;            // [IC][K][FS]: alpha
  float* ro = ra + IC * K * FS;            // [OC][K][FS]: occupancies waiting for their sum
  float* edge = ro + OC * K * FS;          // [W][NR K][2]: each warp's bottom two v a step
  int* flag = reinterpret_cast<int*>(edge + 2 * W * NR * K);   // [W]: chunks each warp has done
  int* staged = flag + W;                  // [STAGERS]: chunks each stager has landed
  int* stored = staged + STAGERS;          // [STORERS]: chunks each storer has emptied
  if (tid < W + STAGERS + STORERS) flag[tid] = 0;
  const int tl = tlen[b], ul = ulen[b];
  const int tz = min(max(tl, 0), T);       // frames tz .. T-1 are dead
  const int top = tz - 1;                  // the chain walks frames top .. 0
  const int nch = (tz + K - 1) / K;
  const float logz = -nll[b];
  const float gg = g[b];
  const size_t base = (size_t)b * T * S;
  float* out = gemit + base;
  __syncthreads();

  if (warp >= W) {
    const int h = warp - W;
    auto frame = [&](int c, int i) { return top - c * K - i; };   // -1 .. : none
    if (h < STAGERS) {
      const float* const src[2] = {emit + base, alpha + base};
      float* const ring[2] = {re, ra};
      stage_inputs<C, K, 2, STAGERS>(src, ring, staged, flag, W, IC, nch, S, h, lane, frame);
    } else {
      // the dead frames first: one contiguous run of the row
      for (size_t i = (size_t)tz * S + tid - nc - 32 * STAGERS; i < (size_t)T * S; i += 32 * STORERS)
        out[i] = 0.f;
      store_outputs<C, K, STORERS, true>(ro, out, stored, flag, W, OC, nch, S, h - STAGERS, lane, gg, frame);
    }
    return;
  }

  int st[C];
  bool live[C];
  float sk2[C], be[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int s = tid * C + j;
    st[j] = s;
    live[j] = s < S;
    sk2[j] = (s + 2 < S) ? skip[(size_t)b * S + s + 2] : kNeg;
    be[j] = (s == 2 * ul || (s == 2 * ul - 1 && ul > 0)) ? 0.f : kNeg;   // bh at t_len - 1
  }
  float* mine = edge + 2 * NR * K * warp;
  const float* above = edge + 2 * NR * K * (warp + 1);

  for (int k = 0; k < nch; ++k) {
    wait_chunk<STAGERS, STORERS>(staged, stored, flag, warp + 1 < W ? warp + 1 : -1, warp - 1, k, OC);
    float2 ys[K];     // warp + 1's bottom two v of each step of this chunk
#pragma unroll
    for (int i = 0; i < K; ++i)
      ys[i] = warp + 1 < W ? *reinterpret_cast<const float2*>(above + 2 * ((k % NR) * K + i))
                           : make_float2(kNeg, kNeg);
    const int off = (k % IC) * K * FS + tid * C;
    float* ok = ro + (k % OC) * K * FS + tid * C;
    float* ek = mine + 2 * (k % NR) * K;
    // the chunk's inputs first, as in the forward
    float ein[K][C], ain[K][C];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      load_states<C>(re + off + i * FS, ein[i]);
      load_states<C>(ra + off + i * FS, ain[i]);
    }
    // a step; the last chunk also keeps beta at the steps below frame 0
    auto step = [&](int i, auto edge) {
      const int t = top - k * K - i;
      float v[C], oc[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        v[j] = live[j] ? ein[i][j] + be[j] : kNeg;
        oc[j] = exp_fast(ain[i][j] + be[j] - logz);
      }
      store_states<C>(ok + i * FS, oc);
      // v's bottom two states of this warp, for warp - 1
      if (C >= 2 && lane == 0)
        *reinterpret_cast<float2*>(ek + 2 * i) = make_float2(v[0], v[C >= 2 ? 1 : 0]);
      if (C == 1 && lane < 2) ek[2 * i + lane] = v[0];
      float dn1 = __shfl_down_sync(FULL, v[0], 1);
      float dn2 = C >= 2 ? __shfl_down_sync(FULL, v[C >= 2 ? 1 : 0], 1)
                         : __shfl_down_sync(FULL, v[0], 2);
      if (lane == 31) {
        dn1 = ys[i].x;
        dn2 = ys[i].y;
      }
      if (C == 1 && lane == 30) dn2 = ys[i].x;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float n1 = j + 1 < C ? v[j + 1 < C ? j + 1 : 0] : dn1;
        const float n2 = j + 2 < C ? v[j + 2 < C ? j + 2 : 0] : j + 2 == C ? dn1 : dn2;
        const float nb = fmaxf(lae3(v[j], n1, n2 + sk2[j]), kNeg);
        be[j] = !decltype(edge)::value || t >= 0 ? nb : be[j];
      }
    };
    if (top - k * K - (K - 1) >= 0) {
#pragma unroll
      for (int i = 0; i < K; ++i) step(i, std::false_type{});
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) step(i, std::true_type{});
    }
    post_flag(flag + warp, k + 1, lane);
  }
}

template <int NS>
__global__ void __launch_bounds__(MAX_THREADS)
    ctc_dp_fwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                      const int* __restrict__ tlen, const int* __restrict__ ulen,
                      float* __restrict__ nll, float* __restrict__ alpha, int T, int S) {
  constexpr int CH = chunk<NS>();
  extern __shared__ float sh[];     // [2][S]
  const int b = blockIdx.x, nt = blockDim.x;
  const int tl = tlen[b], ul = ulen[b];
  const size_t base = (size_t)b * T * S;
  int st[NS];
  bool live[NS];
  float sk[NS], al[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    st[i] = threadIdx.x + i * nt;
    live[i] = st[i] < S;
    sk[i] = live[i] ? skip[(size_t)b * S + st[i]] : kNeg;
    al[i] = kNeg;
  }
  float ce[NS][CH], ne[NS][CH];
  auto load = [&](int t0, float (&xs)[NS][CH]) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int t = t0 + k;
        xs[i][k] = (live[i] && t < T) ? emit[base + (size_t)t * S + st[i]] : kNeg;
      }
  };
  load(0, ce);
  for (int t0 = 0; t0 < T; t0 += CH) {
    load(t0 + CH, ne);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int t = t0 + k;
      if (t >= T) break;
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          al[i] = (st[i] < 2 && !(st[i] == 1 && ul == 0)) ? ce[i][k] : kNeg;
      } else {
        float* cur = sh + (t & 1) * S;
#pragma unroll
        for (int i = 0; i < NS; ++i)
          if (live[i]) cur[st[i]] = al[i];
        __syncthreads();
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int s = st[i];
          const float f1 = (live[i] && s >= 1) ? cur[s - 1] : kNeg;
          const float f2 = (live[i] && s >= 2) ? cur[s - 2] + sk[i] : kNeg;
          const float upd = fmaxf(lae(lae(al[i], f1), f2) + ce[i][k], kNeg);
          if (t < tl) al[i] = upd;
        }
      }
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (live[i]) alpha[base + (size_t)t * S + st[i]] = al[i];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int k = 0; k < CH; ++k) ce[i][k] = ne[i][k];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NS; ++i)
    if (live[i]) sh[st[i]] = al[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    const float fb = sh[2 * ul];
    const float fl = ul > 0 ? sh[2 * ul - 1] : kNeg;
    nll[b] = -lae(fb, fl);
  }
}

template <int NS>
__global__ void __launch_bounds__(MAX_THREADS)
    ctc_dp_bwd_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                      const float* __restrict__ alpha, const int* __restrict__ tlen,
                      const int* __restrict__ ulen, const float* __restrict__ nll,
                      const float* __restrict__ g, float* __restrict__ gemit, int T, int S) {
  constexpr int CH = chunk<NS>();
  extern __shared__ float sh[];     // [2][S]
  const int b = blockIdx.x, nt = blockDim.x;
  const int tl = tlen[b], ul = ulen[b];
  const size_t base = (size_t)b * T * S;
  const float logz = -nll[b];
  const float gg = g[b];
  int st[NS];
  bool live[NS];
  float sk2[NS], term[NS], beta[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int s = threadIdx.x + i * nt;
    st[i] = s;
    live[i] = s < S;
    sk2[i] = (s + 2 < S) ? skip[(size_t)b * S + s + 2] : kNeg;
    term[i] = (s == 2 * ul || (s == 2 * ul - 1 && ul > 0)) ? 0.f : kNeg;
    beta[i] = kNeg;
  }
  float ce[NS][CH], ca[NS][CH], ne[NS][CH], na[NS][CH];
  // chunks walk time downwards: slot k holds step t0 - k
  auto load = [&](int t0, float (&xs)[NS][CH], float (&ys)[NS][CH]) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        const int t = t0 - k;
        const bool ok = live[i] && t >= 0;
        xs[i][k] = ok ? emit[base + (size_t)t * S + st[i]] : kNeg;
        ys[i][k] = ok ? alpha[base + (size_t)t * S + st[i]] : kNeg;
      }
  };
  load(T - 1, ce, ca);
  for (int t0 = T - 1; t0 >= 0; t0 -= CH) {
    load(t0 - CH, ne, na);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int t = t0 - k;
      if (t < 0) break;
      float* cur = sh + (t & 1) * S;
      float v[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float bh = (t >= tl - 1) ? term[i] : beta[i];
        if (live[i])
          gemit[base + (size_t)t * S + st[i]] = t < tl ? expf(ca[i][k] + bh - logz) : 0.f;
        v[i] = ce[i][k] + bh;
        if (live[i]) cur[st[i]] = v[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int s = st[i];
        const float n1 = (s + 1 < S) ? cur[s + 1] : kNeg;
        const float n2 = (s + 2 < S) ? cur[s + 2] + sk2[i] : kNeg;
        beta[i] = fmaxf(lae(lae(v[i], n1), n2), kNeg);
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        ce[i][k] = ne[i][k];
        ca[i][k] = na[i][k];
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

// calls run(std::integral_constant<int, C>) for c == C, C = 1 .. CHAIN_MAX_C
template <int C = 1, typename Run>
cudaError_t by_c(int c, Run run) {
  if constexpr (C > CHAIN_MAX_C) {
    return cudaErrorInvalidValue;
  } else {
    if (c == C) return run(std::integral_constant<int, C>{});
    return by_c<C + 1>(c, run);
  }
}

}  // namespace

// The chain kernels where S <= 32 * CHAIN_WARPS * CHAIN_MAX_C (a function of
// S alone, as ops/ctc_dp.py route mirrors), else the block path, whose two
// shared rows of S floats are the limit the wrapper checks (ops/ctc_dp.py).
extern "C" int ctc_dp_fwd(const void* emit, const void* skip, const void* tlen, const void* ulen,
                          void* nll, void* alpha, void* stream, int B, int T, int S) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xe = static_cast<const float*>(emit);
  const float* xs = static_cast<const float*>(skip);
  const int* tl = static_cast<const int*>(tlen);
  const int* ul = static_cast<const int*>(ulen);
  float* out_nll = static_cast<float*>(nll);
  float* out_alpha = static_cast<float*>(alpha);
  const int c = chain_c(S);
  if (c <= CHAIN_MAX_C) {
    const int w = chain_w(S, c);
    return static_cast<int>(by_c(c, [&](auto cc) {
      constexpr int C = decltype(cc)::value;
      return run_kernel(ctc_dp_fwd_chain<C>, B, 32 * (w + FWD_STAGERS + fwd_storers(C)),
                        chain_smem(C, w, 1, FWD_STAGERS, fwd_storers(C)), st, xe, xs, tl, ul,
                        out_nll, out_alpha, T, S);
    }));
  }
  int ns, threads;
  shape_for(S, &ns, &threads);
  const size_t smem = sizeof(float) * 2 * (size_t)S;
  auto run = [&](auto kernel) {
    return run_kernel(kernel, B, threads, smem, st, xe, xs, tl, ul, out_nll, out_alpha, T, S);
  };
  auto dispatch = [&]() -> cudaError_t { LATTICE_DP_DISPATCH(ctc_dp_fwd_kernel) };
  return static_cast<int>(dispatch());
}

extern "C" int ctc_dp_bwd(const void* emit, const void* skip, const void* alpha,
                          const void* tlen, const void* ulen, const void* nll, const void* g,
                          void* gemit, void* stream, int B, int T, int S) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xe = static_cast<const float*>(emit);
  const float* xs = static_cast<const float*>(skip);
  const float* xa = static_cast<const float*>(alpha);
  const int* tl = static_cast<const int*>(tlen);
  const int* ul = static_cast<const int*>(ulen);
  const float* xn = static_cast<const float*>(nll);
  const float* xg = static_cast<const float*>(g);
  float* out = static_cast<float*>(gemit);
  const int c = chain_c(S);
  if (c <= CHAIN_MAX_C) {
    const int w = chain_w(S, c);
    return static_cast<int>(by_c(c, [&](auto cc) {
      constexpr int C = decltype(cc)::value;
      return run_kernel(ctc_dp_bwd_chain<C>, B, 32 * (w + BWD_STAGERS + BWD_STORERS),
                        chain_smem(C, w, 2, BWD_STAGERS, BWD_STORERS), st, xe, xs, xa, tl,
                        ul, xn, xg, out, T, S);
    }));
  }
  int ns, threads;
  shape_for(S, &ns, &threads);
  const size_t smem = sizeof(float) * 2 * (size_t)S;
  auto run = [&](auto kernel) {
    return run_kernel(kernel, B, threads, smem, st, xe, xs, xa, tl, ul, xn, xg, out, T, S);
  };
  auto dispatch = [&]() -> cudaError_t { LATTICE_DP_DISPATCH(ctc_dp_bwd_kernel) };
  return static_cast<int>(dispatch());
}
