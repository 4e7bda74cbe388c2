// Kaldi log-mel filterbank features on the card, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/fbank_kernel.py
// (fbank_pallas / _fbank_kernel). Per frame of ws samples (snip_edges
// framing, shift samples apart) of a waveform already scaled by 2^15:
// dither, DC removal, preemphasis 0.97 with the first sample replicated,
// the povey window, the power spectrum of bins 0 .. padded/2 - 1 of the
// zero-padded real DFT, the mel sum and log(max(., float32 epsilon)). All
// float32.
//
// Dither: the TPU kernel draws from the TPU's own generator, which no other
// machine reproduces. Here each (seed, b, frame, sample) is hashed into two
// uniforms and Box-Muller gives the normal; ops/fbank_kernel.py's plain
// version implements the same hash, so that kernel and plain version agree
// with dither on.
//
// Bound, at 48 utterances of 15 s (71,904 frames of 400 samples, padded
// 512, 80 mel bins): the bytes, 46.1 MB of waveform in and 23.0 MB of
// features out, take 0.0206 ms at 3.35 TB/s. The work of this design is
// about 16 kflop a frame (the 256-point complex FFT, 5 n log2 n, ~10.2k;
// its split pass and the power ~3.1k; DC removal, preemphasis and window
// ~2k; the 501 mel weights ~1k; the log): 1.2 GFLOP, 0.018 ms at the
// card's 67 TFLOP/s float32 rate. So the bytes bound it. (The first design
// computed the DFT as products, 2 ws F 2 + 2 F M flops a frame (F = padded
// / 2, M mel bins), 3.2e10 flops, 0.48 ms: that count was the old design's,
// not the function's.)
//
// Design: a block takes one utterance and a tile of up to 32 consecutive
// frames (tile_frames), 8 warps (16 with dither: the dither's arithmetic
// then has more warps to hide in).
//  - Staging: the tile's contiguous span of samples, (F - 1) shift + ws,
//    is copied once into shared memory by cp.async, 16 bytes a thread from
//    the first 16-byte-aligned address on (4-byte copies for the head and
//    the tail: rows start unaligned when N % 4 != 0; no TMA box). The
//    frames, which overlap 2.5 times, then read shared memory; the first
//    design read every sample of every frame from global memory.
//  - A warp a frame. The real DFT is a complex FFT of padded / 2 points
//    (even samples the real part, odd the imaginary): Stockham passes of
//    radix 8, 4 or 2 (plan_radix: 512 = 8 8 8, 256 = 8 8 4, 128 = 8 8 2),
//    each butterfly in registers, the passes exchanging through the warp's
//    own padded slice of shared memory with __syncwarp only; then the split
//    pass to bins 0 .. padded/2 - 1, a lane taking bins k and padded/2 - k.
//    The first pass is fused with the framing (first_pass_framed, padded
//    512 and 1024): a lane loads the samples of its own first-pass inputs,
//    dithers them (the same hash and Box-Muller as the plain version,
//    accurate logf / sqrtf / cosf), takes the mean by shuffles and each
//    sample's predecessor by one shuffle, applies preemphasis and the
//    window and runs its butterflies, so the conditioned frame never
//    passes through shared memory; smaller sizes condition into the buffer
//    first (condition). The twiddles come from a host table of
//    exp(-2 pi i k / padded) made in float64 and rounded once, laid out in
//    the order the passes read them (ops/fbank_kernel.py pass_twiddles):
//    4 KB a block, held in registers where a lane needs few. The first
//    design streamed the 819 KB cos / sin matrices from L2 for every 16
//    frames (3.7 GB of L2 reads).
//  - The power spectra of the tile stay in shared memory, a row a frame.
//    The mel sum reads only each bin's run of non-zero weights
//    (ops/fbank_kernel.py sparse_mel: 501 at 80 bins and padded 512, where
//    the first design did 20,480 products a frame), with the lanes over
//    the tile's frames and the warps over the bins: each weight is read
//    once for 32 frames. Then the log, and the tile's features are stored
//    as one contiguous run.
//  - Two block barriers after the staging (FFTs, mel sum, store).
//    cudaFuncSetAttribute runs once per kernel and device, not at every
//    launch.
// Every width the first design took is taken: ws <= 1024 (padded 1 ..
// 1024), any number of mel bins, any N >= ws, B >= 1, T >= 1, dither on or
// off.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace {

// warps a block: 8 without dither, 16 with it (measured best of the two
// for each, scripts/torch_fbank_ablation.py)
template <bool DITHER>
__host__ __device__ constexpr int warps_of() { return DITHER ? 16 : 8; }

constexpr int kMaxPadded = 1024;
constexpr int kTileFrames = 32;        // frames a block: a lane a frame in the mel sum
constexpr int kSpanFloats = 8192;      // at most this many staged samples a block (32 KB)
constexpr int kTwiddleRegs = 16;       // complex twiddles a lane may hold in registers
constexpr int kSmemOptIn = 232448;     // bytes of shared memory a block may use on Hopper
constexpr float kEps = 1.1920928955078125e-07f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kRsqrt2 = 0.70710678118654752f;

// two uniforms per (seed, b, frame, sample): counter hash, stream 0 and 1
__device__ __forceinline__ uint32_t dither_hash(uint32_t seed, uint32_t b, uint32_t t,
                                                uint32_t n, uint32_t stream) {
  uint32_t x = ((seed * 0x9E3779B9u + b * 0x85EBCA6Bu) ^ (t * 0xC2B2AE35u)) ^
               (n * 0x27D4EB2Fu) ^ (stream * 0x165667B1u);
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float dither_normal(uint32_t seed, uint32_t b, uint32_t t,
                                               uint32_t n) {
  const float u1 = (float)((dither_hash(seed, b, t, n, 0u) >> 8) + 1u) * (1.0f / 16777216.0f);
  const float u2 = (float)(dither_hash(seed, b, t, n, 1u) >> 8) * (1.0f / 16777216.0f);
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// ------------------------------------------------------------ complex FFT

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// Products that must not fuse with a later add are __fmul_rn, so that the
// rounding is the same whatever ptxas contracts (the CPU tests emulate it).
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -__fmul_rn(a.y, b.y)), fmaf(a.x, b.y, __fmul_rn(a.y, b.x)));
}
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }   // a (-i)

// the radix-R DFT of u[0 .. R-1] in place, forward (exp(-2 pi i jk / R))
template <int R>
__device__ __forceinline__ void dft(float2* u) {
  if constexpr (R == 2) {
    const float2 a = u[0];
    u[0] = cadd(a, u[1]);
    u[1] = csub(a, u[1]);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(u[0], u[2]), t1 = csub(u[0], u[2]);
    const float2 t2 = cadd(u[1], u[3]), t3 = mul_mi(csub(u[1], u[3]));
    u[0] = cadd(t0, t2);
    u[2] = csub(t0, t2);
    u[1] = cadd(t1, t3);
    u[3] = csub(t1, t3);
  } else if constexpr (R == 8) {
    float2 e[4] = {u[0], u[2], u[4], u[6]}, o[4] = {u[1], u[3], u[5], u[7]};
    dft<4>(e);
    dft<4>(o);
    o[1] = make_float2(__fmul_rn(o[1].x + o[1].y, kRsqrt2), __fmul_rn(o[1].y - o[1].x, kRsqrt2));
    o[2] = mul_mi(o[2]);
    o[3] = make_float2(__fmul_rn(o[3].y - o[3].x, kRsqrt2), -__fmul_rn(o[3].x + o[3].y, kRsqrt2));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      u[k] = cadd(e[k], o[k]);
      u[k + 4] = csub(e[k], o[k]);
    }
  }
}

// the radix of the FFT pass over n points still to combine: 8 while 8
// divides them, then 4, then 2 (ops/fbank_kernel.py radix_plan)
__host__ __device__ constexpr int plan_radix(int n) {
  return n % 8 == 0 ? 8 : n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1;
}

// entries of the pass twiddle table (ops/fbank_kernel.py pass_twiddles)
// before the pass that follows p_stop combined points: each pass after the
// first, P points combined and radix R, holds W_{RP}^{jk} at k (R-1) + j-1
// (k < P, 1 <= j < R); after the passes (p_stop = n), the split pass's
// W_{2n}^k, k <= n / 2
__host__ __device__ constexpr int tw_offset(int n, int p_stop) {
  int off = 0, p = 1;
  while (p < n && p < p_stop) {
    const int r = plan_radix(n / p);
    if (p > 1) off += p * (r - 1);
    p *= r;
  }
  return off;
}

// twiddles a lane holds in registers for the passes after the first that
// precede the pass after p_stop combined points (all of them at p_stop =
// n): each pass, its butterflies a lane (PER) times R - 1
__host__ __device__ constexpr int tw_reg_offset(int n, int p_stop) {
  int regs = 0, p = 1;
  while (p < n && p < p_stop) {
    const int r = plan_radix(n / p);
    if (p > 1) regs += (n / r + 31) / 32 * (r - 1);
    p *= r;
  }
  return regs;
}

// complex index -> slot in a warp's buffer: one pad slot every 16, so that
// the passes' strided writes fall in different banks. The passes split
// each address into a part a lane computes once and a constant:
// sw(lane + M) = sw(lane) + sw(M) for M a multiple of 16, and
// sw(base + jP) = base + ((i - k) R >> 4) + (k >> 4) + sw(jP) for a
// butterfly's outputs (tests/test_torch_fbank.py checks both).
__host__ __device__ constexpr int sw(int i) { return i + (i >> 4); }

template <int N>
__host__ __device__ constexpr int buf_slots() { return N + N / 16; }

// Stockham pass of radix R after P points have been combined: butterfly i
// (k = i mod P) reads x[i + j N/R], multiplies input j by W_{RP}^{jk}, and
// writes output j to (i - k) R + k + j P. Reads all, then writes all. The
// twiddles come from the lane's registers (twr) where REG, else from the
// shared table.
template <int N, int R, int P, bool REG>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* twp, const float2* twr,
                                         int lane) {
  constexpr int NB = N / R, PER = (NB + 31) / 32, OFF = tw_offset(N, P);
  constexpr int RO = tw_reg_offset(N, P);
  float2 u[PER][R];
  static_assert(NB % 16 == 0 || NB < 32, "reads at sw(lane) + constants");
  const float2* rd = buf + sw(lane);
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int i = lane + 32 * c;
    if (NB % 32 == 0 || i < NB) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        u[c][j] = NB % 16 == 0 ? rd[sw(32 * c + j * NB)] : buf[sw(i + j * NB)];
      if constexpr (P > 1) {
        const float2* w =
            REG ? twr + RO + c * (R - 1) - 1 : twp + OFF + (i & (P - 1)) * (R - 1) - 1;
#pragma unroll
        for (int j = 1; j < R; ++j) u[c][j] = cmul(u[c][j], w[j]);
      }
      dft<R>(u[c]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int i = lane + 32 * c;
    if (NB % 32 == 0 || i < NB) {
      const int k = i & (P - 1);
      float2* wr = buf + (i - k) * R + k + (((i - k) * R) >> 4) + (k >> 4);
#pragma unroll
      for (int j = 0; j < R; ++j) wr[sw(j * P)] = u[c][j];
    }
  }
  __syncwarp();
}

template <int N, int P, bool REG>
__device__ __forceinline__ void fft(float2* buf, const float2* twp, const float2* twr, int lane) {
  if constexpr (P < N) {
    constexpr int R = plan_radix(N / P);
    fft_pass<N, R, P, REG>(buf, twp, twr, lane);
    fft<N, P * R, REG>(buf, twp, twr, lane);
  }
}

// a lane's twiddles of the passes after the first, from the shared table
// into registers (the same for every frame the warp takes)
template <int N, int P>
__device__ __forceinline__ void load_twiddles(float2* twr, const float2* twp, int lane) {
  if constexpr (P < N) {
    constexpr int R = plan_radix(N / P);
    if constexpr (P > 1) {
      constexpr int NB = N / R, PER = (NB + 31) / 32, OFF = tw_offset(N, P);
      constexpr int RO = tw_reg_offset(N, P);
#pragma unroll
      for (int c = 0; c < PER; ++c) {
        const int i = lane + 32 * c;
        if (NB % 32 == 0 || i < NB) {
#pragma unroll
          for (int j = 1; j < R; ++j)
            twr[RO + c * (R - 1) + j - 1] = twp[OFF + (i & (P - 1)) * (R - 1) + j - 1];
        }
      }
    }
    load_twiddles<N, P * R>(twr, twp, lane);
  }
}

// The frame conditioned into a warp's buffer, for the FFTs whose first
// pass is not fused with the framing: lane + 32 q's samples (dithered) in
// registers, the mean by shuffles, preemphasis with the previous sample by
// a shuffle, the window, zeros past ws, written as z[m] = y[2m] + i y[2m+1].
template <int N, bool DITHER>
__device__ __forceinline__ void condition(float* bufs, const float* src, const float* win, int ws,
                                          float dither, uint32_t seed, int b, int t, int lane) {
  constexpr int Q = (2 * N + 31) / 32;
  float x[Q];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int n = lane + 32 * q;
    x[q] = 0.f;
    if (n < ws) {
      x[q] = DITHER ? fmaf(dither, dither_normal(seed, b, t, n), src[n]) : src[n];
      s += x[q];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s / (float)ws;
  float last = 0.f;                    // lane 31's sample of the previous q
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int n = lane + 32 * q;
    const float cur = x[q] - mean;
    const float up = __shfl_up_sync(0xffffffffu, cur, 1);
    const float prev = lane > 0 ? up : (q > 0 ? last : cur);
    last = __shfl_sync(0xffffffffu, cur, 31);
    if (n < 2 * N)
      bufs[2 * sw(n >> 1) + (n & 1)] = n < ws ? __fmul_rn(fmaf(-0.97f, prev, cur), win[n]) : 0.f;
  }
  __syncwarp();
}

// The first FFT pass fused with the framing, where its butterflies are a
// whole number of warps (N / R % 32 == 0: N = 256, 512): the lane loads the
// samples of its own inputs z[i + j N/R] = y[2m] + i y[2m+1] (as float2
// where the frame is 8-byte aligned), dithers them, takes the mean by
// shuffles, gets each even sample's predecessor (the odd sample of the lane
// before) by one shuffle, conditions them (preemphasis, window, zeros past
// ws) and runs its butterflies: the conditioned frame never goes through
// shared memory.
template <int N, bool DITHER>
__device__ __forceinline__ void first_pass_framed(float2* buf, const float* src, const float* win,
                                                  int ws, float dither, uint32_t seed, int b,
                                                  int t, int lane) {
  constexpr int R = plan_radix(N), NB = N / R, PER = NB / 32;
  float2 u[PER][R];
  // branch-free loads: past ws they read other samples of the shared
  // memory (the span, then the work region), masked to 0 below
  const float* sl = src + 2 * lane;
  if ((reinterpret_cast<uintptr_t>(src) & 7u) == 0) {
#pragma unroll
    for (int c = 0; c < PER; ++c)
#pragma unroll
      for (int j = 0; j < R; ++j)
        u[c][j] = *reinterpret_cast<const float2*>(sl + 2 * (32 * c + j * NB));
  } else {
#pragma unroll
    for (int c = 0; c < PER; ++c)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float* p = sl + 2 * (32 * c + j * NB);
        u[c][j] = make_float2(p[0], p[1]);
      }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < PER; ++c) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int n = 2 * (lane + 32 * c + j * NB);
      float2 v = u[c][j];
      if constexpr (DITHER) {
        if (n < ws) v.x = fmaf(dither, dither_normal(seed, b, t, n), v.x);
        if (n + 1 < ws) v.y = fmaf(dither, dither_normal(seed, b, t, n + 1), v.y);
      }
      v.x = n < ws ? v.x : 0.f;
      v.y = n + 1 < ws ? v.y : 0.f;
      s += v.x;
      s += v.y;
      u[c][j] = v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mean = s / (float)ws;
  float r[PER][R];
#pragma unroll
  for (int c = 0; c < PER; ++c)
#pragma unroll
    for (int j = 0; j < R; ++j) r[c][j] = __shfl_sync(0xffffffffu, u[c][j].y, (lane + 31) & 31);
#pragma unroll
  for (int c = 0; c < PER; ++c) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int n = 2 * (lane + 32 * c + j * NB);
      // lane 0's predecessor: lane 31's of the butterfly before (c - 1, or
      // the last c of j - 1); sample 0 replicates itself
      const float before = c > 0 ? r[c - 1][j] : (j > 0 ? r[PER - 1][j - 1] : u[0][0].x);
      const float cur_e = u[c][j].x - mean, cur_o = u[c][j].y - mean;
      const float prev_e = (lane > 0 ? r[c][j] : before) - mean;
      const float2 w = *reinterpret_cast<const float2*>(win + n);   // past ws: masked
      const float ye = __fmul_rn(fmaf(-0.97f, prev_e, cur_e), w.x);
      const float yo = __fmul_rn(fmaf(-0.97f, cur_e, cur_o), w.y);
      u[c][j] = make_float2(n < ws ? ye : 0.f, n + 1 < ws ? yo : 0.f);
    }
    dft<R>(u[c]);
  }
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    float2* wr = buf + (lane + 32 * c) * R + (((lane + 32 * c) * R) >> 4);
#pragma unroll
    for (int j = 0; j < R; ++j) wr[j] = u[c][j];
  }
  __syncwarp();
}

// Z = FFT_N(z) in buf -> power of the real DFT's bins 0 .. N-1 into pw:
// Y[k] = E + W^k O, Y[N-k] = conj(E - W^k O), with E = (Z[k] + conj Z[N-k])
// / 2, O = -i (Z[k] - conj Z[N-k]) / 2, W = W_2N
template <int N>
__device__ __forceinline__ void split_power(const float2* buf, float* pw, const float2* twp,
                                            int lane) {
  constexpr int NP = N / 2 + 1, PER = (NP + 31) / 32;
  const float2* w = twp + tw_offset(N, N);
  const float2* zk = buf + sw(lane);
  const float2* zn = buf + sw(N - lane);   // Z[N - k] at - sw(32 c); Z[0] for k = 0
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int k = lane + 32 * c;
    if (k < NP) {
      const float2 z = N >= 32 ? zk[sw(32 * c)] : buf[sw(k)];
      const float2 x = N >= 32 ? (k == 0 ? buf[0] : zn[-sw(32 * c)]) : buf[sw((N - k) & (N - 1))];
      const float2 e = make_float2(0.5f * (z.x + x.x), 0.5f * (z.y - x.y));
      const float2 o = make_float2(0.5f * (z.y + x.y), -0.5f * (z.x - x.x));
      const float2 b = cmul(w[k], o);
      const float2 yk = cadd(e, b), yn = csub(e, b);
      if (k < N) pw[k] = fmaf(yk.x, yk.x, __fmul_rn(yk.y, yk.y));
      if (k > 0 && 2 * k != N) pw[N - k] = fmaf(yn.x, yn.x, __fmul_rn(yn.y, yn.y));
    }
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

struct Layout {      // offsets in floats into the dynamic shared memory
  int win, span, work, pw, total;
};

// twiddles, window, the staged span (+3 for its alignment), the work region
// (the warps' FFT buffers, then the tile's features), the tile's power
// spectra (rows of N + 3, the last 3 zeros: lanes over frames read them
// without conflicts, and the mel sum reads up to 3 past a bin's run)
__host__ __device__ inline Layout layout(int n, int n_tw, int ws, int span, int tf, int nmel,
                                         int warps) {
  Layout l{};
  l.win = round4(2 * n_tw);
  l.span = l.win + round4(ws);
  l.work = l.span + round4(span + 3);
  const int bufs = warps * round4(2 * (n + n / 16)), feats = tf * (nmel + 1);
  l.pw = l.work + round4(bufs > feats ? bufs : feats);
  l.total = l.pw + tf * (n + 3);
  return l;
}

// blocks an SM the registers must allow where N <= 256: 3 of 8 warps (as
// many as the shared memory allows; 85 registers a thread, measured faster
// than 64), 2 of 16 (scripts/torch_fbank_ablation.py)
template <int N, bool DITHER>
__host__ __device__ constexpr int min_blocks() { return N > 256 ? 1 : DITHER ? 2 : 3; }

template <int N, bool DITHER>
__global__ void __launch_bounds__(32 * warps_of<DITHER>(), min_blocks<N, DITHER>())
fbank_fft_kernel(const float* __restrict__ wave, const float* __restrict__ window,
                 const float2* __restrict__ twg, const int* __restrict__ mel_info,
                 const float* __restrict__ mel_w, float* __restrict__ out, int n_samples, int T,
                 int ws, int shift, int n_tw, int nmel, int tf, float dither, uint32_t seed) {
  constexpr int kWarps = warps_of<DITHER>(), kThreads = 32 * kWarps;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, t0 = blockIdx.x * tf, nfr = min(tf, T - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = (nfr - 1) * shift + ws;
  const Layout L = layout(N, n_tw, ws, (tf - 1) * shift + ws, tf, nmel, kWarps);
  float2* twp = reinterpret_cast<float2*>(smem);
  float* win = smem + L.win;
  float2* buf = reinterpret_cast<float2*>(smem + L.work + warp * round4(2 * buf_slots<N>()));
  float* pw = smem + L.pw;

  // staging: 4-byte copies up to the first 16-byte-aligned sample, 16-byte
  // copies after it, 4-byte copies for the tail; placed so that the
  // 16-byte copies land on 16-byte-aligned shared addresses
  const float* g = wave + (size_t)b * n_samples + (size_t)t0 * shift;
  const int h = min(len, (int)(((16u - (uint32_t)((uintptr_t)g & 15u)) & 15u) >> 2));
  float* span = smem + L.span + ((4 - h) & 3);
  const int n16 = (len - h) >> 2, tail = h + 4 * n16;
  if ((int)threadIdx.x < h) cp_async4(span + threadIdx.x, g + threadIdx.x);
  for (int q = threadIdx.x; q < n16; q += kThreads) cp_async16(span + h + 4 * q, g + h + 4 * q);
  if ((int)threadIdx.x < len - tail) cp_async4(span + tail + threadIdx.x, g + tail + threadIdx.x);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < n_tw; i += kThreads) twp[i] = twg[i];
  for (int i = threadIdx.x; i < ws; i += kThreads) win[i] = window[i];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // one warp a frame: the framing and conditioning (fused with the first
  // FFT pass where FRAMED), the FFT (its twiddles in registers where they
  // are few), the power into the tile's row
  constexpr int TWR = tw_reg_offset(N, N);
  constexpr bool REG = TWR <= kTwiddleRegs;
  constexpr int R1 = N > 1 ? plan_radix(N) : 1;
  constexpr bool FRAMED = (N / R1) % 32 == 0;
  float2 twr[REG && TWR > 0 ? TWR : 1];
  if constexpr (REG) load_twiddles<N, 1>(twr, twp, lane);
  for (int f = warp; f < nfr; f += kWarps) {
    const int t = t0 + f;
    const float* src = span + f * shift;
    if constexpr (FRAMED) {
      first_pass_framed<N, DITHER>(buf, src, win, ws, dither, seed, b, t, lane);
      fft<N, R1, REG>(buf, twp, twr, lane);
    } else {
      condition<N, DITHER>(reinterpret_cast<float*>(buf), src, win, ws, dither, seed, b, t, lane);
      fft<N, 1, REG>(buf, twp, twr, lane);
    }
    split_power<N>(buf, pw + f * (N + 3), twp, lane);
    if (lane < 3) pw[f * (N + 3) + N + lane] = 0.f;
    __syncwarp();
  }
  __syncthreads();

  // the mel sum: lane = frame, warps over bins (m = warp, warp + kWarps,
  // ...), two bins at a time (two chains of FMAs). A warp loads the (first
  // bin, count, offset) of up to 32 of its bins at once and hands them out
  // by shuffles. Each bin's weights are read four at a time (its run starts
  // at a multiple of 4 and is padded with zeros), once a warp for its 32
  // frames, each against a power (past the run, a finite power or a row's
  // zeros: times a zero weight, they add exactly 0); then the log, into
  // the tile's features (rows of nmel + 1). Lanes past nfr repeat the last
  // frame and store nothing.
  float* feats = smem + L.work;
  const float* p = pw + min(lane, nfr - 1) * (N + 3);
  float* fr = feats + lane * (nmel + 1);
  const bool mine = lane < nfr;
  for (int m0 = warp; m0 < nmel; m0 += 32 * kWarps) {
    const int mi = m0 + kWarps * lane;
    int lo_l = 0, cnt_l = 0, off_l = 0;
    if (mi < nmel) {
      lo_l = __ldg(mel_info + 3 * mi);
      cnt_l = __ldg(mel_info + 3 * mi + 1);
      off_l = __ldg(mel_info + 3 * mi + 2);
    }
    const int nq = min(32, (nmel - m0 + kWarps - 1) / kWarps);
    for (int q = 0; q < nq; q += 2) {
      constexpr unsigned kAll = 0xffffffffu;
      const int ca = __shfl_sync(kAll, cnt_l, q), cb = __shfl_sync(kAll, cnt_l, q + 1);
      const float* pa = p + __shfl_sync(kAll, lo_l, q);
      const float* pb = p + __shfl_sync(kAll, lo_l, q + 1);
      const float4* wa = reinterpret_cast<const float4*>(mel_w + __shfl_sync(kAll, off_l, q));
      const float4* wb = reinterpret_cast<const float4*>(mel_w + __shfl_sync(kAll, off_l, q + 1));
      float acc_a = 0.f, acc_b = 0.f;
      for (int j = 0; j < max(ca, cb); j += 4) {
        if (j < ca) {
          const float4 w4 = __ldg(wa + (j >> 2));
          acc_a = fmaf(pa[j], w4.x, acc_a);
          acc_a = fmaf(pa[j + 1], w4.y, acc_a);
          acc_a = fmaf(pa[j + 2], w4.z, acc_a);
          acc_a = fmaf(pa[j + 3], w4.w, acc_a);
        }
        if (j < cb) {
          const float4 w4 = __ldg(wb + (j >> 2));
          acc_b = fmaf(pb[j], w4.x, acc_b);
          acc_b = fmaf(pb[j + 1], w4.y, acc_b);
          acc_b = fmaf(pb[j + 2], w4.z, acc_b);
          acc_b = fmaf(pb[j + 3], w4.w, acc_b);
        }
      }
      if (mine) fr[m0 + kWarps * q] = logf(fmaxf(acc_a, kEps));
      if (mine && q + 1 < nq) fr[m0 + kWarps * (q + 1)] = logf(fmaxf(acc_b, kEps));
    }
  }
  __syncthreads();

  // the tile's features are one contiguous run of the output: a warp a row
  float* o = out + ((size_t)b * T + t0) * nmel;
  for (int f = warp; f < nfr; f += kWarps)
    for (int m = lane; m < nmel; m += 32) o[f * nmel + m] = feats[f * (nmel + 1) + m];
}

// sets the large-shared-memory attribute of ``kernel`` on the current
// device once, not at every launch
cudaError_t allow_large_smem(const void* kernel) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> done;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({dev, kernel})) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done.insert({dev, kernel});
  return e;
}

// frames a block takes: kTileFrames, fewer where their span of samples
// would pass kSpanFloats or the block's shared memory would not fit
inline int tile_frames(int n, int n_tw, int ws, int shift, int nmel, int warps) {
  int tf = kTileFrames;
  while (tf > 1 && ((tf - 1) * shift + ws > kSpanFloats ||
                    sizeof(float) * (size_t)layout(n, n_tw, ws, (tf - 1) * shift + ws, tf, nmel,
                                                   warps).total > (size_t)kSmemOptIn))
    --tf;
  return tf;
}

template <int N, bool DITHER>
cudaError_t launch(const float* wave, const float* window, const float2* tw, const int* info,
                   const float* mel_w, float* out, cudaStream_t st, int B, int n_samples, int T,
                   int ws, int shift, int n_tw, int nmel, float dither, uint32_t seed) {
  constexpr int warps = warps_of<DITHER>();
  auto kernel = fbank_fft_kernel<N, DITHER>;
  if (n_tw != tw_offset(N, N) + N / 2 + 1) return cudaErrorInvalidValue;
  const int tf = tile_frames(N, n_tw, ws, shift, nmel, warps);
  const size_t smem =
      sizeof(float) * (size_t)layout(N, n_tw, ws, (tf - 1) * shift + ws, tf, nmel, warps).total;
  if (smem > (size_t)kSmemOptIn) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = allow_large_smem(reinterpret_cast<const void*>(kernel));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((T + tf - 1) / tf, B);
  kernel<<<grid, 32 * warps, smem, st>>>(wave, window, tw, info, mel_w, out, n_samples, T, ws,
                                         shift, n_tw, nmel, tf, dither, seed);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(bool dithered, const float* wave, const float* window, const float2* tw,
                     const int* info, const float* mel_w, float* out, cudaStream_t st, int B,
                     int n_samples, int T, int ws, int shift, int n_tw, int nmel, float dither,
                     uint32_t seed) {
  return dithered ? launch<N, true>(wave, window, tw, info, mel_w, out, st, B, n_samples, T, ws,
                                    shift, n_tw, nmel, dither, seed)
                  : launch<N, false>(wave, window, tw, info, mel_w, out, st, B, n_samples, T, ws,
                                     shift, n_tw, nmel, dither, seed);
}

}  // namespace

// wave [B, N] float32 (x 2^15), window [ws], the pass twiddle table
// [n_tw] complex (ops/fbank_kernel.py pass_twiddles(padded)), mel_info
// [nmel, 3] int32 (first bin, count, offset), mel_w [sum of counts] -> out
// [B, T, nmel] float32. padded is the power of two >= ws, at most 1024.
extern "C" int fbank_features(const void* wave, const void* window, const void* tw,
                              const void* mel_info, const void* mel_w, void* out, void* stream,
                              int B, int N, int T, int ws, int shift, int padded, int n_tw,
                              int nmel, int seed, float dither) {
  if (ws < 1 || ws > padded || padded > kMaxPadded || (padded & (padded - 1)) || B < 1 || T < 1 ||
      shift < 1 || nmel < 0 || N < (T - 1) * shift + ws)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d = dither != 0.f;
  const float* wv = static_cast<const float*>(wave);
  const float* wn = static_cast<const float*>(window);
  const float2* t2 = static_cast<const float2*>(tw);
  const int* mi = static_cast<const int*>(mel_info);
  const float* mw = static_cast<const float*>(mel_w);
  float* o = static_cast<float*>(out);
  const uint32_t s = static_cast<uint32_t>(seed);
  cudaError_t e;
#define FBANK_CASE(P, NC)                                                                      \
  case P:                                                                                      \
    e = launch_n<NC>(d, wv, wn, t2, mi, mw, o, st, B, N, T, ws, shift, n_tw, nmel, dither, s); \
    break;
  switch (padded) {
    case 1:
    FBANK_CASE(2, 1)
    FBANK_CASE(4, 2)
    FBANK_CASE(8, 4)
    FBANK_CASE(16, 8)
    FBANK_CASE(32, 16)
    FBANK_CASE(64, 32)
    FBANK_CASE(128, 64)
    FBANK_CASE(256, 128)
    FBANK_CASE(512, 256)
    FBANK_CASE(1024, 512)
    default: e = cudaErrorInvalidValue;
  }
#undef FBANK_CASE
  return static_cast<int>(e);
}
