// Fused Conformer convolution block, inference forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/conv_kernel.py
// (conv_block_fused, _conv_kernel). Per sequence of length T with `length`
// valid frames it computes
//
//   y   = LN_pre(x), zeroed for frames >= length, rounded to x's dtype
//   g   = GLU(y W1 + b1)               (frames in [length, T) keep bias-GLU)
//   z   = depthwise_K(g) + bd          (SAME: ctx//2 left, ctx - ctx//2 right,
//                                       zeros only outside [0, T))
//   out = x + mask(pw2(swish(LN(z))))  (swish output rounded to x's dtype)
//   cache = the trailing K-1 frames of g, zero-left-padded when T < K-1
//
// with float32 math and sums throughout, as the TPU kernel does: the two
// products' operands are y and swish(LN(z)) rounded to x's dtype (the TPU
// kernel's rounding points), g and the depthwise taps stay float32.
//
// Bound: at the decode shape (B=48, T=374, D=256, K=15, bf16) the two
// pointwise products need about 7.1 GFLOP (~7 us at the bf16 tensor rate)
// and the inputs and outputs move about 18 MB (~5.5 us at 3.35 TB/s).
//
// Design. The TPU kernel kept a whole sequence and its [T, 2D] pw1 result
// in VMEM; here it is two launches, with g [B, T, D] float32 between them
// (it stays in the 50 MB L2 at the decode shape).
//
// bf16 (the model's dtype), on the tensor cores: mma.sync m16n8k16, bf16
// operands by ldmatrix from padded shared rows, float32 accumulators.
//  - Launch 1: a block owns 64 rows of the flattened [B T, D] frames and
//    128 GLU channels (the matching a and b columns of W1). Its rows of x
//    arrive by cp.async with the first W1 slices (a ring of 16-row slices
//    [16, a 128 | b 128]); its warps take LN_pre in place into a bf16 tile
//    [64, D]; 8 warps = 2 row halves x 4 groups of 32 channels, each warp
//    holding the a and b accumulators of its channels, so the GLU is taken
//    on the accumulators and g written as float32 pairs.
//  - Launch 2: a block owns 32 frames of one sequence. Each thread takes a
//    channel and runs the K taps over its 32 frames from registers (a
//    window of 32 + K - 1 frames of g read once from L2); the float32 z
//    tile goes to shared memory, each warp takes LN and swish of four
//    frames at once into a bf16 tile [32, D], and the pw2 product runs
//    against W2 streamed in 32-row slices (16 where D % 32 != 0; cp.async
//    ring), each warp owning every 8th 8-column tile of the output;
//    z W2 + b2 (masked) goes back to the float32 tile and the block
//    writes x + z row by row, 16 B a thread.
// float32 (the parity path): the same two launches with FMA products on
// the CUDA cores (no TF32: it would break the parity limit), launch 2
// staging g with its K-1 frame halo in shared memory.
//
// No limit depends on T. The designs above are the narrow path: D a
// multiple of 16 up to 512 (the shipped widths: Conformer-S 144, M 256, L
// 512), bf16 K <= 32 (the register window), float32 what fits shared
// memory (K <= 17 at D = 512). Wider D (to 2048: Conformer XL's 1024 among
// them) or larger K (to 64) take the wide path (see its note below): in
// bf16 four launches, both products on wgmma fed by TMA with 192-row tiles
// and the operands through a bf16 scratch; in float32 16 frames a block
// for launch 2, the depthwise taps and pw2's columns streamed. The C entry
// refuses other shapes before any launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"
#include "rel_attention_hopper.cuh"

namespace {

using rel_attn::bf16;

constexpr int NT = 256;
constexpr float LN_EPS = 1e-5f;
constexpr int MAX_D = 512;
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }
// the bf16 kernels' sigmoid: exp and reciprocal on the special-function unit
// (relative error ~2^-21, far below the bf16 rounding of what it feeds)
__device__ __forceinline__ float sigmoid_fast(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// (mean, rstd) of the D values of a row in shared memory, by one warp, in
// two passes (the mean, then the squares about it) as the plain LayerNorm
template <typename T>
__device__ __forceinline__ float2 row_stats(const T* row, int D, int lane) {
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(row[c]);
  const float mean = warp_sum(s) / D;
  float q = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = to_f(row[c]) - mean;
    q += d * d;
  }
  return make_float2(mean, rsqrtf(warp_sum(q) / D + LN_EPS));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// the trailing ctx frames of g of sequence b, zero-left-padded, as the cache
template <typename T>
__device__ void write_cache(T* __restrict__ cache, const float* __restrict__ gb, int b, int Tlen,
                            int D, int ctx) {
  for (int e = threadIdx.x; e < ctx * D; e += NT) {
    const int j = e / D, c = e - j * D, t = Tlen - ctx + j;
    cache[(size_t)b * ctx * D + e] = from_f<T>(t >= 0 ? gb[(size_t)t * D + c] : 0.f);
  }
}

// ============================================================ bf16 kernels

// ---------------------------------------------------------------- launch 1
constexpr int Q1_M = 64;              // frames per block
constexpr int Q1_C = 128;             // GLU channels per block (4 warp columns x 32)
constexpr int Q1_K = 16;              // W1 rows per ring stage
constexpr int Q1_S = 4;               // ring stages
constexpr int Q1_LDW = 2 * Q1_C + 8;  // a | b columns of a stage row, padded

__host__ __device__ constexpr size_t q1_smem(int D) {
  return 2 * ((size_t)Q1_M * (D + 8) + (size_t)Q1_S * Q1_K * Q1_LDW);
}

__global__ void __launch_bounds__(NT) pw1_glu_bf16_kernel(
    const bf16* __restrict__ x, const int* __restrict__ lengths,
    const float* __restrict__ pre_s, const float* __restrict__ pre_b,
    const bf16* __restrict__ w1, const float* __restrict__ b1, float* __restrict__ glu, int M,
    int Tlen, int D) {
  constexpr int RM = Q1_M, MI = RM / 32;   // frames; 16-row tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldy = D + 8;
  bf16* ys = reinterpret_cast<bf16*>(smem);   // y [RM][ldy]
  bf16* ws = ys + RM * ldy;                   // W1 ring [Q1_S][Q1_K][Q1_LDW]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * RM, c0 = blockIdx.y * Q1_C, nk = D / Q1_K;

  // stage of W1 rows [16 kc, 16 kc + 16): 16 rows x 2 halves x 16 pieces of
  // 16 B, two pieces per thread; channels past D read as zero
  auto load_w = [&](int kc) {
    bf16* dst = ws + (kc % Q1_S) * Q1_K * Q1_LDW;
#pragma unroll
    for (int p = tid; p < Q1_K * 2 * (Q1_C / 8); p += NT) {
      const int r = p >> 5, half = (p >> 4) & 1, cc = (p & 15) * 8, ch = c0 + cc;
      const bool ok = ch < D;
      rel_attn::cp_async<16>(dst + r * Q1_LDW + half * Q1_C + cc,
                             w1 + (size_t)(kc * Q1_K + r) * 2 * D + half * D + (ok ? ch : 0), ok);
    }
  };
  // the block's rows of x into the y tile (rows past M zero), with W1's
  // first stage as one group, then the other stages
  rel_attn::load_rows_async(ys, ldy, x, m0, RM, M, D, tid, NT);
#pragma unroll
  for (int s = 0; s < Q1_S - 1; ++s) {
    if (s < nk) load_w(s);
    rel_attn::cp_async_commit();
  }
  rel_attn::cp_async_wait<Q1_S - 2>();
  __syncthreads();

  // y = LN_pre(x) rounded to bf16 in place, zero for frames past the
  // length: one warp per row, lane holding columns 64 i + 2 lane, + 1
  for (int r = warp; r < RM; r += NT / 32) {
    const int m = m0 + r;
    bool valid = false;
    if (m < M) {
      const int b = m / Tlen;
      valid = m - b * Tlen < lengths[b];
    }
    bf16* yr = ys + r * ldy;
    if (!valid) {
      for (int c = 2 * lane; c < D; c += 64)
        *reinterpret_cast<__nv_bfloat162*>(yr + c) = __floats2bfloat162_rn(0.f, 0.f);
      continue;
    }
    float v[MAX_D / 32];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_D / 64; ++i) {
      const int c = 64 * i + 2 * lane;
      float2 f = make_float2(0.f, 0.f);
      if (c < D) f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(yr + c));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
      s += f.x + f.y;
    }
    const float mean = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_D / 64; ++i)
      if (64 * i + 2 * lane < D) {
        const float d0 = v[2 * i] - mean, d1 = v[2 * i + 1] - mean;
        q += d0 * d0 + d1 * d1;
      }
    const float rstd = rsqrtf(warp_sum(q) / D + LN_EPS);
#pragma unroll
    for (int i = 0; i < MAX_D / 64; ++i) {
      const int c = 64 * i + 2 * lane;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(yr + c) = __floats2bfloat162_rn(
            (v[2 * i] - mean) * rstd * pre_s[c] + pre_b[c],
            (v[2 * i + 1] - mean) * rstd * pre_s[c + 1] + pre_b[c + 1]);
    }
  }

  // h = y W1: warp (wr, wc) owns rows 16 MI wr .. 16 MI wr + 16 MI - 1
  // and channels c0 + 32 wc .. + 31: n8 tiles 0-3 of the a half, 4-7 of
  // the b half
  const int wr = warp >> 2, wc = warp & 3;
  const int live = min(4, max(0, (D - c0 - 32 * wc) / 8));   // n8 tiles of channels < D
  float acc[MI][8][4] = {};
  for (int kc = 0; kc < nk; ++kc) {
    rel_attn::cp_async_wait<Q1_S - 2>();
    __syncthreads();
    if (kc + Q1_S - 1 < nk) load_w(kc + Q1_S - 1);
    rel_attn::cp_async_commit();
    if (live == 0) continue;
    const bf16* wt = ws + (kc % Q1_S) * Q1_K * Q1_LDW;
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      rel_attn::load_a(a[mi], ys, ldy, 16 * MI * wr + 16 * mi, kc * Q1_K, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bf[4];
        rel_attn::load_bt(bf, wt, Q1_LDW, 0, half * Q1_C + 32 * wc + 16 * p, lane);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          rel_attn::mma(acc[mi][4 * half + 2 * p], a[mi], bf[0], bf[1]);
          rel_attn::mma(acc[mi][4 * half + 2 * p + 1], a[mi], bf[2], bf[3]);
        }
      }
  }
  // g = (h_a + b1_a) sigmoid(h_b + b1_b) on the accumulators
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * MI * wr + 16 * mi + (lane >> 2) + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= live) continue;
        const int ch = c0 + 32 * wc + 8 * nt + 2 * (lane & 3);
        *reinterpret_cast<float2*>(glu + (size_t)m * D + ch) = make_float2(
            (acc[mi][nt][2 * h] + b1[ch]) * sigmoid_fast(acc[mi][4 + nt][2 * h] + b1[D + ch]),
            (acc[mi][nt][2 * h + 1] + b1[ch + 1]) *
                sigmoid_fast(acc[mi][4 + nt][2 * h + 1] + b1[D + ch + 1]));
      }
    }
}

// ---------------------------------------------------------------- launch 2
constexpr int Q2_T = 32;   // frames per block
constexpr int Q2_K = 32;   // W2 rows per ring stage (16 where D is not a multiple of 32)
constexpr int Q2_S = 3;    // ring stages
constexpr int Q2_NT = MAX_D / 8 / (NT / 32);   // 8-column output tiles per warp, at most
static_assert(Q2_T == 4 * (NT / 32) && Q1_M % (4 * (NT / 32)) == 0,
              "the LayerNorms take four rows per warp at a time");

__host__ __device__ constexpr size_t q2_smem(int D) {
  return 4 * (size_t)Q2_T * D + 2 * (size_t)(Q2_T + Q2_S * Q2_K) * (D + 8);
}

template <int KMAX>
__global__ void __launch_bounds__(NT) dw_ln_pw2_bf16_kernel(
    const bf16* __restrict__ x, const int* __restrict__ lengths, const float* __restrict__ glu,
    const float* __restrict__ wd, const float* __restrict__ bd, const float* __restrict__ ln_s,
    const float* __restrict__ ln_b, const bf16* __restrict__ w2, const float* __restrict__ b2,
    bf16* __restrict__ out, bf16* __restrict__ cache, int Tlen, int D, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldz = D + 8;
  float* zs = reinterpret_cast<float*>(smem);                // z [Q2_T][D] float32
  bf16* zq = reinterpret_cast<bf16*>(zs + Q2_T * D);         // swish(LN(z)) [Q2_T][ldz]
  bf16* ws = zq + Q2_T * ldz;                                // W2 ring [Q2_S][Q2_K][ldz]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kq = D % 32 ? 16 : Q2_K, nk = D / kq;            // W2 rows per stage, stages
  const int t0 = blockIdx.x * Q2_T, b = blockIdx.y;
  const int ctx = K - 1, lpad = ctx / 2;
  const int len = lengths[b];
  const float* gb = glu + (size_t)b * Tlen * D;
  const bf16* xb = x + (size_t)b * Tlen * D;

  auto load_w = [&](int kc) {
    bf16* dst = ws + (kc % Q2_S) * Q2_K * ldz;
    const int per_row = D / 8;   // pieces of 16 B
    for (int i = tid; i < kq * per_row; i += NT) {
      const int r = i / per_row, cc = (i - r * per_row) * 8;
      rel_attn::cp_async<16>(dst + r * ldz + cc, w2 + (size_t)(kc * kq + r) * D + cc, true);
    }
  };
#pragma unroll
  for (int s = 0; s < Q2_S - 1; ++s) {
    if (s < nk) load_w(s);
    rel_attn::cp_async_commit();
  }

  // depthwise taps: a thread per channel, its 32 frames from a register
  // window of 32 + K - 1 frames of g (zeros outside [0, T))
  for (int c = tid; c < D; c += NT) {
    float w[KMAX], gv[Q2_T + KMAX - 1];
#pragma unroll
    for (int tap = 0; tap < KMAX; ++tap) w[tap] = tap < K ? wd[tap * D + c] : 0.f;
#pragma unroll
    for (int i = 0; i < Q2_T + KMAX - 1; ++i) {
      const int t = t0 - lpad + i;
      gv[i] = (i < Q2_T + ctx && t >= 0 && t < Tlen) ? gb[(size_t)t * D + c] : 0.f;
    }
    const float bias = bd[c];
#pragma unroll
    for (int r = 0; r < Q2_T; ++r) {
      float a = 0.f;
#pragma unroll
      for (int tap = 0; tap < KMAX; ++tap)
        if (tap < K) a = fmaf(gv[r + tap], w[tap], a);
      zs[r * D + c] = a + bias;
    }
  }
  __syncthreads();

  // LN, swish, rounded to bf16: warp w takes frames w + 8 q (q < 4), the
  // four reductions in flight together, lane holding columns lane + 32 i
  {
    float v[4][MAX_D / 32], mean[4], rstd[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* zr = zs + (warp + 8 * q) * D;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i) {
        const int c = lane + 32 * i;
        v[q][i] = c < D ? zr[c] : 0.f;
        s += v[q][i];
      }
      mean[q] = s;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) mean[q] = warp_sum(mean[q]) / D;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i)
        if (lane + 32 * i < D) sq += (v[q][i] - mean[q]) * (v[q][i] - mean[q]);
      rstd[q] = sq;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) rstd[q] = rsqrtf(warp_sum(rstd[q]) / D + LN_EPS);
#pragma unroll
    for (int i = 0; i < MAX_D / 32; ++i) {
      const int c = lane + 32 * i;
      if (c >= D) continue;
      const float s_c = ln_s[c], b_c = ln_b[c];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float z = (v[q][i] - mean[q]) * rstd[q] * s_c + b_c;
        zq[(warp + 8 * q) * ldz + c] = __float2bfloat16(z * sigmoid_fast(z));
      }
    }
  }

  // pw2: warp w owns the 8-column output tiles w, w + 8, ...; rows 0-15, 16-31
  const int ntiles = D / 8;
  float acc[2][Q2_NT][4] = {};
  for (int kc = 0; kc < nk; ++kc) {
    rel_attn::cp_async_wait<Q2_S - 2>();
    __syncthreads();
    if (kc + Q2_S - 1 < nk) load_w(kc + Q2_S - 1);
    rel_attn::cp_async_commit();
    const bf16* wt = ws + (kc % Q2_S) * Q2_K * ldz;
    for (int k16 = 0; k16 < kq; k16 += 16) {
      uint32_t a[2][4];
      rel_attn::load_a(a[0], zq, ldz, 0, kc * kq + k16, lane);
      rel_attn::load_a(a[1], zq, ldz, 16, kc * kq + k16, lane);
#pragma unroll
      for (int j = 0; j < Q2_NT; ++j) {
        const int nt = warp + 8 * j;
        if (nt < ntiles) {
          uint32_t bf[2];
          rel_attn::load_bt1(bf, wt, ldz, k16, 8 * nt, lane);
          rel_attn::mma(acc[0][j], a[0], bf[0], bf[1]);
          rel_attn::mma(acc[1][j], a[1], bf[0], bf[1]);
        }
      }
    }
  }

  // z = mask(acc + b2) into the float32 tile (unread since the LN), then
  // out = x + z row by row, 16 B a thread
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mi + (lane >> 2) + 8 * h;
      const bool on = t0 + r < len;
#pragma unroll
      for (int j = 0; j < Q2_NT; ++j) {
        const int nt = warp + 8 * j;
        if (nt >= ntiles) continue;
        const int c = 8 * nt + 2 * (lane & 3);
        *reinterpret_cast<float2*>(zs + r * D + c) =
            on ? make_float2(acc[mi][j][2 * h] + b2[c], acc[mi][j][2 * h + 1] + b2[c + 1])
               : make_float2(0.f, 0.f);
      }
    }
  __syncthreads();
  bf16* ob = out + (size_t)b * Tlen * D;
  const int per_row = D / 8;
  for (int i = tid; i < Q2_T * per_row; i += NT) {
    const int r = i / per_row, c = (i - r * per_row) * 8, t = t0 + r;
    if (t >= Tlen) continue;
    const uint4 xv = *reinterpret_cast<const uint4*>(xb + (size_t)t * D + c);
    const float4 za = *reinterpret_cast<const float4*>(zs + r * D + c);
    const float4 zb = *reinterpret_cast<const float4*>(zs + r * D + c + 4);
    const float z[8] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
    uint4 ov;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 xf = __bfloat1622float2(xp[q]);
      op[q] = __floats2bfloat162_rn(xf.x + z[2 * q], xf.y + z[2 * q + 1]);
    }
    *reinterpret_cast<uint4*>(ob + (size_t)t * D + c) = ov;
  }
  if (blockIdx.x == 0) write_cache<bf16>(cache, gb, b, Tlen, D, ctx);
}

// ========================================================= float32 kernels

// ---------------------------------------------------------------- launch 1
constexpr int P1_M = 64;   // frames per block
constexpr int P1_C = 32;   // GLU channels per block (64 columns of W1)
constexpr int P1_K = 32;   // k-slice

__global__ void __launch_bounds__(NT) pw1_glu_f32_kernel(
    const float* __restrict__ x, const int* __restrict__ lengths,
    const float* __restrict__ pre_s, const float* __restrict__ pre_b,
    const float* __restrict__ w1, const float* __restrict__ b1, float* __restrict__ glu,
    int Tlen, int D) {
  __shared__ float sMean[P1_M], sRstd[P1_M];
  __shared__ float sA[P1_M][P1_K + 1];
  __shared__ float sW[P1_K][2 * P1_C + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * P1_M, c0 = blockIdx.y * P1_C, b = blockIdx.z;
  const int len = lengths[b];
  const float* xb = x + (size_t)b * Tlen * D;

  for (int r = warp; r < P1_M; r += NT / 32) {  // LN_pre statistics
    const int t = t0 + r;
    float mean = 0.f, rstd = 0.f;
    if (t < Tlen) {
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s += xb[(size_t)t * D + c];
      mean = warp_sum(s) / D;
      float q = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float dv = xb[(size_t)t * D + c] - mean;
        q += dv * dv;
      }
      rstd = rsqrtf(warp_sum(q) / D + LN_EPS);
    }
    if (lane == 0) {
      sMean[r] = mean;
      sRstd[r] = rstd;
    }
  }
  __syncthreads();

  const int tx = tid & 15, ty = tid >> 4;
  float acc_a[4][2], acc_b[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q) acc_a[r][q] = acc_b[r][q] = 0.f;

  for (int k0 = 0; k0 < D; k0 += P1_K) {
    for (int e = tid; e < P1_M * P1_K; e += NT) {
      const int r = e / P1_K, kk = e - r * P1_K, t = t0 + r, kc = k0 + kk;
      float val = 0.f;
      if (t < Tlen && t < len && kc < D) {
        const float xv = xb[(size_t)t * D + kc];
        val = (xv - sMean[r]) * sRstd[r] * pre_s[kc] + pre_b[kc];
      }
      sA[r][kk] = val;
    }
    for (int e = tid; e < P1_K * 2 * P1_C; e += NT) {
      const int kk = e / (2 * P1_C), q = e - kk * 2 * P1_C;
      const int ch = c0 + (q < P1_C ? q : q - P1_C);
      const int col = q < P1_C ? ch : D + ch;
      sW[kk][q] = (k0 + kk < D && ch < D) ? w1[(size_t)(k0 + kk) * 2 * D + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < P1_K; ++kk) {
      float a[4], wa[2], wb[2];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sA[ty + 16 * r][kk];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        wa[q] = sW[kk][tx + 16 * q];
        wb[q] = sW[kk][P1_C + tx + 16 * q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          acc_a[r][q] = fmaf(a[r], wa[q], acc_a[r][q]);
          acc_b[r][q] = fmaf(a[r], wb[q], acc_b[r][q]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + ty + 16 * r;
    if (t >= Tlen) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = c0 + tx + 16 * q;
      if (c >= D) continue;
      const float ha = acc_a[r][q] + b1[c];
      const float hb = acc_b[r][q] + b1[D + c];
      glu[((size_t)b * Tlen + t) * D + c] = ha * sigmoidf(hb);
    }
  }
}

// ---------------------------------------------------------------- launch 2
constexpr int P2_T = 32;   // frames per block
constexpr int P2_K = 16;   // W2 k-slice
constexpr int P2_CC = MAX_D / 32;   // output columns per lane, at most

__host__ __device__ constexpr size_t p2_smem(int D, int K) {
  return sizeof(float) * (size_t)D * (P2_T + (K - 1) + P2_T + P2_K + K);
}

__global__ void __launch_bounds__(NT) dw_ln_pw2_f32_kernel(
    const float* __restrict__ x, const int* __restrict__ lengths,
    const float* __restrict__ glu, const float* __restrict__ wd,
    const float* __restrict__ bd, const float* __restrict__ ln_s,
    const float* __restrict__ ln_b, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out, float* __restrict__ cache,
    int Tlen, int D, int K) {
  extern __shared__ float smem_f[];
  const int ctx = K - 1, lpad = ctx / 2;
  float* sG = smem_f;                  // [P2_T + ctx][D] g with halo
  float* sZ = sG + (P2_T + ctx) * D;   // [P2_T][D]
  float* sW = sZ + P2_T * D;           // [P2_K][D]
  float* sWd = sW + P2_K * D;          // [K][D] taps

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * P2_T, b = blockIdx.y;
  const int len = lengths[b];
  const float* gb = glu + (size_t)b * Tlen * D;

  for (int e = tid; e < (P2_T + ctx) * D; e += NT) {
    const int r = e / D, c = e - r * D, t = t0 - lpad + r;
    sG[e] = (t >= 0 && t < Tlen) ? gb[(size_t)t * D + c] : 0.f;
  }
  for (int e = tid; e < K * D; e += NT) sWd[e] = wd[e];
  __syncthreads();

  for (int c = tid; c < D; c += NT) {  // depthwise taps
    const float bias = bd[c];
    for (int r = 0; r < P2_T; ++r) {
      float acc = 0.f;
      for (int tap = 0; tap < K; ++tap)
        acc = fmaf(sG[(r + tap) * D + c], sWd[tap * D + c], acc);
      sZ[r * D + c] = acc + bias;
    }
  }
  __syncthreads();

  for (int r = warp; r < P2_T; r += NT / 32) {  // LN, swish
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += sZ[r * D + c];
    const float mean = warp_sum(s) / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dv = sZ[r * D + c] - mean;
      q += dv * dv;
    }
    const float rstd = rsqrtf(warp_sum(q) / D + LN_EPS);
    for (int c = lane; c < D; c += 32) {
      const float z = (sZ[r * D + c] - mean) * rstd * ln_s[c] + ln_b[c];
      sZ[r * D + c] = z * sigmoidf(z);
    }
  }
  __syncthreads();

  // pw2: rows warp + 8r (r < 4), columns lane + 32cc (cc < D / 32)
  float acc[4][P2_CC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < P2_CC; ++cc) acc[r][cc] = 0.f;
  for (int k0 = 0; k0 < D; k0 += P2_K) {
    for (int e = tid; e < P2_K * D; e += NT) sW[e] = w2[(size_t)k0 * D + e];
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < P2_K; ++kk) {
      float a[4], w[P2_CC];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sZ[(warp + 8 * r) * D + k0 + kk];
#pragma unroll
      for (int cc = 0; cc < P2_CC; ++cc) {
        const int c = lane + 32 * cc;
        w[cc] = c < D ? sW[kk * D + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < P2_CC; ++cc) acc[r][cc] = fmaf(a[r], w[cc], acc[r][cc]);
    }
    __syncthreads();
  }

  const float* xb = x + (size_t)b * Tlen * D;
  float* ob = out + (size_t)b * Tlen * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + warp + 8 * r;
    if (t >= Tlen) continue;
#pragma unroll
    for (int cc = 0; cc < P2_CC; ++cc) {
      const int c = lane + 32 * cc;
      if (c >= D) continue;
      const float z = t < len ? acc[r][cc] + b2[c] : 0.f;
      ob[(size_t)t * D + c] = xb[(size_t)t * D + c] + z;
    }
  }
  if (blockIdx.x == 0) write_cache<float>(cache, gb, b, Tlen, D, ctx);
}

// ============================================================ wide path
// D above 512 (up to MAX_D_WIDE) or K above the narrow kernels' (up to
// MAX_K), in both dtypes.
//
// float32 (the parity path): launch 1 is pw1_glu_f32_kernel, which has no
// width limit; launch 2, dw_ln_pw2_f32_wide_kernel, takes W2_T = 16 frames
// a block: the depthwise taps (a thread per channel, its 16 frames' sums in
// registers, the taps streamed in windows of TAPS, 16 + TAPS - 1 frames of
// g from L2 a window, so that no register array grows with K); z [16, D]
// float32 in shared memory, LN and swish in place, a warp a frame in two
// passes; pw2 in column passes of W2_NC_F32 columns, W2's [W2_K rows x NC]
// slices through a 2-stage cp.async ring, FMAs (8 columns a lane for two
// frames), out = x + mask(z W2 + b2) from the accumulators.
//
// bf16, on wgmma fed by TMA (hopper_gemm.cuh): four launches, the two
// products' operands through a bf16 scratch [M, D] (y, then swish(LN(z)):
// the TPU kernel rounds both to bf16 at exactly those points, so the
// scratch changes no value), g float32 [M, D] as before.
//  1. ln_pre_bf16_kernel: y = mask(LN_pre(x)) in bf16, a warp a row, the
//     row's 16-byte pieces in registers (D <= 2048: 8 a lane).
//  2. conv_gemm_kernel<EPI_GLU>: h = y W1 on tiles of 192 rows x 64
//     channels, the a and b columns of those channels as the two 64-column
//     blocks of one MN-major B (W1 as it lies in memory), so the GLU is
//     taken on the accumulators; g staged through shared memory, 16-byte
//     stores.
//  3. dw_ln_bf16_kernel: 16 frames of one sequence a block, the depthwise
//     taps as the float32 kernel takes them (depthwise_streamed), LN and
//     swish a warp a frame, swish(LN(z)) in bf16 into the scratch, 16-byte
//     stores; the cache from g.
//  4. conv_gemm_kernel<EPI_RES>: out = x + mask(zq W2 + b2) on tiles of
//     192 rows x 128 columns, staged 64 columns at a time, x read and out
//     written as 16-byte vectors.
// At 6d's decode shape (B=8, T'=374: M = 2992, D=1024, K=15) the products
// are 256 and 128 tiles on 132 SMs (two rounds and one), W1 is read from
// L2 16 times and W2 16 times (96 MB), the operand 16 and 8 times (144 MB).
// The first design (32- and 16-frame blocks on mma.sync, W1 read 94 times
// and W2 192 times, ~800 MB of L2 traffic) took 0.32 ms of device time,
// its weights' copies and its 4- and 8-byte stores the largest stages by
// ablation (PERF.md). Bound at that shape: the products' 18.8 GFLOP over
// every frame, 0.0190 ms at the bf16 tensor rate; over the frames within
// their lengths, as chip_smoke.py and scripts/torch_width_times.py count
// them, 0.011-0.014 ms (operations). This design: 0.069-0.072 ms of device
// time on an H100 at 700 W, the four launches ~5, ~23, ~25 and ~17 us
// (PERF.md, scripts/torch_conv_ablation.py).
constexpr int MAX_D_WIDE = 2048;
constexpr int MAX_K = 64;
constexpr int W2_T = 16;            // frames per block
constexpr int W2_K = 16;            // W2 rows per ring stage (float32)
constexpr int TAPS = 16;            // depthwise taps per register window
constexpr int W2_NC_F32 = 256;      // pw2 columns per pass, float32

// float32 launch 2: z [W2_T][D] and the W2 ring [2][W2_K][NC]
__host__ __device__ constexpr size_t w2_smem_f32(int D) {
  return 4 * (size_t)W2_T * D + 2 * 4 * (size_t)W2_K * W2_NC_F32;
}

// z = depthwise_K(g) + bd for frames [t0, t0 + W2_T) of one sequence into
// zs [W2_T][D]: taps in ascending order, as the narrow kernels sum them
__device__ __forceinline__ void depthwise_streamed(float* __restrict__ zs,
                                                   const float* __restrict__ gb,
                                                   const float* __restrict__ wd,
                                                   const float* __restrict__ bd, int t0,
                                                   int Tlen, int D, int K) {
  const int lpad = (K - 1) / 2;
  for (int c = threadIdx.x; c < D; c += NT) {
    float a[W2_T];
#pragma unroll
    for (int r = 0; r < W2_T; ++r) a[r] = 0.f;
    for (int tb = 0; tb < K; tb += TAPS) {
      float w[TAPS], gv[W2_T + TAPS - 1];
#pragma unroll
      for (int i = 0; i < TAPS; ++i) w[i] = tb + i < K ? wd[(tb + i) * D + c] : 0.f;
#pragma unroll
      for (int i = 0; i < W2_T + TAPS - 1; ++i) {
        const int t = t0 - lpad + tb + i;
        gv[i] = (tb + i < K + W2_T - 1 && t >= 0 && t < Tlen) ? gb[(size_t)t * D + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < W2_T; ++r)
#pragma unroll
        for (int i = 0; i < TAPS; ++i)
          if (tb + i < K) a[r] = fmaf(gv[r + i], w[i], a[r]);
    }
    const float bias = bd[c];
#pragma unroll
    for (int r = 0; r < W2_T; ++r) zs[r * D + c] = a[r] + bias;
  }
}

// rows [row0, row0 + W2_K) and columns [c0, c0 + cols) of W2 [D][D] into
// dst (rows ld apart) by 16-byte cp.async, columns >= D zero
template <typename T>
__device__ __forceinline__ void load_w2_slice(T* dst, int ld, const T* __restrict__ w2, int row0,
                                              int D, int c0, int cols) {
  constexpr int V = 16 / (int)sizeof(T);
  const int per_row = cols / V;
  for (int p = threadIdx.x; p < W2_K * per_row; p += NT) {
    const int r = p / per_row, c = (p - r * per_row) * V, j = c0 + c;
    const bool ok = j < D;
    rel_attn::cp_async<16>(dst + r * ld + c, w2 + (size_t)(row0 + r) * D + (ok ? j : 0), ok);
  }
}


// ------------------------------------------------------------ wide bf16
constexpr int ROWS_NT = NT / 32;            // rows a block of the row-wise launches
constexpr int PIECES = MAX_D_WIDE / 256;    // 16-byte pieces of a row a lane, at most
constexpr int EPI_GLU = 0, EPI_RES = 1;

// launch 1: y = LN_pre(x) rounded to bf16, zero for frames past the
// length, a warp a row; lane l holds the pieces l + 32 i (8 columns each)
__global__ void __launch_bounds__(NT) ln_pre_bf16_kernel(
    const bf16* __restrict__ x, const int* __restrict__ lengths,
    const float* __restrict__ pre_s, const float* __restrict__ pre_b, bf16* __restrict__ y,
    int M, int Tlen, int D) {
  const int m = blockIdx.x * ROWS_NT + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  const int b = m / Tlen, np = D / 8;
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)m * D);
  if (m - b * Tlen >= lengths[b]) {
    for (int p = lane; p < np; p += 32) yr[p] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)m * D);
  float v[PIECES][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int p = lane + 32 * i;
    pg::unpack8(p < np ? xr[p] : make_uint4(0u, 0u, 0u, 0u), v[i]);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[i][e];
  }
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PIECES; ++i)
    if (lane + 32 * i < np)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean;
        q += d * d;
      }
  const float rstd = rsqrtf(warp_sum(q) / D + LN_EPS);
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int p = lane + 32 * i;
    if (p >= np) continue;
    float sc[8], bi[8], o[8];
    pg::load8(pre_s + 8 * p, sc);
    pg::load8(pre_b + 8 * p, bi);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = (v[i][e] - mean) * rstd * sc[e] + bi[e];
    yr[p] = pg::pack8(o);
  }
}

// launch 3: z = depthwise_K(g) + bd for frames [t0, t0 + W2_T) of one
// sequence, then swish(LN(z)) rounded to bf16 into zq, a warp a frame
// (lane l the pieces l + 32 i); block 0 of a sequence writes its cache
__global__ void __launch_bounds__(NT) dw_ln_bf16_kernel(
    const float* __restrict__ glu, const float* __restrict__ wd, const float* __restrict__ bd,
    const float* __restrict__ ln_s, const float* __restrict__ ln_b, bf16* __restrict__ zq,
    bf16* __restrict__ cache, int Tlen, int D, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* zs = reinterpret_cast<float*>(smem);   // z [W2_T][D] float32
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * W2_T, b = blockIdx.y;
  const float* gb = glu + (size_t)b * Tlen * D;
  depthwise_streamed(zs, gb, wd, bd, t0, Tlen, D, K);
  __syncthreads();
  for (int r = warp; r < W2_T && t0 + r < Tlen; r += NT / 32) {   // LN, swish, rounded to bf16
    const float* zr = zs + r * D;
    const float2 st = row_stats(zr, D, lane);
    uint4* qr = reinterpret_cast<uint4*>(zq + ((size_t)b * Tlen + t0 + r) * D);
    for (int p = lane; p < D / 8; p += 32) {
      float z[8], sc[8], bi[8];
      pg::load8(zr + 8 * p, z);
      pg::load8(ln_s + 8 * p, sc);
      pg::load8(ln_b + 8 * p, bi);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float u = (z[e] - st.x) * st.y * sc[e] + bi[e];
        z[e] = u * sigmoid_fast(u);
      }
      qr[p] = pg::pack8(z);
    }
  }
  if (blockIdx.x == 0) write_cache<bf16>(cache, gb, b, Tlen, D, K - 1);
}

// launches 2 and 4: a persistent GEMM on bf16 wgmma (hopper_gemm.cuh). A:
// the scratch [M, D] by amap (boxes of 64 columns x 192 rows); B: W1 [D,
// 2D] or W2 [D, D] by bmap (boxes of 64 columns x 64 rows), MN-major.
//  EPI_GLU: tile (mt, nt) is rows 192 mt.. x channels 64 nt..; its B is
//    W1's a columns 64 nt.. and b columns D + 64 nt.. (channels past D read
//    b columns or zeros and are not stored), so accumulator columns 0-63
//    are h_a and 64-127 h_b of the same channels; g = (h_a + b1)
//    sigmoid(h_b + b1') into `glu`.
//  EPI_RES: tile (mt, nt) is rows 192 mt.. x columns 128 nt..; out = x +
//    mask(acc + b2) (rows past their sequence's length: x).
template <int EPI>
__global__ void __launch_bounds__(pg::THREADS, 1) conv_gemm_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
    const int* __restrict__ lengths, const float* __restrict__ bias, const bf16* __restrict__ x,
    float* __restrict__ glu, bf16* __restrict__ out, int M, int Tlen, int D) {
  extern __shared__ unsigned char smem_raw[];
  const pg::Smem sm = pg::setup(smem_raw);
  __syncthreads();
  const int tn = EPI == EPI_GLU ? (D + 63) / 64 : (D + 127) / 128;
  const int tiles = (M + pg::TM - 1) / pg::TM * tn, nk = (D + 63) / 64;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (wg == 0) {
    hopper::setmaxnreg_dec<pg::REG_PRODUCER>();
    if (tid == 0)
      pg::produce(sm, tiles, tn, nk, [&](unsigned char* dst, uint64_t* bar, int mt, int nt, int kc) {
        hopper::tma_load(dst, &amap, bar, 64 * kc, pg::TM * mt);
        const int n0 = EPI == EPI_GLU ? 64 * nt : 128 * nt, n1 = EPI == EPI_GLU ? D + n0 : n0 + 64;
        hopper::tma_load(dst + pg::A_BYTES, &bmap, bar, n0, 64 * kc);
        hopper::tma_load(dst + pg::A_BYTES + pg::ATOM, &bmap, bar, n1, 64 * kc);
      });
    return;
  }

  hopper::setmaxnreg_inc<pg::REG_CONSUMER>();
  const int c = wg - 1, ct = tid & 127, q = tid & 3;
  float acc[64];
  int g = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tn) * pg::TM + 64 * c, nt = t % tn;   // this warpgroup's rows m0..
    pg::consume(acc, sm, nk, g, c, [](float (&a)[64], uint32_t sa, uint32_t sb, int kc) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wq::wgmma_ss<128, 0, 1>(a, hopper::desc(sa + kk * 32),
                                wq::desc_mn(sb + kk * 2048, pg::ATOM), (kc | kk) != 0);
    });
    if constexpr (EPI == EPI_GLU) {
      const int c0 = 64 * nt;
      const float* stg = pg::stage(sm.stg, c, 0, [&](int i, int hh, int e) {
        const int ch = min(c0 + 8 * i + 2 * q + e, D - 1);
        return (acc[4 * i + 2 * hh + e] + bias[ch]) *
               sigmoid_fast(acc[4 * (i + 8) + 2 * hh + e] + bias[D + ch]);
      });
      for (int j = ct; j < 64 * 16; j += 128) {   // 64 rows x 16 float4
        const int r = j >> 4, cc = (j & 15) * 4, m = m0 + r;
        if (m < M && c0 + cc < D)
          *reinterpret_cast<float4*>(glu + (size_t)m * D + c0 + cc) =
              *reinterpret_cast<const float4*>(stg + r * pg::EPI_LD + cc);
      }
    } else {
#pragma unroll   // whole: acc is indexed by half, so it stays in registers
      for (int half = 0; half < 2; ++half) {
        const int n0 = 128 * nt + 64 * half;
        const float* stg = pg::stage(sm.stg, c, half, [&](int i, int hh, int e) {
          return acc[4 * i + 2 * hh + e] + bias[min(128 * nt + 8 * i + 2 * q + e, D - 1)];
        });
        for (int j = ct; j < 64 * 8; j += 128) {   // 64 rows x 8 pieces of 8 columns
          const int r = j >> 3, cc = (j & 7) * 8, m = m0 + r, n = n0 + cc;
          if (m >= M || n >= D) continue;
          const int bq = m / Tlen;
          const bool on = m - bq * Tlen < lengths[bq];
          float xv[8], z[8];
          pg::load8(x + (size_t)m * D + n, xv);
          pg::load8(stg + r * pg::EPI_LD + cc, z);
#pragma unroll
          for (int e = 0; e < 8; ++e) xv[e] += on ? z[e] : 0.f;
          pg::store8(out + (size_t)m * D + n, xv);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT) dw_ln_pw2_f32_wide_kernel(
    const float* __restrict__ x, const int* __restrict__ lengths, const float* __restrict__ glu,
    const float* __restrict__ wd, const float* __restrict__ bd, const float* __restrict__ ln_s,
    const float* __restrict__ ln_b, const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out, float* __restrict__ cache, int Tlen, int D, int K) {
  constexpr int NC = W2_NC_F32, CC = NC / 32;   // a lane's columns of a pass
  extern __shared__ __align__(16) unsigned char smem[];
  float* zs = reinterpret_cast<float*>(smem);   // z, then swish(LN(z)) [W2_T][D]
  float* ws = zs + W2_T * D;                    // W2 ring [2][W2_K][NC]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * W2_T, b = blockIdx.y;
  const int len = lengths[b];
  const float* gb = glu + (size_t)b * Tlen * D;
  const float* xb = x + (size_t)b * Tlen * D;
  float* ob = out + (size_t)b * Tlen * D;
  const int nk = D / W2_K, steps = (D + NC - 1) / NC * nk;
  auto load_w = [&](int st) {
    load_w2_slice(ws + (st & 1) * W2_K * NC, NC, w2, (st % nk) * W2_K, D, (st / nk) * NC, NC);
  };
  load_w(0);
  rel_attn::cp_async_commit();

  depthwise_streamed(zs, gb, wd, bd, t0, Tlen, D, K);
  __syncthreads();
  for (int r = warp; r < W2_T; r += NT / 32) {   // LN, swish, in place
    float* zr = zs + r * D;
    const float2 st = row_stats(zr, D, lane);
    for (int c = lane; c < D; c += 32) {
      const float z = (zr[c] - st.x) * st.y * ln_s[c] + ln_b[c];
      zr[c] = z * sigmoidf(z);
    }
  }

  // pw2: frames warp and warp + 8, columns n0 + lane + 32 cc of a pass
  float acc[2][CC];
  for (int st = 0; st < steps; ++st) {
    const int kc = st % nk, n0 = (st / nk) * NC;
    if (st + 1 < steps) {
      load_w(st + 1);
      rel_attn::cp_async_commit();
      rel_attn::cp_async_wait<1>();
    } else {
      rel_attn::cp_async_wait<0>();
    }
    __syncthreads();
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) acc[r][cc] = 0.f;
    }
    const float* wt = ws + (st & 1) * W2_K * NC;
#pragma unroll 4
    for (int kk = 0; kk < W2_K; ++kk) {
      const float a0 = zs[warp * D + kc * W2_K + kk];
      const float a1 = zs[(warp + 8) * D + kc * W2_K + kk];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const float w = wt[kk * NC + lane + 32 * cc];
        acc[0][cc] = fmaf(a0, w, acc[0][cc]);
        acc[1][cc] = fmaf(a1, w, acc[1][cc]);
      }
    }
    __syncthreads();
    if (kc == nk - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + warp + 8 * r;
        if (t >= Tlen) continue;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const int c = n0 + lane + 32 * cc;
          if (c >= D) continue;
          const float z = t < len ? acc[r][cc] + b2[c] : 0.f;
          ob[(size_t)t * D + c] = xb[(size_t)t * D + c] + z;
        }
      }
    }
  }
  if (blockIdx.x == 0) write_cache<float>(cache, gb, b, Tlen, D, K - 1);
}

// ------------------------------------------------------------------- host

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// the narrow kernels: every shipped width (D <= 512, K = 15)
bool narrow_shape(int D, int K, int is_bf16) {
  if (D > MAX_D) return false;
  return is_bf16 ? K <= 32 : p2_smem(D, K) <= (size_t)SMEM_LIMIT;
}

bool shape_ok(int D, int K) {
  return D >= 16 && D % 16 == 0 && D <= MAX_D_WIDE && K >= 1 && K <= MAX_K;
}

// the wide bf16 route: four launches (see "wide path" above), the operand
// scratch opnd bf16 [M, D]
cudaError_t launch_bf16_wide(const bf16* x, const int* lengths, const float* pre_s,
                             const float* pre_b, const bf16* w1, const float* b1, const float* wd,
                             const float* bd, const float* ln_s, const float* ln_b,
                             const bf16* w2, const float* b2, bf16* out, bf16* cache, float* glu,
                             bf16* opnd, cudaStream_t stream, int B, int Tlen, int D, int K) {
  const int M = B * Tlen;
  static bool smem_set = false;   // once per process
  if (!smem_set) {
    cudaError_t err = set_smem(conv_gemm_kernel<EPI_GLU>, pg::SMEM);
    if (err == cudaSuccess) err = set_smem(conv_gemm_kernel<EPI_RES>, pg::SMEM);
    if (err == cudaSuccess) err = set_smem(dw_ln_bf16_kernel, 4 * (size_t)W2_T * MAX_D_WIDE);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap amap, w1map, w2map;
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t err = hopper::tile_map(&amap, BF16, 2, opnd, M, D, pg::TM);
  if (err == cudaSuccess) err = hopper::weight_map(&w1map, BF16, 2, w1, D, 2 * D, 64);
  if (err == cudaSuccess) err = hopper::weight_map(&w2map, BF16, 2, w2, D, D, 64);
  if (err != cudaSuccess) return err;
  const int mt = (M + pg::TM - 1) / pg::TM;
  ln_pre_bf16_kernel<<<(M + ROWS_NT - 1) / ROWS_NT, NT, 0, stream>>>(x, lengths, pre_s, pre_b,
                                                                     opnd, M, Tlen, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles1 = mt * ((D + 63) / 64);
  conv_gemm_kernel<EPI_GLU><<<pg::grid_size(tiles1), pg::THREADS, pg::SMEM, stream>>>(
      amap, w1map, lengths, b1, nullptr, glu, nullptr, M, Tlen, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_ln_bf16_kernel<<<dim3((Tlen + W2_T - 1) / W2_T, B), NT, 4 * (size_t)W2_T * D, stream>>>(
      glu, wd, bd, ln_s, ln_b, opnd, cache, Tlen, D, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles2 = mt * ((D + 127) / 128);
  conv_gemm_kernel<EPI_RES><<<pg::grid_size(tiles2), pg::THREADS, pg::SMEM, stream>>>(
      amap, w2map, lengths, b2, x, nullptr, out, M, Tlen, D);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* x, const void* lengths, const void* pre_s, const void* pre_b,
                        const void* w1, const void* b1, const void* wd, const void* bd,
                        const void* ln_s, const void* ln_b, const void* w2, const void* b2,
                        void* out, void* cache, void* glu, void* opnd, cudaStream_t stream,
                        int B, int Tlen, int D, int K) {
  if (!narrow_shape(D, K, 1)) {
    if (opnd == nullptr) return cudaErrorInvalidValue;
    return launch_bf16_wide(
        static_cast<const bf16*>(x), static_cast<const int*>(lengths),
        static_cast<const float*>(pre_s), static_cast<const float*>(pre_b),
        static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(wd), static_cast<const float*>(bd),
        static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out),
        static_cast<bf16*>(cache), static_cast<float*>(glu), static_cast<bf16*>(opnd), stream, B,
        Tlen, D, K);
  }
  const int M = B * Tlen;
  cudaError_t err = set_smem(pw1_glu_bf16_kernel, q1_smem(D));
  if (err != cudaSuccess) return err;
  dim3 grid1((M + Q1_M - 1) / Q1_M, (D + Q1_C - 1) / Q1_C);
  pw1_glu_bf16_kernel<<<grid1, NT, q1_smem(D), stream>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(lengths),
      static_cast<const float*>(pre_s), static_cast<const float*>(pre_b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<float*>(glu), M,
      Tlen, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kernel = K <= 16 ? dw_ln_pw2_bf16_kernel<16> : dw_ln_pw2_bf16_kernel<32>;
  const size_t smem2 = q2_smem(D);
  err = set_smem(kernel, smem2);
  if (err != cudaSuccess) return err;
  dim3 grid2((Tlen + Q2_T - 1) / Q2_T, B);
  kernel<<<grid2, NT, smem2, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(lengths),
      static_cast<const float*>(glu), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), static_cast<bf16*>(cache), Tlen, D,
      K);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const void* lengths, const void* pre_s, const void* pre_b,
                       const void* w1, const void* b1, const void* wd, const void* bd,
                       const void* ln_s, const void* ln_b, const void* w2, const void* b2,
                       void* out, void* cache, void* glu, cudaStream_t stream, int B, int Tlen,
                       int D, int K) {
  dim3 grid1((Tlen + P1_M - 1) / P1_M, (D + P1_C - 1) / P1_C, B);
  pw1_glu_f32_kernel<<<grid1, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(lengths),
      static_cast<const float*>(pre_s), static_cast<const float*>(pre_b),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<float*>(glu), Tlen, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const bool wide = !narrow_shape(D, K, 0);
  auto kernel = wide ? dw_ln_pw2_f32_wide_kernel : dw_ln_pw2_f32_kernel;
  const size_t smem = wide ? w2_smem_f32(D) : p2_smem(D, K);
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int t2 = wide ? W2_T : P2_T;
  dim3 grid2((Tlen + t2 - 1) / t2, B);
  kernel<<<grid2, NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(lengths),
      static_cast<const float*>(glu), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), static_cast<float*>(cache),
      Tlen, D, K);
  return cudaGetLastError();
}

}  // namespace

// x [B,T,D] (float32 or bf16: is_bf16); lengths int32 [B]; pre_s, pre_b,
// b2, bd, ln_s, ln_b float32 [D]; w1 [D,2D] and w2 [D,D] in x's dtype
// (16-byte aligned); b1 float32 [2D]; wd float32 [K,D]; out [B,T,D] and
// cache [B,K-1,D] in x's dtype; glu float32 scratch [B,T,D]; opnd bf16
// scratch [B,T,D] (16-byte aligned), read only by the wide bf16 route (may
// be null elsewhere). All contiguous. D a multiple of 16 up to 2048 and 1
// <= K <= 64: the narrow kernels where narrow_shape holds, else the wide
// path. Returns the CUDA error code (0 on success; cudaErrorInvalidValue
// before any launch for a shape outside these).
extern "C" int conv_block_fwd(const void* x, const void* lengths, const void* pre_s,
                              const void* pre_b, const void* w1, const void* b1,
                              const void* wd, const void* bd, const void* ln_s,
                              const void* ln_b, const void* w2, const void* b2,
                              void* out, void* cache, void* glu, void* opnd, void* stream, int B,
                              int Tlen, int D, int K, int is_bf16) {
  if (!shape_ok(D, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_bf16(x, lengths, pre_s, pre_b, w1, b1, wd, bd, ln_s, ln_b, w2, b2, out,
                            cache, glu, opnd, s, B, Tlen, D, K)
              : launch_f32(x, lengths, pre_s, pre_b, w1, b1, wd, bd, ln_s, ln_b, w2, b2, out,
                           cache, glu, s, B, Tlen, D, K);
  return static_cast<int>(err);
}
