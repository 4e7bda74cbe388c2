// Relative-position flash attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of conformer_tpu/ops/pallas/
// attention_kernel.py _flash_bwd: _attn_bwd_dq_kernel (call :396) and
// _attn_bwd_dkv_kernel (call :436). From the forward's inputs, its lse and
// delta = rowsum(dO * O) (a torch op outside the kernels, as in JAX), both
// recompute the score tiles
//
//   s  = ((q+u) K^T + AB F^T) * scale,   p = mask ? exp(s - lse) : 0,
//   dp = dO V^T,  times keep / (1 - rate) where dropout is live,
//   dS = p * (dp - delta) * scale,
//
// and accumulate, in float32,
//   dq kernel:  dQu = dS K,   dAB = dS F        (one block per query tile)
//   dkv kernel: dK = dS^T (q+u),  dV = pd^T dO  (one block per key tile)
// with pd = p * keep / (1 - rate). The keep-mask is the hash of
// rel_attention_common.cuh on global (row, column), so it equals the
// forward's element for element. Each output element belongs to one block
// and is summed in a fixed order: no atomics, bitwise repeatable. Fully
// masked rows carry lse = 1e30 and give p = 0; ragged tails of queries and
// keys are zero-filled or bounds-checked, not padded in memory.
//
// Bound: at the training shape (B=32, H=4, T=Tk=374, dk=64, D=256, bf16)
// dq moves about 115 MB (dAB alone 49 MB in float32) and dkv about 79 MB,
// so both are bound by the card's memory rate (34 and 23 us at 3.35 TB/s,
// chip_smoke.py), ahead of their tensor-core products (the score tile is
// recomputed in both, as in JAX).
//
// Two routes by width (rel_attention_common.cuh): in bf16 every width runs
// the wide kernels below, on wgmma fed by TMA (dk up to 128, dk and D
// multiples of 8; ops/rel_attention.py zero-pads the widths that are not,
// such as Conformer-S's dk 36, up to them); in float32 the narrow (D <=
// 512) or the wide design of the float32 kernels.
//
// float32 design (the parity path): float32 FMAs on the CUDA cores, with
// float32 tiles in shared memory. The position depth D streams in chunks of
// DCM columns of AB and F, as in the forward: at D <= DCM one chunk stays
// in shared memory, above (Conformer-L, D = 512) the chunks are loaded in
// turn wherever the position term or dAB needs them.
//  - dq: 256 threads own a 32-row query tile; Q and dO stay in shared
//    memory while 64-key tiles of K, V and F stream through. Each thread
//    keeps a 2 x 32 slice of dAB (rows ty+16r, columns tx+16c over NCH
//    chunks) and a 2 x QC slice of dQ in registers (157 KB of shared memory
//    at L).
//  - dkv: 256 threads own a 64-key tile; K and V stay in shared memory (F
//    too at D <= DCM) while 32-row query tiles stream through; each thread
//    holds a 4 x OC slice of dK and of dV (165 KB at L).
//  Narrow widths: QC = OC = 4, DCM = 256, NCH = 2 (D <= 512). Wide: QC = OC
//  = 8 (dk <= 128), DCM = 128, NCH = 4, and dq's grid splits dAB's columns
//  into groups of 512, each block recomputing its tile's scores, so that no
//  D is refused (157 and 166 KB at dk = 128).
//
// The bf16 path (dk up to 128, any D), redesigned for Hopper: S, P and
// dS once per (query, key) pair for the whole backward on wgmma fed by TMA
// through an mbarrier ring (rel_flash_bwd_ds_wide_kernel), dS and pd to
// bf16 scratches in device memory, then [dQu | dAB] = dS [K | F] (dq) and
// dK = dS^T (q+u), dV = pd^T dO (dkv) as wgmma products of their own; the
// autograd backward launches the first kernel once for both. Each output
// element still belongs to one block and is summed in a fixed order:
// bitwise repeatable. See the kernels' notes.

#include "rel_attention_hopper.cuh"

namespace {

using namespace rel_attn;

constexpr int NT = 256;
constexpr int DQ_BQ = 32;    // query rows of a dq block
constexpr int DQ_BK = 64;    // key tile streamed by a dq block
constexpr int KV_BK = 64;    // keys of a dkv block
constexpr int KV_BQ = 32;    // query tile streamed by a dkv block
constexpr int F32_DC = 256;  // columns of AB and F per chunk (narrow)
constexpr int F32_NCH = 2;   // chunks a dq block's dAB columns span (narrow: D <= 512)

// rows [row0, row0 + rows) and columns [c0, c0 + dc) of src [n_rows][width]
// into dst (row stride ld); rows at or past n_rows are zero
__device__ __forceinline__ void load_cols(float* dst, int ld, const float* src, int row0,
                                          int rows, int n_rows, int width, int c0, int dc,
                                          int tid) {
  for (int e = tid; e < rows * dc; e += NT) {
    const int r = e / dc, c = e - r * dc, i = row0 + r;
    dst[r * ld + c] = i < n_rows ? src[(size_t)i * width + c0 + c] : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int row0,
                                          int rows, int n_rows, int width, int tid) {
  load_cols(dst, ld, src, row0, rows, n_rows, width, 0, width, tid);
}

// QC dQ columns a thread (tx + 16 c: dk <= 16 QC); AB and F's columns in
// chunks of DCM; a block's dAB columns span NCH chunks: with SPLIT the grid's
// x holds ceil(D / (NCH DCM)) such column groups per query tile, each
// recomputing the scores, so that D has no limit (dQ from group 0)
template <int QC, int DCM, int NCH, bool SPLIT>
__global__ void __launch_bounds__(NT) rel_flash_bwd_dq_f32_kernel(
    const float* __restrict__ qu, const float* __restrict__ ab, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ feats,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, float* __restrict__ dab,
    int H, int Tq, int Tk, int dk, int D, float scale, int drop, uint32_t thr, int Ht,
    int Ho, float inv_keep) {
  extern __shared__ float smem[];
  constexpr int CPC = DCM / 16;              // a thread's dAB columns per chunk
  const int DC = min(D, DCM), DCp = DC + 1;
  const int dkp = dk + 1, BKp = DQ_BK + 1;   // +1: no bank conflicts
  const bool one_chunk = D <= DCM;
  float* sQ = smem;                  // [DQ_BQ][dkp]
  float* sAB = sQ + DQ_BQ * dkp;     // [DQ_BQ][DCp]  a chunk of AB's columns
  float* sdO = sAB + DQ_BQ * DCp;    // [DQ_BQ][dkp]
  float* sK = sdO + DQ_BQ * dkp;     // [DQ_BK][dkp]
  float* sV = sK + DQ_BK * dkp;      // [DQ_BK][dkp]
  float* sF = sV + DQ_BK * dkp;      // [DQ_BK][DCp]  a chunk of F's columns
  float* sDS = sF + DQ_BK * DCp;     // [DQ_BQ][BKp]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (Tq + DQ_BQ - 1) / DQ_BQ, grp = SPLIT ? blockIdx.x / nq : 0;
  const int q0 = (blockIdx.x - grp * nq) * DQ_BQ, h = blockIdx.y, b = blockIdx.z;
  const int ab0 = grp * NCH * DCM;           // the block's first dAB column
  const size_t bh = (size_t)b * H + h;
  const uint32_t hbh = (uint32_t)b * (uint32_t)Ht + (uint32_t)(Ho + h);  // keep-mask head
  const float* abg = ab + bh * Tq * D;
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;

  load_rows(sQ, dkp, qu + bh * Tq * dk, q0, DQ_BQ, Tq, dk, tid);
  if (one_chunk) load_rows(sAB, DCp, abg, q0, DQ_BQ, Tq, D, tid);
  load_rows(sdO, dkp, dout + bh * Tq * dk, q0, DQ_BQ, Tq, dk, tid);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ty + 16 * r;
    row_lse[r] = i < Tq ? lse[bh * Tq + i] : LSE_BIG;
    row_delta[r] = i < Tq ? delta[bh * Tq + i] : 0.f;
  }

  // dAB columns ab0 + ch DCM + tx + 16c of chunk ch in acc_ab[r][CPC ch + c]
  float acc_q[2][QC], acc_ab[2][CPC * NCH];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < QC; ++c) acc_q[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CPC * NCH; ++c) acc_ab[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += DQ_BK) {
    load_rows(sK, dkp, k + bh * Tk * dk, k0, DQ_BK, Tk, dk, tid);
    load_rows(sV, dkp, v + bh * Tk * dk, k0, DQ_BK, Tk, dk, tid);
    if (one_chunk) load_rows(sF, DCp, feats, k0, DQ_BK, Tk, D, tid);
    __syncthreads();

    float s[2][4], dp[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int d = 0; d < dk; ++d) {   // (q+u) K^T and dO V^T
      float a[2], g[2], bk[4], bv[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        a[r] = sQ[(ty + 16 * r) * dkp + d];
        g[r] = sdO[(ty + 16 * r) * dkp + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bk[c] = sK[(tx + 16 * c) * dkp + d];
        bv[c] = sV[(tx + 16 * c) * dkp + d];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(a[r], bk[c], s[r][c]);
          dp[r][c] = fmaf(g[r], bv[c], dp[r][c]);
        }
    }
    float sb[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sb[r][c] = 0.f;
    for (int c0 = 0; c0 < D; c0 += DC) {    // AB F^T, chunk by chunk
      const int dc = min(DC, D - c0);
      if (!one_chunk) {
        __syncthreads();
        load_cols(sAB, DCp, abg, q0, DQ_BQ, Tq, D, c0, dc, tid);
        load_cols(sF, DCp, feats, k0, DQ_BK, Tk, D, c0, dc, tid);
        __syncthreads();
      }
      for (int d = 0; d < dc; ++d) {
        float a[2], bb[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) a[r] = sAB[(ty + 16 * r) * DCp + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = sF[(tx + 16 * c) * DCp + d];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sb[r][c] = fmaf(a[r], bb[c], sb[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        const bool ok = i < Tq && j < Tk && mg[(size_t)i * Tk + j] != 0;
        const float p = ok ? expf((s[r][c] + sb[r][c]) * scale - row_lse[r]) : 0.f;
        float dpv = dp[r][c];
        if (drop)
          dpv = keep_prob(sd, hbh, (uint32_t)i, (uint32_t)j, thr) ? dpv * inv_keep : 0.f;
        sDS[(ty + 16 * r) * BKp + tx + 16 * c] = p * (dpv - row_delta[r]) * scale;
      }
    }
    __syncthreads();

    for (int j = 0; j < DQ_BK; ++j) {   // dQu += dS K
      float ds[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) ds[r] = sDS[(ty + 16 * r) * BKp + j];
#pragma unroll
      for (int c = 0; c < QC; ++c) {
        const int d = tx + 16 * c;
        const float kk = d < dk ? sK[j * dkp + d] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) acc_q[r][c] = fmaf(ds[r], kk, acc_q[r][c]);
      }
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {   // dAB += dS F, chunk by chunk
      const int c0 = ab0 + ch * DCM;
      if (c0 >= D) break;
      if (!one_chunk) {
        __syncthreads();
        load_cols(sF, DCp, feats, k0, DQ_BK, Tk, D, c0, min(DC, D - c0), tid);
        __syncthreads();
      }
      for (int j = 0; j < DQ_BK; ++j) {
        float ds[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) ds[r] = sDS[(ty + 16 * r) * BKp + j];
#pragma unroll
        for (int c = 0; c < CPC; ++c) {
          const int d = c0 + tx + 16 * c;
          const float ff = d < D ? sF[j * DCp + tx + 16 * c] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            acc_ab[r][CPC * ch + c] = fmaf(ds[r], ff, acc_ab[r][CPC * ch + c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= Tq) continue;
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      const int d = tx + 16 * c;
      if (grp == 0 && d < dk) dq[(bh * Tq + i) * dk + d] = acc_q[r][c];
    }
#pragma unroll
    for (int c = 0; c < CPC * NCH; ++c) {
      const int d = ab0 + (c / CPC) * DCM + tx + 16 * (c % CPC);
      if (d < D) dab[(bh * Tq + i) * D + d] = acc_ab[r][c];
    }
  }
}

// OC dK and dV columns a thread (tx + 16 c: dk <= 16 OC); chunks of DCM
template <int OC, int DCM>
__global__ void __launch_bounds__(NT) rel_flash_bwd_dkv_f32_kernel(
    const float* __restrict__ qu, const float* __restrict__ ab, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ feats,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk_out,
    float* __restrict__ dv_out, int H, int Tq, int Tk, int dk, int D, float scale,
    int drop, uint32_t thr, int Ht, int Ho, float inv_keep) {
  extern __shared__ float smem[];
  const int DC = min(D, DCM), DCp = DC + 1;
  const int dkp = dk + 1, BKp = KV_BK + 1;
  const bool one_chunk = D <= DCM;
  float* sK = smem;                  // [KV_BK][dkp]
  float* sV = sK + KV_BK * dkp;      // [KV_BK][dkp]
  float* sF = sV + KV_BK * dkp;      // [KV_BK][DCp]  a chunk of F's columns
  float* sQ = sF + KV_BK * DCp;      // [KV_BQ][dkp]
  float* sAB = sQ + KV_BQ * dkp;     // [KV_BQ][DCp]  the same chunk of AB's
  float* sdO = sAB + KV_BQ * DCp;    // [KV_BQ][dkp]
  float* sPd = sdO + KV_BQ * dkp;    // [KV_BQ][BKp]
  float* sDS = sPd + KV_BQ * BKp;    // [KV_BQ][BKp]
  float* sLse = sDS + KV_BQ * BKp;   // [KV_BQ]
  float* sDelta = sLse + KV_BQ;      // [KV_BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * KV_BK, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint32_t hbh = (uint32_t)b * (uint32_t)Ht + (uint32_t)(Ho + h);  // keep-mask head
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;

  load_rows(sK, dkp, k + bh * Tk * dk, k0, KV_BK, Tk, dk, tid);
  load_rows(sV, dkp, v + bh * Tk * dk, k0, KV_BK, Tk, dk, tid);
  if (one_chunk) load_rows(sF, DCp, feats, k0, KV_BK, Tk, D, tid);
  const float* abg = ab + bh * Tq * D;

  float acc_k[4][OC], acc_v[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += KV_BQ) {
    load_rows(sQ, dkp, qu + bh * Tq * dk, q0, KV_BQ, Tq, dk, tid);
    if (one_chunk) load_rows(sAB, DCp, abg, q0, KV_BQ, Tq, D, tid);
    load_rows(sdO, dkp, dout + bh * Tq * dk, q0, KV_BQ, Tq, dk, tid);
    if (tid < KV_BQ) {
      const int i = q0 + tid;
      sLse[tid] = i < Tq ? lse[bh * Tq + i] : LSE_BIG;
      sDelta[tid] = i < Tq ? delta[bh * Tq + i] : 0.f;
    }
    __syncthreads();

    // scores of the tile: queries ty+16r (r < 2), keys tx+16c (c < 4)
    float s[2][4], dp[2][4], sb[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = sb[r][c] = 0.f;
    for (int d = 0; d < dk; ++d) {
      float a[2], g[2], bk[4], bv[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        a[r] = sQ[(ty + 16 * r) * dkp + d];
        g[r] = sdO[(ty + 16 * r) * dkp + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bk[c] = sK[(tx + 16 * c) * dkp + d];
        bv[c] = sV[(tx + 16 * c) * dkp + d];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(a[r], bk[c], s[r][c]);
          dp[r][c] = fmaf(g[r], bv[c], dp[r][c]);
        }
    }
    for (int c0 = 0; c0 < D; c0 += DC) {   // AB F^T, chunk by chunk
      const int dc = min(DC, D - c0);
      if (!one_chunk) {
        __syncthreads();
        load_cols(sAB, DCp, abg, q0, KV_BQ, Tq, D, c0, dc, tid);
        load_cols(sF, DCp, feats, k0, KV_BK, Tk, D, c0, dc, tid);
        __syncthreads();
      }
      for (int d = 0; d < dc; ++d) {
        float a[2], bb[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) a[r] = sAB[(ty + 16 * r) * DCp + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = sF[(tx + 16 * c) * DCp + d];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sb[r][c] = fmaf(a[r], bb[c], sb[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = ty + 16 * r, i = q0 + qi;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        const bool ok = i < Tq && j < Tk && mg[(size_t)i * Tk + j] != 0;
        const float p = ok ? expf((s[r][c] + sb[r][c]) * scale - sLse[qi]) : 0.f;
        float pd = p, dpv = dp[r][c];
        if (drop) {
          const bool kp = keep_prob(sd, hbh, (uint32_t)i, (uint32_t)j, thr);
          pd = kp ? p * inv_keep : 0.f;
          dpv = kp ? dpv * inv_keep : 0.f;
        }
        sPd[qi * BKp + tx + 16 * c] = pd;
        sDS[qi * BKp + tx + 16 * c] = p * (dpv - sDelta[qi]) * scale;
      }
    }
    __syncthreads();

    for (int q = 0; q < KV_BQ; ++q) {   // dV += pd^T dO, dK += dS^T (q+u)
      float pk[4], dsk[4], go[OC], qq[OC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pk[r] = sPd[q * BKp + ty + 16 * r];
        dsk[r] = sDS[q * BKp + ty + 16 * r];
      }
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int d = tx + 16 * c;
        go[c] = d < dk ? sdO[q * dkp + d] : 0.f;
        qq[c] = d < dk ? sQ[q * dkp + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          acc_v[r][c] = fmaf(pk[r], go[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(dsk[r], qq[c], acc_k[r][c]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= Tk) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int d = tx + 16 * c;
      if (d < dk) {
        dk_out[(bh * Tk + j) * dk + d] = acc_k[r][c];
        dv_out[(bh * Tk + j) * dk + d] = acc_v[r][c];
      }
    }
  }
}

// ------------------------------------------------------------ wide, bf16
// dk up to 128 and any D (every bf16 width), redesigned for Hopper: S, P
// and dS are computed once per (query, key) pair for the whole backward,
// on wgmma fed by TMA (rel_attention_hopper.cuh), and written to bf16
// scratches that three product kernels share:
//   1. rel_flash_bwd_ds_wide_kernel: block = 128 query rows of one (batch,
//      head); a producer warpgroup (one thread) streams TMA boxes of 64
//      depth columns into a 4-stage ring of 32 KB stages, completing on
//      mbarriers; two consumer warpgroups, 64 rows each, take every 128-key
//      tile in turn: S = [q+u | AB] [K | F]^T over the depth DKM + D (q+u
//      and K's chunks, then AB and F's) and dP = dO V^T (DKM), both on
//      wgmma m64n128k16 with float32 accumulators in registers; then, from
//      the accumulators (the keep-mask hash at the global head, b Ht + Ho +
//      h), dS = p (dP keep / (1 - rate) - delta) scale and, for dkv, pd = p
//      keep / (1 - rate) are written as bf16 to the scratches dS and pd [B,
//      H, Tq, round128(Tk)] (73.5 MB each at B=32, T'=374, H=8; zero past Tk
//      and on key tiles the mask hides from all 128 rows, whose products are
//      skipped).
//   2. rel_flash_bwd_dsk_wide_kernel (dq): [dQu | dAB] = dS [K | F], the
//      product JAX's dq kernel body computes (82.5 GFLOP at that shape):
//      block = 128 query rows; per 128-column tile of the output, dS
//      (K-major) and [K | F] (64 keys x 128 columns, MN-major: K's boxes for
//      columns below DKM, F's above) stream through the same kind of ring
//      into wgmma m64n128k16; each tile's epilogue writes its float32
//      columns while the producer already loads the next tile's stages.
//   3. rel_flash_bwd_dkv_wide_kernel (dkv): dK = dS^T (q+u) and dV = pd^T
//      dO, the products of JAX's dkv kernel body (18.3 GFLOP): block = 128
//      keys; per 64-row chunk of queries, one stage of dS (two boxes of 64
//      keys x 64 rows, the A operand MN-major: wgmma's transpose of A) and
//      q+u (the B operand, MN-major), then one of pd and dO, into
//      wgmma m64nDKMk16; dK and dV in registers, written once.
// dq runs 1 (without pd) and 2; dkv runs 1 and 3; the autograd backward
// runs 1 once and then 2 and 3 (rel_flash_attention_bwd). dS and pd are
// rounded to bf16 once, as the A operands of their products. Each output
// element is one block's, summed over the depth in a
// fixed order: bitwise repeatable, and dK, dV the same bits on either
// path. No limit on D; dk <= 128, multiples of 8 (the TMA boxes' strides),
// operands 16-byte aligned.
// Why S is shared rather than recomputed: S's depth DKM + D (1152 at d =
// 1024) makes it the backward's largest product, so a dkv that recomputes
// S^T per key tile (the first design, on mma.sync) or a dq that recomputes
// it per group of output columns does that product again; writing dS and
// pd once costs their bytes instead (PERF.md has both designs' times). At
// Conformer-M's and -L's depths (320, 576) a dq and a dkv that each
// recompute S, with one operand in shared memory for the whole block, were
// built too and measured slower than this path's one call (PERF.md).
// Bound at that shape: dq's bytes (AB read and dAB written dominate: 0.22
// ms at 3.35 TB/s) over its products (S, dP and the dS product, ~0.18 ms
// at the bf16 tensor rate); dkv's bytes (~0.12 ms). The scratches add dS's
// and pd's writes and re-reads (0.09 ms) and kernel 1 re-reads AB's chunks
// from L2 once per key tile (PERF.md).

// dS (and pd, where pd is not null) of 128 query rows of one (batch, head)
// against every key tile; the maps: q+u, AB, dO [B H, Tq, *], K, V [B H,
// Tk, *] and F [1, Tk, D] in boxes of 64 columns x 128 rows
__global__ void __launch_bounds__(wq::THREADS, 1) rel_flash_bwd_ds_wide_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap abmap,
    const __grid_constant__ CUtensorMap omap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap fmap,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ ds,
    bf16* __restrict__ pd, int H, int Tq, int Tk, int Tkp, int dkc, int D, float scale,
    int drop, uint32_t thr, int Ht, int Ho, float inv_keep) {
  using namespace wq;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  uint8_t* live = reinterpret_cast<uint8_t*>(empty + STAGES);   // [nkt]: a live pair in the tile
  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int nkt = (Tk + TK - 1) / TK, ns = dkc + (D + 63) / 64;
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  if (tid == 0) init_ring(full, empty);
  live_tiles(live, mg, q0, Tq, Tk, nkt);

  if (wg == 0) {
    hopper::setmaxnreg_dec<REG_PRODUCER>();
    if (tid == 0) {
      int g = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        if (!live[kt]) continue;
        const int k0 = kt * TK;
        for (int d = 0; d < ns + dkc; ++d, ++g) {   // S's depth chunks, then dP's
          unsigned char* dst = claim(ring, full, empty, g);
          uint64_t* bar = &full[g % STAGES];
          if (d < dkc) {
            tma_load3(dst, &qmap, bar, 64 * d, q0, bh);
            tma_load3(dst + HALF, &kmap, bar, 64 * d, k0, bh);
          } else if (d < ns) {
            tma_load3(dst, &abmap, bar, 64 * (d - dkc), q0, bh);
            tma_load3(dst + HALF, &fmap, bar, 64 * (d - dkc), k0, 0);
          } else {
            tma_load3(dst, &omap, bar, 64 * (d - ns), q0, bh);
            tma_load3(dst + HALF, &vmap, bar, 64 * (d - ns), k0, bh);
          }
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<REG_CONSUMER>();
  const int c = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 64 * c + 16 * warp + (lane >> 2);   // this thread's rows r0, r0 + 8
  const uint32_t hbh = (uint32_t)b * (uint32_t)Ht + (uint32_t)(Ho + h);   // keep-mask head
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float sl2 = scale * LOG2E;
  const bool even = Tk % 2 == 0 && reinterpret_cast<uintptr_t>(mask) % 2 == 0;
  int qi[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + r0 + 8 * r;
    lse2[r] = qi[r] < Tq ? lse[(size_t)bh * Tq + qi[r]] * LOG2E : LSE_BIG;
    dl[r] = qi[r] < Tq ? delta[(size_t)bh * Tq + qi[r]] : 0.f;
  }
  bf16* dsg = ds + (size_t)bh * Tq * Tkp;
  bf16* pdg = pd == nullptr ? nullptr : pd + (size_t)bh * Tq * Tkp;
  auto put = [&](bf16* base, int i, int j, uint32_t v) {
    *reinterpret_cast<uint32_t*>(base + (size_t)i * Tkp + j) = v;
  };
  int g = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TK;
    if (!live[kt]) {   // dS = pd = 0 on the whole tile
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (qi[r] < Tq)
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            put(dsg, qi[r], k0 + 8 * i + 2 * (lane & 3), 0u);
            if (pdg != nullptr) put(pdg, qi[r], k0 + 8 * i + 2 * (lane & 3), 0u);
          }
      continue;
    }
    float s[64], dp[64];
    ring_products<128, 0, 0>(s, ns, ring, full, empty, g, c);
    ring_products<128, 0, 0>(dp, dkc, ring, full, empty, g, c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = k0 + 8 * i + 2 * (lane & 3);
        const uint32_t mk = mask_pair(mg, qi[r], j, Tq, Tk, even);
        float dsv[2], pdv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = mask_bit(mk, e) ? exp2_approx(s[4 * i + 2 * r + e] * sl2 - lse2[r]) : 0.f;
          float dpv = dp[4 * i + 2 * r + e];
          pdv[e] = p;
          if (drop) {
            const bool kp = keep_prob(sd, hbh, (uint32_t)qi[r], (uint32_t)(j + e), thr);
            dpv = kp ? dpv * inv_keep : 0.f;
            pdv[e] = kp ? p * inv_keep : 0.f;
          }
          dsv[e] = p * (dpv - dl[r]) * scale;
        }
        if (qi[r] < Tq) {
          put(dsg, qi[r], j, pack_bf16(dsv[0], dsv[1]));
          if (pdg != nullptr) put(pdg, qi[r], j, pack_bf16(pdv[0], pdv[1]));
        }
      }
    }
  }
}

// [dQu | dAB] = dS [K | F] for 128 query rows of one (batch, head): the
// maps dS [B H, Tq, Tkp] in boxes of 64 keys x 128 rows, K [B H, Tk, dk]
// and F [1, Tk, D] in boxes of 64 columns x 64 keys; dQu's columns are
// [0, DKM) (zero past dk), dAB's [DKM, DKM + D)
__global__ void __launch_bounds__(wq::THREADS, 1) rel_flash_bwd_dsk_wide_kernel(
    const __grid_constant__ CUtensorMap dsmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap fmap, float* __restrict__ dq, float* __restrict__ dab,
    int H, int Tq, int Tkp, int dk, int dkm, int D) {
  using namespace wq;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int nct = (dkm + D + TN - 1) / TN, nkc = Tkp / 64;
  if (tid == 0) init_ring(full, empty);
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<REG_PRODUCER>();
    if (tid == 0) {
      int g = 0;
      for (int ct = 0; ct < nct; ++ct)
        for (int kc = 0; kc < nkc; ++kc, ++g) {
          unsigned char* dst = claim(ring, full, empty, g);
          uint64_t* bar = &full[g % STAGES];
          tma_load3(dst, &dsmap, bar, 64 * kc, q0, bh);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int col = TN * ct + 64 * jj;
            if (col < dkm)
              tma_load3(dst + HALF + jj * ATOM, &kmap, bar, col, 64 * kc, bh);
            else
              tma_load3(dst + HALF + jj * ATOM, &fmap, bar, col - dkm, 64 * kc, 0);
          }
        }
    }
    return;
  }

  hopper::setmaxnreg_inc<REG_CONSUMER>();
  const int c = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 64 * c + 16 * warp + (lane >> 2);
  int g = 0;
  for (int ct = 0; ct < nct; ++ct) {
    float acc[64];
    ring_products<128, 0, 1>(acc, nkc, ring, full, empty, g, c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + r0 + 8 * r;
      if (i >= Tq) continue;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = TN * ct + 8 * n + 2 * (lane & 3);   // dk, D: multiples of 8
        const float2 v = make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
        if (col < dk)
          *reinterpret_cast<float2*>(dq + ((size_t)bh * Tq + i) * dk + col) = v;
        else if (col >= dkm && col - dkm < D)
          *reinterpret_cast<float2*>(dab + ((size_t)bh * Tq + i) * D + col - dkm) = v;
      }
    }
  }
}

// dK = dS^T (q+u), dV = pd^T dO for 128 keys of one (batch, head): the
// maps dS, pd [B H, Tq, Tkp] in boxes of 64 keys x 64 rows (consumer
// warpgroup c's A: keys 64 c ..), q+u, dO [B H, Tq, dk] in boxes of 64
// columns x 64 rows; stages alternate (dS, q+u) and (pd, dO) over 64-row
// chunks of the queries (zero past Tq)
template <int DKM>
__global__ void __launch_bounds__(wq::THREADS, 1) rel_flash_bwd_dkv_wide_kernel(
    const __grid_constant__ CUtensorMap dsmap, const __grid_constant__ CUtensorMap pdmap,
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
    float* __restrict__ dk_out, float* __restrict__ dv_out, int H, int Tq, int Tk, int dk) {
  using namespace wq;
  constexpr int DKC = DKM / 64;
  constexpr uint32_t BYTES = HALF + DKC * ATOM;   // a stage: A's two boxes, B's DKC
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int k0 = blockIdx.x * TK, h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int nqc = (Tq + 63) / 64;
  const int nc = Tk - k0 > 64 ? 2 : 1;   // consumer warpgroups with a key below Tk
  if (tid == 0) init_ring(full, empty, nc);
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<REG_PRODUCER>();
    if (tid == 0) {
      int g = 0;
      for (int qc = 0; qc < nqc; ++qc)
#pragma unroll
        for (int t = 0; t < 2; ++t, ++g) {   // (dS, q+u), then (pd, dO)
          unsigned char* dst = claim(ring, full, empty, g, BYTES);
          uint64_t* bar = &full[g % STAGES];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            tma_load3(dst + j * ATOM, t ? &pdmap : &dsmap, bar, k0 + 64 * j, 64 * qc, bh);
#pragma unroll
          for (int j = 0; j < DKC; ++j)
            tma_load3(dst + HALF + j * ATOM, t ? &omap : &qmap, bar, 64 * j, 64 * qc, bh);
        }
    }
    return;
  }

  hopper::setmaxnreg_inc<REG_CONSUMER>();
  const int c = wg - 1;
  if (c >= nc) return;   // all 64 keys past Tk: no products, nothing to write
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  float ak[DKM / 2], av[DKM / 2];
#pragma unroll
  for (int i = 0; i < DKM / 2; ++i) ak[i] = av[i] = 0.f;
  fence_regs(ak);
  fence_regs(av);
  int g = 0;
  for (int qc = 0; qc < nqc; ++qc) {
#pragma unroll
    for (int t = 0; t < 2; ++t, ++g) {
      const uint32_t s = await_stage(ring, full, g);
      const uint32_t a = s + c * ATOM, bb = s + HALF;
      hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_mn(a + kk * 2048, ATOM), db = desc_mn(bb + kk * 2048, ATOM);
        if (t == 0)
          wgmma_ss<DKM, 1, 1>(ak, da, db, 1);
        else
          wgmma_ss<DKM, 1, 1>(av, da, db, 1);
      }
      hopper::wg_commit();
      if (g > 0) {   // the products of the stage before are done: release it
        hopper::wg_wait<1>();
        hopper::mbar_arrive(&empty[(g - 1) % STAGES]);
      }
    }
  }
  hopper::wg_wait0();
  fence_regs(ak);
  fence_regs(av);
  hopper::mbar_arrive(&empty[(g - 1) % STAGES]);

  const int r0 = 64 * c + 16 * warp + (lane >> 2);   // this thread's keys k0 + r0, + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + r0 + 8 * r;
    if (j >= Tk) continue;
#pragma unroll
    for (int n = 0; n < DKM / 8; ++n) {
      const int col = 8 * n + 2 * (lane & 3);   // dk: a multiple of 8
      if (col >= dk) continue;
      const size_t at = ((size_t)bh * Tk + j) * dk + col;
      *reinterpret_cast<float2*>(dk_out + at) =
          make_float2(ak[4 * n + 2 * r], ak[4 * n + 2 * r + 1]);
      *reinterpret_cast<float2*>(dv_out + at) =
          make_float2(av[4 * n + 2 * r], av[4 * n + 2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------ launches

// Shared memory of one block, in bytes.
template <int DCM>
size_t dq_f32_smem(int dk, int D) {
  const size_t dcp = (size_t)min(D, DCM) + 1;
  return sizeof(float) * ((size_t)2 * DQ_BQ * (dk + 1) + (size_t)DQ_BQ * dcp +
                          (size_t)2 * DQ_BK * (dk + 1) + (size_t)DQ_BK * dcp +
                          (size_t)DQ_BQ * (DQ_BK + 1));
}

template <int DCM>
size_t dkv_f32_smem(int dk, int D) {
  const size_t dcp = (size_t)min(D, DCM) + 1;
  return sizeof(float) * ((size_t)2 * KV_BK * (dk + 1) + (size_t)KV_BK * dcp +
                          (size_t)2 * KV_BQ * (dk + 1) + (size_t)KV_BQ * dcp +
                          (size_t)2 * KV_BQ * (KV_BK + 1) + 2 * KV_BQ);
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, size_t smem, dim3 grid, int threads, cudaStream_t stream,
                   Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

struct Args {
  const void *qu, *ab, *k, *v, *feats, *mask, *seed, *dout, *lse, *delta;
  void *o1, *o2, *scratch;
  cudaStream_t stream;
  int B, H, Tq, Tk, dk, D, drop;
  uint32_t thr;
  int Ht, Ho;
  float scale, inv_keep;
  void *o3 = nullptr, *o4 = nullptr;   // the combined backward's dK, dV
};

// the float32 kernels take no extra int: wrap them to the common signature
cudaError_t run_f32(void (*kernel)(const float*, const float*, const float*, const float*,
                                   const float*, const uint8_t*, const int*, const float*,
                                   const float*, const float*, float*, float*, int, int, int,
                                   int, int, float, int, uint32_t, int, int, float),
                    size_t smem, dim3 grid, const Args& a) {
  return launch(kernel, smem, grid, NT, a.stream, static_cast<const float*>(a.qu),
                static_cast<const float*>(a.ab), static_cast<const float*>(a.k),
                static_cast<const float*>(a.v), static_cast<const float*>(a.feats),
                static_cast<const uint8_t*>(a.mask), static_cast<const int*>(a.seed),
                static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
                static_cast<const float*>(a.delta), static_cast<float*>(a.o1),
                static_cast<float*>(a.o2), a.H, a.Tq, a.Tk, a.dk, a.D, a.scale, a.drop, a.thr,
                a.Ht, a.Ho, a.inv_keep);
}

// the wide bf16 path's operands must be 16-byte aligned
bool wide_ok(const Args& a) {
  return wide_width(a.dk, a.D, true) && aligned16(a.qu) && aligned16(a.ab) && aligned16(a.k) &&
         aligned16(a.v) && aligned16(a.feats) && aligned16(a.dout);
}

// elements of one of the wide bf16 path's scratches, bf16 [B, H, Tq,
// round128(Tk)]: dS, then (dkv and the combined backward) pd after it
size_t scratch_elems(const Args& a) {
  return (size_t)a.B * a.H * a.Tq * round_up(a.Tk, wq::TK);
}

// kernel 1 of the wide bf16 backward: dS into the scratch, and pd after it
// with_pd (see rel_flash_bwd_ds_wide_kernel)
cudaError_t launch_ds_wide(const Args& a, bool with_pd) {
  const int bhn = a.B * a.H, tkp = round_up(a.Tk, wq::TK);
  CUtensorMap qm, abm, om, km, vm, fm;
  cudaError_t e = wq::bf16_map3(&qm, a.qu, a.dk, a.Tq, bhn, wq::TQ);
  if (e == cudaSuccess) e = wq::bf16_map3(&abm, a.ab, a.D, a.Tq, bhn, wq::TQ);
  if (e == cudaSuccess) e = wq::bf16_map3(&om, a.dout, a.dk, a.Tq, bhn, wq::TQ);
  if (e == cudaSuccess) e = wq::bf16_map3(&km, a.k, a.dk, a.Tk, bhn, wq::TK);
  if (e == cudaSuccess) e = wq::bf16_map3(&vm, a.v, a.dk, a.Tk, bhn, wq::TK);
  if (e == cudaSuccess) e = wq::bf16_map3(&fm, a.feats, a.D, a.Tk, 1, wq::TK);
  if (e != cudaSuccess) return e;
  bf16* ds = static_cast<bf16*>(a.scratch);
  const dim3 grid((a.Tq + wq::TQ - 1) / wq::TQ, a.H, a.B);
  return launch(rel_flash_bwd_ds_wide_kernel, wq::SMEM + tkp / wq::TK, grid, wq::THREADS,
                a.stream, qm, abm, om, km, vm, fm, static_cast<const uint8_t*>(a.mask),
                static_cast<const int*>(a.seed), static_cast<const float*>(a.lse),
                static_cast<const float*>(a.delta), ds,
                with_pd ? ds + scratch_elems(a) : nullptr, a.H, a.Tq, a.Tk, tkp,
                a.dk <= 64 ? 1 : 2, a.D, a.scale, a.drop, a.thr, a.Ht, a.Ho, a.inv_keep);
}

// kernel 2 (dq): [dQu | dAB] = dS [K | F] into dq, dab
cudaError_t launch_dsk_wide(const Args& a, void* dq, void* dab) {
  const int bhn = a.B * a.H, tkp = round_up(a.Tk, wq::TK), dkm = a.dk <= 64 ? 64 : 128;
  CUtensorMap dsm, km, fm;
  cudaError_t e = wq::bf16_map3(&dsm, a.scratch, tkp, a.Tq, bhn, wq::TQ);
  if (e == cudaSuccess) e = wq::bf16_map3(&km, a.k, a.dk, a.Tk, bhn, 64);
  if (e == cudaSuccess) e = wq::bf16_map3(&fm, a.feats, a.D, a.Tk, 1, 64);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Tq + wq::TQ - 1) / wq::TQ, a.H, a.B);
  return launch(rel_flash_bwd_dsk_wide_kernel, wq::SMEM, grid, wq::THREADS, a.stream, dsm, km,
                fm, static_cast<float*>(dq), static_cast<float*>(dab), a.H, a.Tq, tkp, a.dk,
                dkm, a.D);
}

// kernel 3 (dkv): dK = dS^T (q+u), dV = pd^T dO into dk_out, dv_out
cudaError_t launch_dkv_wide(const Args& a, void* dk_out, void* dv_out) {
  const int bhn = a.B * a.H, tkp = round_up(a.Tk, wq::TK);
  const bf16* ds = static_cast<const bf16*>(a.scratch);
  CUtensorMap dsm, pdm, qm, om;
  cudaError_t e = wq::bf16_map3(&dsm, ds, tkp, a.Tq, bhn, 64);
  if (e == cudaSuccess) e = wq::bf16_map3(&pdm, ds + scratch_elems(a), tkp, a.Tq, bhn, 64);
  if (e == cudaSuccess) e = wq::bf16_map3(&qm, a.qu, a.dk, a.Tq, bhn, 64);
  if (e == cudaSuccess) e = wq::bf16_map3(&om, a.dout, a.dk, a.Tq, bhn, 64);
  if (e != cudaSuccess) return e;
  const dim3 grid(tkp / wq::TK, a.H, a.B);
  auto kernel = a.dk <= 64 ? rel_flash_bwd_dkv_wide_kernel<64> : rel_flash_bwd_dkv_wide_kernel<128>;
  return launch(kernel, wq::SMEM, grid, wq::THREADS, a.stream, dsm, pdm, qm, om,
                static_cast<float*>(dk_out), static_cast<float*>(dv_out), a.H, a.Tq, a.Tk, a.dk);
}

cudaError_t launch_dq(const Args& a, bool bf16_) {
  const int nq32 = (a.Tq + DQ_BQ - 1) / DQ_BQ;
  if (!bf16_) {
    if (narrow_width(a.dk, a.D, false))
      return run_f32(rel_flash_bwd_dq_f32_kernel<4, F32_DC, F32_NCH, false>,
                     dq_f32_smem<F32_DC>(a.dk, a.D), dim3(nq32, a.H, a.B), a);
    if (!wide_width(a.dk, a.D, false)) return cudaErrorInvalidValue;
    const int groups = (a.D + 4 * 128 - 1) / (4 * 128);
    return run_f32(rel_flash_bwd_dq_f32_kernel<8, 128, 4, true>, dq_f32_smem<128>(a.dk, a.D),
                   dim3(nq32 * groups, a.H, a.B), a);
  }
  if (!wide_ok(a) || a.scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = launch_ds_wide(a, false);
  return e != cudaSuccess ? e : launch_dsk_wide(a, a.o1, a.o2);
}

cudaError_t launch_dkv(const Args& a, bool bf16_) {
  const int nk64 = (a.Tk + KV_BK - 1) / KV_BK;
  if (!bf16_) {
    if (narrow_width(a.dk, a.D, false))
      return run_f32(rel_flash_bwd_dkv_f32_kernel<4, F32_DC>, dkv_f32_smem<F32_DC>(a.dk, a.D),
                     dim3(nk64, a.H, a.B), a);
    if (!wide_width(a.dk, a.D, false)) return cudaErrorInvalidValue;
    return run_f32(rel_flash_bwd_dkv_f32_kernel<8, 128>, dkv_f32_smem<128>(a.dk, a.D),
                   dim3(nk64, a.H, a.B), a);
  }
  if (!wide_ok(a) || a.scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = launch_ds_wide(a, true);
  return e != cudaSuccess ? e : launch_dkv_wide(a, a.o1, a.o2);
}

}  // namespace

// Inputs as rel_flash_attention_fwd's (q_u, ab, k, v, feats, mask, seed),
// plus dout [B,H,Tq,dk] in the inputs' dtype and lse, delta float32
// [B,H,Tq]. dq_kernel writes dq [B,H,Tq,dk] and dab [B,H,Tq,D]; dkv_kernel
// writes dk, dv [B,H,Tk,dk]; all float32, contiguous. Widths as the
// forward's, but in bf16 only wide_width's (dk and D multiples of 8; dout
// 16-byte aligned too). Ht, Ho: the keep-mask's head total and offset, as
// the forward's. scratch: the bf16 path's dS, bf16 [B,H,Tq,round128(Tk)],
// followed for dkv by pd of the same shape (null in float32). Each returns
// the CUDA error code of its launches (0 on success; cudaErrorInvalidValue
// before any launch for widths outside both paths).
extern "C" int rel_flash_attention_bwd_dq(
    const void* qu, const void* ab, const void* k, const void* v, const void* feats,
    const void* mask, const void* seed, const void* dout, const void* lse,
    const void* delta, void* dq, void* dab, void* scratch, void* stream, int B, int H, int Tq,
    int Tk, int dk, int D, int is_bf16, int drop, int thr_bits, int Ht, int Ho, float scale,
    float inv_keep) {
  const Args a{qu, ab, k, v, feats, mask, seed, dout, lse, delta, dq, dab, scratch,
               static_cast<cudaStream_t>(stream), B, H, Tq, Tk, dk, D, drop,
               static_cast<uint32_t>(thr_bits), Ht, Ho, scale, inv_keep};
  return static_cast<int>(launch_dq(a, is_bf16 != 0));
}

extern "C" int rel_flash_attention_bwd_dkv(
    const void* qu, const void* ab, const void* k, const void* v, const void* feats,
    const void* mask, const void* seed, const void* dout, const void* lse,
    const void* delta, void* dk_out, void* dv_out, void* scratch, void* stream, int B, int H,
    int Tq, int Tk, int dk, int D, int is_bf16, int drop, int thr_bits, int Ht, int Ho,
    float scale, float inv_keep) {
  const Args a{qu, ab, k, v, feats, mask, seed, dout, lse, delta, dk_out, dv_out, scratch,
               static_cast<cudaStream_t>(stream), B, H, Tq, Tk, dk, D, drop,
               static_cast<uint32_t>(thr_bits), Ht, Ho, scale, inv_keep};
  return static_cast<int>(launch_dkv(a, is_bf16 != 0));
}

// The whole wide bf16 backward: dS and pd once, then dq's and dkv's
// products (arguments as the two above, dq, dab, dk, dv and the scratch of
// dS and pd). Returns cudaErrorInvalidValue before any launch off the wide
// bf16 path, which the two functions above take one by one.
extern "C" int rel_flash_attention_bwd(
    const void* qu, const void* ab, const void* k, const void* v, const void* feats,
    const void* mask, const void* seed, const void* dout, const void* lse,
    const void* delta, void* dq, void* dab, void* dk_out, void* dv_out, void* scratch,
    void* stream, int B, int H, int Tq, int Tk, int dk, int D, int is_bf16, int drop,
    int thr_bits, int Ht, int Ho, float scale, float inv_keep) {
  const Args a{qu, ab, k, v, feats, mask, seed, dout, lse, delta, dq, dab, scratch,
               static_cast<cudaStream_t>(stream), B, H, Tq, Tk, dk, D, drop,
               static_cast<uint32_t>(thr_bits), Ht, Ho, scale, inv_keep, dk_out, dv_out};
  if (!is_bf16 || !wide_ok(a) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = launch_ds_wide(a, true);
  if (e == cudaSuccess) e = launch_dsk_wide(a, dq, dab);
  if (e == cudaSuccess) e = launch_dkv_wide(a, dk_out, dv_out);
  return static_cast<int>(e);
}
