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
// bf16 design (the model's path): every product on the tensor cores,
// mma.sync.m16n8k16 with bf16 operands and float32 accumulators, ldmatrix
// from padded rows, the next 16-deep step's fragments loaded while the
// current one multiplies, cp.async 2-stage rings, the mask bytes one tile
// ahead, tiles the mask hides entirely skipped; the score product is one
// product of depth KD = dk + D (rounded up to 64) over [q+u | AB] and
// [K | F], as in the forward.
//  - dq: 16 warps own 64 query rows of one (batch, head), or 8 warps 32
//    rows where 64 do not fit shared memory (Conformer-L); [q+u | AB] and
//    dO stay in shared memory while 64-key tiles of [K | F] and V stream
//    through, each block starting at another tile (rotated, as the
//    forward). Each warp computes 16 rows x 16 keys of S and dP and writes
//    its dS to shared memory once, as bf16. Then [dQu | dAB] += dS . [K | F]
//    is one product of width KD: each warp owns KD / 8 of its columns for
//    32 rows, so a thread holds KD / 8 float32 accumulators (40 at
//    Conformer-M, 72 at L). 159 KB of shared memory at M, 210 KB at L.
//  - dkv: 4 warps own 64 keys; [K | F] and V stay in shared memory while
//    32-row query tiles of [q+u | AB], dO, lse and delta stream through.
//    Each warp computes S^T and dP^T for its 16 keys, then dV += pd^T dO
//    and dK += dS^T (q+u) with pd^T and dS^T taken from the accumulator
//    registers as bf16 A operands. 101 KB at M (two blocks per SM).
//  wgmma and TMA are the next step (see rel_flash_attention.cu).
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
// The wide bf16 path (dk up to 128, any D; rel_attention_common.cuh's
// narrow_width decides, as in the forward). dq, redesigned for Hopper
// (rel_flash_bwd_ds_wide_kernel, rel_flash_bwd_dsk_wide_kernel): S, dP and
// dS once per (query, key) pair on wgmma fed by TMA through an mbarrier
// ring, dS to a bf16 scratch in device memory, then [dQu | dAB] = dS [K |
// F] as a second wgmma product (the first design split the output columns
// over the grid and recomputed S, dP and dS for each group of 512). dkv
// streams the score product's depth through a ring of 64-column chunks of
// AB and F, as the forward's wide kernel (80 KB at DKM = 128). Each output
// element still belongs to one block and is summed in a fixed order:
// bitwise repeatable. See the kernels' notes.

#include "hopper_common.cuh"
#include "rel_attention_common.cuh"

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

// ------------------------------------------------------------ bf16, tensor cores

constexpr int QK = 64;    // key tile streamed by a bf16 dq block
constexpr int VK = 64;    // keys of a bf16 dkv block: 4 warps x 16
constexpr int VQ = 32;    // query tile streamed by a bf16 dkv block
constexpr int VNT = 128;

// QB query rows (32 or 64) and QB / 4 warps; NT8 = KD / 64: the 8-column
// tiles of [dQu | dAB] that each warp owns for 32 rows
template <int NT8, int QB>
__global__ void __launch_bounds__(QB * 8) rel_flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ ab, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ feats,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, float* __restrict__ dab, int H,
    int Tq, int Tk, int dk, int D, int DKP, float scale, int drop, uint32_t thr, int Ht,
    int Ho, float inv_keep) {
  constexpr int QNT = QB * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int KD = NT8 * 64, LDA = KD + 8, LDV = DKP + 8, LDS = QK + 8;
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);   // [QB][LDA]  [q+u | AB]
  bf16* sO = sA + QB * LDA;                       // [QB][LDV]  dO
  bf16* sB = sO + QB * LDV;                       // [2][QK][LDA]  [K | F]
  bf16* sV = sB + 2 * QK * LDA;                   // [2][QK][LDV]
  bf16* sS = sV + 2 * QK * LDV;                   // [QB][LDS]  dS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int q0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint32_t hbh = (uint32_t)b * (uint32_t)Ht + (uint32_t)(Ho + h);  // keep-mask head
  const bf16* kg = k + bh * Tk * dk;
  const bf16* vg = v + bh * Tk * dk;
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float sl2 = scale * LOG2E;

  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n = (QB * (LDA + LDV) + 2 * QK * (LDA + LDV) + QB * LDS) * 2 / 16;
    for (int e = tid; e < n; e += QNT) z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  load_rows_async(sA, LDA, qu + bh * Tq * dk, q0, QB, Tq, dk, tid, QNT);
  load_rows_async(sA + DKP, LDA, ab + bh * Tq * D, q0, QB, Tq, D, tid, QNT);
  load_rows_async(sO, LDV, dout + bh * Tq * dk, q0, QB, Tq, dk, tid, QNT);
  auto load_keys = [&](int stage, int k0) {
    bf16* b_ = sB + stage * QK * LDA;
    load_rows_async(b_, LDA, kg, k0, QK, Tk, dk, tid, QNT);
    load_rows_async(b_ + DKP, LDA, feats, k0, QK, Tk, D, tid, QNT);
    load_rows_async(sV + stage * QK * LDV, LDV, vg, k0, QK, Tk, dk, tid, QNT);
  };
  // blocks start at different key tiles (see rotated)
  const int n_tiles = (Tk + QK - 1) / QK;
  const int rot = (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) % n_tiles;
  load_keys(0, rotated(0, rot, n_tiles) * QK);
  cp_async_commit();

  // phase 1: warp = 16 rows (rg) x 16 keys (kg) of S, dP, dS
  const int rg = (warp % (QB / 16)) * 16, kg0 = (warp / (QB / 16)) * 16;
  int qi[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + rg + g + 8 * r;
    lse2[r] = qi[r] < Tq ? lse[bh * Tq + qi[r]] * LOG2E : LSE_BIG;
    dl[r] = qi[r] < Tq ? delta[bh * Tq + qi[r]] : 0.f;
  }
  // phase 2: warp owns columns [c0, c0 + 8 NT8) of [dQu | dAB] for the 32
  // rows from rb
  const int c0 = (warp & 7) * NT8 * 8, rb = (warp >> 3) * 32;
  float acc[2][NT8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  // the mask bytes of this thread's 8 scores, loaded one tile ahead
  const bool even = Tk % 2 == 0 && reinterpret_cast<uintptr_t>(mask) % 2 == 0;
  uint32_t mk[2][2], mk_next[2][2];
  auto load_mask = [&](int k0, uint32_t (&m_)[2][2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        m_[r][n] = mask_pair(mg, qi[r], k0 + kg0 + n * 8 + 2 * c4, Tq, Tk, even);
  };
  load_mask(rotated(0, rot, n_tiles) * QK, mk);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = rotated(t, rot, n_tiles) * QK, stage = t & 1;
    if (t + 1 < n_tiles) {
      const int k1 = rotated(t + 1, rot, n_tiles) * QK;
      load_keys(stage ^ 1, k1);
      load_mask(k1, mk_next);
    }
    cp_async_commit();
    cp_async_wait<1>();
    // a tile that the mask hides from every row of the block adds nothing
    bool any = false;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 2; ++n) any |= mk[r][n] != 0u;
    if (__syncthreads_or(any)) {
      const bf16* tB = sB + stage * QK * LDA;
      const bf16* tV = sV + stage * QK * LDV;

      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      {  // fragments of step kk + 16 load while step kk multiplies (KD % 32 == 0)
        uint32_t fx[2][4], fy[2][4];
        auto frags = [&](uint32_t (&f)[2][4], int kk) {
          load_a(f[0], sA, LDA, rg, kk, lane);
          load_b(f[1], tB, LDA, kg0, kk, lane);
        };
        auto step = [&](const uint32_t (&f)[2][4]) {
          mma(s[0], f[0], f[1][0], f[1][1]);
          mma(s[1], f[0], f[1][2], f[1][3]);
        };
        frags(fx, 0);
        for (int kk = 0; kk < KD; kk += 32) {
          frags(fy, kk + 16);
          step(fx);
          if (kk + 32 < KD) frags(fx, kk + 32);
          step(fy);
        }
      }
      for (int kk = 0; kk < DKP; kk += 16) {
        uint32_t a[4], bb[4];
        load_a(a, sO, LDV, rg, kk, lane);
        load_b(bb, tV, LDV, kg0, kk, lane);
        mma(dp[0], a, bb[0], bb[1]);
        mma(dp[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p =
                mask_bit(mk[r][n], e) ? exp2_approx(s[n][2 * r + e] * sl2 - lse2[r]) : 0.f;
            float dpv = dp[n][2 * r + e];
            if (drop)
              dpv = keep_prob(sd, hbh, (uint32_t)qi[r],
                              (uint32_t)(k0 + kg0 + n * 8 + 2 * c4 + e), thr)
                        ? dpv * inv_keep
                        : 0.f;
            ds[e] = p * (dpv - dl[r]) * scale;
          }
          *reinterpret_cast<uint32_t*>(sS + (rg + g + 8 * r) * LDS + kg0 + n * 8 + 2 * c4) =
              pack_bf16(ds[0], ds[1]);
        }
      __syncthreads();

      // phase 2: [dQu | dAB] += dS . [K | F]
#pragma unroll
      for (int kk = 0; kk < QK; kk += 16) {
        uint32_t a0[4], a1[4];
        load_a(a0, sS, LDS, rb, kk, lane);
        load_a(a1, sS, LDS, rb + 16, kk, lane);
#pragma unroll
        for (int n = 0; n < NT8; n += 2) {
          if (n + 1 < NT8) {
            uint32_t bb[4];
            load_bt(bb, tB, LDA, kk, c0 + n * 8, lane);
            mma(acc[0][n], a0, bb[0], bb[1]);
            mma(acc[1][n], a1, bb[0], bb[1]);
            mma(acc[0][n + 1], a0, bb[2], bb[3]);
            mma(acc[1][n + 1], a1, bb[2], bb[3]);
          } else {
            uint32_t bb[2];
            load_bt1(bb, tB, LDA, kk, c0 + n * 8, lane);
            mma(acc[0][n], a0, bb[0], bb[1]);
            mma(acc[1][n], a1, bb[0], bb[1]);
          }
        }
      }
    }
    __syncthreads();   // this stage and dS are rewritten by the next iteration
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 2; ++n) mk[r][n] = mk_next[r][n];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + rb + mt * 16 + g + 8 * r;
      if (i >= Tq) continue;
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + n * 8 + 2 * c4 + e;
          const float x = acc[mt][n][2 * r + e];
          if (c < dk)
            dq[(bh * Tq + i) * dk + c] = x;
          else if (c >= DKP && c < DKP + D)
            dab[(bh * Tq + i) * D + c - DKP] = x;
        }
    }
}

template <int DKP>
__global__ void __launch_bounds__(VNT) rel_flash_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ ab, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ feats,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk_out,
    float* __restrict__ dv_out, int H, int Tq, int Tk, int dk, int D, int KD, float scale,
    int drop, uint32_t thr, int Ht, int Ho, float inv_keep) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDA = KD + 8, LDV = DKP + 8;
  bf16* sKF = reinterpret_cast<bf16*>(smem_raw);  // [VK][LDA]  [K | F]
  bf16* sV = sKF + VK * LDA;                      // [VK][LDV]
  bf16* sQA = sV + VK * LDV;                      // [2][VQ][LDA]  [q+u | AB]
  bf16* sO = sQA + 2 * VQ * LDA;                  // [2][VQ][LDV]  dO
  float* sL = reinterpret_cast<float*>(sO + 2 * VQ * LDV);   // [2][VQ] lse
  float* sD = sL + 2 * VQ;                                    // [2][VQ] delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int k0 = blockIdx.x * VK, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint32_t hbh = (uint32_t)b * (uint32_t)Ht + (uint32_t)(Ho + h);  // keep-mask head
  const bf16* qg = qu + bh * Tq * dk;
  const bf16* abg = ab + bh * Tq * D;
  const bf16* og = dout + bh * Tq * dk;
  const float* lg = lse + bh * Tq;
  const float* dg = delta + bh * Tq;
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float sl2 = scale * LOG2E;

  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n = (VK * (LDA + LDV) + 2 * VQ * (LDA + LDV)) * 2 / 16;
    for (int e = tid; e < n; e += VNT) z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  load_rows_async(sKF, LDA, k + bh * Tk * dk, k0, VK, Tk, dk, tid, VNT);
  load_rows_async(sKF + DKP, LDA, feats, k0, VK, Tk, D, tid, VNT);
  load_rows_async(sV, LDV, v + bh * Tk * dk, k0, VK, Tk, dk, tid, VNT);
  auto load_queries = [&](int stage, int q0) {
    bf16* a_ = sQA + stage * VQ * LDA;
    load_rows_async(a_, LDA, qg, q0, VQ, Tq, dk, tid, VNT);
    load_rows_async(a_ + DKP, LDA, abg, q0, VQ, Tq, D, tid, VNT);
    load_rows_async(sO + stage * VQ * LDV, LDV, og, q0, VQ, Tq, dk, tid, VNT);
    for (int e = tid; e < VQ; e += VNT) {
      const int i = q0 + e;
      const int ic = i < Tq ? i : Tq - 1;
      cp_async<4>(sL + stage * VQ + e, lg + ic, i < Tq);
      cp_async<4>(sD + stage * VQ + e, dg + ic, i < Tq);
    }
  };
  const int n_tiles = (Tq + VQ - 1) / VQ;
  const int rot = (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) % n_tiles;
  load_queries(0, rotated(0, rot, n_tiles) * VQ);
  cp_async_commit();

  constexpr int NO = DKP / 8;
  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const int r0 = warp * 16;        // the warp's keys in the tile
  int kj[2];
  kj[0] = k0 + r0 + g;
  kj[1] = kj[0] + 8;

  // fragment element (r, n, e): key kj[r], query q0 + 8n + 2c4 + e; its
  // mask byte is loaded one tile ahead
  uint32_t mk[2][8], mk_next[2][8];
  auto load_mask = [&](int q0, uint32_t (&m_)[2][8]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = q0 + (c >> 1) * 8 + 2 * c4 + (c & 1);
        m_[r][c] = i < Tq && kj[r] < Tk ? mg[(size_t)i * Tk + kj[r]] : 0u;
      }
  };
  load_mask(rotated(0, rot, n_tiles) * VQ, mk);
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = rotated(t, rot, n_tiles) * VQ, stage = t & 1;
    if (t + 1 < n_tiles) {
      const int q1 = rotated(t + 1, rot, n_tiles) * VQ;
      load_queries(stage ^ 1, q1);
      load_mask(q1, mk_next);
    }
    cp_async_commit();
    cp_async_wait<1>();
    // a tile that the mask hides from every key of the block adds nothing
    bool any = false;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) any |= mk[r][c] != 0u;
    if (__syncthreads_or(any)) {
      const bf16* tA = sQA + stage * VQ * LDA;
      const bf16* tO = sO + stage * VQ * LDV;
      const float* tL = sL + stage * VQ;
      const float* tD = sD + stage * VQ;

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      {  // S^T = [K | F] . [q+u | AB]^T; step kk + 16's fragments load while kk multiplies
        uint32_t fx[3][4], fy[3][4];
        auto frags = [&](uint32_t (&f)[3][4], int kk) {
          load_a(f[0], sKF, LDA, r0, kk, lane);
          load_b(f[1], tA, LDA, 0, kk, lane);
          load_b(f[2], tA, LDA, 16, kk, lane);
        };
        auto step = [&](const uint32_t (&f)[3][4]) {
          mma(st[0], f[0], f[1][0], f[1][1]);
          mma(st[1], f[0], f[1][2], f[1][3]);
          mma(st[2], f[0], f[2][0], f[2][1]);
          mma(st[3], f[0], f[2][2], f[2][3]);
        };
        frags(fx, 0);
        for (int kk = 0; kk < KD; kk += 32) {
          frags(fy, kk + 16);
          step(fx);
          if (kk + 32 < KD) frags(fx, kk + 32);
          step(fy);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DKP; kk += 16) {     // dP^T = V . dO^T
        uint32_t a[4], b0[4], b1[4];
        load_a(a, sV, LDV, r0, kk, lane);
        load_b(b0, tO, LDV, 0, kk, lane);
        load_b(b1, tO, LDV, 16, kk, lane);
        mma(dpt[0], a, b0[0], b0[1]);
        mma(dpt[1], a, b0[2], b0[3]);
        mma(dpt[2], a, b1[0], b1[1]);
        mma(dpt[3], a, b1[2], b1[3]);
      }
      // st becomes pd^T, dpt becomes dS^T
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = n * 8 + 2 * c4 + e;
            const float p =
                mk[r][n * 2 + e] != 0u ? exp2_approx(st[n][2 * r + e] * sl2 - tL[qc] * LOG2E) : 0.f;
            float pd = p, dpv = dpt[n][2 * r + e];
            if (drop) {
              const bool kp = keep_prob(sd, hbh, (uint32_t)(q0 + qc), (uint32_t)kj[r], thr);
              pd = kp ? p * inv_keep : 0.f;
              dpv = kp ? dpv * inv_keep : 0.f;
            }
            st[n][2 * r + e] = pd;
            dpt[n][2 * r + e] = p * (dpv - tD[qc]) * scale;
          }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {           // dV += pd^T dO, dK += dS^T (q+u)
        uint32_t ap[4], as[4];
        acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bo[4], bq[4];
          load_bt(bo, tO, LDV, kk * 16, n * 8, lane);
          load_bt(bq, tA, LDA, kk * 16, n * 8, lane);
          mma(acc_v[n], ap, bo[0], bo[1]);
          mma(acc_v[n + 1], ap, bo[2], bo[3]);
          mma(acc_k[n], as, bq[0], bq[1]);
          mma(acc_k[n + 1], as, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();   // this stage is refilled by the next iteration
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) mk[r][c] = mk_next[r][c];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = kj[r];
    if (j >= Tk) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * c4 + e;
        if (d < dk) {
          dk_out[(bh * Tk + j) * dk + d] = acc_k[n][2 * r + e];
          dv_out[(bh * Tk + j) * dk + d] = acc_v[n][2 * r + e];
        }
      }
  }
}

// ------------------------------------------------------------ wide, bf16
// dk up to 128 and any D (see narrow_width). The score product's depth
// streams as in the forward's wide kernel: the head columns (DKM wide) of
// the block's own rows stay in shared memory, the other side's head
// columns come per tile, and AB F^T's depth goes through a 2-stage ring of
// WCH-column chunks.

// dq, redesigned for Hopper: two launches, and S, dP and dS computed once
// per (query, key) pair. The first design split [dQu | dAB]'s DKM + D
// columns over the grid in groups of 512 and each group's block computed
// S, dP and dS again (three times at d = 1024): 19x its bound, 4.2 ms at
// the 1024-wide training shape (PERF.md).
//   1. rel_flash_bwd_ds_wide_kernel: block = 128 query rows of one (batch,
//      head); a producer warpgroup (one thread) streams TMA boxes of 64
//      depth columns into a 4-stage ring of 32 KB stages, completing on
//      mbarriers; two consumer warpgroups, 64 rows each, take every 128-key
//      tile in turn: S = [q+u | AB] [K | F]^T over the depth DKM + D (q+u
//      and K's chunks, then AB and F's) and dP = dO V^T (DKM), both on
//      wgmma m64n128k16 with float32 accumulators in registers; then dS =
//      p (dP keep / (1 - rate) - delta) scale from the accumulators (the
//      keep-mask hash at the global head, b Ht + Ho + h) is written as bf16
//      to a scratch dS [B, H, Tq, round128(Tk)] (73.5 MB at B=32, T'=374,
//      H=8; zero past Tk and on key tiles the mask hides from all 128 rows,
//      whose products are skipped).
//   2. rel_flash_bwd_dsk_wide_kernel: [dQu | dAB] = dS [K | F], the product
//      JAX's kernel body computes (82.5 GFLOP at that shape): block = 128
//      query rows; per 128-column tile of the output, dS (K-major) and [K |
//      F] (64 keys x 128 columns, MN-major: K's boxes for columns below DKM,
//      F's above) stream through the same kind of ring into wgmma
//      m64n128k16; each tile's epilogue writes its float32 columns while the
//      producer already loads the next tile's stages.
// Each output element is one block's, summed over the depth in a fixed
// order: bitwise repeatable. No limit on D; dk <= 128, multiples of 8 (the
// TMA boxes' strides), operands 16-byte aligned.
// Bound at that shape: the bytes (AB read and dAB written dominate: 0.22
// ms at 3.35 TB/s) over the products (S, dP and the dS product, ~0.18 ms
// at the bf16 tensor rate). The scratch adds dS's write and re-read (0.04
// ms) and kernel 1 re-reads AB's chunks from L2 once per key tile; the
// time (0.72 ms, PERF.md) is about 3x the bound.

namespace wq {

constexpr int THREADS = 384;             // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int REG_PRODUCER = 40, REG_CONSUMER = 232;
constexpr int TQ = 128;                  // query rows of a block
constexpr int TK = 128;                  // keys of a dS tile (kernel 1)
constexpr int TN = 128;                  // output columns of a tile (kernel 2)
constexpr int STAGES = 4;
constexpr uint32_t ATOM = 8192;          // 64 rows x 128 bytes, 128-byte swizzle
constexpr uint32_t HALF = 2 * ATOM;      // a stage's A (128 rows) or B (128 rows / 2 atoms)
constexpr uint32_t STAGE = 2 * HALF;
constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);

// K-major operand descriptor (128-byte swizzle, 8-row groups 1024 B apart)
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) | (kGroup << 16) | (kGroup << 32) |
         (1ull << 62);
}
// MN-major operand: 64-element column blocks `lbo` bytes apart, 8-row
// groups 1024 B apart along K
__device__ __forceinline__ uint64_t desc_mn(uint32_t a, uint32_t lbo) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) | (kGroup << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, float32) = [d +] A (64 x 16) B (16 x 128), bf16; TB: B
// MN-major (1) or K-major (0), A K-major. The accumulator's element (row,
// col) of warp w, lane l: row 16 w + l / 4 (+8 for d[4i+2], d[4i+3]),
// column 8 i + 2 (l % 4) (+1 for d[4i+1], d[4i+3]).
template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// TMA: the box at (c0 inner, c1, c2 outer) of a 3-d `map` into shared memory at dst
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(hopper::saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hopper::saddr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the ring's barriers: full (the producer's copies, by bytes), empty (both
// consumer warpgroups' threads)
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  for (int i = 0; i < STAGES; ++i) {
    hopper::mbar_init(&full[i], 1);
    hopper::mbar_init(&empty[i], CONSUMERS);
  }
  hopper::mbar_fence_init();
}

// producer: wait for stage g's slot and arm its barrier for one stage of bytes
__device__ __forceinline__ unsigned char* claim(unsigned char* ring, uint64_t* full,
                                                uint64_t* empty, int g) {
  const int st = g % STAGES;
  hopper::mbar_wait(&empty[st], ((g / STAGES) & 1) ^ 1);
  hopper::mbar_expect(&full[st], STAGE);
  return ring + st * STAGE;
}

// consumer warpgroup c: acc = (its 64 rows of the stages' A) x (their B)
// over the next n stages of the ring (g counts stages); each stage is
// released once the products that read it are done
template <int TB>
__device__ __forceinline__ void ring_products(float (&acc)[64], int n, unsigned char* ring,
                                              uint64_t* full, uint64_t* empty, int& g, int c) {
  int prev = 0;
  fence_regs(acc);
  hopper::wg_fence();
  for (int i = 0; i < n; ++i, ++g) {
    const int st = g % STAGES;
    hopper::mbar_wait(&full[st], (g / STAGES) & 1);
    const uint32_t a = hopper::saddr(ring + st * STAGE) + c * ATOM;
    const uint32_t b = hopper::saddr(ring + st * STAGE) + HALF;
    if (i > 0) hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n128<TB>(acc, desc(a + kk * 32), TB ? desc_mn(b + kk * 2048, ATOM) : desc(b + kk * 32),
                     (i | kk) != 0);
    hopper::wg_commit();
    if (i > 0) {
      hopper::wg_wait<1>();
      hopper::mbar_arrive(&empty[prev]);
    }
    prev = st;
  }
  hopper::wg_wait0();
  fence_regs(acc);
  hopper::mbar_arrive(&empty[prev]);
}

}  // namespace wq

// dS of 128 query rows of one (batch, head) against every key tile; the
// maps: q+u, AB, dO [B H, Tq, *], K, V [B H, Tk, *] and F [1, Tk, D] in
// boxes of 64 columns x 128 rows
__global__ void __launch_bounds__(wq::THREADS, 1) rel_flash_bwd_ds_wide_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap abmap,
    const __grid_constant__ CUtensorMap omap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap fmap,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ ds,
    int H, int Tq, int Tk, int Tkp, int dkc, int D, float scale, int drop, uint32_t thr, int Ht,
    int Ho, float inv_keep) {
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
  // which key tiles the mask leaves any live pair in, for all 128 rows
  for (int kt = 0; kt < nkt; ++kt) {
    bool any = false;
    for (int e = tid; e < TQ * TK; e += THREADS) {
      const int i = q0 + e / TK, j = kt * TK + e % TK;
      any |= i < Tq && j < Tk && mg[(size_t)i * Tk + j] != 0;
    }
    any = __syncthreads_or(any);
    if (tid == 0) live[kt] = any;
  }
  __syncthreads();

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
  int g = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TK;
    if (!live[kt]) {   // dS = 0 on the whole tile
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (qi[r] < Tq)
#pragma unroll
          for (int i = 0; i < 16; ++i)
            *reinterpret_cast<uint32_t*>(dsg + (size_t)qi[r] * Tkp + k0 + 8 * i + 2 * (lane & 3)) = 0u;
      continue;
    }
    float s[64], dp[64];
    ring_products<0>(s, ns, ring, full, empty, g, c);
    ring_products<0>(dp, dkc, ring, full, empty, g, c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = k0 + 8 * i + 2 * (lane & 3);
        const uint32_t mk = mask_pair(mg, qi[r], j, Tq, Tk, even);
        float dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = mask_bit(mk, e) ? exp2_approx(s[4 * i + 2 * r + e] * sl2 - lse2[r]) : 0.f;
          float dpv = dp[4 * i + 2 * r + e];
          if (drop)
            dpv = keep_prob(sd, hbh, (uint32_t)qi[r], (uint32_t)(j + e), thr) ? dpv * inv_keep
                                                                              : 0.f;
          dsv[e] = p * (dpv - dl[r]) * scale;
        }
        if (qi[r] < Tq)
          *reinterpret_cast<uint32_t*>(dsg + (size_t)qi[r] * Tkp + j) = pack_bf16(dsv[0], dsv[1]);
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
    ring_products<1>(acc, nkc, ring, full, empty, g, c);
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

// dkv: 4 warps own WV_K = 64 keys, each warp 16; K and V stay in shared
// memory while query tiles of WV_Q = 32 rows stream through: per tile q+u,
// dO, lse and delta are loaded, S^T's content term is one product of depth
// DKM and its position term streams F's and AB's chunks through the ring;
// then, as the narrow kernel, dV += pd^T dO and dK += dS^T (q+u) with pd^T
// and dS^T taken from the accumulator registers as bf16 A operands.
constexpr int WV_K = 64;
constexpr int WV_Q = 32;
constexpr int WV_NT = 128;

template <int DKM>
__global__ void __launch_bounds__(WV_NT) rel_flash_bwd_dkv_bf16_wide_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ ab, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ feats,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk_out,
    float* __restrict__ dv_out, int H, int Tq, int Tk, int dk, int D, int unused,
    float scale, int drop, uint32_t thr, int Ht, int Ho, float inv_keep) {
  constexpr int LDH = DKM + 8, NO = DKM / 8, STAGE = (WV_K + WV_Q) * WLDC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [WV_K][LDH]
  bf16* sV = sK + WV_K * LDH;                     // [WV_K][LDH]
  bf16* sQ = sV + WV_K * LDH;                     // [WV_Q][LDH]  q+u of the tile
  bf16* sO = sQ + WV_Q * LDH;                     // [WV_Q][LDH]  dO of the tile
  bf16* sC = sO + WV_Q * LDH;                     // [2][WV_K + WV_Q][WLDC]  F | AB chunks
  float* sL = reinterpret_cast<float*>(sC + 2 * STAGE);   // [WV_Q] lse
  float* sD = sL + WV_Q;                                  // [WV_Q] delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int k0 = blockIdx.x * WV_K, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint32_t hbh = (uint32_t)b * (uint32_t)Ht + (uint32_t)(Ho + h);  // keep-mask head
  const bf16* qg = qu + bh * Tq * dk;
  const bf16* abg = ab + bh * Tq * D;
  const bf16* og = dout + bh * Tq * dk;
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float sl2 = scale * LOG2E;
  const int n_chunks = (D + WCH - 1) / WCH;

  load_tile16(sK, LDH, k + bh * Tk * dk, k0, WV_K, Tk, dk, 0, DKM, tid, WV_NT);
  load_tile16(sV, LDH, v + bh * Tk * dk, k0, WV_K, Tk, dk, 0, DKM, tid, WV_NT);
  cp_async_commit();
  auto load_chunk = [&](int c, int q0) {
    bf16* st = sC + (c & 1) * STAGE;
    load_tile16(st, WLDC, feats, k0, WV_K, Tk, D, c * WCH, WCH, tid, WV_NT);
    load_tile16(st + WV_K * WLDC, WLDC, abg, q0, WV_Q, Tq, D, c * WCH, WCH, tid, WV_NT);
  };
  // st (16 keys from r0 x 32 queries) += A B^T over depth [0, depth)
  auto product = [&](float (&st)[4][4], const bf16* A, const bf16* B, int ld, int depth,
                     int r0) {
#pragma unroll 4
    for (int kk = 0; kk < depth; kk += 16) {
      uint32_t a[4], b0[4], b1[4];
      load_a(a, A, ld, r0, kk, lane);
      load_b(b0, B, ld, 0, kk, lane);
      load_b(b1, B, ld, 16, kk, lane);
      mma(st[0], a, b0[0], b0[1]);
      mma(st[1], a, b0[2], b0[3]);
      mma(st[2], a, b1[0], b1[1]);
      mma(st[3], a, b1[2], b1[3]);
    }
  };

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const int r0 = warp * 16;        // the warp's keys in the tile
  int kj[2];
  kj[0] = k0 + r0 + g;
  kj[1] = kj[0] + 8;

  for (int q0 = 0; q0 < Tq; q0 += WV_Q) {
    // fragment element (r, n, e): key kj[r], query q0 + 8n + 2c4 + e
    uint32_t mk[2][8];
    bool any = false;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = q0 + (c >> 1) * 8 + 2 * c4 + (c & 1);
        mk[r][c] = i < Tq && kj[r] < Tk ? mg[(size_t)i * Tk + kj[r]] : 0u;
        any |= mk[r][c] != 0u;
      }
    // a tile that the mask hides from every key of the block adds nothing;
    // the vote is also the barrier after the last tile's reads
    if (!__syncthreads_or(any)) continue;
    load_tile16(sQ, LDH, qg, q0, WV_Q, Tq, dk, 0, DKM, tid, WV_NT);
    load_tile16(sO, LDH, og, q0, WV_Q, Tq, dk, 0, DKM, tid, WV_NT);
    if (tid < WV_Q) {
      const int i = q0 + tid;
      sL[tid] = i < Tq ? lse[bh * Tq + i] : LSE_BIG;
      sD[tid] = i < Tq ? delta[bh * Tq + i] : 0.f;
    }
    cp_async_commit();
    load_chunk(0, q0);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    product(st, sK, sQ, LDH, DKM, r0);                   // K (q+u)^T
    product(dpt, sV, sO, LDH, DKM, r0);                  // V dO^T
    for (int c = 0; c < n_chunks; ++c) {                 // F AB^T, chunk by chunk
      if (c + 1 < n_chunks) {
        load_chunk(c + 1, q0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* cs = sC + (c & 1) * STAGE;
      product(st, cs, cs + WV_K * WLDC, WLDC, WCH, r0);
      __syncthreads();   // this stage is refilled two chunks on
    }
    // st becomes pd^T, dpt becomes dS^T
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = n * 8 + 2 * c4 + e;
          const float p = mk[r][n * 2 + e] != 0u
                              ? exp2_approx(st[n][2 * r + e] * sl2 - sL[qc] * LOG2E)
                              : 0.f;
          float pd = p, dpv = dpt[n][2 * r + e];
          if (drop) {
            const bool kp = keep_prob(sd, hbh, (uint32_t)(q0 + qc), (uint32_t)kj[r], thr);
            pd = kp ? p * inv_keep : 0.f;
            dpv = kp ? dpv * inv_keep : 0.f;
          }
          st[n][2 * r + e] = pd;
          dpt[n][2 * r + e] = p * (dpv - sD[qc]) * scale;
        }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {           // dV += pd^T dO, dK += dS^T (q+u)
      uint32_t ap[4], as[4];
      acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bo[4], bq[4];
        load_bt(bo, sO, LDH, kk * 16, n * 8, lane);
        load_bt(bq, sQ, LDH, kk * 16, n * 8, lane);
        mma(acc_v[n], ap, bo[0], bo[1]);
        mma(acc_v[n + 1], ap, bo[2], bo[3]);
        mma(acc_k[n], as, bq[0], bq[1]);
        mma(acc_k[n + 1], as, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = kj[r];
    if (j >= Tk) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * c4 + e;
        if (d < dk) {
          dk_out[(bh * Tk + j) * dk + d] = acc_k[n][2 * r + e];
          dv_out[(bh * Tk + j) * dk + d] = acc_v[n][2 * r + e];
        }
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

constexpr size_t wide_dkv_smem(int dkm) {
  return 2 * ((size_t)(2 * WV_K + 2 * WV_Q) * (dkm + 8) + 2 * (size_t)(WV_K + WV_Q) * WLDC) +
         sizeof(float) * 2 * WV_Q;
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
};

// a bf16 kernel: its extra int (narrow dq: round16(dk); narrow dkv: KD;
// wide dq: query tiles; wide dkv: unused) follows D
template <typename K>
cudaError_t run(K kernel, size_t smem, dim3 grid, int threads, const Args& a, int extra) {
  return launch(kernel, smem, grid, threads, a.stream, static_cast<const bf16*>(a.qu),
                static_cast<const bf16*>(a.ab), static_cast<const bf16*>(a.k),
                static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.feats),
                static_cast<const uint8_t*>(a.mask), static_cast<const int*>(a.seed),
                static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
                static_cast<const float*>(a.delta), static_cast<float*>(a.o1),
                static_cast<float*>(a.o2), a.H, a.Tq, a.Tk, a.dk, a.D, extra, a.scale, a.drop,
                a.thr, a.Ht, a.Ho, a.inv_keep);
}

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

// map of a bf16 tensor [depth][rows][cols] (cols and the strides multiples
// of 8 elements), boxes of 64 columns x box_rows rows x 1, 128-byte
// swizzle; a load reads zeros past any end
cudaError_t bf16_map3(CUtensorMap* map, const void* ptr, uint64_t cols, uint64_t rows,
                      uint64_t depth, uint32_t box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = hopper::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  if (cols % 8 != 0 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  cuuint64_t dims[3] = {cols, rows, depth};
  cuuint64_t strides[2] = {cols * sizeof(bf16), cols * rows * sizeof(bf16)};
  cuuint32_t box[3] = {64, box_rows, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the wide bf16 dq: dS into a.scratch [B, H, Tq, round128(Tk)] bf16, then
// [dQu | dAB] = dS [K | F] (see rel_flash_bwd_ds_wide_kernel)
cudaError_t launch_dq_wide(const Args& a) {
  const int dkm = a.dk <= 64 ? 64 : 128, bhn = a.B * a.H;
  const int tkp = round_up(a.Tk, wq::TK), nkt = tkp / wq::TK;
  CUtensorMap qm, abm, om, km, vm, fm, dsm, km2, fm2;
  cudaError_t e = bf16_map3(&qm, a.qu, a.dk, a.Tq, bhn, wq::TQ);
  if (e == cudaSuccess) e = bf16_map3(&abm, a.ab, a.D, a.Tq, bhn, wq::TQ);
  if (e == cudaSuccess) e = bf16_map3(&om, a.dout, a.dk, a.Tq, bhn, wq::TQ);
  if (e == cudaSuccess) e = bf16_map3(&km, a.k, a.dk, a.Tk, bhn, wq::TK);
  if (e == cudaSuccess) e = bf16_map3(&vm, a.v, a.dk, a.Tk, bhn, wq::TK);
  if (e == cudaSuccess) e = bf16_map3(&fm, a.feats, a.D, a.Tk, 1, wq::TK);
  if (e == cudaSuccess) e = bf16_map3(&dsm, a.scratch, tkp, a.Tq, bhn, wq::TQ);
  if (e == cudaSuccess) e = bf16_map3(&km2, a.k, a.dk, a.Tk, bhn, 64);
  if (e == cudaSuccess) e = bf16_map3(&fm2, a.feats, a.D, a.Tk, 1, 64);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Tq + wq::TQ - 1) / wq::TQ, a.H, a.B);
  e = launch(rel_flash_bwd_ds_wide_kernel, wq::SMEM + nkt, grid, wq::THREADS, a.stream, qm, abm,
             om, km, vm, fm, static_cast<const uint8_t*>(a.mask),
             static_cast<const int*>(a.seed), static_cast<const float*>(a.lse),
             static_cast<const float*>(a.delta), static_cast<bf16*>(a.scratch), a.H, a.Tq, a.Tk,
             tkp, dkm / 64, a.D, a.scale, a.drop, a.thr, a.Ht, a.Ho, a.inv_keep);
  if (e != cudaSuccess) return e;
  return launch(rel_flash_bwd_dsk_wide_kernel, wq::SMEM, grid, wq::THREADS, a.stream, dsm, km2,
                fm2, static_cast<float*>(a.o1), static_cast<float*>(a.o2), a.H, a.Tq, tkp, a.dk,
                dkm, a.D);
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
  if (!narrow_width(a.dk, a.D, true)) {
    if (!wide_ok(a) || a.scratch == nullptr) return cudaErrorInvalidValue;
    return launch_dq_wide(a);
  }
  // 64 rows (16 warps) where the block fits shared memory, else 32 (8 warps)
  const int kd = kd_pad(a.dk, a.D), dkp = dk_pad(a.dk);
  const bool rows64 = kd <= 7 * 64 && dq_bf16_smem(a.dk, a.D, 64) <= SMEM_LIMIT;
  const int qb = rows64 ? 64 : 32;
  const dim3 grid((a.Tq + qb - 1) / qb, a.H, a.B);
  const size_t smem = dq_bf16_smem(a.dk, a.D, qb);
  switch (kd / 64) {
#define CASE(N)                                                                            \
  case N:                                                                                  \
    return rows64 ? run(rel_flash_bwd_dq_bf16_kernel<N, 64>, smem, grid, 512, a, dkp)      \
                  : run(rel_flash_bwd_dq_bf16_kernel<N, 32>, smem, grid, 256, a, dkp);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7)
#undef CASE
    case 8: return run(rel_flash_bwd_dq_bf16_kernel<8, 32>, smem, grid, 256, a, dkp);
    case 9: return run(rel_flash_bwd_dq_bf16_kernel<9, 32>, smem, grid, 256, a, dkp);
    default: return cudaErrorInvalidValue;
  }
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
  if (!narrow_width(a.dk, a.D, true)) {
    if (!wide_ok(a)) return cudaErrorInvalidValue;
    const dim3 grid((a.Tk + WV_K - 1) / WV_K, a.H, a.B);
    return a.dk <= 64
               ? run(rel_flash_bwd_dkv_bf16_wide_kernel<64>, wide_dkv_smem(64), grid, WV_NT, a, 0)
               : run(rel_flash_bwd_dkv_bf16_wide_kernel<128>, wide_dkv_smem(128), grid, WV_NT,
                     a, 0);
  }
  const dim3 grid((a.Tk + VK - 1) / VK, a.H, a.B);
  const size_t smem = dkv_bf16_smem(a.dk, a.D);
  const int kd = kd_pad(a.dk, a.D);
  switch (dk_pad(a.dk)) {
#define CASE(P) \
  case P: return run(rel_flash_bwd_dkv_bf16_kernel<P>, smem, grid, VNT, a, kd);
    CASE(16) CASE(32) CASE(48) CASE(64)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Inputs as rel_flash_attention_fwd's (q_u, ab, k, v, feats, mask, seed),
// plus dout [B,H,Tq,dk] in the inputs' dtype and lse, delta float32
// [B,H,Tq]. dq_kernel writes dq [B,H,Tq,dk] and dab [B,H,Tq,D]; dkv_kernel
// writes dk, dv [B,H,Tk,dk]; all float32, contiguous. Widths as the
// forward's: narrow_width or wide_width (dout 16-byte aligned too on bf16's
// wide path). Ht, Ho: the keep-mask's head total and offset, as the
// forward's. scratch: the wide bf16 dq's dS, bf16 [B,H,Tq,round128(Tk)]
// (null elsewhere; dkv_kernel never reads it). Each returns the CUDA error
// code of its launches (0 on success; cudaErrorInvalidValue before any
// launch for widths outside both paths).
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
