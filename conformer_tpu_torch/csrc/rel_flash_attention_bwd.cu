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
//   rel_flash_bwd_dq:  dQu = dS K,   dAB = dS F       (one block per query tile)
//   rel_flash_bwd_dkv: dK = dS^T (q+u),  dV = pd^T dO (one block per key tile)
// with pd = p * keep / (1 - rate). The keep-mask is the hash of
// rel_attention_common.cuh on global (row, column), so it equals the
// forward's element for element. Each output element belongs to one block:
// no atomics, deterministic. Fully masked rows carry lse = 1e30 and give
// p = 0; ragged tails of queries and keys are bounds-checked, not padded.
//
// Bound: at the training shape (B=32, H=4, T=Tk=374, dk=64, D=256) the
// two kernels do 43.5 GFLOP (JAX's recompute in both; 29.8 is the least
// backward work) and move about 140 MB in bf16, so float32 FMAs on the
// CUDA cores (67 TFLOP/s) bound them at ~0.65 ms, memory at ~0.04 ms.
//
// Design (simple and right first). The TPU kernels held a whole sequence in
// VMEM; here shared memory holds float32 tiles:
//  - dq: 256 threads own a 32-row query tile of one (batch, head); Q, AB and
//    dO stay in shared memory while 64-key tiles of K, V and F stream
//    through. dAB is 32 x D, four times as wide as dQ: each thread keeps its
//    2 x 16 slice of it (rows ty+16r, columns tx+16c) and its 2 x 4 slice of
//    dQ in registers, so D <= 256 and dk <= 64. The tile's dS goes through
//    shared memory to feed both products.
//  - dkv: 256 threads own a 64-key tile; K, V and F stay in shared memory
//    while 32-row query tiles of Q, AB, dO, lse and delta stream through.
//    Each thread holds a 4 x 4 slice (keys ty+16r, dims tx+16c) of dK and
//    of dV; pd and dS of the tile pass through shared memory.
// Both use about 160 KB of shared memory, one block per SM. Tensor-core MMA,
// TMA and more blocks per SM are later work.

#include "rel_attention_common.cuh"

namespace {

using namespace rel_attn;

constexpr int NT = 256;
constexpr int DQ_BQ = 32;    // query rows of a dq block
constexpr int DQ_BK = 64;    // key tile streamed by a dq block
constexpr int KV_BK = 64;    // keys of a dkv block
constexpr int KV_BQ = 32;    // query tile streamed by a dkv block

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int row0,
                                          int rows, int n_rows, int width, int tid) {
  for (int e = tid; e < rows * width; e += NT) {
    const int r = e / width, c = e - r * width, i = row0 + r;
    dst[r * ld + c] = i < n_rows ? to_f(src[(size_t)i * width + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) rel_flash_bwd_dq_kernel(
    const T* __restrict__ qu, const T* __restrict__ ab, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ feats,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, float* __restrict__ dab,
    int H, int Tq, int Tk, int dk, int D, float scale, int drop, uint32_t thr,
    float inv_keep) {
  extern __shared__ float smem[];
  const int dkp = dk + 1, Dp = D + 1, BKp = DQ_BK + 1;   // +1: no bank conflicts
  float* sQ = smem;                  // [DQ_BQ][dkp]
  float* sAB = sQ + DQ_BQ * dkp;     // [DQ_BQ][Dp]
  float* sdO = sAB + DQ_BQ * Dp;     // [DQ_BQ][dkp]
  float* sK = sdO + DQ_BQ * dkp;     // [DQ_BK][dkp]
  float* sV = sK + DQ_BK * dkp;      // [DQ_BK][dkp]
  float* sF = sV + DQ_BK * dkp;      // [DQ_BK][Dp]
  float* sDS = sF + DQ_BK * Dp;      // [DQ_BQ][BKp]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * DQ_BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;

  load_rows(sQ, dkp, qu + bh * Tq * dk, q0, DQ_BQ, Tq, dk, tid);
  load_rows(sAB, Dp, ab + bh * Tq * D, q0, DQ_BQ, Tq, D, tid);
  load_rows(sdO, dkp, dout + bh * Tq * dk, q0, DQ_BQ, Tq, dk, tid);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ty + 16 * r;
    row_lse[r] = i < Tq ? lse[bh * Tq + i] : LSE_BIG;
    row_delta[r] = i < Tq ? delta[bh * Tq + i] : 0.f;
  }

  float acc_q[2][4], acc_ab[2][16];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_q[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) acc_ab[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += DQ_BK) {
    load_rows(sK, dkp, k + bh * Tk * dk, k0, DQ_BK, Tk, dk, tid);
    load_rows(sV, dkp, v + bh * Tk * dk, k0, DQ_BK, Tk, dk, tid);
    load_rows(sF, Dp, feats, k0, DQ_BK, Tk, D, tid);
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
    for (int d = 0; d < D; ++d) {    // AB F^T
      float a[2], bb[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) a[r] = sAB[(ty + 16 * r) * Dp + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bb[c] = sF[(tx + 16 * c) * Dp + d];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sb[r][c] = fmaf(a[r], bb[c], sb[r][c]);
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
          dpv = keep_prob(sd, (uint32_t)bh, (uint32_t)i, (uint32_t)j, thr) ? dpv * inv_keep
                                                                          : 0.f;
        sDS[(ty + 16 * r) * BKp + tx + 16 * c] = p * (dpv - row_delta[r]) * scale;
      }
    }
    __syncthreads();

    for (int j = 0; j < DQ_BK; ++j) {   // dQu += dS K, dAB += dS F
      float ds[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) ds[r] = sDS[(ty + 16 * r) * BKp + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = tx + 16 * c;
        const float kk = d < dk ? sK[j * dkp + d] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) acc_q[r][c] = fmaf(ds[r], kk, acc_q[r][c]);
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int d = tx + 16 * c;
        const float ff = d < D ? sF[j * Dp + d] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) acc_ab[r][c] = fmaf(ds[r], ff, acc_ab[r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= Tq) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = tx + 16 * c;
      if (d < dk) dq[(bh * Tq + i) * dk + d] = acc_q[r][c];
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int d = tx + 16 * c;
      if (d < D) dab[(bh * Tq + i) * D + d] = acc_ab[r][c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) rel_flash_bwd_dkv_kernel(
    const T* __restrict__ qu, const T* __restrict__ ab, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ feats,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk_out,
    float* __restrict__ dv_out, int H, int Tq, int Tk, int dk, int D, float scale,
    int drop, uint32_t thr, float inv_keep) {
  extern __shared__ float smem[];
  const int dkp = dk + 1, Dp = D + 1, BKp = KV_BK + 1;
  float* sK = smem;                  // [KV_BK][dkp]
  float* sV = sK + KV_BK * dkp;      // [KV_BK][dkp]
  float* sF = sV + KV_BK * dkp;      // [KV_BK][Dp]
  float* sQ = sF + KV_BK * Dp;       // [KV_BQ][dkp]
  float* sAB = sQ + KV_BQ * dkp;     // [KV_BQ][Dp]
  float* sdO = sAB + KV_BQ * Dp;     // [KV_BQ][dkp]
  float* sPd = sdO + KV_BQ * dkp;    // [KV_BQ][BKp]
  float* sDS = sPd + KV_BQ * BKp;    // [KV_BQ][BKp]
  float* sLse = sDS + KV_BQ * BKp;   // [KV_BQ]
  float* sDelta = sLse + KV_BQ;      // [KV_BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * KV_BK, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;

  load_rows(sK, dkp, k + bh * Tk * dk, k0, KV_BK, Tk, dk, tid);
  load_rows(sV, dkp, v + bh * Tk * dk, k0, KV_BK, Tk, dk, tid);
  load_rows(sF, Dp, feats, k0, KV_BK, Tk, D, tid);

  float acc_k[4][4], acc_v[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += KV_BQ) {
    load_rows(sQ, dkp, qu + bh * Tq * dk, q0, KV_BQ, Tq, dk, tid);
    load_rows(sAB, Dp, ab + bh * Tq * D, q0, KV_BQ, Tq, D, tid);
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
    for (int d = 0; d < D; ++d) {
      float a[2], bb[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) a[r] = sAB[(ty + 16 * r) * Dp + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bb[c] = sF[(tx + 16 * c) * Dp + d];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sb[r][c] = fmaf(a[r], bb[c], sb[r][c]);
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
          const bool kp = keep_prob(sd, (uint32_t)bh, (uint32_t)i, (uint32_t)j, thr);
          pd = kp ? p * inv_keep : 0.f;
          dpv = kp ? dpv * inv_keep : 0.f;
        }
        sPd[qi * BKp + tx + 16 * c] = pd;
        sDS[qi * BKp + tx + 16 * c] = p * (dpv - sDelta[qi]) * scale;
      }
    }
    __syncthreads();

    for (int q = 0; q < KV_BQ; ++q) {   // dV += pd^T dO, dK += dS^T (q+u)
      float pk[4], dsk[4], go[4], qq[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pk[r] = sPd[q * BKp + ty + 16 * r];
        dsk[r] = sDS[q * BKp + ty + 16 * r];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = tx + 16 * c;
        go[c] = d < dk ? sdO[q * dkp + d] : 0.f;
        qq[c] = d < dk ? sQ[q * dkp + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
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
    for (int c = 0; c < 4; ++c) {
      const int d = tx + 16 * c;
      if (d < dk) {
        dk_out[(bh * Tk + j) * dk + d] = acc_k[r][c];
        dv_out[(bh * Tk + j) * dk + d] = acc_v[r][c];
      }
    }
  }
}

size_t dq_smem(int dk, int D) {
  return sizeof(float) * ((size_t)2 * DQ_BQ * (dk + 1) + (size_t)DQ_BQ * (D + 1) +
                          (size_t)2 * DQ_BK * (dk + 1) + (size_t)DQ_BK * (D + 1) +
                          (size_t)DQ_BQ * (DQ_BK + 1));
}

size_t dkv_smem(int dk, int D) {
  return sizeof(float) * ((size_t)2 * KV_BK * (dk + 1) + (size_t)KV_BK * (D + 1) +
                          (size_t)2 * KV_BQ * (dk + 1) + (size_t)KV_BQ * (D + 1) +
                          (size_t)2 * KV_BQ * (KV_BK + 1) + 2 * KV_BQ);
}

template <typename T>
cudaError_t launch_dq(const void* qu, const void* ab, const void* k, const void* v,
                      const void* feats, const void* mask, const void* seed,
                      const void* dout, const void* lse, const void* delta, void* dq,
                      void* dab, cudaStream_t stream, int B, int H, int Tq, int Tk, int dk,
                      int D, float scale, int drop, uint32_t thr, float inv_keep) {
  const size_t smem = dq_smem(dk, D);
  cudaError_t err = cudaFuncSetAttribute(
      rel_flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + DQ_BQ - 1) / DQ_BQ, H, B);
  rel_flash_bwd_dq_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(ab), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(feats),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(seed),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), static_cast<float*>(dab),
      H, Tq, Tk, dk, D, scale, drop, thr, inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* qu, const void* ab, const void* k, const void* v,
                       const void* feats, const void* mask, const void* seed,
                       const void* dout, const void* lse, const void* delta, void* dk_out,
                       void* dv_out, cudaStream_t stream, int B, int H, int Tq, int Tk,
                       int dk, int D, float scale, int drop, uint32_t thr, float inv_keep) {
  const size_t smem = dkv_smem(dk, D);
  cudaError_t err = cudaFuncSetAttribute(
      rel_flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + KV_BK - 1) / KV_BK, H, B);
  rel_flash_bwd_dkv_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(ab), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(feats),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(seed),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk_out),
      static_cast<float*>(dv_out), H, Tq, Tk, dk, D, scale, drop, thr, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// Inputs as rel_flash_attention_fwd's (q_u, ab, k, v, feats, mask, seed),
// plus dout [B,H,Tq,dk] in the inputs' dtype and lse, delta float32
// [B,H,Tq]. dq_kernel writes dq [B,H,Tq,dk] and dab [B,H,Tq,D]; dkv_kernel
// writes dk, dv [B,H,Tk,dk]; all float32, contiguous. dk <= 64, D <= 256.
// Each returns the CUDA error code of its launch (0 on success).
extern "C" int rel_flash_attention_bwd_dq(
    const void* qu, const void* ab, const void* k, const void* v, const void* feats,
    const void* mask, const void* seed, const void* dout, const void* lse,
    const void* delta, void* dq, void* dab, void* stream, int B, int H, int Tq, int Tk,
    int dk, int D, int is_bf16, int drop, int thr_bits, float scale, float inv_keep) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t thr = static_cast<uint32_t>(thr_bits);
  cudaError_t err =
      is_bf16 ? launch_dq<__nv_bfloat16>(qu, ab, k, v, feats, mask, seed, dout, lse, delta,
                                         dq, dab, s, B, H, Tq, Tk, dk, D, scale, drop, thr,
                                         inv_keep)
              : launch_dq<float>(qu, ab, k, v, feats, mask, seed, dout, lse, delta, dq, dab,
                                 s, B, H, Tq, Tk, dk, D, scale, drop, thr, inv_keep);
  return static_cast<int>(err);
}

extern "C" int rel_flash_attention_bwd_dkv(
    const void* qu, const void* ab, const void* k, const void* v, const void* feats,
    const void* mask, const void* seed, const void* dout, const void* lse,
    const void* delta, void* dk_out, void* dv_out, void* stream, int B, int H, int Tq,
    int Tk, int dk, int D, int is_bf16, int drop, int thr_bits, float scale,
    float inv_keep) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t thr = static_cast<uint32_t>(thr_bits);
  cudaError_t err =
      is_bf16 ? launch_dkv<__nv_bfloat16>(qu, ab, k, v, feats, mask, seed, dout, lse, delta,
                                          dk_out, dv_out, s, B, H, Tq, Tk, dk, D, scale,
                                          drop, thr, inv_keep)
              : launch_dkv<float>(qu, ab, k, v, feats, mask, seed, dout, lse, delta, dk_out,
                                  dv_out, s, B, H, Tq, Tk, dk, D, scale, drop, thr,
                                  inv_keep);
  return static_cast<int>(err);
}
