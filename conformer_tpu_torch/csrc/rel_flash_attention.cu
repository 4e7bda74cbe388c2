// Relative-position flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/attention_kernel.py
// (_attn_fwd_kernel, _fwd_impl). Computes per (batch, head)
//
//   out = dropout(softmax(((q+u) K^T + AB F^T) * scale, mask)) V,   lse
//
// where AB [B,H,Tq,D] and F [Tk,D] are the factorised relative-position
// bias (D = d_model, four times dk at Conformer-M). Semantics kept from the
// TPU kernel: masked scores are -1e30; the normaliser and the lse come from
// the un-dropped probabilities, and only the PV sum sees p * keep / (1 -
// rate); a fully masked row gives out = 0, lse = 1e30. The keep-mask is the
// counter hash of rel_attention_common.cuh on global (row, column), seeded
// from a one-element int32 tensor read on the device; at rate 0 the hash is
// not evaluated and the result is that of the kernel without dropout. The
// backward is rel_flash_attention_bwd.cu.
//
// Bound: at the decode shape (B=48, H=4, T=374, dk=64, D=256, bf16) the
// inputs and outputs move about 81 MB (AB alone 37 MB) and the three
// products need about 20.6 GFLOP, so the card's memory rate bounds it
// (~24 us at 3.35 TB/s) only just above its bf16 tensor rate (~21 us).
//
// Design (simple and right first): the TPU kernel kept a whole 384-row
// sequence in VMEM; here one block of 256 threads owns a 64-row query tile
// of one (batch, head), keeps Q and AB in shared memory as float32, and
// streams 64-key tiles of K, V and F through shared memory with an online
// softmax. Each thread owns a 4x4 register tile of the scores (rows
// ty+16r, keys tx+16c) and of the output (rows ty+16r, dims tx+16c), so
// dk <= 64. Products are float32 FMAs on the CUDA cores; the ragged tail
// of queries and keys is masked in the block instead of padded copies.
// Tensor-core MMA, TMA and warp specialisation are later work.

#include "rel_attention_common.cuh"

namespace {

using namespace rel_attn;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

// reduce over the 16 lanes that share a query row (one half-warp)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(NT) rel_flash_fwd_kernel(
    const T* __restrict__ qu, const T* __restrict__ ab, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ feats,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed, T* __restrict__ out,
    float* __restrict__ lse, int H, int Tq, int Tk, int dk, int D, float scale, int drop,
    uint32_t thr, float inv_keep) {
  extern __shared__ float smem[];
  const int dkp = dk + 1, Dp = D + 1, BKp = BK + 1;  // +1: no bank conflicts
  float* sQ = smem;               // [BQ][dkp]
  float* sAB = sQ + BQ * dkp;     // [BQ][Dp]
  float* sK = sAB + BQ * Dp;      // [BK][dkp]
  float* sV = sK + BK * dkp;      // [BK][dkp]
  float* sF = sV + BK * dkp;      // [BK][Dp]
  float* sP = sF + BK * Dp;       // [BQ][BKp]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* qg = qu + bh * Tq * dk;
  const T* abg = ab + bh * Tq * D;
  const T* kg = k + bh * Tk * dk;
  const T* vg = v + bh * Tk * dk;
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;

  for (int e = tid; e < BQ * dk; e += NT) {
    const int r = e / dk, c = e - r * dk, i = q0 + r;
    sQ[r * dkp + c] = i < Tq ? to_f(qg[(size_t)i * dk + c]) : 0.f;
  }
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e - r * D, i = q0 + r;
    sAB[r * Dp + c] = i < Tq ? to_f(abg[(size_t)i * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    for (int e = tid; e < BK * dk; e += NT) {
      const int r = e / dk, c = e - r * dk, j = k0 + r;
      const bool ok = j < Tk;
      sK[r * dkp + c] = ok ? to_f(kg[(size_t)j * dk + c]) : 0.f;
      sV[r * dkp + c] = ok ? to_f(vg[(size_t)j * dk + c]) : 0.f;
    }
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e - r * D, j = k0 + r;
      sF[r * Dp + c] = j < Tk ? to_f(feats[(size_t)j * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < dk; ++d) {  // content term (q+u) K^T
      float a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sQ[(ty + 16 * r) * dkp + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bb[c] = sK[(tx + 16 * c) * dkp + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bb[c], s[r][c]);
    }
    float sb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sb[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {  // position term AB F^T
      float a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sAB[(ty + 16 * r) * Dp + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bb[c] = sF[(tx + 16 * c) * Dp + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sb[r][c] = fmaf(a[r], bb[c], sb[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        ok[c] = i < Tq && j < Tk && mg[(size_t)i * Tk + j] != 0;
        s[r][c] = ok[c] ? (s[r][c] + sb[r][c]) * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max16(mx));
      // rows with every score masked so far: exp(m - m_new) would be 1
      const float corr = m[r] > 0.5f * NEG_INF ? expf(m[r] - m_new) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        rs += p;
        float pd = p;
        if (drop)
          pd = keep_prob(sd, (uint32_t)bh, (uint32_t)i, (uint32_t)(k0 + tx + 16 * c), thr)
                   ? p * inv_keep
                   : 0.f;
        sP[(ty + 16 * r) * BKp + tx + 16 * c] = pd;
      }
      l[r] = l[r] * corr + row_sum16(rs);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {  // acc += P V
      float p[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = sP[(ty + 16 * r) * BKp + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < dk ? sV[j * dkp + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= Tq) continue;
    const bool live = l[r] > 0.f;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = tx + 16 * c;
      if (d < dk) out[(bh * Tq + i) * dk + d] = from_f<T>(live ? acc[r][c] * inv : 0.f);
    }
    if (tx == 0) lse[bh * Tq + i] = live ? m[r] + logf(fmaxf(l[r], 1e-30f)) : LSE_BIG;
  }
}

template <typename T>
cudaError_t launch(const void* qu, const void* ab, const void* k, const void* v,
                   const void* feats, const void* mask, const void* seed, void* out,
                   void* lse, cudaStream_t stream, int B, int H, int Tq, int Tk, int dk,
                   int D, float scale, int drop, uint32_t thr, float inv_keep) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * (dk + 1) + (size_t)BQ * (D + 1) +
                       2 * (size_t)BK * (dk + 1) + (size_t)BK * (D + 1) +
                       (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      rel_flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  rel_flash_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(ab), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(feats),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(seed), static_cast<T*>(out),
      static_cast<float*>(lse), H, Tq, Tk, dk, D, scale, drop, thr, inv_keep);
  return cudaGetLastError();
}

}  // namespace

// q_u, k, v [B,H,Tq|Tk,dk]; ab [B,H,Tq,D]; feats [Tk,D]; mask uint8 [B,Tq,Tk];
// seed int32 [1] (read only when drop != 0; may be null otherwise);
// out [B,H,Tq,dk] (input dtype); lse float32 [B,H,Tq]. All contiguous.
// thr_bits is the uint32 keep threshold's bit pattern, inv_keep 1/(1-rate).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int rel_flash_attention_fwd(const void* qu, const void* ab, const void* k,
                                       const void* v, const void* feats,
                                       const void* mask, const void* seed, void* out,
                                       void* lse, void* stream, int B, int H, int Tq,
                                       int Tk, int dk, int D, int is_bf16, int drop,
                                       int thr_bits, float scale, float inv_keep) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t thr = static_cast<uint32_t>(thr_bits);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(qu, ab, k, v, feats, mask, seed, out, lse, s, B, H,
                                      Tq, Tk, dk, D, scale, drop, thr, inv_keep)
              : launch<float>(qu, ab, k, v, feats, mask, seed, out, lse, s, B, H, Tq, Tk,
                              dk, D, scale, drop, thr, inv_keep);
  return static_cast<int>(err);
}
