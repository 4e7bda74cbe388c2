// Relative-position flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/attention_kernel.py
// (_attn_fwd_kernel, _fwd_impl). Computes per (batch, head)
//
//   out = dropout(softmax(((q+u) K^T + AB F^T) * scale, mask)) V,   lse
//
// where AB [B,H,Tq,D] and F [Tk,D] are the factorised relative-position
// bias (D = d_model: four times dk at Conformer-M, eight at L). Semantics
// kept from the TPU kernel: masked scores are -1e30; the normaliser and the
// lse come from the un-dropped probabilities, and only the PV sum sees p *
// keep / (1 - rate); a fully masked row gives out = 0, lse = 1e30. The
// keep-mask is the counter hash of rel_attention_common.cuh on global (row,
// column), seeded from a one-element int32 tensor read on the device; at
// rate 0 the hash is not evaluated. The backward is
// rel_flash_attention_bwd.cu.
//
// Bound: at the training shape (B=32, H=4, T=374, dk=64, D=256, bf16) the
// inputs and outputs move about 54 MB (AB alone 24.5 MB) and the products
// need about 13.7 GFLOP on the tensor cores, so the card's memory rate
// bounds it (~16 us at 3.35 TB/s), just above its bf16 tensor rate (~14
// us).
//
// Two routes by width (wide_width, narrow_width of
// rel_attention_common.cuh; PERF.md has each one's times):
//  - wide (dk up to 128, any D; in bf16 dk and D multiples of 8):
//    rel_flash_fwd_wide_kernel, every bf16 width it takes (Conformer-M, -L
//    and the 1024-wide Conformer; a variant that kept [q+u | AB] in shared
//    memory for the whole block measured no faster at M and L), and the
//    float32 design at OC = 8, DCM = 128;
//  - narrow (bf16 widths that are no multiples of 8, such as Conformer-S's
//    dk 36, whose 72-byte rows TMA cannot stride; float32 D <= 512): the
//    mma.sync and float32 designs next.
//
// narrow bf16 design, on the tensor cores with mma.sync:
//  - The two score terms are one product of depth KD = dk + D (rounded up
//    to 64): s = [q+u | AB] . [K | F]^T, bf16 operands, float32
//    accumulators; dk = 36 (Conformer-S) is zero-padded to 48.
//  - A block of NW warps owns 16 NW query rows of one (batch, head), each
//    warp 16 rows; the [q+u | AB] tile stays in shared memory, and key
//    tiles of 8 NW keys of [K | F] and V stream through a 2-stage ring
//    filled by cp.async (16-byte copies where the widths allow, zero-fill
//    past the ragged tail), so the next tile's copy overlaps the current
//    tile's products. NW = 8 where the block fits shared memory (Conformer-
//    M: 182 KB, S: 114 KB), else 4 (L, D=512: 155 KB); one block per SM.
//  - mma.sync.m16n8k16 with ldmatrix from rows padded by 16 bytes (no bank
//    conflicts); the next 16-deep step's fragments load while the current
//    step multiplies. The online softmax runs on the accumulator fragment
//    (quad shuffles for the row max), dropout per fragment element by its
//    global (row, column), and P goes to the P.V product as a bf16 A
//    operand straight from the accumulator registers, never through
//    shared memory. The mask bytes of a tile are loaded one tile ahead.
//  - F [Tk, D] is the same for every block; each block starts at another
//    key tile (rotated), so that the blocks do not all read the same rows
//    of F from L2 at once.
//  - A key tile that the mask hides from every row of the block is skipped
//    (a vote at the barrier the tile needs anyway): the result is the same,
//    since such a tile adds nothing. Padded keys past a row's length cost
//    nothing then. exp2 runs on the special-function unit alone
//    (ex2.approx, subnormals kept, so that no probability flushes to 0).
//
// float32 design (the parity path): one block of 256 threads owns a 64-row
// query tile, keeps Q in shared memory as float32, and streams 64-key tiles
// of K, V and F with an online softmax; each thread owns a 4x4 register
// tile of the scores and a 4 x OC tile of the output (dk <= 16 OC), and
// products are float32 FMAs on the CUDA cores. The position term's depth D
// streams in chunks of DCM columns of AB and F: at D <= DCM (one chunk) AB
// stays in shared memory for the whole block and F comes with each key
// tile, as one product; above (Conformer-L, D = 512: 198 KB) each key tile
// loads the chunks of AB and F in turn. The sums over d run in the same
// order either way. Narrow widths take OC = 4, DCM = 256; wide ones OC = 8,
// DCM = 128 (182 KB at dk = 128), so no D is refused.
//
// The wide path takes dk up to 128 and any D (Conformer XL / XXL,
// FastConformer-XL: d = 1024, 8 heads of 128), where the bf16 tile
// [q+u | AB] of KD = 1152 would need 314 KB at 4 warps, and in bf16 every
// width whose dk and D are multiples of 8 (Conformer-M and -L). Its
// float32 kernel is the one above at OC = 8, DCM = 128. Its bf16 kernel
// (rel_flash_fwd_wide_kernel, below) runs on wgmma fed by TMA through an
// mbarrier ring: 128 query rows a block, the score product's depth DKM + D
// streamed in 64-column boxes of [q+u | AB] and [K | F], 128-key tiles,
// P V with P from registers (129 KB of shared memory at any D, one block
// an SM). The ring keeps the tensor cores fed without a barrier per chunk,
// and 128-key tiles read AB's chunks from L2 half as often as the first
// design's 64-key tiles on mma.sync did (PERF.md).
// Bound at the 1024-wide training shape (B=32, H=8, T=374, dk=128, D=1024,
// bf16): the 300 MB the inputs and outputs move (~90 us at 3.35 TB/s)
// against ~92 GFLOP of products with every pair live (~93 us at the bf16
// tensor rate; fewer on padded keys). What limits it is the ring's
// traffic from L2: AB's rows are read once per 128-key tile (three times
// at T=374), F's once per 128-row block, ~1.4 GB in all.

#include "rel_attention_hopper.cuh"

namespace {

using namespace rel_attn;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int F32_DC = 256;   // columns of AB and F per chunk of the float32 kernel

// rows [row0, row0 + rows) and columns [c0, c0 + dc) of src [n_rows][width]
// into dst (row stride ld); rows at or past n_rows are zero
__device__ __forceinline__ void load_cols(float* dst, int ld, const float* src, int row0,
                                          int rows, int n_rows, int width, int c0, int dc) {
  for (int e = threadIdx.x; e < rows * dc; e += NT) {
    const int r = e / dc, c = e - r * dc, i = row0 + r;
    dst[r * ld + c] = i < n_rows ? src[(size_t)i * width + c0 + c] : 0.f;
  }
}

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

// OC output columns a thread (tx + 16 c, c < OC: dk <= 16 OC); AB and F's
// columns in chunks of DCM
template <int OC, int DCM>
__global__ void __launch_bounds__(NT) rel_flash_fwd_f32_kernel(
    const float* __restrict__ qu, const float* __restrict__ ab, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ feats,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed, float* __restrict__ out,
    float* __restrict__ lse, int H, int Tq, int Tk, int dk, int D, float scale, int drop,
    uint32_t thr, int Ht, int Ho, float inv_keep) {
  extern __shared__ float smem[];
  const int DC = min(D, DCM), DCp = DC + 1, dkp = dk + 1, BKp = BK + 1;  // +1: no bank conflicts
  const bool one_chunk = D <= DCM;
  float* sQ = smem;               // [BQ][dkp]
  float* sAB = sQ + BQ * dkp;     // [BQ][DCp]  a chunk of AB's columns
  float* sK = sAB + BQ * DCp;     // [BK][dkp]
  float* sV = sK + BK * dkp;      // [BK][dkp]
  float* sF = sV + BK * dkp;      // [BK][DCp]  the same chunk of F's columns
  float* sP = sF + BK * DCp;      // [BQ][BKp]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint32_t hbh = (uint32_t)b * (uint32_t)Ht + (uint32_t)(Ho + h);  // keep-mask head
  const float* qg = qu + bh * Tq * dk;
  const float* abg = ab + bh * Tq * D;
  const float* kg = k + bh * Tk * dk;
  const float* vg = v + bh * Tk * dk;
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;

  load_cols(sQ, dkp, qg, q0, BQ, Tq, dk, 0, dk);
  if (one_chunk) load_cols(sAB, DCp, abg, q0, BQ, Tq, D, 0, D);

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    for (int e = tid; e < BK * dk; e += NT) {
      const int r = e / dk, c = e - r * dk, j = k0 + r;
      const bool ok = j < Tk;
      sK[r * dkp + c] = ok ? kg[(size_t)j * dk + c] : 0.f;
      sV[r * dkp + c] = ok ? vg[(size_t)j * dk + c] : 0.f;
    }
    if (one_chunk) load_cols(sF, DCp, feats, k0, BK, Tk, D, 0, D);
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
    for (int c0 = 0; c0 < D; c0 += DC) {  // position term AB F^T, chunk by chunk
      const int dc = min(DC, D - c0);
      if (!one_chunk) {
        __syncthreads();
        load_cols(sAB, DCp, abg, q0, BQ, Tq, D, c0, dc);
        load_cols(sF, DCp, feats, k0, BK, Tk, D, c0, dc);
        __syncthreads();
      }
      for (int d = 0; d < dc; ++d) {
        float a[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = sAB[(ty + 16 * r) * DCp + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = sF[(tx + 16 * c) * DCp + d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sb[r][c] = fmaf(a[r], bb[c], sb[r][c]);
      }
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
          pd = keep_prob(sd, hbh, (uint32_t)i, (uint32_t)(k0 + tx + 16 * c), thr)
                   ? p * inv_keep
                   : 0.f;
        sP[(ty + 16 * r) * BKp + tx + 16 * c] = pd;
      }
      l[r] = l[r] * corr + row_sum16(rs);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {  // acc += P V
      float p[4], vv[OC];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = sP[(ty + 16 * r) * BKp + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < dk ? sV[j * dkp + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
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
    for (int c = 0; c < OC; ++c) {
      const int d = tx + 16 * c;
      if (d < dk) out[(bh * Tq + i) * dk + d] = live ? acc[r][c] * inv : 0.f;
    }
    if (tx == 0) lse[bh * Tq + i] = live ? m[r] + logf(fmaxf(l[r], 1e-30f)) : LSE_BIG;
  }
}

// NW warps own MQ = 16 NW query rows and stream key tiles of MK = 8 NW
// keys; DKP = dk rounded up to 16
template <int DKP, int NW>
__global__ void __launch_bounds__(NW * 32) rel_flash_fwd_bf16_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ ab, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ feats,
    const uint8_t* __restrict__ mask, const int* __restrict__ seed, bf16* __restrict__ out,
    float* __restrict__ lse, int H, int Tq, int Tk, int dk, int D, int KD, float scale,
    int drop, uint32_t thr, int Ht, int Ho, float inv_keep) {
  constexpr int MQ = 16 * NW, MK = 8 * NW, MNT = 32 * NW;
  constexpr int NKT = MK / 8;   // 8-key tiles of a warp's scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDA = KD + 8, LDV = DKP + 8;
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);        // [MQ][LDA]  [q+u | AB]
  bf16* sB = sA + MQ * LDA;                            // [2][MK][LDA]  [K | F]
  bf16* sV = sB + 2 * MK * LDA;                        // [2][MK][LDV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int q0 = blockIdx.x * MQ, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint32_t hbh = (uint32_t)b * (uint32_t)Ht + (uint32_t)(Ho + h);  // keep-mask head
  const bf16* qg = qu + bh * Tq * dk;
  const bf16* abg = ab + bh * Tq * D;
  const bf16* kg = k + bh * Tk * dk;
  const bf16* vg = v + bh * Tk * dk;
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float sl2 = scale * LOG2E;

  // zero everything once: the padding columns are never copied into
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n = (MQ * LDA + 2 * MK * (LDA + LDV)) * 2 / 16;
    for (int e = tid; e < n; e += MNT) z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  load_rows_async(sA, LDA, qg, q0, MQ, Tq, dk, tid, MNT);
  load_rows_async(sA + DKP, LDA, abg, q0, MQ, Tq, D, tid, MNT);
  auto load_keys = [&](int stage, int k0) {
    bf16* b_ = sB + stage * MK * LDA;
    load_rows_async(b_, LDA, kg, k0, MK, Tk, dk, tid, MNT);
    load_rows_async(b_ + DKP, LDA, feats, k0, MK, Tk, D, tid, MNT);
    load_rows_async(sV + stage * MK * LDV, LDV, vg, k0, MK, Tk, dk, tid, MNT);
  };
  // blocks start at different key tiles (see rotated)
  const int n_tiles = (Tk + MK - 1) / MK;
  const int rot = (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) % n_tiles;
  load_keys(0, rotated(0, rot, n_tiles) * MK);
  cp_async_commit();

  constexpr int NO = DKP / 8;   // 8-column tiles of the output
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // m in log2 units
  const int r0 = warp * 16;                              // the warp's rows in the tile
  int qi[2];
  qi[0] = q0 + r0 + g;
  qi[1] = qi[0] + 8;

  // the mask bytes of this thread's 4 NKT scores, loaded one tile ahead
  const bool even = Tk % 2 == 0 && reinterpret_cast<uintptr_t>(mask) % 2 == 0;
  uint32_t mk[2][NKT], mk_next[2][NKT];
  auto load_mask = [&](int k0, uint32_t (&m_)[2][NKT]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < NKT; ++n)
        m_[r][n] = mask_pair(mg, qi[r], k0 + n * 8 + 2 * c4, Tq, Tk, even);
  };
  load_mask(rotated(0, rot, n_tiles) * MK, mk);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = rotated(t, rot, n_tiles) * MK, stage = t & 1;
    if (t + 1 < n_tiles) {
      const int k1 = rotated(t + 1, rot, n_tiles) * MK;
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
      for (int n = 0; n < NKT; ++n) any |= mk[r][n] != 0u;
    if (__syncthreads_or(any)) {
      const bf16* tB = sB + stage * MK * LDA;
      const bf16* tV = sV + stage * MK * LDV;
      float s[NKT][4];
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      // fragments of step kk + 16 load while step kk multiplies (KD % 32 == 0):
      // f[0] of [q+u | AB], f[1 + j] of keys 16 j .. 16 j + 15 of [K | F]
      uint32_t fx[1 + NKT / 2][4], fy[1 + NKT / 2][4];
      auto frags = [&](uint32_t (&f)[1 + NKT / 2][4], int kk) {
        load_a(f[0], sA, LDA, r0, kk, lane);
#pragma unroll
        for (int j = 0; j < NKT / 2; ++j) load_b(f[1 + j], tB, LDA, 16 * j, kk, lane);
      };
      auto step = [&](const uint32_t (&f)[1 + NKT / 2][4]) {
#pragma unroll
        for (int j = 0; j < NKT / 2; ++j) {
          mma(s[2 * j], f[0], f[1 + j][0], f[1 + j][1]);
          mma(s[2 * j + 1], f[0], f[1 + j][2], f[1 + j][3]);
        }
      };
      frags(fx, 0);
      for (int kk = 0; kk < KD; kk += 32) {
        frags(fy, kk + 16);
        step(fx);
        if (kk + 32 < KD) frags(fx, kk + 32);
        step(fy);
      }

      // online softmax on the fragment: rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < NKT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[n][2 * r + e];
            x = mask_bit(mk[r][n], e) ? x * sl2 : NEG_INF;
            mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m[r], quad_max(mx));
        // rows with every score masked so far: exp2(m - m_new) would be 1
        const float corr = m[r] > 0.5f * NEG_INF ? exp2_approx(m[r] - m_new) : 0.f;
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < NKT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[n][2 * r + e];
            const float p = x > 0.5f * NEG_INF ? exp2_approx(x - m_new) : 0.f;
            rs += p;
            x = p;
            if (drop)
              x = keep_prob(sd, hbh, (uint32_t)qi[r],
                            (uint32_t)(k0 + n * 8 + 2 * c4 + e), thr)
                      ? p * inv_keep
                      : 0.f;
          }
        l[r] = l[r] * corr + rs;      // this lane's share; the quad's sum at the end
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][2 * r] *= corr;
          o[n][2 * r + 1] *= corr;
        }
      }

      // o += P V: P from the accumulators as bf16, V by transposing loads
#pragma unroll
      for (int kk = 0; kk < NKT / 2; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bv[4];
          load_bt(bv, tV, LDV, kk * 16, n * 8, lane);
          mma(o[n], a, bv[0], bv[1]);
          mma(o[n + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // this stage is refilled by the next iteration
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < NKT; ++n) mk[r][n] = mk_next[r][n];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    const int i = qi[r];
    if (i >= Tq) continue;
    const bool live = lt > 0.f;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    bf16* orow = out + (bh * Tq + i) * dk;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * c4 + e;
        if (d < dk) orow[d] = __float2bfloat16(live ? o[n][2 * r + e] * inv : 0.f);
      }
    if (c4 == 0) lse[bh * Tq + i] = live ? m[r] * LN2 + logf(fmaxf(lt, 1e-30f)) : LSE_BIG;
  }
}

// The wide bf16 path (dk up to 128, any D, multiples of 8; see
// wide_width), on wgmma fed by TMA (rel_attention_hopper.cuh). A block
// owns TQ = 128 query rows of one (batch, head): one producer thread streams TMA boxes of 64 depth
// columns into a 4-stage ring of 32 KB stages; two consumer warpgroups
// take 64 rows each. Per live 128-key tile:
//  - S = [q+u | AB] [K | F]^T over the depth DKM + D (q+u and K's chunks,
//    then AB and F's), wgmma m64n128k16 from the ring, float32
//    accumulators (64 a thread);
//  - the online softmax on the accumulator fragment (quad shuffles for the
//    row max), the mask bytes loaded before the products, dropout by the
//    keep-mask hash at the global head b Ht + Ho + h;
//  - O += P V on wgmma m64nDKMk16 with P as bf16 A fragments straight from
//    the accumulator registers and V's 128 keys (one stage: DKM / 64 boxes
//    of 128 keys x 64 columns) as an MN-major B.
// Key tiles the mask hides from all 128 rows are skipped (a vote over the
// tile's mask bytes before the roles split), and a consumer warpgroup whose
// 64 rows all lie past Tq issues no products (the chunk shape, Tq = 16):
// the ring's empty barriers count only the working warpgroups.
template <int DKM>
__global__ void __launch_bounds__(wq::THREADS, 1) rel_flash_fwd_wide_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap abmap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap fmap, const uint8_t* __restrict__ mask,
    const int* __restrict__ seed, bf16* __restrict__ out, float* __restrict__ lse, int H,
    int Tq, int Tk, int dk, int D, float scale, int drop, uint32_t thr, int Ht, int Ho,
    float inv_keep) {
  using namespace wq;
  constexpr int DKC = DKM / 64;              // 64-column chunks of the head width
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  uint8_t* live = reinterpret_cast<uint8_t*>(empty + STAGES);   // [nkt]: a live pair in the tile
  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int nkt = (Tk + TK - 1) / TK, ns = DKC + (D + 63) / 64;
  const int nc = Tq - q0 > 64 ? 2 : 1;       // consumer warpgroups with a row below Tq
  const uint8_t* mg = mask + (size_t)b * Tq * Tk;
  if (tid == 0) init_ring(full, empty, nc);
  live_tiles(live, mg, q0, Tq, Tk, nkt);

  if (wg == 0) {
    hopper::setmaxnreg_dec<REG_PRODUCER>();
    if (tid == 0) {
      int g = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        if (!live[kt]) continue;
        const int k0 = kt * TK;
        for (int d = 0; d < ns; ++d, ++g) {   // S's depth chunks
          unsigned char* dst = claim(ring, full, empty, g);
          uint64_t* bar = &full[g % STAGES];
          if (d < DKC) {
            tma_load3(dst, &qmap, bar, 64 * d, q0, bh);
            tma_load3(dst + HALF, &kmap, bar, 64 * d, k0, bh);
          } else {
            tma_load3(dst, &abmap, bar, 64 * (d - DKC), q0, bh);
            tma_load3(dst + HALF, &fmap, bar, 64 * (d - DKC), k0, 0);
          }
        }
        unsigned char* dst = claim(ring, full, empty, g, DKC * HALF);   // V
#pragma unroll
        for (int j = 0; j < DKC; ++j)
          tma_load3(dst + j * HALF, &vmap, &full[g % STAGES], 64 * j, k0, bh);
        ++g;
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<REG_CONSUMER>();
  const int c = wg - 1;
  if (c >= nc) return;   // all 64 rows past Tq: no products, nothing to write
  const int warp = (tid >> 5) & 3, lane = tid & 31, c4 = lane & 3;
  const int r0 = 64 * c + 16 * warp + (lane >> 2);   // this thread's rows r0, r0 + 8
  const uint32_t hbh = (uint32_t)b * (uint32_t)Ht + (uint32_t)(Ho + h);   // keep-mask head
  const uint32_t sd = drop ? (uint32_t)seed[0] : 0u;
  const float sl2 = scale * LOG2E;
  const bool even = Tk % 2 == 0 && reinterpret_cast<uintptr_t>(mask) % 2 == 0;
  int qi[2];
  qi[0] = q0 + r0;
  qi[1] = qi[0] + 8;
  float o[DKM / 2];
#pragma unroll
  for (int i = 0; i < DKM / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // m in log2 units
  int g = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    if (!live[kt]) continue;
    const int k0 = kt * TK;
    // element (r, 4 i + 2 r + e) of the fragment: row qi[r], key k0 + 8 i + 2 c4 + e
    uint32_t mk[2][16];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 16; ++i)
        mk[r][i] = mask_pair(mg, qi[r], k0 + 8 * i + 2 * c4, Tq, Tk, even);
    float s[64];
    ring_products<128, 0, 0>(s, ns, ring, full, empty, g, c);

    // online softmax on the fragment: rows qi[0] (r = 0) and qi[1] (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * i + 2 * r + e];
          x = mask_bit(mk[r][i], e) ? x * sl2 : NEG_INF;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[r], quad_max(mx));
      // rows with every score masked so far: exp2(m - m_new) would be 1
      const float corr = m[r] > 0.5f * NEG_INF ? exp2_approx(m[r] - m_new) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * i + 2 * r + e];
          const float p = x > 0.5f * NEG_INF ? exp2_approx(x - m_new) : 0.f;
          rs += p;
          x = p;
          if (drop)
            x = keep_prob(sd, hbh, (uint32_t)qi[r], (uint32_t)(k0 + 8 * i + 2 * c4 + e), thr)
                    ? p * inv_keep
                    : 0.f;
        }
      l[r] = l[r] * corr + rs;      // this lane's share; the quad's sum at the end
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < DKM / 8; ++n) {
        o[4 * n + 2 * r] *= corr;
        o[4 * n + 2 * r + 1] *= corr;
      }
    }

    // O += P V: P's 16-key steps as bf16 A fragments (acc_to_a's packing)
    uint32_t pa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    const uint32_t sv = await_stage(ring, full, g);
    fence_regs(o);
    fence_regs(pa);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs<DKM, 1>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                       desc_mn(sv + kk * 2048, HALF), 1);
    hopper::wg_commit();
    hopper::wg_wait0();
    fence_regs(o);
    fence_regs(pa);
    hopper::mbar_arrive(&empty[g % STAGES]);
    ++g;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    const int i = qi[r];
    if (i >= Tq) continue;
    const bool live_row = lt > 0.f;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    bf16* orow = out + ((size_t)bh * Tq + i) * dk;
#pragma unroll
    for (int n = 0; n < DKM / 8; ++n) {
      const int col = 8 * n + 2 * c4;   // dk: a multiple of 8
      if (col < dk)
        *reinterpret_cast<uint32_t*>(orow + col) =
            live_row ? pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv) : 0u;
    }
    if (c4 == 0)
      lse[(size_t)bh * Tq + i] = live_row ? m[r] * LN2 + logf(fmaxf(lt, 1e-30f)) : LSE_BIG;
  }
}

template <int OC, int DCM>
cudaError_t launch_f32_oc(const void* qu, const void* ab, const void* k, const void* v,
                          const void* feats, const void* mask, const void* seed, void* out,
                          void* lse, cudaStream_t stream, int B, int H, int Tq, int Tk, int dk,
                          int D, float scale, int drop, uint32_t thr, int Ht, int Ho,
                          float inv_keep) {
  const size_t dcp = (size_t)min(D, DCM) + 1;
  const size_t smem = sizeof(float) * ((size_t)BQ * (dk + 1) + (size_t)BQ * dcp +
                                       2 * (size_t)BK * (dk + 1) + (size_t)BK * dcp +
                                       (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      rel_flash_fwd_f32_kernel<OC, DCM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  rel_flash_fwd_f32_kernel<OC, DCM><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(qu), static_cast<const float*>(ab),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(feats), static_cast<const uint8_t*>(mask),
      static_cast<const int*>(seed), static_cast<float*>(out), static_cast<float*>(lse), H,
      Tq, Tk, dk, D, scale, drop, thr, Ht, Ho, inv_keep);
  return cudaGetLastError();
}

// narrow: 4 output columns a thread, chunks of 256; wide: 8 and 128
cudaError_t launch_f32(const void* qu, const void* ab, const void* k, const void* v,
                       const void* feats, const void* mask, const void* seed, void* out,
                       void* lse, cudaStream_t stream, int B, int H, int Tq, int Tk, int dk,
                       int D, float scale, int drop, uint32_t thr, int Ht, int Ho,
                       float inv_keep) {
  if (narrow_width(dk, D, false))
    return launch_f32_oc<4, F32_DC>(qu, ab, k, v, feats, mask, seed, out, lse, stream, B, H,
                                    Tq, Tk, dk, D, scale, drop, thr, Ht, Ho, inv_keep);
  if (!wide_width(dk, D, false)) return cudaErrorInvalidValue;
  return launch_f32_oc<8, 128>(qu, ab, k, v, feats, mask, seed, out, lse, stream, B, H, Tq,
                               Tk, dk, D, scale, drop, thr, Ht, Ho, inv_keep);
}

template <int DKP, int NW>
cudaError_t launch_bf16_dkp(const void* qu, const void* ab, const void* k, const void* v,
                            const void* feats, const void* mask, const void* seed, void* out,
                            void* lse, cudaStream_t stream, int B, int H, int Tq, int Tk,
                            int dk, int D, float scale, int drop, uint32_t thr, int Ht, int Ho,
                            float inv_keep) {
  const size_t smem = fwd_bf16_smem(dk, D, NW);
  cudaError_t err = cudaFuncSetAttribute(rel_flash_fwd_bf16_kernel<DKP, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + 16 * NW - 1) / (16 * NW), H, B);
  rel_flash_fwd_bf16_kernel<DKP, NW><<<grid, 32 * NW, smem, stream>>>(
      static_cast<const bf16*>(qu), static_cast<const bf16*>(ab), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(feats),
      static_cast<const uint8_t*>(mask), static_cast<const int*>(seed), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Tq, Tk, dk, D, kd_pad(dk, D), scale, drop, thr, Ht, Ho,
      inv_keep);
  return cudaGetLastError();
}

// the wide bf16 forward: the maps q+u, AB [B H, Tq, *], K, V [B H, Tk, dk]
// and F [1, Tk, D] in boxes of 64 columns x 128 rows
template <int DKM>
cudaError_t launch_bf16_wide(const void* qu, const void* ab, const void* k, const void* v,
                             const void* feats, const void* mask, const void* seed, void* out,
                             void* lse, cudaStream_t stream, int B, int H, int Tq, int Tk,
                             int dk, int D, float scale, int drop, uint32_t thr, int Ht, int Ho,
                             float inv_keep) {
  const int bhn = B * H;
  CUtensorMap qm, abm, km, vm, fm;
  cudaError_t e = wq::bf16_map3(&qm, qu, dk, Tq, bhn, wq::TQ);
  if (e == cudaSuccess) e = wq::bf16_map3(&abm, ab, D, Tq, bhn, wq::TQ);
  if (e == cudaSuccess) e = wq::bf16_map3(&km, k, dk, Tk, bhn, wq::TK);
  if (e == cudaSuccess) e = wq::bf16_map3(&vm, v, dk, Tk, bhn, wq::TK);
  if (e == cudaSuccess) e = wq::bf16_map3(&fm, feats, D, Tk, 1, wq::TK);
  if (e != cudaSuccess) return e;
  const size_t smem = wq::SMEM + (Tk + wq::TK - 1) / wq::TK;
  e = cudaFuncSetAttribute(rel_flash_fwd_wide_kernel<DKM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + wq::TQ - 1) / wq::TQ, H, B);
  rel_flash_fwd_wide_kernel<DKM><<<grid, wq::THREADS, smem, stream>>>(
      qm, abm, km, vm, fm, static_cast<const uint8_t*>(mask), static_cast<const int*>(seed),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, Tq, Tk, dk, D, scale, drop, thr, Ht,
      Ho, inv_keep);
  return cudaGetLastError();
}

// narrow: 8 warps (128 query rows) where their tile fits shared memory,
// else 4; wide: DKM = 64 or 128
cudaError_t launch_bf16(const void* qu, const void* ab, const void* k, const void* v,
                        const void* feats, const void* mask, const void* seed, void* out,
                        void* lse, cudaStream_t stream, int B, int H, int Tq, int Tk, int dk,
                        int D, float scale, int drop, uint32_t thr, int Ht, int Ho,
                        float inv_keep) {
  if (wide_width(dk, D, true)) {
    if (!aligned16(qu) || !aligned16(ab) || !aligned16(k) || !aligned16(v) || !aligned16(feats))
      return cudaErrorInvalidValue;
    return dk <= 64 ? launch_bf16_wide<64>(qu, ab, k, v, feats, mask, seed, out, lse, stream,
                                           B, H, Tq, Tk, dk, D, scale, drop, thr, Ht, Ho,
                                           inv_keep)
                    : launch_bf16_wide<128>(qu, ab, k, v, feats, mask, seed, out, lse, stream,
                                            B, H, Tq, Tk, dk, D, scale, drop, thr, Ht, Ho,
                                            inv_keep);
  }
  if (!narrow_width(dk, D, true)) return cudaErrorInvalidValue;
  const bool eight = fwd_bf16_smem(dk, D, 8) <= SMEM_LIMIT;
  switch (dk_pad(dk)) {
#define CASE(P)                                                                               \
  case P:                                                                                     \
    return eight ? launch_bf16_dkp<P, 8>(qu, ab, k, v, feats, mask, seed, out, lse, stream, B, \
                                         H, Tq, Tk, dk, D, scale, drop, thr, Ht, Ho,           \
                                         inv_keep)                                             \
                 : launch_bf16_dkp<P, 4>(qu, ab, k, v, feats, mask, seed, out, lse, stream, B, \
                                         H, Tq, Tk, dk, D, scale, drop, thr, Ht, Ho,           \
                                         inv_keep);
    CASE(16) CASE(32) CASE(48) CASE(64)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_u, k, v [B,H,Tq|Tk,dk]; ab [B,H,Tq,D]; feats [Tk,D]; mask uint8 [B,Tq,Tk];
// seed int32 [1] (read only when drop != 0; may be null otherwise);
// out [B,H,Tq,dk] (input dtype); lse float32 [B,H,Tq]. All contiguous.
// Widths: narrow_width or wide_width of rel_attention_common.cuh (dk <=
// 128; bf16's wide path dk and D multiples of 8, inputs 16-byte aligned).
// thr_bits is the uint32 keep threshold's bit pattern,
// inv_keep 1/(1-rate). The keep-mask hashes head h of row b as
// b * Ht + Ho + h: the heads' place among the Ht heads of the whole
// attention under tensor parallelism ((H, 0) without it). Returns the
// CUDA error code of the launch (0 on success; cudaErrorInvalidValue
// before any launch for widths outside both paths).
extern "C" int rel_flash_attention_fwd(const void* qu, const void* ab, const void* k,
                                       const void* v, const void* feats,
                                       const void* mask, const void* seed, void* out,
                                       void* lse, void* stream, int B, int H, int Tq,
                                       int Tk, int dk, int D, int is_bf16, int drop,
                                       int thr_bits, int Ht, int Ho, float scale,
                                       float inv_keep) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t thr = static_cast<uint32_t>(thr_bits);
  cudaError_t err =
      is_bf16 ? launch_bf16(qu, ab, k, v, feats, mask, seed, out, lse, s, B, H, Tq, Tk, dk,
                            D, scale, drop, thr, Ht, Ho, inv_keep)
              : launch_f32(qu, ab, k, v, feats, mask, seed, out, lse, s, B, H, Tq, Tk, dk,
                           D, scale, drop, thr, Ht, Ho, inv_keep);
  return static_cast<int>(err);
}
