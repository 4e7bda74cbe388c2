// Shared by the relative-position flash-attention kernels
// (rel_flash_attention.cu, forward; rel_flash_attention_bwd.cu, backward):
// constants, the dropout keep-mask hash, and the tensor-core helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rel_attn {

constexpr float NEG_INF = -1e30f;
constexpr float LSE_BIG = 1e30f;   // lse of a fully masked row: exp(s - lse) = 0

// Dropout keep-mask of one attention probability, the counter hash of the
// TPU kernel's _tile_keep_mask (conformer_tpu/ops/pallas/attention_kernel.py
// :41) in uint32 arithmetic: a function of (seed, b*H + h, global query row,
// global key column) alone, with b*H + h the head's index in the whole
// attention (b*Ht + Ho + h for a model rank's heads [Ho, Ho + H) of Ht,
// which then draw the whole attention's mask for those heads), so the
// forward and both backward kernels, which
// walk the tiles in different orders, regenerate the same mask, and the
// probability matrix never exists in memory. Keep where x >= thr, thr =
// uint32(rate * 2^32), so the keep rate is 1 - rate within 2^-32.
__device__ __forceinline__ bool keep_prob(uint32_t seed, uint32_t bh, uint32_t row,
                                          uint32_t col, uint32_t thr) {
  uint32_t x = ((seed * 0x9E3779B9u + bh * 0x85EBCA6Bu) ^ (row * 0xC2B2AE35u)) ^
               (col * 0x27D4EB2Fu);
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x >= thr;
}

}  // namespace rel_attn

// ---------------------------------------------------------------- tensor cores
// Helpers of the bf16 kernels: 16-byte-or-narrower cp.async with zero-fill,
// ldmatrix, and the bf16 mma.sync.m16n8k16 with float32 accumulators. A
// warp's m16n8 accumulator fragment: lane (g = lane / 4, c = lane % 4)
// holds rows g (elements 0, 1) and g + 8 (elements 2, 3), columns 2c and
// 2c + 1 of the 8-column tile.

namespace rel_attn {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  // src-size 0 writes BYTES zeros: rows past the end of a matrix
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + rows) of the row-major matrix src [n_rows, width]
// into shared memory at dst, rows ld elements apart; rows at or past
// n_rows are zero-filled. Copies of the widest of 16, 8 and 4 bytes that
// the width and the address allow; an odd width goes through registers.
// Thread tid copies pieces tid, tid + nthreads, ... in row-major order.
template <int BYTES, typename T>
__device__ __forceinline__ void copy_pieces(T* dst, int ld, const T* src, int row0, int rows,
                                            int n_rows, int width, int tid, int nthreads) {
  constexpr int V = BYTES / (int)sizeof(T);
  const int per_row = width / V;
  const int step_r = nthreads / per_row, step_c = (nthreads - step_r * per_row) * V;
  int r = tid / per_row, c = (tid - r * per_row) * V;
  const int row_end = per_row * V;
  while (r < rows) {
    const int i = row0 + r;
    const bool ok = i < n_rows;
    const T* g = src + (size_t)(ok ? i : 0) * width + c;   // a valid address when zero-filling
    T* s = dst + r * ld + c;
    if constexpr (BYTES >= 4)
      cp_async<BYTES>(s, g, ok);
    else
      *s = ok ? *g : T(0.f);
    r += step_r;
    c += step_c;
    if (c >= row_end) {
      c -= row_end;
      ++r;
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_rows_async(T* dst, int ld, const T* src, int row0,
                                                int rows, int n_rows, int width, int tid,
                                                int nthreads) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  int bytes = 16;
  while (bytes > (int)sizeof(T) &&
         ((width * (int)sizeof(T)) % bytes != 0 || a % (uintptr_t)bytes != 0))
    bytes >>= 1;
  switch (bytes) {
    case 16: copy_pieces<16>(dst, ld, src, row0, rows, n_rows, width, tid, nthreads); break;
    case 8: copy_pieces<8>(dst, ld, src, row0, rows, n_rows, width, tid, nthreads); break;
    case 4: copy_pieces<4>(dst, ld, src, row0, rows, n_rows, width, tid, nthreads); break;
    default:
      copy_pieces<(int)sizeof(T)>(dst, ld, src, row0, rows, n_rows, width, tid, nthreads);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// A fragment (16 x 16) at rows r0, columns c0 of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int r0,
                                       int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-column tiles (columns n0 .. n0 + 15 of B = tile^T,
// depth k0 .. k0 + 15) from a row-major tile [n][k]: {b0, b1} of the first
// tile in r[0..1], of the second in r[2..3]
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* tile, int ld, int n0,
                                       int k0, int lane) {
  ldsm_x4(r, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-column tiles (columns n0 .. n0 + 15, depth k0 ..
// k0 + 15) from a row-major tile [k][n] (B itself), by transposing loads
__device__ __forceinline__ void load_bt(uint32_t (&r)[4], const bf16* tile, int ld, int k0,
                                        int n0, int lane) {
  ldsm_x4_t(r, tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// the same for one 8-column tile
__device__ __forceinline__ void load_bt1(uint32_t (&r)[2], const bf16* tile, int ld, int k0,
                                         int n0, int lane) {
  ldsm_x2_t(r, tile + (k0 + (lane & 15)) * ld + n0);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 as one bf16x2 register, lo in the low half (round to nearest)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragment (16 x 16) of the accumulators of two adjacent 8-column
// tiles: the product's k runs over those 16 columns
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Mask bytes (i, j) and (i, j + 1) of the [Tq, Tk] mask rows at mg, as the
// low two bytes of a word, zero outside [0, Tq) x [0, Tk): one 16-bit load
// where ``even`` (Tk even and mg 2-byte aligned). Tested with mask_bit only
// where used, so that the load's latency hides behind other work.
__device__ __forceinline__ uint32_t mask_pair(const uint8_t* mg, int i, int j, int Tq, int Tk,
                                              bool even) {
  if (i >= Tq || j >= Tk) return 0u;
  const uint8_t* p = mg + (size_t)i * Tk + j;
  if (even) return *reinterpret_cast<const uint16_t*>(p);
  return (uint32_t)p[0] | (j + 1 < Tk ? (uint32_t)p[1] << 8 : 0u);
}

__device__ __forceinline__ bool mask_bit(uint32_t pair, int e) {
  return ((pair >> (8 * e)) & 0xffu) != 0u;
}

// Tile t of n in the order of a block that starts at tile rot: blocks that
// stream the same matrix (F) start at different tiles, so that they do not
// all read the same rows of it at once.
__device__ __forceinline__ int rotated(int t, int rot, int n) {
  const int x = t + rot;
  return x >= n ? x - n : x;
}

// 2^x by the special-function unit alone (relative error 2^-22), keeping
// subnormal results: a probability is never flushed to zero
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory layout of the bf16 kernels, in elements: a row of
// [q+u | AB] or [K | F] is KD = round64(DKP + D) wide (DKP = dk rounded up
// to 16; F and AB start at column DKP; the rest is zero), plus 8 elements
// so that the eight 16-byte rows of an ldmatrix fall in distinct banks.
__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int dk_pad(int dk) { return round_up(dk, 16); }
__host__ __device__ constexpr int kd_pad(int dk, int D) { return round_up(dk_pad(dk) + D, 64); }

constexpr size_t SMEM_LIMIT = 232448;   // bytes of shared memory a block may use

// Shared memory, in bytes, of one block of the mma.sync bf16 forward,
// which keeps the whole [q+u | AB] row, at nw warps. ops/rel_attention.py
// computes the same.
inline size_t fwd_bf16_smem(int dk, int D, int nw) {
  const int kd = kd_pad(dk, D), ldv = dk_pad(dk) + 8;
  return 2 * ((size_t)16 * nw * (kd + 8) + 2 * (size_t)8 * nw * (kd + 8 + ldv));
}

// The two paths of every attention kernel, chosen by width alone:
//  - wide: dk <= 128 and any D; in bf16 dk and D multiples of 8 and every
//    operand 16-byte aligned (the TMA boxes' row strides and addresses).
//    In bf16 it takes every width it can (Conformer-M, -L, the 1024-wide
//    Conformer), and the backward every width (ops/rel_attention.py
//    zero-pads dk and D up to multiples of 8);
//  - narrow: dk <= 64; in float32 D <= 512; in bf16 the forward of the
//    widths the wide kernels do not take (Conformer-S's dk 36, whose
//    72-byte rows TMA cannot stride), on mma.sync, with the score depth
//    KD <= 576 and its block within shared memory.
inline bool wide_width(int dk, int D, bool bf16_) {
  return dk <= 128 && (!bf16_ || (dk % 8 == 0 && D % 8 == 0));
}
inline bool narrow_width(int dk, int D, bool bf16_) {
  if (dk > 64) return false;
  if (!bf16_) return D <= 512;
  return !wide_width(dk, D, true) && kd_pad(dk, D) <= 576 &&
         fwd_bf16_smem(dk, D, 4) <= SMEM_LIMIT;
}
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace rel_attn
