// A persistent GEMM skeleton on Hopper's warpgroup products, shared by the
// wide conv block (conv_block.cu: bf16 pw1 and pw2) and the wide fused int8
// FFN (int8_ffn.cu: the hidden and the output products).
//
// Output tiles of TM = 192 rows x TN = 128 accumulator columns. A block is
// one producer warpgroup (one thread issues the TMA copies) and three
// consumer warpgroups of 64 rows each; it walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... (a grid of at most one block an SM), so that
// the producer fills the next tile's stages while the consumers run the
// last one's epilogue, and no product runs a second wave on a few SMs: at
// M = 2992 the 192-row tiles give 16 row tiles, 128 tiles for an output of
// 1024 columns (one round on 132 SMs) and 256 or 512 for 2048 or 4096 (two
// or four rounds).
//
// A stage of the ring is 40 KB, whatever the operand type, since a row of
// an operand box is 128 bytes of K (64 bf16 or 128 int8 values):
//  - A: 192 rows x 128 bytes (K-major, three 64-row atoms, consumer c's at
//    c * ATOM);
//  - B: 16 KB, either 128 rows of 128 bytes (K-major: int8 W^T) or two
//    blocks of 64 columns x 64 depth rows, ATOM apart (MN-major: a bf16
//    weight [K, N] as it lies in memory).
// Both complete on the stage's full barrier by bytes; each consumer thread
// arrives on its empty barrier once the products that read it are done.
// Each consumer warpgroup stages its epilogue through shared memory (64
// rows x 64 floats at a time), so that device memory sees 16-byte stores.
#pragma once

#include <cuda_bf16.h>

#include "hopper_common.cuh"

namespace pg {

constexpr int WGS = 3;                          // consumer warpgroups
constexpr int THREADS = 128 * (WGS + 1);
constexpr int TM = 64 * WGS, TN = 128;          // output tile: rows, accumulator columns
constexpr int STAGES = 4;
constexpr int REG_PRODUCER = 40, REG_CONSUMER = 152;
constexpr uint32_t ATOM = 8192;                 // 64 rows x 128 bytes, 128-byte swizzle
constexpr uint32_t A_BYTES = WGS * ATOM;
constexpr uint32_t B_BYTES = 2 * ATOM;
constexpr uint32_t STAGE = A_BYTES + B_BYTES;
constexpr int EPI_LD = 72;                      // floats a staged row: 64 + 8 (a warp's float2
                                                // writes in two wavefronts)
constexpr uint32_t EPI_BYTES = WGS * 64 * EPI_LD * sizeof(float);
constexpr size_t SMEM = 1024 + STAGES * STAGE + EPI_BYTES + 2 * STAGES * sizeof(uint64_t);
static_assert(SMEM <= 232448, "the ring and the staging exceed a block's shared memory");

struct Smem {
  unsigned char* ring;
  float* stg;        // [WGS][64][EPI_LD]
  uint64_t* full;
  uint64_t* empty;
};

// the ring, the staging and the barriers in the dynamic shared memory; the
// barriers initialised by thread 0 (the caller synchronises the block)
__device__ __forceinline__ Smem setup(unsigned char* raw) {
  Smem s;
  s.ring = hopper::align1024(raw);
  s.stg = reinterpret_cast<float*>(s.ring + STAGES * STAGE);
  s.full = reinterpret_cast<uint64_t*>(s.ring + STAGES * STAGE + EPI_BYTES);
  s.empty = s.full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.empty[i], 128 * WGS);
    }
    hopper::mbar_fence_init();
  }
  return s;
}

// producer thread: for each of this block's tiles (tile t is row tile
// t / tn, column tile t % tn) and each of its nk stages of K, wait for the
// slot, arm its barrier for STAGE bytes and call load(dst, bar, mt, nt, kc),
// which issues the stage's TMA copies
template <class Load>
__device__ __forceinline__ void produce(const Smem& s, int tiles, int tn, int nk, Load load) {
  int g = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    for (int kc = 0; kc < nk; ++kc, ++g) {
      const int st = g % STAGES;
      hopper::mbar_wait(&s.empty[st], ((g / STAGES) & 1) ^ 1);
      hopper::mbar_expect(&s.full[st], STAGE);
      load(s.ring + st * STAGE, &s.full[st], t / tn, t % tn, kc);
    }
}

__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// consumer warpgroup c: acc = (its 64 rows of A) x B over the next nk
// stages of the ring (g counts stages across tiles); mma(acc, a, b, kc)
// issues one stage's products on the shared addresses a (the warpgroup's
// A atom) and b, overwriting acc where kc == 0. Each stage is released once
// the products that read it are done.
template <typename Acc, class Mma>
__device__ __forceinline__ void consume(Acc (&acc)[64], const Smem& s, int nk, int& g, int c,
                                        Mma mma) {
  int prev = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(acc[i]);
  hopper::wg_fence();
  for (int kc = 0; kc < nk; ++kc, ++g) {
    const int st = g % STAGES;
    hopper::mbar_wait(&s.full[st], (g / STAGES) & 1);
    const uint32_t base = hopper::saddr(s.ring + st * STAGE);
    if (kc > 0) hopper::wg_fence();
    mma(acc, base + c * ATOM, base + A_BYTES, kc);
    hopper::wg_commit();
    if (kc > 0) {
      hopper::wg_wait<1>();
      hopper::mbar_arrive(&s.empty[prev]);
    }
    prev = st;
  }
  hopper::wg_wait0();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(acc[i]);
  hopper::mbar_arrive(&s.empty[prev]);
}

// Consumer warpgroup c's staging area, 64 rows x 64 columns of the tile at
// a time. The accumulator's element (row, col) of warp w, lane l: row
// 16 w + l / 4 (+8: hh = 1), column 8 i + 2 (l % 4) (+1: e = 1), acc[4 i +
// 2 hh + e]. stage(c, half, val) waits until the area's last readers are
// done, writes val(i, hh, e) for the columns 8 i of the half (i in [8 half,
// 8 half + 8)) at (row, col - 64 half), and waits until all of it is
// written; then each thread may read any of it.
template <class Val>
__device__ __forceinline__ float* stage(float* stg_all, int c, int half, Val val) {
  float* stg = stg_all + c * 64 * EPI_LD;
  const int tid = threadIdx.x & 127, w = tid >> 5, l = tid & 31;
  hopper::bar_sync(1 + c, 128);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i8 = 8 * half + i;
      *reinterpret_cast<float2*>(stg + (16 * w + (l >> 2) + 8 * hh) * EPI_LD + 8 * i +
                                 2 * (l & 3)) = make_float2(val(i8, hh, 0), val(i8, hh, 1));
    }
  hopper::bar_sync(1 + c, 128);
  return stg;
}

// Eight consecutive values as float32, 16 bytes in memory (global or
// shared, 16-byte aligned): bf16 as one uint4, float32 as two float4;
// float32 to bf16 rounded to nearest even. For the epilogues and the
// row-wise launches beside the products.
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = pack8(v);
}

// ------------------------------------------------------------- host side

// blocks of the persistent grid: one an SM, at most one a tile
inline int grid_size(int tiles) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return tiles < sms ? tiles : sms;
}

}  // namespace pg
