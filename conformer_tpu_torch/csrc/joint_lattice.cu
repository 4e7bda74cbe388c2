// Fused transducer joint over the full lattice, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/joint_kernel.py:
// _forward / _fwd_kernel (joint_lattice_fwd), and _backward's two calls,
// _bwd_xp_kernel (joint_lattice_bwd_xp) and _bwd_w_kernel
// (joint_lattice_bwd_w). For every lattice cell m = (b, t, u), with
// x = tanh(enc[b,t] + pred[b,u]) in enc's dtype (the sum in the wider of
// the two dtypes: rounded to bf16 when both are bf16, as the TPU kernel
// does; the model gives bf16 enc and float32 pred) and logits = x W + bias
// (float32 sums, W in enc's dtype, bias float32):
//
//   logZ = logsumexp_v logits,  lp_blank = logits[blank] - logZ,
//   lp_emit = logits[lab[b,u]] - logZ   (0 - logZ for a label outside [0, V));
//
// and, from the saved logZ and the cotangents g_b, g_e,
//
//   dl[m,v] = -(g_b + g_e) p + g_b [v = blank] + g_e [v = lab],  p = exp(logits - logZ)
//   dpre = (dl W^T) (1 - x^2),  d enc[b,t] = sum_u dpre,  d pred[b,u] = sum_t dpre,
//   dW = sum_m x^T dl,  dbias = sum_m dl.
//
// The [B, T, U+1, V] logits never exist: each block holds a tile of them.
//
// Bound: the products. One product is 2 M J V flops (M = B T (U+1) cells):
// 3.0e12 at the training shape (B=24, T'=374, U+1=65, J=512, V=5002), 3.0 ms
// at the bf16 tensor rate and 45 ms in float32 off the tensor cores. The
// forward is one product; bwd_xp two (the logits again, and dl W^T);
// bwd_w two (the logits again, and x^T dl). The bytes (enc, pred, W, the
// lattice outputs) are tens of MB, far below. The exps (M V per pass, 2.9e9)
// take ~0.7 ms on the special-function units.
//
// Design. The TPU kernel kept a (16 t x 128-padded u) x J tile and all of W
// in VMEM; neither fits a block's 227 KB here. The cells are flattened into
// M rows and a block owns a fixed tile of BM rows (64 in bf16, 32 in
// float32) whatever U is: the block shape never depends on U (a block that
// held every u was refused at U+1 = 201 in the simple lattice's backward).
// The block keeps its x tile in shared memory and walks V in tiles of 64
// columns; W's column tile [J x 64] is staged in shared memory per step
// (W, 5 MB in bf16, stays in the 50 MB L2). Products: in bf16 on the tensor
// cores through nvcuda::wmma (16x16x16, float32 accumulators); in float32 as
// FMAs on the CUDA cores (no TF32), through the same 16x16 fragment shape.
// Each logits tile goes to shared memory for the epilogue: an online
// logsumexp per row and the blank and label picks (forward), or dl
// (backward, rounded to the inputs' dtype as the product's operand).
//
// Reductions across blocks take no atomics, so the backward is bitwise
// repeatable. bwd_xp: each block accumulates its rows' dX = dl W^T over all
// of V in registers, writes dpre [M, J] float32, and a second grid sums it
// over u (d enc) and over t (d pred) in a fixed order. bwd_w: a first grid
// writes x [M, J] in the inputs' dtype; the main grid's block owns (a V
// tile, a chunk of rows) and accumulates that chunk's dW tile [J x 64] in
// registers; a last grid sums the chunks' partial dW and dbias in order.
// The C entries report the grids they launched (1, 2 and 3).
//
// Limits: J a multiple of 128 up to 512; V padded by the caller to Vp, a
// multiple of 64 (W's padded columns are never read into a result).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BN = 64;                 // V columns per tile
constexpr int NCF = BN / 16;           // 16-wide fragments across a V tile
constexpr int LDL = BN + 4;            // row stride of the float32 logits tile
constexpr int kMaxNJ = 512 / 128;      // 16-wide fragments of J per warp, at most

template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int BM = 64, PADX = 8, LDW = BN + 8, LDD = BN + 8;
};
template <> struct Tile<float> {
  static constexpr int BM = 32, PADX = 4, LDW = BN + 4, LDD = BN + 4;
};

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Byte offsets of the shared-memory regions: x tile [BM][J+PADX], W tile
// [J][LDW], logits [BM][LDL] float32, dl [BM][LDD], row constants [4][BM].
template <typename T> struct Smem {
  int ldx;
  size_t x, w, l, d, rows, total;
  __host__ __device__ explicit Smem(int J) {
    ldx = J + Tile<T>::PADX;
    x = 0;
    w = align128(x + sizeof(T) * Tile<T>::BM * ldx);
    l = align128(w + sizeof(T) * J * Tile<T>::LDW);
    d = align128(l + sizeof(float) * Tile<T>::BM * LDL);
    rows = align128(d + sizeof(T) * Tile<T>::BM * Tile<T>::LDD);
    total = rows + sizeof(float) * 4 * Tile<T>::BM;
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// x = tanh(e + p) in T, the sum in the wider of T and TP (rounded to bf16
// when both are bf16)
template <typename T, typename TP> __device__ __forceinline__ T joint_x(T e, TP p) {
  float s = to_f(e) + to_f(p);
  if constexpr (std::is_same<T, bf16>::value && std::is_same<TP, bf16>::value)
    s = to_f(from_f<bf16>(s));
  return from_f<T>(tanhf(s));
}

// c += A (16 x 16) B (16 x 16), A and B in shared memory, row- or
// column-major as ACol / BCol say.
template <typename T> struct Mma;

template <> struct Mma<bf16> {
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  static __device__ __forceinline__ void zero(Acc& c) { wmma::fill_fragment(c, 0.f); }
  template <bool ACol, bool BCol>
  static __device__ __forceinline__ void mma(Acc& c, const bf16* a, int lda, const bf16* b,
                                             int ldb) {
    using LA = typename std::conditional<ACol, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<BCol, wmma::col_major, wmma::row_major>::type;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
    wmma::load_matrix_sync(fa, a, lda);
    wmma::load_matrix_sync(fb, b, ldb);
    wmma::mma_sync(c, fa, fb, c);
  }
  static __device__ __forceinline__ void store(float* p, const Acc& c, int ldp) {
    wmma::store_matrix_sync(p, c, ldp, wmma::mem_row_major);
  }
};

// float32: lane l holds row l/2, columns 8 (l%2) .. 8 (l%2) + 7 of the tile
struct AccF {
  float v[8];
};
template <> struct Mma<float> {
  using Acc = AccF;
  static __device__ __forceinline__ void zero(Acc& c) {
#pragma unroll
    for (int q = 0; q < 8; ++q) c.v[q] = 0.f;
  }
  template <bool ACol, bool BCol>
  static __device__ __forceinline__ void mma(Acc& c, const float* a, int lda, const float* b,
                                             int ldb) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = ACol ? a[k * lda + r] : a[r * lda + k];
      float bv[8];
      if constexpr (BCol) {
#pragma unroll
        for (int q = 0; q < 8; ++q) bv[q] = b[(c0 + q) * ldb + k];
      } else {
        const float4 lo = *reinterpret_cast<const float4*>(b + k * ldb + c0);
        const float4 hi = *reinterpret_cast<const float4*>(b + k * ldb + c0 + 4);
        bv[0] = lo.x; bv[1] = lo.y; bv[2] = lo.z; bv[3] = lo.w;
        bv[4] = hi.x; bv[5] = hi.y; bv[6] = hi.z; bv[7] = hi.w;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) c.v[q] = fmaf(av, bv[q], c.v[q]);
    }
  }
  static __device__ __forceinline__ void store(float* p, const Acc& c, int ldp) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) p[r * ldp + c0 + q] = c.v[q];
  }
};

// lab of cell m = (b, t, u): lab[b, u]
__device__ __forceinline__ int cell_label(const int* lab, int m, int Tn, int U1) {
  const int bt = m / U1;
  return lab[(bt / Tn) * U1 + (m - bt * U1)];
}

// rows [m0, m0 + BM) of x = tanh(enc + pred) into Xs, one warp per row;
// rows at or past M are zero
template <typename T, typename TP>
__device__ void load_x_tanh(T* Xs, int ldx, const T* __restrict__ enc,
                            const TP* __restrict__ pred, int m0, int M, int Tn, int U1, int J) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < Tile<T>::BM; r += kWarps) {
    const int m = m0 + r;
    T* dst = Xs + (size_t)r * ldx;
    if (m < M) {
      const int bt = m / U1, u = m - bt * U1, b = bt / Tn;
      const T* e = enc + (size_t)bt * J;
      const TP* p = pred + ((size_t)b * U1 + u) * J;
      for (int j = lane; j < J; j += 32) dst[j] = joint_x<T, TP>(e[j], p[j]);
    } else {
      for (int j = lane; j < J; j += 32) dst[j] = from_f<T>(0.f);
    }
  }
}

// W[:, v0 : v0 + BN] into Ws [J][LDW], 16-byte loads
template <typename T>
__device__ void load_w_tile(T* Ws, const T* __restrict__ W, int J, int Vp, int v0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = BN / VEC;
  for (int i = threadIdx.x; i < J * PER_ROW; i += kThreads) {
    const int j = i / PER_ROW, c = (i - j * PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(Ws + (size_t)j * Tile<T>::LDW + c) =
        *reinterpret_cast<const uint4*>(W + (size_t)j * Vp + v0 + c);
  }
}

// rows [m0, m0 + BM) of the x buffer [M][J] into Xs; rows at or past `end` are zero
template <typename T>
__device__ void load_x_rows(T* Xs, int ldx, const T* __restrict__ X, int m0, int end, int J) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = J / VEC;
  for (int i = threadIdx.x; i < Tile<T>::BM * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * VEC, m = m0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m < end) val = *reinterpret_cast<const uint4*>(X + (size_t)m * J + c);
    *reinterpret_cast<uint4*>(Xs + (size_t)r * ldx + c) = val;
  }
}

// Ls[BM][BN] = Xs[BM][J] Ws[J][BN] (float32 sums; the epilogues add the bias)
template <typename T>
__device__ void logits_tile(float* Ls, const T* Xs, int ldx, const T* Ws, int J) {
  using MM = Mma<T>;
  constexpr int NF = Tile<T>::BM / 16 * NCF / kWarps;
  const int warp = threadIdx.x >> 5;
  typename MM::Acc acc[NF];
  int rf[NF], cf[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = warp * NF + i;
    rf[i] = f / NCF;
    cf[i] = f % NCF;
    MM::zero(acc[i]);
  }
  for (int k = 0; k < J; k += 16) {
#pragma unroll
    for (int i = 0; i < NF; ++i)
      MM::template mma<false, false>(acc[i], Xs + (size_t)rf[i] * 16 * ldx + k, ldx,
                                     Ws + (size_t)k * Tile<T>::LDW + cf[i] * 16, Tile<T>::LDW);
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) MM::store(Ls + rf[i] * 16 * LDL + cf[i] * 16, acc[i], LDL);
}

// the row constants of rows [m0, m0 + BM): logZ, g_b, g_e, label; rows at
// or past `end` get g = 0 and no label
template <typename T>
__device__ void load_rows(float* rows, const float* __restrict__ logz,
                          const float* __restrict__ gb, const float* __restrict__ ge,
                          const int* __restrict__ lab, int m0, int end, int Tn, int U1) {
  constexpr int BM = Tile<T>::BM;
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    const int m = m0 + i;
    const bool ok = m < end;
    rows[i] = ok ? logz[m] : 0.f;
    rows[BM + i] = ok ? gb[m] : 0.f;
    rows[2 * BM + i] = ok ? ge[m] : 0.f;
    reinterpret_cast<int*>(rows)[3 * BM + i] = ok ? cell_label(lab, m, Tn, U1) : -1;
  }
}

// dl of the logits tile in Ls (bias not yet added) into Ds (the product's
// operand, rounded to T) and, with kKeep, back into Ls as float32
template <typename T, bool kKeep>
__device__ void dlogits_tile(float* Ls, T* Ds, const float* rows, const float* __restrict__ bias,
                             int m0, int end, int v0, int V, int blank) {
  constexpr int BM = Tile<T>::BM, TPR = kThreads / BM, CPT = BN / TPR;
  const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const float lz = rows[r], g_b = rows[BM + r], g_e = rows[2 * BM + r];
  const int lb = reinterpret_cast<const int*>(rows)[3 * BM + r];
  const bool ok = m0 + r < end;
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int c = sub + TPR * q, v = v0 + c;
    float d = 0.f;
    if (ok && v < V) {
      const float p = __expf(Ls[r * LDL + c] + bias[v] - lz);
      d = -(g_b + g_e) * p + (v == blank ? g_b : 0.f) + (v == lb ? g_e : 0.f);
    }
    Ds[r * Tile<T>::LDD + c] = from_f<T>(d);
    if (kKeep) Ls[r * LDL + c] = d;
  }
}

template <typename T, typename TP>
__global__ void __launch_bounds__(kThreads, 1)
joint_fwd_kernel(const T* __restrict__ enc, const TP* __restrict__ pred, const T* __restrict__ W,
                 const float* __restrict__ bias, const int* __restrict__ lab,
                 float* __restrict__ lpb, float* __restrict__ lpe, float* __restrict__ logz,
                 int M, int Tn, int U1, int J, int V, int Vp, int blank) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> S(J);
  T* Xs = reinterpret_cast<T*>(smem + S.x);
  T* Ws = reinterpret_cast<T*>(smem + S.w);
  float* Ls = reinterpret_cast<float*>(smem + S.l);
  constexpr int BM = Tile<T>::BM, TPR = kThreads / BM, CPT = BN / TPR;
  const int m0 = blockIdx.x * BM;
  const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR, m = m0 + r;
  const int lb = (sub == 0 && m < M) ? cell_label(lab, m, Tn, U1) : -1;

  load_x_tanh<T, TP>(Xs, S.ldx, enc, pred, m0, M, Tn, U1, J);
  float run_m = -INFINITY, run_s = 0.f, bl = 0.f, em = 0.f;
  for (int v0 = 0; v0 < Vp; v0 += BN) {
    __syncthreads();
    load_w_tile<T>(Ws, W, J, Vp, v0);
    __syncthreads();
    logits_tile<T>(Ls, Xs, S.ldx, Ws, J);
    __syncthreads();
    // online logsumexp over this thread's columns of its row
    const float* lr = Ls + r * LDL;
    float tmax = -INFINITY;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int c = sub + TPR * q, v = v0 + c;
      if (v < V) tmax = fmaxf(tmax, lr[c] + bias[v]);
    }
    const float mn = fmaxf(run_m, tmax);
    if (mn != -INFINITY) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = sub + TPR * q, v = v0 + c;
        if (v < V) s += __expf(lr[c] + bias[v] - mn);
      }
      run_s = run_s * __expf(run_m - mn) + s;
      run_m = mn;
    }
    if (sub == 0) {
      if (blank >= v0 && blank < v0 + BN) bl = lr[blank - v0] + bias[blank];
      if (lb >= v0 && lb < v0 + BN && lb < V) em = lr[lb - v0] + bias[lb];
    }
  }
  // combine the row's TPR partial sums (neighbouring lanes)
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, run_m, off);
    const float os = __shfl_xor_sync(0xffffffffu, run_s, off);
    const float mn = fmaxf(run_m, om);
    run_s = mn == -INFINITY ? 0.f : run_s * __expf(run_m - mn) + os * __expf(om - mn);
    run_m = mn;
  }
  if (sub == 0 && m < M) {
    const float lz = run_m + logf(run_s);
    lpb[m] = bl - lz;
    lpe[m] = em - lz;
    logz[m] = lz;
  }
}

template <typename T, typename TP>
__global__ void __launch_bounds__(kThreads, 1)
joint_bwd_xp_kernel(const T* __restrict__ enc, const TP* __restrict__ pred,
                    const T* __restrict__ W, const float* __restrict__ bias,
                    const int* __restrict__ lab, const float* __restrict__ logz,
                    const float* __restrict__ gb, const float* __restrict__ ge,
                    float* __restrict__ dpre, int M, int Tn, int U1, int J, int V, int Vp,
                    int blank) {
  using MM = Mma<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> S(J);
  T* Xs = reinterpret_cast<T*>(smem + S.x);
  T* Ws = reinterpret_cast<T*>(smem + S.w);
  float* Ls = reinterpret_cast<float*>(smem + S.l);
  T* Ds = reinterpret_cast<T*>(smem + S.d);
  float* rows = reinterpret_cast<float*>(smem + S.rows);
  constexpr int BM = Tile<T>::BM, RF = BM / 16, LDW = Tile<T>::LDW, LDD = Tile<T>::LDD;
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nj = J / 128;

  load_rows<T>(rows, logz, gb, ge, lab, m0, M, Tn, U1);
  load_x_tanh<T, TP>(Xs, S.ldx, enc, pred, m0, M, Tn, U1, J);
  // dX [BM][J]: warp w owns the J columns [16 nj w, 16 nj (w + 1))
  typename MM::Acc dx[RF][kMaxNJ];
#pragma unroll
  for (int a = 0; a < RF; ++a)
#pragma unroll
    for (int jf = 0; jf < kMaxNJ; ++jf) MM::zero(dx[a][jf]);

  for (int v0 = 0; v0 < Vp; v0 += BN) {
    __syncthreads();
    load_w_tile<T>(Ws, W, J, Vp, v0);
    __syncthreads();
    logits_tile<T>(Ls, Xs, S.ldx, Ws, J);
    __syncthreads();
    dlogits_tile<T, false>(Ls, Ds, rows, bias, m0, M, v0, V, blank);
    __syncthreads();
    // dX += dl W^T: W^T's (v, j) is Ws[j][v], a column-major B operand
#pragma unroll
    for (int a = 0; a < RF; ++a)
#pragma unroll
      for (int jf = 0; jf < kMaxNJ; ++jf) {
        if (jf >= nj) continue;
        const int j0 = (warp * nj + jf) * 16;
#pragma unroll
        for (int k = 0; k < BN; k += 16)
          MM::template mma<false, true>(dx[a][jf], Ds + a * 16 * LDD + k, LDD,
                                        Ws + (size_t)j0 * LDW + k, LDW);
      }
  }
  __syncthreads();
  // dpre = dX (1 - x^2), each fragment staged through the W tile's space
  float* stage = reinterpret_cast<float*>(Ws) + warp * 256;
#pragma unroll
  for (int a = 0; a < RF; ++a)
#pragma unroll
    for (int jf = 0; jf < kMaxNJ; ++jf) {
      if (jf >= nj) continue;
      const int j0 = (warp * nj + jf) * 16;
      MM::store(stage, dx[a][jf], 16);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = a * 16 + (e >> 4), j = j0 + (e & 15), m = m0 + row;
        if (m < M) {
          const float xv = to_f(Xs[(size_t)row * S.ldx + j]);
          dpre[(size_t)m * J + j] = stage[e] * (1.f - xv * xv);
        }
      }
      __syncwarp();
    }
}

// d enc[b,t] = sum_u dpre[b,t,u] (blocks [0, B T)); d pred[b,u] = sum_t
// dpre[b,t,u] (blocks [B T, B T + B U1)); in order, no atomics
__global__ void joint_reduce_xp_kernel(const float* __restrict__ dpre, float* __restrict__ d_enc,
                                       float* __restrict__ d_pred, int B, int Tn, int U1, int J) {
  const int blk = blockIdx.x;
  if (blk < B * Tn) {
    const float* src = dpre + (size_t)blk * U1 * J;
    for (int j = threadIdx.x; j < J; j += blockDim.x) {
      float s = 0.f;
      for (int u = 0; u < U1; ++u) s += src[(size_t)u * J + j];
      d_enc[(size_t)blk * J + j] = s;
    }
  } else {
    const int bu = blk - B * Tn, b = bu / U1, u = bu - b * U1;
    const float* src = dpre + ((size_t)b * Tn * U1 + u) * J;
    for (int j = threadIdx.x; j < J; j += blockDim.x) {
      float s = 0.f;
      for (int t = 0; t < Tn; ++t) s += src[(size_t)t * U1 * J + j];
      d_pred[(size_t)bu * J + j] = s;
    }
  }
}

// x [M][J] in the inputs' dtype, one warp per row
template <typename T, typename TP>
__global__ void joint_x_kernel(const T* __restrict__ enc, const TP* __restrict__ pred,
                               T* __restrict__ X, int M, int Tn, int U1, int J) {
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  const int bt = m / U1, u = m - bt * U1, b = bt / Tn;
  const T* e = enc + (size_t)bt * J;
  const TP* p = pred + ((size_t)b * U1 + u) * J;
  for (int j = lane; j < J; j += 32) X[(size_t)m * J + j] = joint_x<T, TP>(e[j], p[j]);
}

// block (V tile, chunk of rows): that chunk's dW[:, tile] and dbias[tile]
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
joint_bwd_w_kernel(const T* __restrict__ X, const T* __restrict__ W,
                   const float* __restrict__ bias, const int* __restrict__ lab,
                   const float* __restrict__ logz, const float* __restrict__ gb,
                   const float* __restrict__ ge, float* __restrict__ part,
                   float* __restrict__ dbpart, int M, int Tn, int U1, int J, int V, int Vp,
                   int blank, int rows_per_chunk) {
  using MM = Mma<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> S(J);
  T* Xs = reinterpret_cast<T*>(smem + S.x);
  T* Ws = reinterpret_cast<T*>(smem + S.w);
  float* Ls = reinterpret_cast<float*>(smem + S.l);
  T* Ds = reinterpret_cast<T*>(smem + S.d);
  float* rows = reinterpret_cast<float*>(smem + S.rows);
  constexpr int BM = Tile<T>::BM, LDD = Tile<T>::LDD;
  const int v0 = blockIdx.x * BN, chunk = blockIdx.y;
  const int begin = chunk * rows_per_chunk;
  const int end = min(M, begin + rows_per_chunk);
  const int warp = threadIdx.x >> 5, nj = J / 128;

  load_w_tile<T>(Ws, W, J, Vp, v0);
  // dW [J][BN]: warp w owns the J rows [16 nj w, 16 nj (w + 1))
  typename MM::Acc dw[kMaxNJ][NCF];
#pragma unroll
  for (int jf = 0; jf < kMaxNJ; ++jf)
#pragma unroll
    for (int c = 0; c < NCF; ++c) MM::zero(dw[jf][c]);
  float dbacc = 0.f;

  for (int m0 = begin; m0 < end; m0 += BM) {
    __syncthreads();
    load_rows<T>(rows, logz, gb, ge, lab, m0, end, Tn, U1);
    load_x_rows<T>(Xs, S.ldx, X, m0, end, J);
    __syncthreads();
    logits_tile<T>(Ls, Xs, S.ldx, Ws, J);
    __syncthreads();
    dlogits_tile<T, true>(Ls, Ds, rows, bias, m0, end, v0, V, blank);
    __syncthreads();
    if (threadIdx.x < BN)
      for (int r = 0; r < BM; ++r) dbacc += Ls[r * LDL + threadIdx.x];
    // dW += x^T dl: x^T's (j, row) is Xs[row][j], a column-major A operand
#pragma unroll
    for (int jf = 0; jf < kMaxNJ; ++jf) {
      if (jf >= nj) continue;
      const int j0 = (warp * nj + jf) * 16;
#pragma unroll
      for (int c = 0; c < NCF; ++c)
#pragma unroll
        for (int k = 0; k < BM; k += 16)
          MM::template mma<true, false>(dw[jf][c], Xs + (size_t)k * S.ldx + j0, S.ldx,
                                        Ds + k * LDD + c * 16, LDD);
    }
  }
  float* pc = part + (size_t)chunk * J * Vp;
#pragma unroll
  for (int jf = 0; jf < kMaxNJ; ++jf) {
    if (jf >= nj) continue;
    const int j0 = (warp * nj + jf) * 16;
#pragma unroll
    for (int c = 0; c < NCF; ++c) MM::store(pc + (size_t)j0 * Vp + v0 + c * 16, dw[jf][c], Vp);
  }
  if (threadIdx.x < BN) dbpart[(size_t)chunk * Vp + v0 + threadIdx.x] = dbacc;
}

// dW = sum over chunks of the partials, dbias likewise, in chunk order
__global__ void joint_reduce_w_kernel(const float* __restrict__ part,
                                      const float* __restrict__ dbpart, float* __restrict__ dw,
                                      float* __restrict__ db, int n_chunks, size_t JV, int Vp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < JV) {
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += part[(size_t)c * JV + i];
    dw[i] = s;
  } else if (i < JV + Vp) {
    const size_t v = i - JV;
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += dbpart[(size_t)c * Vp + v];
    db[v] = s;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, typename TP>
cudaError_t launch_fwd(const void* enc, const void* pred, const void* w, const void* bias,
                       const void* lab, void* lpb, void* lpe, void* logz, cudaStream_t st, int M,
                       int Tn, int U1, int J, int V, int Vp, int blank) {
  const Smem<T> S(J);
  cudaError_t e = set_smem(joint_fwd_kernel<T, TP>, S.total);
  if (e != cudaSuccess) return e;
  const int grid = (M + Tile<T>::BM - 1) / Tile<T>::BM;
  joint_fwd_kernel<T, TP><<<grid, kThreads, S.total, st>>>(
      static_cast<const T*>(enc), static_cast<const TP*>(pred), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(lab), static_cast<float*>(lpb),
      static_cast<float*>(lpe), static_cast<float*>(logz), M, Tn, U1, J, V, Vp, blank);
  return cudaGetLastError();
}

template <typename T, typename TP>
cudaError_t launch_bwd_xp(const void* enc, const void* pred, const void* w, const void* bias,
                          const void* lab, const void* logz, const void* gb, const void* ge,
                          void* dpre, void* d_enc, void* d_pred, int* launched, cudaStream_t st,
                          int B, int Tn, int U1, int J, int V, int Vp, int blank) {
  const int M = B * Tn * U1;
  const Smem<T> S(J);
  cudaError_t e = set_smem(joint_bwd_xp_kernel<T, TP>, S.total);
  if (e != cudaSuccess) return e;
  const int grid = (M + Tile<T>::BM - 1) / Tile<T>::BM;
  joint_bwd_xp_kernel<T, TP><<<grid, kThreads, S.total, st>>>(
      static_cast<const T*>(enc), static_cast<const TP*>(pred), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(lab),
      static_cast<const float*>(logz), static_cast<const float*>(gb),
      static_cast<const float*>(ge), static_cast<float*>(dpre), M, Tn, U1, J, V, Vp, blank);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  *launched = 1;
  joint_reduce_xp_kernel<<<B * Tn + B * U1, 128, 0, st>>>(
      static_cast<const float*>(dpre), static_cast<float*>(d_enc), static_cast<float*>(d_pred),
      B, Tn, U1, J);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched = 2;
  return e;
}

template <typename T, typename TP>
cudaError_t launch_bwd_w(const void* enc, const void* pred, const void* w, const void* bias,
                         const void* lab, const void* logz, const void* gb, const void* ge,
                         void* xbuf, void* part, void* dbpart, void* dw, void* db, int* launched,
                         cudaStream_t st, int B, int Tn, int U1, int J, int V, int Vp, int blank,
                         int n_chunks) {
  const int M = B * Tn * U1;
  joint_x_kernel<T, TP><<<(M + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const T*>(enc), static_cast<const TP*>(pred), static_cast<T*>(xbuf), M, Tn,
      U1, J);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  *launched = 1;
  const Smem<T> S(J);
  e = set_smem(joint_bwd_w_kernel<T>, S.total);
  if (e != cudaSuccess) return e;
  const int tiles = (M + Tile<T>::BM - 1) / Tile<T>::BM;
  const int rows_per_chunk = (tiles + n_chunks - 1) / n_chunks * Tile<T>::BM;
  joint_bwd_w_kernel<T><<<dim3(Vp / BN, n_chunks), kThreads, S.total, st>>>(
      static_cast<const T*>(xbuf), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(lab), static_cast<const float*>(logz),
      static_cast<const float*>(gb), static_cast<const float*>(ge), static_cast<float*>(part),
      static_cast<float*>(dbpart), M, Tn, U1, J, V, Vp, blank, rows_per_chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  *launched = 2;
  const size_t jv = (size_t)J * Vp;
  const size_t n = jv + Vp;
  joint_reduce_w_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(dbpart), static_cast<float*>(dw),
      static_cast<float*>(db), n_chunks, jv, Vp);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched = 3;
  return e;
}

}  // namespace

// The C entries: enc in bf16 or float32 (is_bf16), pred likewise
// (pred_bf16); w [J,Vp] in enc's dtype, bias [Vp] float32, lab [B,U1] int32.

// -> lpb, lpe, logz [B,T,U1] float32.
extern "C" int joint_lattice_fwd(const void* enc, const void* pred, const void* w,
                                 const void* bias, const void* lab, void* lpb, void* lpe,
                                 void* logz, void* stream, int B, int T, int U1, int J, int V,
                                 int Vp, int blank, int is_bf16, int pred_bf16) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T * U1;
#define JOINT_FWD(T_, TP_) \
  launch_fwd<T_, TP_>(enc, pred, w, bias, lab, lpb, lpe, logz, st, M, T, U1, J, V, Vp, blank)
  return static_cast<int>(is_bf16 ? (pred_bf16 ? JOINT_FWD(bf16, bf16) : JOINT_FWD(bf16, float))
                                  : (pred_bf16 ? JOINT_FWD(float, bf16) : JOINT_FWD(float, float)));
#undef JOINT_FWD
}

// -> d_enc [B,T,J], d_pred [B,U1,J] float32; dpre [B*T*U1, J] float32 scratch.
// *grids: the grids launched (2).
extern "C" int joint_lattice_bwd_xp(const void* enc, const void* pred, const void* w,
                                    const void* bias, const void* lab, const void* logz,
                                    const void* gb, const void* ge, void* dpre, void* d_enc,
                                    void* d_pred, void* grids, void* stream, int B, int T, int U1,
                                    int J, int V, int Vp, int blank, int is_bf16, int pred_bf16) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* launched = static_cast<int*>(grids);
  *launched = 0;
#define JOINT_XP(T_, TP_)                                                                     \
  launch_bwd_xp<T_, TP_>(enc, pred, w, bias, lab, logz, gb, ge, dpre, d_enc, d_pred, launched, \
                         st, B, T, U1, J, V, Vp, blank)
  return static_cast<int>(is_bf16 ? (pred_bf16 ? JOINT_XP(bf16, bf16) : JOINT_XP(bf16, float))
                                  : (pred_bf16 ? JOINT_XP(float, bf16) : JOINT_XP(float, float)));
#undef JOINT_XP
}

// -> dw [J,Vp], db [Vp] float32; scratch: xbuf [B*T*U1, J] in enc's dtype,
// part [n_chunks, J, Vp] and dbpart [n_chunks, Vp] float32.
// *grids: the grids launched (3).
extern "C" int joint_lattice_bwd_w(const void* enc, const void* pred, const void* w,
                                   const void* bias, const void* lab, const void* logz,
                                   const void* gb, const void* ge, void* xbuf, void* part,
                                   void* dbpart, void* dw, void* db, void* grids, void* stream,
                                   int B, int T, int U1, int J, int V, int Vp, int blank,
                                   int n_chunks, int is_bf16, int pred_bf16) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* launched = static_cast<int*>(grids);
  *launched = 0;
#define JOINT_W(T_, TP_)                                                                      \
  launch_bwd_w<T_, TP_>(enc, pred, w, bias, lab, logz, gb, ge, xbuf, part, dbpart, dw, db,     \
                        launched, st, B, T, U1, J, V, Vp, blank, n_chunks)
  return static_cast<int>(is_bf16 ? (pred_bf16 ? JOINT_W(bf16, bf16) : JOINT_W(bf16, float))
                                  : (pred_bf16 ? JOINT_W(float, bf16) : JOINT_W(float, float)));
#undef JOINT_W
}
