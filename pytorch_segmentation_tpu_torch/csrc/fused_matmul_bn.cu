// BN-apply + activation + 1x1 convolution (a matrix product) + BN statistics in
// one pass, forward and backward, and the channels-major product of the
// layout benchmark, written for Hopper (sm_90a).
//
// Replaces pytorch_segmentation_tpu/ops/pallas/fused_matmul_bn.py
// (fused_bn_act_matmul -> _fwd_kernel, _bwd_dx_kernel, _bwd_dw_kernel) and
// tools/bench_cmajor.py (pallas_cmajor -> _mm_kernel). With x [N, K], the
// previous layer's folded BN (scale, shift) [K] and W [K, M]:
//
//   forward   z = act(x * scale + shift)      in x's type: the product is
//                                             rounded, then the sum
//             y32 = z @ W                     f32 sums of exact products
//             y = y32 rounded to x's type; col_sum = sum_n y32, col_sumsq =
//             sum_n y32^2, both from the f32 sums before that rounding
//   backward  dy_tot = dy + dsum + 2 * y32 * dsumsq, rounded to x's type (the
//             statistics' cotangents folded into the product's)
//             dz = (dy_tot @ W^T) * act'(pre), pre = x * scale + shift in f32
//             dx = dz * scale; dscale = sum_n dz * x; dshift = sum_n dz
//             dW = z^T @ dy_tot
//   cmajor    Y[co, pix] = W[co, ci] @ X[ci, pix], bf16 operands, f32 out
//
// The TPU kernels walk a sequential grid: the statistics' row partials, the
// dz tile carried in scratch over the column steps and the dW block summed
// over the row steps all lean on grid steps running in order on one core.
// Here blocks run in no order, so every reduction across blocks is written
// as f32 partials (one slot per block, no atomics) that the wrapper sums in a
// fixed order: two launches give the same bits. The VMEM tile rules, the
// (1, 8, lane) statistic tiles and the 512-wide column split are not carried
// over.
//
// One tile loop serves all four kernels: 256 threads (8 warps) own a C tile
// of 128 x 64 and each warp a 32 x 32 corner of it (2 x 2 accumulators of
// 16 x 16). Operands are staged 32 deep through two buffers in shared
// memory: the 16-byte global loads of step i + 1 are issued into registers
// before the products of step i and stored (the prologue applied on the
// way) after them, so one barrier per step suffices and the loads' latency
// hides behind the products. For bf16 the products are nvcuda::wmma
// m16n16k16 tensor-core instructions with f32 accumulators and the prologue
// runs on packed bf16 pairs (mul.rn then add.rn, which round exactly where
// the plain version does); the f32 instantiation is a plain FFMA loop in
// full f32 (no TF32): it exists so that a small f32 model on the card can
// be held against the CPU. Ragged edges are masked while a tile is staged
// (zeros), never padded in device memory.
//
// The dx kernel owns a 128-row tile and works in two phases. Phase 1 repeats
// the forward's loop per 64 columns of M and writes dy_tot [N, M] in x's
// type to a scratch buffer in device memory; phase 2 reads it back (the same
// block wrote it, so it comes from the L2) and forms dz 64 columns of K at a
// time, so a [128, K] f32 dz never has to fit in registers or shared memory.
// The dW kernel then reads the same dy_tot instead of recomputing y32 per
// (K tile, M tile), which would repeat the forward's product K/128 times;
// the price is one more write and read of an [N, M] array (as large as dy).
// y32 is recomputed exactly once per backward (phase 1). N is split over
// blocks in the dW kernel (the wrapper picks the split from N, K, M so that
// the card is full while the [splits, K, M] partials stay small).
//
// What bounds them on an H100: at the ResNet-50 shapes of the train step
// (N = 532,512 down to 34,848; K, M = 64..2048) the wide layers are bound by
// operations (2 N K M at 989 TFLOP/s in bf16) and the 64..256-channel layers
// of stage 1 by bytes (x read once, y written once at 3.35 TB/s). A wmma loop
// through register-staged double buffers reaches a fraction of the tensor
// cores' rate; wgmma, TMA and a deeper ring of tiles are the later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // rows of a C tile
constexpr int kBN = 64;        // columns of a C tile
constexpr int kLdc = kBN + 4;  // leading dimension of the f32 C tile
constexpr int kParts = kThreads / kBN;  // row groups of a column reduction

template <typename T>
struct Tile {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte access
  static constexpr int kPad = kVec;                 // shifts rows across banks
  // depth of one staged step; 64 for bf16 was no faster on an H100 (128
  // registers in every kernel, the same times)
  static constexpr int kBK = 32;
  static constexpr int kLdA = kBK + kPad;    // [kBM][kBK], row-major
  static constexpr int kLdAT = kBM + kPad;   // [kBK][kBM], the transposed use
  static constexpr int kLdB = kBN + kPad;    // [kBK][kBN], row-major
  static constexpr int kLdBT = kBK + kPad;   // [kBN][kBK], the transposed use
  static constexpr int kAElems = kBM * kLdA;   // >= kBK * kLdAT
  static constexpr int kBElems = kBN * kLdBT;  // >= kBK * kLdB
  static constexpr size_t kABytes = sizeof(T) * kAElems;
  static constexpr size_t kBBytes = sizeof(T) * kBElems;
  // two staging buffers of each operand; the dx kernel's column reduction
  // borrows the space between two tile loops
  static constexpr size_t kStageBytes = 2 * (kABytes + kBBytes);
  static constexpr size_t kCBytes = sizeof(float) * kBM * kLdc;
  static constexpr size_t kRedBytes = sizeof(float) * 2 * kParts * kBN;
  static constexpr size_t kBytes = kStageBytes + kCBytes + kRedBytes;
  // the dx epilogue: a thread owns kVec columns and every kRowLanes-th row
  static constexpr int kColGroups = kBN / kVec;
  static constexpr int kRowLanes = kThreads / kColGroups;
};

static_assert(Tile<__nv_bfloat16>::kAElems >= Tile<__nv_bfloat16>::kBK * Tile<__nv_bfloat16>::kLdAT, "A");
static_assert(Tile<__nv_bfloat16>::kBElems >= Tile<__nv_bfloat16>::kBK * Tile<__nv_bfloat16>::kLdB, "B");
static_assert(Tile<float>::kAElems >= Tile<float>::kBK * Tile<float>::kLdAT, "A");
static_assert(Tile<float>::kBElems >= Tile<float>::kBK * Tile<float>::kLdB, "B");
static_assert(Tile<__nv_bfloat16>::kABytes % 128 == 0 &&
              Tile<__nv_bfloat16>::kBBytes % 128 == 0 &&
              Tile<float>::kABytes % 128 == 0 &&
              Tile<float>::kBBytes % 128 == 0, "regions stay 128-byte aligned");
static_assert(Tile<__nv_bfloat16>::kStageBytes >=
                  sizeof(float) * 2 * Tile<__nv_bfloat16>::kRowLanes * kBN &&
              Tile<float>::kStageBytes >=
                  sizeof(float) * 2 * Tile<float>::kRowLanes * kBN,
              "the dx reduction fits the staging buffers");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// act: 0 = none, 1 = relu, 2 = relu6
__device__ __forceinline__ bool act_grad_mask(float pre, int act) {
  if (act == 1) return pre > 0.0f;
  if (act == 2) return pre > 0.0f && pre < 6.0f;
  return true;
}

// The previous BatchNorm's fold for the kVec columns of K from `col`, in the
// form the prologue multiplies and adds with: scale and shift rounded to
// x's type. A thread's vectors of one staged tile share their columns, so
// it is made once per step.
template <typename T>
struct Fold;

template <>
struct Fold<__nv_bfloat16> {
  __nv_bfloat162 scale[4], shift[4];
  __device__ __forceinline__ void load(const float* s, const float* b,
                                       int64_t col) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 sv = *reinterpret_cast<const float4*>(s + col + 4 * h);
      const float4 bv = *reinterpret_cast<const float4*>(b + col + 4 * h);
      scale[2 * h] = __floats2bfloat162_rn(sv.x, sv.y);
      scale[2 * h + 1] = __floats2bfloat162_rn(sv.z, sv.w);
      shift[2 * h] = __floats2bfloat162_rn(bv.x, bv.y);
      shift[2 * h + 1] = __floats2bfloat162_rn(bv.z, bv.w);
    }
  }
  // z = act(x * scale + shift) on one 16-byte vector, rounded where the
  // plain version rounds: mul.rn, then add.rn, on packed pairs. The plain
  // version forms both in f32 and rounds each to bf16: the f32 product of
  // two bf16 values is exact, and the f32 sum of two bf16 values is either
  // exact or so lopsided that it rounds to the larger one either way, so one
  // rounding and two give the same bits. The _rn forms keep the compiler
  // from contracting the pair into one fused multiply-add.
  __device__ __forceinline__ void apply(uint4& v, int act) const {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
    const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
    const __nv_bfloat162 six = __float2bfloat162_rn(6.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 q = __hadd2_rn(__hmul2_rn(p[i], scale[i]), shift[i]);
      if (act != 0) q = __hmax2(q, zero);
      if (act == 2) q = __hmin2(q, six);
      p[i] = q;
    }
  }
};

template <>
struct Fold<float> {
  float4 scale, shift;
  __device__ __forceinline__ void load(const float* s, const float* b,
                                       int64_t col) {
    scale = *reinterpret_cast<const float4*>(s + col);
    shift = *reinterpret_cast<const float4*>(b + col);
  }
  __device__ __forceinline__ void apply(uint4& v, int act) const {
    float* p = reinterpret_cast<float*>(&v);
    const float sv[4] = {scale.x, scale.y, scale.z, scale.w};
    const float bv[4] = {shift.x, shift.y, shift.z, shift.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float q = __fadd_rn(__fmul_rn(p[i], sv[i]), bv[i]);
      if (act != 0) q = fmaxf(q, 0.0f);
      if (act == 2) q = fminf(q, 6.0f);
      p[i] = q;
    }
  }
};

// Where one operand's tiles come from: the row-major matrix `p` (leading
// dimension ld); step i of a tile loop takes the tile whose top-left element
// is (row + i * row_step, col + i * col_step). Elements at or beyond
// row_limit / col_limit read as zeros. col, col_step, col_limit and ld are
// multiples of the vector width, so a 16-byte vector lies wholly inside or
// outside.
template <typename T>
struct Src {
  const T* p;
  int64_t ld, row, col, row_step, col_step, row_limit, col_limit;
};

// One kRows x kCols operand tile on its way to shared memory: fetch() issues
// the 16-byte global loads into registers, commit() stores them (with
// kPrologue the columns index K and every vector goes through the prologue).
template <typename T, int kRows, int kCols, bool kPrologue>
struct Stage {
  static constexpr int kVec = Tile<T>::kVec;
  static constexpr int kVecsPerRow = kCols / kVec;
  static constexpr int kCount = kRows * kVecsPerRow / kThreads;
  static_assert(kRows * kVecsPerRow % kThreads == 0, "whole vectors a thread");
  uint4 v[kCount];
  unsigned inside;  // bit j: vector j lies inside the matrix

  __device__ __forceinline__ void fetch(const Src<T>& src, int step) {
    const int64_t row0 = src.row + step * src.row_step;
    const int64_t col0 = src.col + step * src.col_step;
    inside = 0u;
#pragma unroll
    for (int j = 0; j < kCount; ++j) {
      const int at = threadIdx.x + j * kThreads;
      const int64_t grow = row0 + at / kVecsPerRow;
      const int64_t gcol = col0 + (at % kVecsPerRow) * kVec;
      if (grow < src.row_limit && gcol < src.col_limit) {
        v[j] = *reinterpret_cast<const uint4*>(src.p + grow * src.ld + gcol);
        inside |= 1u << j;
      } else {
        v[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  __device__ __forceinline__ void commit(T* dst, int ld, const Src<T>& src,
                                         int step, const float* scale,
                                         const float* shift, int act) {
    // every vector of this thread starts in the same column of the tile
    static_assert(kThreads % kVecsPerRow == 0, "one column group a thread");
    const int c = (threadIdx.x % kVecsPerRow) * kVec;
    Fold<T> fold;
    if constexpr (kPrologue) {
      const int64_t gcol = src.col + step * src.col_step + c;
      if (gcol < src.col_limit) fold.load(scale, shift, gcol);
    }
#pragma unroll
    for (int j = 0; j < kCount; ++j) {
      const int r = (threadIdx.x + j * kThreads) / kVecsPerRow;
      if constexpr (kPrologue) {
        if (inside & (1u << j)) fold.apply(v[j], act);
      }
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v[j];
    }
  }
};

// The accumulators of one warp: the 32 x 32 corner of the 128 x 64 C tile at
// rows 32 (warp >> 1), columns 32 (warp & 1), as 2 x 2 sub-tiles of 16 x 16.
// mma() adds A[rows, kBK] @ B[kBK, 64] from shared memory. A(r, k) is
// As[r * lda + k], or As[k * lda + r] when kAT; B(k, c) is Bs[k * ldb + c],
// or Bs[c * ldb + k] when kBT. Sub-tiles at or beyond `rows` are skipped
// (their rows are zeros).
template <typename T>
struct Acc;

template <>
struct Acc<__nv_bfloat16> {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);
    }
  }

  template <bool kAT, bool kBT>
  __device__ __forceinline__ void mma(const __nv_bfloat16* As, int lda,
                                      const __nv_bfloat16* Bs, int ldb,
                                      int rows) {
    using ALayout = typename std::conditional<kAT, wmma::col_major,
                                              wmma::row_major>::type;
    using BLayout = typename std::conditional<kBT, wmma::col_major,
                                              wmma::row_major>::type;
    constexpr int kBK = Tile<__nv_bfloat16>::kBK;
    const int warp = threadIdx.x >> 5;
    const int r0 = (warp >> 1) * 32, c0 = (warp & 1) * 32;
    if (r0 >= rows) return;  // uniform over the warp
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cc = c0 + 16 * j;
        wmma::load_matrix_sync(
            b[j], kBT ? Bs + cc * ldb + kk : Bs + kk * ldb + cc, ldb);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = r0 + 16 * i;
        if (rr < rows) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a;
          wmma::load_matrix_sync(
              a, kAT ? As + kk * lda + rr : As + rr * lda + kk, lda);
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a, b[j], c[i][j]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* Cs) {
    const int warp = threadIdx.x >> 5;
    const int r0 = (warp >> 1) * 32, c0 = (warp & 1) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(Cs + (r0 + 16 * i) * kLdc + c0 + 16 * j,
                                c[i][j], kLdc, wmma::mem_row_major);
      }
    }
  }
};

// Full f32 on the CUDA cores: a lane owns row (lane >> 1) and 8 columns of
// each 16x16 sub-tile.
template <>
struct Acc<float> {
  float c[2][2][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 8; ++e) c[i][j][e] = 0.0f;
      }
    }
  }

  template <bool kAT, bool kBT>
  __device__ __forceinline__ void mma(const float* As, int lda,
                                      const float* Bs, int ldb, int rows) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = (warp >> 1) * 32 + (lane >> 1);
    const int c0 = (warp & 1) * 32 + (lane & 1) * 8;
    if ((warp >> 1) * 32 >= rows) return;
    for (int kk = 0; kk < Tile<float>::kBK; ++kk) {
      float b[2][8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int cc = c0 + 16 * j + e;
          b[j][e] = kBT ? Bs[cc * ldb + kk] : Bs[kk * ldb + cc];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = r0 + 16 * i;
        const float a = kAT ? As[kk * lda + rr] : As[rr * lda + kk];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 8; ++e) c[i][j][e] = fmaf(a, b[j][e], c[i][j][e]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* Cs) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = (warp >> 1) * 32 + (lane >> 1);
    const int c0 = (warp & 1) * 32 + (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          Cs[(r0 + 16 * i) * kLdc + c0 + 16 * j + e] = c[i][j][e];
        }
      }
    }
  }
};

template <typename T>
struct Smem {
  unsigned char* stage;  // [A0][A1][B0][B1]
  float* c;
  float* red;  // [2][kParts][kBN]
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    stage = raw;
    c = reinterpret_cast<float*>(raw + Tile<T>::kStageBytes);
    red = reinterpret_cast<float*>(raw + Tile<T>::kStageBytes +
                                   Tile<T>::kCBytes);
  }
  __device__ __forceinline__ T* a(int buf) const {
    return reinterpret_cast<T*>(stage + buf * Tile<T>::kABytes);
  }
  __device__ __forceinline__ T* b(int buf) const {
    return reinterpret_cast<T*>(stage + 2 * Tile<T>::kABytes +
                                buf * Tile<T>::kBBytes);
  }
};

// acc = sum over `steps` staged steps of A_i @ B_i, the A tiles kAR x kAC
// from `a` (through the prologue when kPrologue), the B tiles kBR x kBC from
// `b`. Step i + 1's global loads are in flight during step i's products, and
// the two staging buffers alternate, so one barrier a step is enough: a
// thread can only write a buffer again after every thread has passed the
// barrier that follows its last reads. Ends with a barrier: the staging
// buffers are free.
template <typename T, int kAR, int kAC, bool kPrologue, bool kAT, int kBR,
          int kBC, bool kBT>
__device__ __forceinline__ void tile_loop(
    Acc<T>& acc, const Smem<T>& sm, const Src<T>& a, const Src<T>& b,
    int steps, int lda, int ldb, int rows, const float* scale,
    const float* shift, int act) {
  Stage<T, kAR, kAC, kPrologue> sa;
  Stage<T, kBR, kBC, false> sb;
  acc.zero();
  sa.fetch(a, 0);
  sb.fetch(b, 0);
  for (int i = 0; i < steps; ++i) {
    const int buf = i & 1;
    sa.commit(sm.a(buf), lda, a, i, scale, shift, act);
    sb.commit(sm.b(buf), ldb, b, i, nullptr, nullptr, 0);
    __syncthreads();
    if (i + 1 < steps) {
      sa.fetch(a, i + 1);
      sb.fetch(b, i + 1);
    }
    acc.template mma<kAT, kBT>(sm.a(buf), lda, sm.b(buf), ldb, rows);
  }
  __syncthreads();
}

// acc = z[row0 .. row0 + 128, :] @ W[:, col0 .. col0 + 64], z staged through
// the prologue.
template <typename T>
__device__ __forceinline__ void product_z_w(
    Acc<T>& acc, const Smem<T>& sm, const T* x, const float* scale,
    const float* shift, const T* w, int64_t n, int k, int m, int act,
    int64_t row0, int col0) {
  constexpr int kBK = Tile<T>::kBK;
  const Src<T> a = {x, k, row0, 0, 0, kBK, n, k};
  const Src<T> b = {w, m, 0, col0, kBK, 0, k, m};
  tile_loop<T, kBM, kBK, true, false, kBK, kBN, false>(
      acc, sm, a, b, (k + kBK - 1) / kBK, Tile<T>::kLdA, Tile<T>::kLdB, kBM,
      scale, shift, act);
}

// Sum the per-thread pair (s0, s1) of column `c`, row group `part`, over the
// row groups in a fixed order; the first 64 threads return the totals.
__device__ __forceinline__ void reduce_parts(float* red, int c, int part,
                                             float& s0, float& s1) {
  red[part * kBN + c] = s0;
  red[(kParts + part) * kBN + c] = s1;
  __syncthreads();
  if (part == 0) {
    s0 = red[c];
    s1 = red[kParts * kBN + c];
#pragma unroll
    for (int p = 1; p < kParts; ++p) {
      s0 += red[p * kBN + c];
      s1 += red[(kParts + p) * kBN + c];
    }
  }
  __syncthreads();
}

// grid: row_tiles * col_tiles blocks, the column tile fastest, so the blocks
// that share a row tile of x run together. partials: [row_tiles, 2, M].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) fwd_kernel(
    const T* x, const float* scale, const float* shift, const T* w, T* y,
    float* partials, int64_t n, int k, int m, int act, int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm(smem_raw);
  constexpr int kVec = Tile<T>::kVec;
  const int64_t row_tile = blockIdx.x / col_tiles;
  const int col0 = (int)(blockIdx.x % col_tiles) * kBN;
  const int64_t row0 = row_tile * kBM;

  Acc<T> acc;
  product_z_w<T>(acc, sm, x, scale, shift, w, n, k, m, act, row0, col0);
  acc.store(sm.c);
  __syncthreads();

  // y: the f32 sums rounded once
  for (int v = threadIdx.x; v < kBM * (kBN / kVec); v += kThreads) {
    const int r = v / (kBN / kVec);
    const int c = (v - r * (kBN / kVec)) * kVec;
    if (row0 + r < n && col0 + c < m) {
      __align__(16) T e[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) from_f32(sm.c[r * kLdc + c + i], &e[i]);
      *reinterpret_cast<uint4*>(y + (row0 + r) * m + col0 + c) =
          *reinterpret_cast<const uint4*>(e);
    }
  }
  // the statistics from the f32 sums; rows at or beyond n are exact zeros
  const int c = threadIdx.x & (kBN - 1), part = threadIdx.x / kBN;
  float s = 0.0f, ss = 0.0f;
  for (int r = part * (kBM / kParts); r < (part + 1) * (kBM / kParts); ++r) {
    const float v = sm.c[r * kLdc + c];
    s += v;
    ss = fmaf(v, v, ss);
  }
  reduce_parts(sm.red, c, part, s, ss);
  if (part == 0 && col0 + c < m) {
    partials[(row_tile * 2 + 0) * m + col0 + c] = s;
    partials[(row_tile * 2 + 1) * m + col0 + c] = ss;
  }
}

// grid: one block per 128-row tile. dy_tot [N, M] is written in phase 1 and
// read back in phase 2 by the same block (after a barrier; read through
// plain loads, never the read-only path). partials: [row_tiles, 2, K].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) bwd_dx_kernel(
    const T* x, const float* scale, const float* shift, const T* w,
    const T* dy, const float* dsum, const float* dsumsq, T* dy_tot, T* dx,
    float* partials, int64_t n, int k, int m, int act) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm(smem_raw);
  constexpr int kVec = Tile<T>::kVec;
  constexpr int kBK = Tile<T>::kBK;
  constexpr int kColGroups = Tile<T>::kColGroups;
  constexpr int kRowLanes = Tile<T>::kRowLanes;
  const int64_t row_tile = blockIdx.x;
  const int64_t row0 = row_tile * kBM;
  Acc<T> acc;

  // phase 1: dy_tot = dy + dsum + 2 y32 dsumsq, each f32 operation rounded
  // on its own as the plain version's are, then rounded to x's type
  for (int col0 = 0; col0 < m; col0 += kBN) {
    product_z_w<T>(acc, sm, x, scale, shift, w, n, k, m, act, row0, col0);
    acc.store(sm.c);
    __syncthreads();
    for (int v = threadIdx.x; v < kBM * (kBN / kVec); v += kThreads) {
      const int r = v / (kBN / kVec);
      const int c = (v - r * (kBN / kVec)) * kVec;
      if (row0 + r < n && col0 + c < m) {
        const int64_t at = (row0 + r) * m + col0 + c;
        __align__(16) T e[kVec];
        *reinterpret_cast<uint4*>(e) =
            *reinterpret_cast<const uint4*>(dy + at);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float y32 = sm.c[r * kLdc + c + i];
          const float t = __fadd_rn(
              __fadd_rn(to_f32(e[i]), dsum[col0 + c + i]),
              __fmul_rn(2.0f * y32, dsumsq[col0 + c + i]));
          from_f32(t, &e[i]);
        }
        *reinterpret_cast<uint4*>(dy_tot + at) =
            *reinterpret_cast<const uint4*>(e);
      }
    }
    __syncthreads();
  }

  // phase 2: dz = dy_tot @ W^T, 64 columns of K at a time
  const int group = threadIdx.x % kColGroups;
  const int row_lane = threadIdx.x / kColGroups;
  float* red = reinterpret_cast<float*>(sm.stage);  // [2][kRowLanes][kBN]
  for (int kc = 0; kc < k; kc += kBN) {
    const Src<T> a = {dy_tot, m, row0, 0, 0, kBK, n, m};
    // W[kc .. kc + 64, m0 .. m0 + 32], read as its transpose
    const Src<T> b = {w, m, kc, 0, 0, kBK, k, m};
    tile_loop<T, kBM, kBK, false, false, kBN, kBK, true>(
        acc, sm, a, b, (m + kBK - 1) / kBK, Tile<T>::kLdA, Tile<T>::kLdBT,
        kBM, nullptr, nullptr, 0);
    acc.store(sm.c);
    __syncthreads();
    // the mask from the f32 pre; dx, and this tile's share of dscale and
    // dshift: a thread owns kVec columns and every kRowLanes-th row
    const int c = group * kVec;
    const int gk = kc + c;
    float dsc[kVec], dsh[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) dsc[i] = dsh[i] = 0.0f;
    if (gk < k) {
      float sc[kVec], sh[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sc[i] = scale[gk + i];
        sh[i] = shift[gk + i];
      }
#pragma unroll
      for (int r = row_lane; r < kBM; r += kRowLanes) {
        if (row0 + r < n) {
          const int64_t at = (row0 + r) * k + gk;
          __align__(16) T e[kVec];
          *reinterpret_cast<uint4*>(e) =
              *reinterpret_cast<const uint4*>(x + at);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float xv = to_f32(e[i]);
            const float pre = __fadd_rn(__fmul_rn(xv, sc[i]), sh[i]);
            const float dz =
                act_grad_mask(pre, act) ? sm.c[r * kLdc + c + i] : 0.0f;
            from_f32(__fmul_rn(dz, sc[i]), &e[i]);
            dsc[i] += __fmul_rn(dz, xv);
            dsh[i] += dz;
          }
          *reinterpret_cast<uint4*>(dx + at) =
              *reinterpret_cast<const uint4*>(e);
        }
      }
    }
    // the staging buffers are free between two tile loops
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      red[row_lane * kBN + c + i] = dsc[i];
      red[(kRowLanes + row_lane) * kBN + c + i] = dsh[i];
    }
    __syncthreads();
    if (threadIdx.x < 2 * kBN) {
      const int which = threadIdx.x / kBN, col = threadIdx.x % kBN;
      float total = 0.0f;
      for (int l = 0; l < kRowLanes; ++l) {
        total += red[(which * kRowLanes + l) * kBN + col];
      }
      if (kc + col < k) {
        partials[(row_tile * 2 + which) * k + kc + col] = total;
      }
    }
    __syncthreads();
  }
}

// grid: splits * k_tiles * m_tiles blocks. Block (split, kt, mt) sums
// z^T @ dy_tot over its rows [split * rows_per_split, ...) into
// partials[split, kt * 128 .., mt * 64 ..]; partials: [splits, K, M] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) bwd_dw_kernel(
    const T* x, const float* scale, const float* shift, const T* dy_tot,
    float* partials, int64_t n, int k, int m, int act, int k_tiles,
    int m_tiles, int64_t rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm(smem_raw);
  constexpr int kBK = Tile<T>::kBK;
  const int tiles = k_tiles * m_tiles;
  const int64_t split = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x % tiles);
  const int k0 = (tile / m_tiles) * kBM;
  const int col0 = (tile % m_tiles) * kBN;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_end =
      r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int rows = k - k0 < kBM ? k - k0 : kBM;
  const int steps =
      r_end > r_begin ? (int)((r_end - r_begin + kBK - 1) / kBK) : 0;

  Acc<T> acc;
  // z[r .. r + 32, k0 .. k0 + 128], read as its transpose
  const Src<T> a = {x, k, r_begin, k0, kBK, 0, r_end, k};
  const Src<T> b = {dy_tot, m, r_begin, col0, kBK, 0, r_end, m};
  tile_loop<T, kBK, kBM, true, true, kBK, kBN, false>(
      acc, sm, a, b, steps, Tile<T>::kLdAT, Tile<T>::kLdB, rows, scale,
      shift, act);
  acc.store(sm.c);
  __syncthreads();
  float* out = partials + split * (int64_t)k * m;
  for (int v = threadIdx.x; v < kBM * (kBN / 4); v += kThreads) {
    const int r = v / (kBN / 4);
    const int c = (v - r * (kBN / 4)) * 4;
    if (k0 + r < k && col0 + c < m) {
      *reinterpret_cast<float4*>(out + (int64_t)(k0 + r) * m + col0 + c) =
          *reinterpret_cast<const float4*>(sm.c + r * kLdc + c);
    }
  }
}

// grid: pix_tiles * co_tiles blocks, the co tile fastest, so the blocks that
// share a pixel tile of X run together.
__global__ void __launch_bounds__(kThreads, 2) cmajor_kernel(
    const __nv_bfloat16* w, const __nv_bfloat16* x, float* y, int co, int ci,
    int64_t pix, int co_tiles) {
  using T = __nv_bfloat16;
  constexpr int kBK = Tile<T>::kBK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem<T> sm(smem_raw);
  const int row0 = (int)(blockIdx.x % co_tiles) * kBM;
  const int64_t col0 = (int64_t)(blockIdx.x / co_tiles) * kBN;
  const int rows = co - row0 < kBM ? co - row0 : kBM;

  Acc<T> acc;
  const Src<T> a = {w, ci, row0, 0, 0, kBK, co, ci};
  const Src<T> b = {x, pix, 0, col0, kBK, 0, ci, pix};
  tile_loop<T, kBM, kBK, false, false, kBK, kBN, false>(
      acc, sm, a, b, (ci + kBK - 1) / kBK, Tile<T>::kLdA, Tile<T>::kLdB, rows,
      nullptr, nullptr, 0);
  acc.store(sm.c);
  __syncthreads();
  for (int v = threadIdx.x; v < kBM * (kBN / 4); v += kThreads) {
    const int r = v / (kBN / 4);
    const int c = (v - r * (kBN / 4)) * 4;
    if (row0 + r < co && col0 + c < pix) {
      *reinterpret_cast<float4*>(y + (int64_t)(row0 + r) * pix + col0 + c) =
          *reinterpret_cast<const float4*>(sm.c + r * kLdc + c);
    }
  }
}

template <typename K>
int allow_shared(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int64_t n, int k, int m) {
  return n < 1 || k < 8 || m < 8 || k % 8 != 0 || m % 8 != 0;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the dW kernel's splits are whole staged steps of either type
constexpr int kRowStep = 64;
static_assert(kRowStep % Tile<__nv_bfloat16>::kBK == 0 &&
              kRowStep % Tile<float>::kBK == 0, "row step");

}  // namespace

// Plain C entry points for ctypes. dtype: 0 = float32, 1 = bfloat16; act:
// 0 = none, 1 = relu, 2 = relu6. Every matrix is row-major and dense, every
// pointer 16-byte aligned, K and M multiples of 8; scale, shift, dsum and
// dsumsq are f32. Each returns cudaGetLastError() after its launch
// (0 = success) and neither allocates nor synchronises.

// y [N, M] in x's type; partials f32 [ceil(N / 128), 2, M]: each row tile's
// column sums and sums of squares.
extern "C" int pseg_fused_matmul_bn_fwd(
    const void* x, const void* scale, const void* shift, const void* w,
    void* y, void* partials, int dtype, int act, int64_t n, int k, int m,
    void* stream) {
  if (bad_shape(n, k, m) || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t col_tiles = ceil_div(m, kBN);
  const int64_t blocks = ceil_div(n, kBM) * col_tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PSEG_LAUNCH(T)                                                        \
  do {                                                                        \
    const int err = allow_shared(fwd_kernel<T>, Tile<T>::kBytes);             \
    if (err != 0) return err;                                                 \
    fwd_kernel<T><<<(unsigned)blocks, kThreads, Tile<T>::kBytes, s>>>(        \
        (const T*)x, (const float*)scale, (const float*)shift, (const T*)w,   \
        (T*)y, (float*)partials, n, k, m, act, (int)col_tiles);               \
  } while (0)
  if (dtype == 0) {
    PSEG_LAUNCH(float);
  } else if (dtype == 1) {
    PSEG_LAUNCH(__nv_bfloat16);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PSEG_LAUNCH
  return (int)cudaGetLastError();
}

// dy [N, M] and dx [N, K] in x's type; dy_tot [N, M] in x's type is written
// here and read by pseg_fused_matmul_bn_bwd_dw; partials f32
// [ceil(N / 128), 2, K]: each row tile's share of dscale and dshift.
extern "C" int pseg_fused_matmul_bn_bwd_dx(
    const void* x, const void* scale, const void* shift, const void* w,
    const void* dy, const void* dsum, const void* dsumsq, void* dy_tot,
    void* dx, void* partials, int dtype, int act, int64_t n, int k, int m,
    void* stream) {
  if (bad_shape(n, k, m) || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = ceil_div(n, kBM);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PSEG_LAUNCH(T)                                                        \
  do {                                                                        \
    const int err = allow_shared(bwd_dx_kernel<T>, Tile<T>::kBytes);          \
    if (err != 0) return err;                                                 \
    bwd_dx_kernel<T><<<(unsigned)blocks, kThreads, Tile<T>::kBytes, s>>>(     \
        (const T*)x, (const float*)scale, (const float*)shift, (const T*)w,   \
        (const T*)dy, (const float*)dsum, (const float*)dsumsq, (T*)dy_tot,   \
        (T*)dx, (float*)partials, n, k, m, act);                              \
  } while (0)
  if (dtype == 0) {
    PSEG_LAUNCH(float);
  } else if (dtype == 1) {
    PSEG_LAUNCH(__nv_bfloat16);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PSEG_LAUNCH
  return (int)cudaGetLastError();
}

// partials f32 [splits, K, M]: split s sums rows [s * rows_per_split,
// min(N, (s + 1) * rows_per_split)); rows_per_split is a multiple of 64.
extern "C" int pseg_fused_matmul_bn_bwd_dw(
    const void* x, const void* scale, const void* shift, const void* dy_tot,
    void* partials, int dtype, int act, int64_t n, int k, int m, int splits,
    int64_t rows_per_split, void* stream) {
  if (bad_shape(n, k, m) || act < 0 || act > 2 || splits < 1 ||
      rows_per_split < kRowStep || rows_per_split % kRowStep != 0 ||
      rows_per_split * splits < n) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t k_tiles = ceil_div(k, kBM), m_tiles = ceil_div(m, kBN);
  const int64_t blocks = k_tiles * m_tiles * splits;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PSEG_LAUNCH(T)                                                        \
  do {                                                                        \
    const int err = allow_shared(bwd_dw_kernel<T>, Tile<T>::kBytes);          \
    if (err != 0) return err;                                                 \
    bwd_dw_kernel<T><<<(unsigned)blocks, kThreads, Tile<T>::kBytes, s>>>(     \
        (const T*)x, (const float*)scale, (const float*)shift,                \
        (const T*)dy_tot, (float*)partials, n, k, m, act, (int)k_tiles,       \
        (int)m_tiles, rows_per_split);                                        \
  } while (0)
  if (dtype == 0) {
    PSEG_LAUNCH(float);
  } else if (dtype == 1) {
    PSEG_LAUNCH(__nv_bfloat16);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PSEG_LAUNCH
  return (int)cudaGetLastError();
}

// w [co, ci] and x [ci, pix] bf16, y [co, pix] f32; ci and pix multiples
// of 8.
extern "C" int pseg_cmajor_matmul(const void* w, const void* x, void* y,
                                  int co, int ci, int64_t pix, void* stream) {
  using T = __nv_bfloat16;
  if (co < 1 || ci < 8 || pix < 8 || ci % 8 != 0 || pix % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t co_tiles = ceil_div(co, kBM);
  const int64_t blocks = ceil_div(pix, kBN) * co_tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int err = allow_shared(cmajor_kernel, Tile<T>::kBytes);
  if (err != 0) return err;
  cmajor_kernel<<<(unsigned)blocks, kThreads, Tile<T>::kBytes,
                  (cudaStream_t)stream>>>((const T*)w, (const T*)x, (float*)y,
                                          co, ci, pix, (int)co_tiles);
  return (int)cudaGetLastError();
}
