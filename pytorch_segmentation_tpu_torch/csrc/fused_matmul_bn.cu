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
// Two main loops. The Hopper loop (namespace hop below: TMA into a ring of
// shared-memory stages, wgmma into f32 accumulators in registers, one
// producer warp and two consumer warpgroups, 128 x 64 or 128 x 128 tiles)
// runs every bf16 product: the forward (fwd_wgmma_kernel), dx as two full
// grids (dx_dy_tot_wgmma_kernel, then dx_dz_wgmma_kernel), dW
// (dw_wgmma_kernel) and the channels-major product (cmajor_wgmma_kernel).
// The older loop runs the f32 forward, dx and dW.
//
// The older loop: 256 threads (8 warps) own a C tile of 128 x 64 and each
// warp a 32 x 32 corner of it. Operands are staged 32 deep through two
// buffers in shared memory: the 16-byte global loads of step i + 1 are
// issued into registers before the products of step i and stored (the
// prologue applied on the way) after them, so one barrier per step
// suffices. The products are a plain FFMA loop in full f32 (no TF32): the
// loop exists so that a small f32 model on the card can be held against the
// CPU. Ragged edges are masked while a tile is staged (zeros), never padded
// in device memory.
//
// dx, whichever loop: y32 is recomputed exactly once per backward and
// dy_tot [N, M] is written in x's type, because the dW kernel reads it
// instead of recomputing y32 per (K tile, M tile), which would repeat the
// forward's product K/128 times; the price is one more write and read of an
// [N, M] array (as large as dy). The f32 dx owns a 128-row tile: phase 1
// repeats the forward's loop per 64 columns of M and writes dy_tot, phase 2
// reads it back (from the L2) and forms dz 64 columns of K at a time. The
// bf16 dx gives each product a full grid, because one block per row tile
// leaves most of the card idle at the deep stages (N = 34,848: 272 row
// tiles, each doing both products one after the other): (a) the forward's
// loop over (row tile, M tile) with a dy_tot epilogue, (b) dz = dy_tot @ W^T
// over (row tile, K tile) with W read K-major, whose epilogue reads the
// block's x tile, forms pre in f32, the mask and dx, and writes its dscale /
// dshift partials into a slot of its own.
//
// dW reduces over the N rows, and no shape of the ResNet-50 step has more
// than 64 output tiles of 128 x 128 (132 SMs): N is split over blocks, each
// split a whole number of 64-row stages, so that the (K tile, M tile,
// split) grid fills the card (the wrapper picks the split, dw_split); each
// block writes its f32 partial sums into a slot [split, K, M] of its own.
// Both of its operands hold the reduction outermost (x [N, K], dy_tot
// [N, M]), so the Hopper kernel reads both MN-major: wgmma's transposed
// forms of A = z^T and B = dy_tot, straight from the TMA boxes.
//
// What bounds the Hopper kernels at the ResNet-50 step's shapes (PERF.md
// section 6 has the bound and the time of each): stage 1 (N = 532,512,
// 64..256 channels) and stage 2 (N = 135,200) are bound by bytes, stages 3-4
// (N = 34,848) by bytes up to 1024 channels and by operations at 512 <->
// 2048. Against the operations, the loop issues m64nBNk16 wgmma from
// 128-byte-swizzled shared memory that TMA fills three or four stages
// ahead, with two blocks an SM so that one block's epilogue overlaps the
// other's loads. Against the bytes, the forward streams x once and writes y
// once; dx's two grids read x twice and write and read back dy_tot, which
// the narrow stage-1 shapes feel most. The dx epilogues issue their 16-byte
// loads kBatch at a time before the stores they feed, so that the loads
// overlap one another instead of each waiting for the store before it. The
// channels-major product is bound by bytes at every shape of its tool
// (mostly its f32 output): its epilogue stores 16 bytes a thread, a warp's
// stores covering 512 contiguous bytes of a row.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // rows of a C tile
constexpr int kBN = 64;        // columns of a C tile
constexpr int kLdc = kBN + 4;  // leading dimension of the f32 C tile
constexpr int kParts = kThreads / kBN;  // row groups of a column reduction

template <typename T>
struct Tile {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte access
  static constexpr int kPad = kVec;                 // shifts rows across banks
  static constexpr int kBK = 32;  // depth of one staged step
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

static_assert(Tile<float>::kAElems >= Tile<float>::kBK * Tile<float>::kLdAT, "A");
static_assert(Tile<float>::kBElems >= Tile<float>::kBK * Tile<float>::kLdB, "B");
static_assert(Tile<float>::kABytes % 128 == 0 &&
              Tile<float>::kBBytes % 128 == 0, "regions stay 128-byte aligned");
static_assert(Tile<float>::kStageBytes >=
                  sizeof(float) * 2 * Tile<float>::kRowLanes * kBN,
              "the f32 dx reduction fits the staging buffers");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }

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
// or Bs[c * ldb + k] when kBT. Warps whose rows lie at or beyond `rows` are
// skipped (their rows are zeros).
template <typename T>
struct Acc;

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

// The f32 forward (bf16 runs fwd_wgmma_kernel). grid: row_tiles * col_tiles
// blocks, the column tile fastest, so the blocks that share a row tile of x
// run together. partials: [row_tiles, 2, M].
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

// The f32 dx (bf16 runs the two dx_*_wgmma_kernel grids). grid: one block
// per 128-row tile. dy_tot [N, M] is written in phase 1 and
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

// The f32 dW (bf16 runs dw_wgmma_kernel). grid: splits * k_tiles * m_tiles
// blocks. Block (split, kt, mt) sums
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

template <typename K>
int allow_shared(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int64_t n, int k, int m) {
  return n < 1 || k < 8 || m < 8 || k % 8 != 0 || m % 8 != 0;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the dW kernels' splits are whole staged steps of either loop
constexpr int kRowStep = 64;
static_assert(kRowStep % Tile<float>::kBK == 0, "row step");

// A split of N over the dW kernels' blocks: whole row steps, every row in
// exactly one split, no split empty.
bool bad_split(int64_t n, int splits, int64_t rows_per_split) {
  return splits < 1 || rows_per_split < kRowStep ||
         rows_per_split % kRowStep != 0 || rows_per_split > 2147483647LL ||
         rows_per_split * splits < n || rows_per_split * (splits - 1) >= n;
}


// ---------------------------------------------------------------------------
// The Hopper main loop (bf16 only): TMA loads into a ring of shared-memory
// stages, wgmma from shared memory into f32 accumulators in registers.
//
// A block owns a 128 x BN tile of C = A @ B, summed over a depth in stages
// of 64. An operand's stage tile sits in shared memory as TMA writes it with
// the 128-byte swizzle (rows of 128 bytes, 8 rows to a swizzle period), in
// one of two forms; wgmma's transpose flags say which (legal for 16-bit
// types only):
//   K-major, the depth contiguous: a row per row of A (column of B), 64
//     deep, one TMA box of 64 x rows. The forward and dx's first grid take
//     A = x [N, K] and B = W^T [M, K] (the wrapper keeps that copy of the
//     weight beside W [K, M]); dx's second grid A = dy_tot [N, M] and
//     B = W [K, M]; the channels-major product A = W [co, ci].
//   MN-major, the rows of A (columns of B) contiguous: a row per step of the
//     depth, 64 wide, one box of 64 x 64 (8 KB) per 64 rows of A (columns of
//     B). dW takes A = z^T from x [N, K] and B = dy_tot [N, M]; the
//     channels-major product B = X [ci, pix].
// 288 threads: warpgroups 0 and 1 consume (rows 0-63 and 64-127 of the
// tile, m64nBNk16 wgmma; or, in a product of 64 rows at most, the same 64
// rows and a half of the columns each), the lane 0 of warp 8 produces: it
// waits for a stage to be released, arms its "full" barrier with the
// stage's byte count and issues the TMA loads (a box wholly outside the
// matrix is not loaded; its rows of C are not stored). A consumer
// warpgroup releases stage i - 1 once its wgmma group of stage i has been
// issued and that of i - 1 has completed, so one group stays in flight.
//
// The prologue reaches the A operand in shared memory: each consumer
// warpgroup rewrites its own 64 rows of 128 bytes of x in place, z = act(x
// * scale + shift) on packed bf16 pairs (the same mul.rn / add.rn as Fold
// above), rows at or beyond N set to exact zeros (TMA fills them with
// zeros, but act(0 * scale + shift) is not zero), then fences the generic
// writes against the async proxy that wgmma reads through. A row of the
// forward's K-major x tile and a row of dW's MN-major x box are both a row
// of x, so one rewrite serves both; the forward's fold follows the stage's
// columns, dW's is fixed for the block. That is the simpler of the two
// routes to a prologue on Hopper (the other keeps A in registers, the RS
// form of wgmma, which has no MN-major A): the x tile is read from shared
// memory once more and written back, but the loop stays one SS wgmma for
// every product. The fold (scale and shift rounded to bf16) is cached in
// shared memory once per block, zero beyond K, so padded columns give z = 0
// and never NaN.
// ---------------------------------------------------------------------------

namespace hop {

constexpr int kBM = 128;                   // rows of a C tile
constexpr int kBK = 64;                    // depth of a stage: one 128-byte row
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kRowBytes = kBK * 2;         // 128, the swizzle span
constexpr int kABytes = kBM * kRowBytes;   // 16 KB
constexpr int kGroupRows = 64;             // rows of a consumer warpgroup
constexpr int kBoxBytes = kGroupRows * kRowBytes;  // 8 KB: 64 rows of 128 B
constexpr int kBatch = 4;  // 16-byte loads a dx epilogue issues together

template <int BN>
struct Cfg {
  // 96 KB of ring either way, so that two blocks fit an SM
  static constexpr int kStages = BN == 64 ? 4 : 3;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kLdc = BN + 4;  // the f32 C tile, laid over the ring
  static constexpr int kCFloats = kBM * kLdc;
  // dx's epilogues: a thread owns 8 columns and every kRowLanes-th row
  static constexpr int kColGroups = BN / 8;
  static constexpr int kRowLanes = kConsumers / kColGroups;
  static_assert(4 * (kCFloats + 2 * kRowLanes * BN) <= kRingBytes,
                "the epilogues fit the ring");
  static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0,
                "every tile starts on a swizzle period");
  static_assert(kBM % (kBatch * kRowLanes) == 0,
                "the dx epilogues' batches cover the tile");
  // dynamic shared memory: alignment slack, the ring, the fold
  static size_t bytes(int fold_cols) {
    return 1024 + kRingBytes + (size_t)4 * fold_cols;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Until the phase of parity `parity` of the barrier has completed. A phase
// that never completes (a lost arrival or a transaction count that does not
// add up) traps after 4 s: the launch fails with an error instead of holding
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > 4000000000ull) {
      __trap();
    }
  }
}

// a box of the 2-D tensor map at (inner, outer) into shared memory; the
// barrier's transaction count falls by the box's bytes when it has landed
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner),
      "r"(outer)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The wgmma descriptor of an operand tile at p with the 128-byte swizzle
// (the fields of cute's GmmaDescriptor, cute/arch/mma_sm90_desc.hpp, as
// make_gmma_desc in cute/atom/mma_traits_sm90_gmma.hpp fills them; CUTLASS
// itself is not included). The stride offset steps 8 rows (1024 bytes) in
// both forms: along M or N in a K-major tile, along the depth in an
// MN-major one. The leading offset is unused in a K-major tile (a k16
// step's depth lies within one 128-byte row); in an MN-major one it steps
// from one 64-wide box to the next along M or N.
template <bool kMN>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  uint64_t desc = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  desc |= (uint64_t)(kMN ? kBoxBytes >> 4 : 1) << 16;  // leading offset
  desc |= (uint64_t)(1024 >> 4) << 32;                  // stride offset
  desc |= (uint64_t)1 << 62;                            // 128-byte swizzle
  return desc;
}

// How far a k16 step moves an operand's start: 32 bytes along the rows
// (K-major) or 16 rows down (MN-major).
__host__ __device__ constexpr int k16_bytes(bool mn) {
  return mn ? 16 * kRowBytes : 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// d += A @ B, one k16 step of a warpgroup; kTA / kTB: A / B MN-major (the
// transpose immediates)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB)
      : "memory");
}

template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB)
      : "memory");
}

template <int WN, bool kAMN, bool kBMN>
__device__ __forceinline__ void wgmma_tile(float (&d)[WN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (WN == 64) {
    wgmma_m64n64<kAMN, kBMN>(d, da, db);
  } else {
    wgmma_m64n128<kAMN, kBMN>(d, da, db);
  }
}

// The block's shared state. The barriers are static; the ring and the fold
// are dynamic, from the first 1024-byte boundary (the swizzle's period).
template <int BN>
struct Ring {
  unsigned char* base;
  __nv_bfloat162* fold_scale;  // [fold_cols / 2]
  __nv_bfloat162* fold_shift;
  __device__ __forceinline__ Ring(unsigned char* raw, int fold_cols) {
    const uint32_t addr = smem_u32(raw);
    base = raw + ((1024 - (addr & 1023)) & 1023);
    fold_scale = reinterpret_cast<__nv_bfloat162*>(base + Cfg<BN>::kRingBytes);
    fold_shift = fold_scale + fold_cols / 2;
  }
  __device__ __forceinline__ unsigned char* a(int s) const {
    return base + s * Cfg<BN>::kStageBytes;
  }
  __device__ __forceinline__ unsigned char* b(int s) const {
    return base + s * Cfg<BN>::kStageBytes + kABytes;
  }
  __device__ __forceinline__ float* c() const {
    return reinterpret_cast<float*>(base);
  }
};

// Set up the barriers and (with a prologue) the fold cache of the columns
// fold_col0 .. fold_col0 + fold_cols: every thread of the block, before the
// roles part.
template <int BN>
__device__ __forceinline__ void setup(const Ring<BN>& ring, uint64_t* full,
                                      uint64_t* empty, const float* scale,
                                      const float* shift, int k,
                                      int fold_col0, int fold_cols) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg<BN>::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one elected thread per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int p = threadIdx.x; p < fold_cols / 2; p += kThreads) {
    // K is a multiple of 8: a pair lies wholly inside or outside
    const int c = fold_col0 + 2 * p;
    const bool in = c < k;
    ring.fold_scale[p] = __floats2bfloat162_rn(in ? scale[c] : 0.0f,
                                               in ? scale[c + 1] : 0.0f);
    ring.fold_shift[p] = __floats2bfloat162_rn(in ? shift[c] : 0.0f,
                                               in ? shift[c + 1] : 0.0f);
  }
  __syncthreads();
}

// Where a stage's tile of one operand comes from: step i loads the box at
// (depth0 + 64 i, pos) when K-major, or `boxes` boxes side by side
// (kBoxBytes apart) at (pos + 64 j, depth0 + 64 i) when MN-major; `bytes`
// is what they land (a box counts whole, out-of-bounds fill included).
struct Operand {
  const CUtensorMap* map;
  int pos, depth0, boxes, bytes;
};

// How many of the 64-wide boxes of [pos, pos + width) hold part of a
// matrix `extent` wide (pos < extent).
__host__ __device__ __forceinline__ int box_count(int64_t extent,
                                                  int64_t pos, int width) {
  const int64_t left = (extent - pos + kGroupRows - 1) / kGroupRows;
  return left < width / kGroupRows ? (int)left : width / kGroupRows;
}

template <bool kMN>
__device__ __forceinline__ void load(unsigned char* dst, const Operand& o,
                                     uint64_t* bar, int i) {
  if constexpr (kMN) {
    for (int j = 0; j < o.boxes; ++j) {
      tma_load(dst + j * kBoxBytes, o.map, bar, o.pos + kGroupRows * j,
               o.depth0 + i * kBK);
    }
  } else {
    tma_load(dst, o.map, bar, o.depth0 + i * kBK, o.pos);
  }
}

// The producer: lane 0 of warp 8 keeps the ring full.
template <int BN, bool kAMN, bool kBMN>
__device__ __forceinline__ void produce(const Ring<BN>& ring, uint64_t* full,
                                        uint64_t* empty, const Operand& a,
                                        const Operand& b, int steps) {
  constexpr int S = Cfg<BN>::kStages;
  for (int i = 0; i < steps; ++i) {
    const int s = i % S;
    if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
    mbar_expect_tx(&full[s], a.bytes + b.bytes);
    load<kAMN>(ring.a(s), a, &full[s], i);
    load<kBMN>(ring.b(s), b, &full[s], i);
  }
}

// A consumer warpgroup: acc (64 x WN) = the sum over the steps of A_s @ B_s,
// its A rows from a_off in the stage's A tile, its B columns from b_off in
// the B tile. prologue(a, i) may rewrite A in place before step i's
// products (apply_fold).
template <int BN, int WN, bool kAMN, bool kBMN, class Prologue>
__device__ __forceinline__ void consume(float (&acc)[WN / 2],
                                        const Ring<BN>& ring, uint64_t* full,
                                        uint64_t* empty, int steps,
                                        int a_off, int b_off,
                                        const Prologue& prologue) {
  constexpr int S = Cfg<BN>::kStages;
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < WN / 2; ++j) acc[j] = 0.0f;
  for (int i = 0; i < steps; ++i) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    unsigned char* a = ring.a(s) + a_off;
    const unsigned char* b = ring.b(s) + b_off;
    prologue(a, i);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_tile<WN, kAMN, kBMN>(acc,
                                 smem_desc<kAMN>(a + kk * k16_bytes(kAMN)),
                                 smem_desc<kBMN>(b + kk * k16_bytes(kBMN)));
    }
    wgmma_commit();
    if (i > 0) {
      wgmma_wait<1>();
      if (t == 0) mbar_arrive(&empty[(i - 1) % S]);
    }
  }
  wgmma_wait<0>();
}

using bf16 = __nv_bfloat16;

// The column, from the start of a 64-column x box, of the 8 that this
// thread's chunk in apply_fold holds: the swizzle puts chunk p of row r at
// columns 8 (p ^ (r & 7)), and the thread's rows share r & 7.
__device__ __forceinline__ int fold_column() {
  const int t = threadIdx.x & 127;
  return 8 * ((t & 7) ^ ((t >> 3) & 7));
}

// The fold of the 8 columns from `col` of the block's cache.
template <int BN>
__device__ __forceinline__ Fold<bf16> cached_fold(const Ring<BN>& ring,
                                                  int col) {
  Fold<bf16> fold;
  const uint4 sv = *reinterpret_cast<const uint4*>(ring.fold_scale + col / 2);
  const uint4 bv = *reinterpret_cast<const uint4*>(ring.fold_shift + col / 2);
  const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
  const uint32_t bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    fold.scale[q] = *reinterpret_cast<const __nv_bfloat162*>(&sw[q]);
    fold.shift[q] = *reinterpret_cast<const __nv_bfloat162*>(&bw[q]);
  }
  return fold;
}

// z = act(x * scale + shift) in place on a consumer warpgroup's 64 rows of
// x at `a`: this thread's 16-byte chunk t % 8 of rows t / 8 + 16 j; rows at
// or beyond rows_left become zeros. Then the generic writes are fenced
// against the async proxy and the warpgroup waits for all of them.
__device__ __forceinline__ void apply_fold(unsigned char* a,
                                           const Fold<bf16>& fold,
                                           int64_t rows_left, int act) {
  const int t = threadIdx.x & 127;
  const int p = t & 7, r0 = t >> 3;
#pragma unroll
  for (int j = 0; j < kGroupRows / 16; ++j) {
    const int r = r0 + 16 * j;
    uint4* at = reinterpret_cast<uint4*>(a + r * kRowBytes + p * 16);
    uint4 v = *at;
    if (r < rows_left) {
      fold.apply(v, act);
    } else {
      v = make_uint4(0u, 0u, 0u, 0u);
    }
    *at = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(2 + (threadIdx.x >> 7), 128);
}

// A consumer warpgroup's accumulators (64 x WN) into the f32 C tile
// [128][kLdc] laid over the ring at (row0, col0), once neither warpgroup
// reads the ring any more. Fragment layout of m64nNk16: warp w of the group
// holds rows 16 w + lane / 4 (+ 8), and columns 8 j + 2 (lane % 4) (+ 1)
// of every 8-column group j.
template <int BN, int WN>
__device__ __forceinline__ void store_c(const float (&acc)[WN / 2],
                                        const Ring<BN>& ring, int row0,
                                        int col0) {
  constexpr int kLdc = Cfg<BN>::kLdc;
  named_sync(1, kConsumers);
  float* cs = ring.c();
  const int lane = threadIdx.x & 31;
  const int row = row0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(cs + row * kLdc + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(cs + (row + 8) * kLdc + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_sync(1, kConsumers);
}

// The first `rows` rows of the f32 C tile into out [.., ld] at (row0,
// col0), 16 bytes a thread (a warp's stores cover 512 contiguous bytes of a
// 128-column row); nothing at or beyond (row_limit, col_limit), col_limit a
// multiple of 4.
template <int BN>
__device__ __forceinline__ void write_c(const Ring<BN>& ring, int rows,
                                        float* out, int64_t ld, int64_t row0,
                                        int64_t col0, int64_t row_limit,
                                        int64_t col_limit) {
  constexpr int kLdc = Cfg<BN>::kLdc;
  const float* cs = ring.c();
  for (int v = threadIdx.x; v < rows * (BN / 4); v += kConsumers) {
    const int r = v / (BN / 4);
    const int c = (v - r * (BN / 4)) * 4;
    if (row0 + r < row_limit && col0 + c < col_limit) {
      *reinterpret_cast<float4*>(out + (row0 + r) * ld + col0 + c) =
          *reinterpret_cast<const float4*>(cs + r * kLdc + c);
    }
  }
}

// grid: row_tiles * col_tiles, the column tile fastest. ta: x [N, K] in
// boxes of 64 x 128; tb: W^T [M, K] in boxes of 64 x BN. partials:
// [row_tiles, 2, M], as fwd_kernel's.
template <int BN>
__global__ void __launch_bounds__(kThreads, 2) fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, const float* scale,
    const float* shift, bf16* y, float* partials, int64_t n, int k, int m,
    int act, int col_tiles, int fold_cols) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[Cfg<BN>::kStages];
  __shared__ __align__(8) uint64_t empty[Cfg<BN>::kStages];
  const Ring<BN> ring(smem_raw, fold_cols);
  const int64_t row_tile = blockIdx.x / col_tiles;
  const int col0 = (int)(blockIdx.x % col_tiles) * BN;
  const int64_t row0 = row_tile * kBM;
  const int steps = (k + kBK - 1) / kBK;
  setup<BN>(ring, full, empty, scale, shift, k, 0, fold_cols);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      produce<BN, false, false>(
          ring, full, empty, Operand{&ta, (int)row0, 0, 1, kABytes},
          Operand{&tb, col0, 0, 1, Cfg<BN>::kBBytes}, steps);
    }
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int64_t rows_left = n - row0 - wg * kGroupRows;
  const int fcol = fold_column();
  float acc[BN / 2];
  consume<BN, BN, false, false>(
      acc, ring, full, empty, steps, wg * kBoxBytes, 0,
      [&](unsigned char* a, int i) {
        apply_fold(a, cached_fold(ring, i * kBK + fcol), rows_left, act);
      });
  store_c<BN, BN>(acc, ring, wg * kGroupRows, 0);

  constexpr int kLdc = Cfg<BN>::kLdc;
  const float* cs = ring.c();
  // y: the f32 sums rounded once, 16 bytes a store
  for (int v = threadIdx.x; v < kBM * (BN / 8); v += kConsumers) {
    const int r = v / (BN / 8);
    const int c = (v - r * (BN / 8)) * 8;
    if (row0 + r < n && col0 + c < m) {
      __align__(16) bf16 e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = __float2bfloat16_rn(cs[r * kLdc + c + i]);
      }
      *reinterpret_cast<uint4*>(y + (row0 + r) * m + col0 + c) =
          *reinterpret_cast<const uint4*>(e);
    }
  }
  // the statistics from the f32 sums (rows at or beyond n are exact zeros),
  // summed over the row parts in a fixed order
  constexpr int kParts = kConsumers / BN;
  float* red = ring.c() + Cfg<BN>::kCFloats;
  const int c = threadIdx.x % BN, part = threadIdx.x / BN;
  float s = 0.0f, ss = 0.0f;
  for (int r = part * (kBM / kParts); r < (part + 1) * (kBM / kParts); ++r) {
    const float v = cs[r * kLdc + c];
    s += v;
    ss = fmaf(v, v, ss);
  }
  red[part * BN + c] = s;
  red[(kParts + part) * BN + c] = ss;
  named_sync(1, kConsumers);
  if (part == 0 && col0 + c < m) {
    for (int p = 1; p < kParts; ++p) {
      s += red[p * BN + c];
      ss += red[(kParts + p) * BN + c];
    }
    partials[(row_tile * 2 + 0) * m + col0 + c] = s;
    partials[(row_tile * 2 + 1) * m + col0 + c] = ss;
  }
}

// dx, first grid: the forward's loop over (row tile, M tile), then dy_tot =
// dy + dsum + 2 y32 dsumsq with each f32 operation rounded on its own,
// rounded to bf16.
template <int BN>
__global__ void __launch_bounds__(kThreads, 2) dx_dy_tot_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, const float* scale,
    const float* shift, const bf16* dy, const float* dsum,
    const float* dsumsq, bf16* dy_tot, int64_t n, int k, int m, int act,
    int col_tiles, int fold_cols) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[Cfg<BN>::kStages];
  __shared__ __align__(8) uint64_t empty[Cfg<BN>::kStages];
  const Ring<BN> ring(smem_raw, fold_cols);
  const int64_t row_tile = blockIdx.x / col_tiles;
  const int col0 = (int)(blockIdx.x % col_tiles) * BN;
  const int64_t row0 = row_tile * kBM;
  const int steps = (k + kBK - 1) / kBK;
  setup<BN>(ring, full, empty, scale, shift, k, 0, fold_cols);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      produce<BN, false, false>(
          ring, full, empty, Operand{&ta, (int)row0, 0, 1, kABytes},
          Operand{&tb, col0, 0, 1, Cfg<BN>::kBBytes}, steps);
    }
    return;
  }
  const int wg = threadIdx.x >> 7;
  const int64_t rows_left = n - row0 - wg * kGroupRows;
  const int fcol = fold_column();
  float acc[BN / 2];
  consume<BN, BN, false, false>(
      acc, ring, full, empty, steps, wg * kBoxBytes, 0,
      [&](unsigned char* a, int i) {
        apply_fold(a, cached_fold(ring, i * kBK + fcol), rows_left, act);
      });
  store_c<BN, BN>(acc, ring, wg * kGroupRows, 0);

  // A thread owns the same 8 columns in each of its vectors (the consumers
  // are a multiple of BN / 8). Its loads of dy are issued kBatch at a time
  // before the stores of dy_tot they feed: loads and stores interleaved one
  // by one would wait for one another (the compiler cannot tell the arrays
  // apart), and a whole tile's loads at once would spill at 128 columns.
  constexpr int kLdc = Cfg<BN>::kLdc;
  constexpr int kRowLanes = Cfg<BN>::kRowLanes;  // rows between vectors
  const float* cs = ring.c();
  const int c = (threadIdx.x % Cfg<BN>::kColGroups) * 8;
  const int r0 = threadIdx.x / Cfg<BN>::kColGroups;
  const bool col_in = col0 + c < m;
  float ds[8], dss[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ds[i] = col_in ? dsum[col0 + c + i] : 0.0f;
    dss[i] = col_in ? dsumsq[col0 + c + i] : 0.0f;
  }
#pragma unroll
  for (int b = 0; b < kBM / (kBatch * kRowLanes); ++b) {
    const int j0 = r0 + b * kBatch * kRowLanes;
    uint4 dyv[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int64_t row = row0 + j0 + j * kRowLanes;
      if (row < n && col_in) {
        dyv[j] = *reinterpret_cast<const uint4*>(dy + row * m + col0 + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int r = j0 + j * kRowLanes;
      if (row0 + r < n && col_in) {
        const bf16* e = reinterpret_cast<const bf16*>(&dyv[j]);
        __align__(16) bf16 out[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float y32 = cs[r * kLdc + c + i];
          const float t = __fadd_rn(__fadd_rn(__bfloat162float(e[i]), ds[i]),
                                    __fmul_rn(2.0f * y32, dss[i]));
          out[i] = __float2bfloat16_rn(t);
        }
        *reinterpret_cast<uint4*>(dy_tot + (row0 + r) * m + col0 + c) =
            *reinterpret_cast<const uint4*>(out);
      }
    }
  }
}

// dx, second grid: dz = dy_tot @ W^T over (row tile, K tile). ta: dy_tot
// [N, M] in boxes of 64 x 128; tb: W [K, M] in boxes of 64 x BN. The
// epilogue forms pre in f32 from x, the mask, dx = dz * scale, and this
// tile's dscale / dshift into its own slot of partials [row_tiles, 2, K].
template <int BN>
__global__ void __launch_bounds__(kThreads, 2) dx_dz_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, const bf16* x,
    const float* scale, const float* shift, bf16* dx, float* partials,
    int64_t n, int k, int m, int act, int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[Cfg<BN>::kStages];
  __shared__ __align__(8) uint64_t empty[Cfg<BN>::kStages];
  const Ring<BN> ring(smem_raw, 0);
  const int64_t row_tile = blockIdx.x / col_tiles;
  const int kc = (int)(blockIdx.x % col_tiles) * BN;
  const int64_t row0 = row_tile * kBM;
  const int steps = (m + kBK - 1) / kBK;
  setup<BN>(ring, full, empty, nullptr, nullptr, 0, 0, 0);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      produce<BN, false, false>(
          ring, full, empty, Operand{&ta, (int)row0, 0, 1, kABytes},
          Operand{&tb, kc, 0, 1, Cfg<BN>::kBBytes}, steps);
    }
    return;
  }
  float acc[BN / 2];
  consume<BN, BN, false, false>(acc, ring, full, empty, steps,
                                (threadIdx.x >> 7) * kBoxBytes, 0,
                                [](unsigned char*, int) {});
  store_c<BN, BN>(acc, ring, (threadIdx.x >> 7) * kGroupRows, 0);

  constexpr int kLdc = Cfg<BN>::kLdc;
  constexpr int kRowLanes = Cfg<BN>::kRowLanes;
  const float* cs = ring.c();
  float* red = ring.c() + Cfg<BN>::kCFloats;  // [2][kRowLanes][BN]
  const int group = threadIdx.x % Cfg<BN>::kColGroups;
  const int row_lane = threadIdx.x / Cfg<BN>::kColGroups;
  const int c = group * 8;
  const int gk = kc + c;
  float dsc[8], dsh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dsc[i] = dsh[i] = 0.0f;
  if (gk < k) {
    // loads of x kBatch at a time before the stores of dx, as in the first
    // grid; the rows in ascending order, so the sums' order is fixed
    float sc[8], sh[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[i] = scale[gk + i];
      sh[i] = shift[gk + i];
    }
#pragma unroll
    for (int b = 0; b < kBM / (kBatch * kRowLanes); ++b) {
      const int j0 = row_lane + b * kBatch * kRowLanes;
      uint4 xv[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int64_t row = row0 + j0 + j * kRowLanes;
        if (row < n) xv[j] = *reinterpret_cast<const uint4*>(x + row * k + gk);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = j0 + j * kRowLanes;
        if (row0 + r < n) {
          const bf16* e = reinterpret_cast<const bf16*>(&xv[j]);
          __align__(16) bf16 out[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float xf = __bfloat162float(e[i]);
            const float pre = __fadd_rn(__fmul_rn(xf, sc[i]), sh[i]);
            const float dz =
                act_grad_mask(pre, act) ? cs[r * kLdc + c + i] : 0.0f;
            out[i] = __float2bfloat16_rn(__fmul_rn(dz, sc[i]));
            dsc[i] += __fmul_rn(dz, xf);
            dsh[i] += dz;
          }
          *reinterpret_cast<uint4*>(dx + (row0 + r) * k + gk) =
              *reinterpret_cast<const uint4*>(out);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[row_lane * BN + c + i] = dsc[i];
    red[(kRowLanes + row_lane) * BN + c + i] = dsh[i];
  }
  named_sync(1, kConsumers);
  for (int o = threadIdx.x; o < 2 * BN; o += kConsumers) {
    const int which = o / BN, col = o % BN;
    float total = 0.0f;
    for (int l = 0; l < kRowLanes; ++l) {
      total += red[(which * kRowLanes + l) * BN + col];
    }
    if (kc + col < k) partials[(row_tile * 2 + which) * k + kc + col] = total;
  }
}

// dW: grid splits * tiles, the tile fastest (M tile, then K tile), so the
// blocks that read the same rows run together. Block (split, tile) sums
// z^T @ dy_tot over rows [split * rows_per_split, min(n, ...)) into its slot
// of partials [splits, K, M] f32. tx: x [N, K] and tdy: dy_tot [N, M], both
// in boxes of 64 x 64 read MN-major (the rows of N are the depth). A split
// is whole 64-row stages, so a stage never reaches into the next split;
// only the last split's last stage runs past N.
template <int BN>
__global__ void __launch_bounds__(kThreads, 2) dw_wgmma_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tdy, const float* scale,
    const float* shift, float* partials, int n, int k, int m, int act,
    int m_tiles, int tiles, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[Cfg<BN>::kStages];
  __shared__ __align__(8) uint64_t empty[Cfg<BN>::kStages];
  const Ring<BN> ring(smem_raw, kBM);
  const int split = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int k0 = (tile / m_tiles) * kBM;
  const int col0 = (tile % m_tiles) * BN;
  const int r_begin = split * rows_per_split;
  const int rows = min(n - r_begin, rows_per_split);
  const int steps = (rows + kBK - 1) / kBK;
  const int a_boxes = box_count(k, k0, kBM);
  setup<BN>(ring, full, empty, scale, shift, k, k0, kBM);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const int b_boxes = box_count(m, col0, BN);
      produce<BN, true, true>(
          ring, full, empty,
          Operand{&tx, k0, r_begin, a_boxes, a_boxes * kBoxBytes},
          Operand{&tdy, col0, r_begin, b_boxes, b_boxes * kBoxBytes}, steps);
    }
    return;
  }
  // a warpgroup whose box was not loaded (its columns of x lie past K)
  // multiplies whatever the ring holds into rows of dW that are not stored
  const int wg = threadIdx.x >> 7;
  const bool loaded = wg < a_boxes;
  const Fold<bf16> fold = cached_fold(ring, wg * kGroupRows + fold_column());
  float acc[BN / 2];
  consume<BN, BN, true, true>(
      acc, ring, full, empty, steps, wg * kBoxBytes, 0,
      [&](unsigned char* a, int i) {
        if (loaded) apply_fold(a, fold, rows - i * kBK, act);
      });
  store_c<BN, BN>(acc, ring, wg * kGroupRows, 0);
  write_c<BN>(ring, kBM, partials + (int64_t)split * k * m, m, k0, col0, k,
              m);
}

// C [rows, cols] f32 = A @ B, one 128-column tile per block; grid:
// col_tiles * row_tiles, the row tile fastest (the blocks that read the
// same columns of B run together). ta: A [rows, depth] in boxes of 64 deep
// x the tile's rows, or with kAMN [depth, rows] in boxes of 64 x 64; tb:
// B [depth, cols] in boxes of 64 x 64 (kBMN), or [cols, depth] in boxes of
// 64 deep x 128. kShareA: a tile of 64 rows whose warpgroups share A and
// take 64 columns each (a tile of 128 rows over 64 rows of C would leave a
// warpgroup idle). The channels-major product is <false, true, *> with
// A = W [co, ci], B = X [ci, pix]; the other major-nesses exist for the
// test that holds the descriptors of all four against known products.
template <bool kAMN, bool kBMN, bool kShareA>
__global__ void __launch_bounds__(kThreads, 2) cmajor_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, float* c, int rows,
    int64_t cols, int depth, int row_tiles) {
  constexpr int BN = 128;                          // the tile's columns
  constexpr int WN = kShareA ? BN / 2 : BN;        // a warpgroup's
  constexpr int TM = kShareA ? kGroupRows : kBM;   // the tile's rows
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[Cfg<BN>::kStages];
  __shared__ __align__(8) uint64_t empty[Cfg<BN>::kStages];
  const Ring<BN> ring(smem_raw, 0);
  const int row0 = (int)(blockIdx.x % row_tiles) * TM;
  const int64_t col0 = (int64_t)(blockIdx.x / row_tiles) * BN;
  const int steps = (depth + kBK - 1) / kBK;
  setup<BN>(ring, full, empty, nullptr, nullptr, 0, 0, 0);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const int a_boxes = kAMN ? box_count(rows, row0, TM) : 1;
      const int b_boxes = kBMN ? box_count(cols, col0, BN) : 1;
      produce<BN, kAMN, kBMN>(
          ring, full, empty,
          Operand{&ta, row0, 0, a_boxes,
                  kAMN ? a_boxes * kBoxBytes : TM * kRowBytes},
          Operand{&tb, (int)col0, 0, b_boxes,
                  kBMN ? b_boxes * kBoxBytes : BN * kRowBytes},
          steps);
    }
    return;
  }
  const int wg = threadIdx.x >> 7;
  float acc[WN / 2];
  consume<BN, WN, kAMN, kBMN>(acc, ring, full, empty, steps,
                              kShareA ? 0 : wg * kBoxBytes,
                              kShareA ? wg * kBoxBytes : 0,
                              [](unsigned char*, int) {});
  store_c<BN, WN>(acc, ring, kShareA ? 0 : wg * kGroupRows,
                  kShareA ? wg * WN : 0);
  write_c<BN>(ring, TM, c, cols, row0, col0, rows, cols);
}

// A 2-D tensor map of a row-major bf16 matrix [outer, inner] read in boxes
// of 64 x box_outer with the 128-byte swizzle; 0 or the CUresult of a
// refusal.
int encode(CUtensorMap* map, const void* p, int64_t inner, int64_t outer,
           int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return (int)cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Dynamic shared memory of a kernel of `bn` columns whose fold covers k
// columns (0 for none), or -1 when there is no such kernel or it would not
// fit the 227 KB a block may have.
int shared_bytes(int bn, int k) {
  const int fold_cols = (k + kBK - 1) / kBK * kBK;
  size_t bytes = 0;
  if (bn == 64) {
    bytes = Cfg<64>::bytes(fold_cols);
  } else if (bn == 128) {
    bytes = Cfg<128>::bytes(fold_cols);
  } else {
    return -1;
  }
  return bytes <= 232448 ? (int)bytes : -1;
}

// A refused descriptor comes back as 10000 + its CUresult, apart from the
// runtime's own errors.
constexpr int kTensorMapError = 10000;

// The cu* calls of libcuda need a context current on the calling thread, which a
// thread that has only made runtime calls (an autograd worker) may lack:
// cudaFree(0) binds the runtime's context of the current device.
int bind_context() {
  CUcontext ctx = nullptr;
  if (cuCtxGetCurrent(&ctx) == CUDA_SUCCESS && ctx != nullptr) return 0;
  return (int)cudaFree(nullptr);
}

// One launch of cmajor_wgmma_kernel: C [rows, cols] f32 = A @ B, operands
// as it reads them; every extent a multiple of 8 and below 2^31.
template <bool kAMN, bool kBMN, bool kShareA>
int launch_product(const void* a, const void* b, void* c, int rows,
                   int64_t cols, int depth, void* stream) {
  constexpr int TM = kShareA ? kGroupRows : kBM;
  CUtensorMap ta, tb;
  int err = bind_context();
  if (err != 0) return err;
  err = kAMN ? encode(&ta, a, rows, depth, kGroupRows)
             : encode(&ta, a, depth, rows, TM);
  if (err == 0) {
    err = kBMN ? encode(&tb, b, cols, depth, kGroupRows)
               : encode(&tb, b, depth, cols, 128);
  }
  if (err != 0) return kTensorMapError + err;
  const int64_t row_tiles = ceil_div(rows, TM);
  const int64_t blocks = row_tiles * ceil_div(cols, 128);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t bytes = Cfg<128>::bytes(0);
  err = allow_shared(cmajor_wgmma_kernel<kAMN, kBMN, kShareA>, bytes);
  if (err != 0) return err;
  cmajor_wgmma_kernel<kAMN, kBMN, kShareA>
      <<<(unsigned)blocks, kThreads, bytes, (cudaStream_t)stream>>>(
          ta, tb, (float*)c, rows, cols, depth, (int)row_tiles);
  return (int)cudaGetLastError();
}

}  // namespace hop

}  // namespace

// Plain C entry points for ctypes. act: 0 = none, 1 = relu, 2 = relu6. Every matrix is row-major and dense, every
// pointer 16-byte aligned, K and M multiples of 8; scale, shift, dsum and
// dsumsq are f32. Each returns cudaGetLastError() after its launch
// (0 = success) and neither allocates nor synchronises.

// The f32 forward (bf16 takes pseg_fused_matmul_bn_fwd_wgmma): y [N, M] f32;
// partials f32 [ceil(N / 128), 2, M]: each row tile's column sums and sums
// of squares.
extern "C" int pseg_fused_matmul_bn_fwd(
    const void* x, const void* scale, const void* shift, const void* w,
    void* y, void* partials, int act, int64_t n, int k, int m,
    void* stream) {
  if (bad_shape(n, k, m) || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t col_tiles = ceil_div(m, kBN);
  const int64_t blocks = ceil_div(n, kBM) * col_tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int err = allow_shared(fwd_kernel<float>, Tile<float>::kBytes);
  if (err != 0) return err;
  fwd_kernel<float><<<(unsigned)blocks, kThreads, Tile<float>::kBytes,
                      (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const float*)shift,
      (const float*)w, (float*)y, (float*)partials, n, k, m, act,
      (int)col_tiles);
  return (int)cudaGetLastError();
}

// The f32 dx (bf16 takes pseg_fused_matmul_bn_bwd_dx_wgmma): dy [N, M] and
// dx [N, K] f32; dy_tot [N, M] f32 is written here and read by
// pseg_fused_matmul_bn_bwd_dw; partials f32 [ceil(N / 128), 2, K]: each row
// tile's share of dscale and dshift.
extern "C" int pseg_fused_matmul_bn_bwd_dx(
    const void* x, const void* scale, const void* shift, const void* w,
    const void* dy, const void* dsum, const void* dsumsq, void* dy_tot,
    void* dx, void* partials, int act, int64_t n, int k, int m,
    void* stream) {
  if (bad_shape(n, k, m) || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = ceil_div(n, kBM);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int err = allow_shared(bwd_dx_kernel<float>, Tile<float>::kBytes);
  if (err != 0) return err;
  bwd_dx_kernel<float><<<(unsigned)blocks, kThreads, Tile<float>::kBytes,
                         (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const float*)shift,
      (const float*)w, (const float*)dy, (const float*)dsum,
      (const float*)dsumsq, (float*)dy_tot, (float*)dx, (float*)partials, n,
      k, m, act);
  return (int)cudaGetLastError();
}

// The f32 dW (bf16 takes pseg_fused_matmul_bn_bwd_dw_wgmma): x and dy_tot
// f32; partials f32 [splits, K, M]: split s sums rows [s * rows_per_split,
// min(N, (s + 1) * rows_per_split)).
extern "C" int pseg_fused_matmul_bn_bwd_dw(
    const void* x, const void* scale, const void* shift, const void* dy_tot,
    void* partials, int act, int64_t n, int k, int m, int splits,
    int64_t rows_per_split, void* stream) {
  if (bad_shape(n, k, m) || act < 0 || act > 2 ||
      bad_split(n, splits, rows_per_split)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t k_tiles = ceil_div(k, kBM), m_tiles = ceil_div(m, kBN);
  const int64_t blocks = k_tiles * m_tiles * splits;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int err = allow_shared(bwd_dw_kernel<float>, Tile<float>::kBytes);
  if (err != 0) return err;
  bwd_dw_kernel<float><<<(unsigned)blocks, kThreads, Tile<float>::kBytes,
                         (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const float*)shift,
      (const float*)dy_tot, (float*)partials, n, k, m, act, (int)k_tiles,
      (int)m_tiles, rows_per_split);
  return (int)cudaGetLastError();
}

// The Hopper kernels (bf16 only). wt = W^T [M, K] and w = W [K, M], both
// dense bf16; the rest as above. Each encodes its TMA descriptors on the
// host and returns 10000 + the CUresult if one is refused.

// y [N, M]; partials f32 [ceil(N / 128), 2, M], as pseg_fused_matmul_bn_fwd.
extern "C" int pseg_fused_matmul_bn_fwd_wgmma(
    const void* x, const void* scale, const void* shift, const void* wt,
    void* y, void* partials, int act, int64_t n, int k, int m, int bn,
    void* stream) {
  if (bad_shape(n, k, m) || act < 0 || act > 2 || n > 2147483647LL ||
      hop::shared_bytes(bn, k) < 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap ta, tb;
  int err = hop::bind_context();
  if (err != 0) return err;
  err = hop::encode(&ta, x, k, n, hop::kBM);
  if (err == 0) err = hop::encode(&tb, wt, k, m, bn);
  if (err != 0) return hop::kTensorMapError + err;
  const int fold_cols = (int)ceil_div(k, hop::kBK) * hop::kBK;
  const int64_t col_tiles = ceil_div(m, bn);
  const int64_t blocks = ceil_div(n, hop::kBM) * col_tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PSEG_LAUNCH(BN)                                                       \
  do {                                                                        \
    const size_t bytes = hop::Cfg<BN>::bytes(fold_cols);                      \
    err = allow_shared(hop::fwd_wgmma_kernel<BN>, bytes);                     \
    if (err != 0) return err;                                                 \
    hop::fwd_wgmma_kernel<BN><<<(unsigned)blocks, hop::kThreads, bytes, s>>>( \
        ta, tb, (const float*)scale, (const float*)shift,                     \
        (__nv_bfloat16*)y, (float*)partials, n, k, m, act, (int)col_tiles,    \
        fold_cols);                                                           \
  } while (0)
  if (bn == 64) {
    PSEG_LAUNCH(64);
  } else {
    PSEG_LAUNCH(128);
  }
#undef PSEG_LAUNCH
  return (int)cudaGetLastError();
}

// dx as two grids on the stream, one call: (a) dy_tot over (row tile,
// M tile), (b) dz, dx and the dscale / dshift partials over (row tile,
// K tile). dy_tot [N, M] and partials [ceil(N / 128), 2, K] as in
// pseg_fused_matmul_bn_bwd_dx.
extern "C" int pseg_fused_matmul_bn_bwd_dx_wgmma(
    const void* x, const void* scale, const void* shift, const void* w,
    const void* wt, const void* dy, const void* dsum, const void* dsumsq,
    void* dy_tot, void* dx, void* partials, int act, int64_t n, int k, int m,
    int bn_m, int bn_k, void* stream) {
  if (bad_shape(n, k, m) || act < 0 || act > 2 || n > 2147483647LL ||
      hop::shared_bytes(bn_m, k) < 0 || hop::shared_bytes(bn_k, 0) < 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tx, twt, tdy, tw;
  int err = hop::bind_context();
  if (err != 0) return err;
  err = hop::encode(&tx, x, k, n, hop::kBM);
  if (err == 0) err = hop::encode(&twt, wt, k, m, bn_m);
  if (err == 0) err = hop::encode(&tdy, dy_tot, m, n, hop::kBM);
  if (err == 0) err = hop::encode(&tw, w, m, k, bn_k);
  if (err != 0) return hop::kTensorMapError + err;
  const int fold_cols = (int)ceil_div(k, hop::kBK) * hop::kBK;
  const int64_t row_tiles = ceil_div(n, hop::kBM);
  const int64_t m_tiles = ceil_div(m, bn_m), k_tiles = ceil_div(k, bn_k);
  if (row_tiles * (m_tiles > k_tiles ? m_tiles : k_tiles) > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
#define PSEG_LAUNCH_A(BN)                                                     \
  do {                                                                        \
    const size_t bytes = hop::Cfg<BN>::bytes(fold_cols);                      \
    err = allow_shared(hop::dx_dy_tot_wgmma_kernel<BN>, bytes);               \
    if (err != 0) return err;                                                 \
    hop::dx_dy_tot_wgmma_kernel<BN>                                           \
        <<<(unsigned)(row_tiles * m_tiles), hop::kThreads, bytes, s>>>(       \
            tx, twt, (const float*)scale, (const float*)shift,                \
            (const __nv_bfloat16*)dy, (const float*)dsum,                     \
            (const float*)dsumsq, (__nv_bfloat16*)dy_tot, n, k, m, act,       \
            (int)m_tiles, fold_cols);                                         \
  } while (0)
#define PSEG_LAUNCH_B(BN)                                                     \
  do {                                                                        \
    const size_t bytes = hop::Cfg<BN>::bytes(0);                              \
    err = allow_shared(hop::dx_dz_wgmma_kernel<BN>, bytes);                   \
    if (err != 0) return err;                                                 \
    hop::dx_dz_wgmma_kernel<BN>                                               \
        <<<(unsigned)(row_tiles * k_tiles), hop::kThreads, bytes, s>>>(       \
            tdy, tw, (const __nv_bfloat16*)x, (const float*)scale,            \
            (const float*)shift, (__nv_bfloat16*)dx, (float*)partials, n, k,  \
            m, act, (int)k_tiles);                                            \
  } while (0)
  if (bn_m == 64) {
    PSEG_LAUNCH_A(64);
  } else {
    PSEG_LAUNCH_A(128);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (bn_k == 64) {
    PSEG_LAUNCH_B(64);
  } else {
    PSEG_LAUNCH_B(128);
  }
#undef PSEG_LAUNCH_A
#undef PSEG_LAUNCH_B
  return (int)cudaGetLastError();
}

// dW: partials f32 [splits, K, M] as pseg_fused_matmul_bn_bwd_dw's, from x
// and dy_tot bf16; bn: the M tile, 64 or 128 (the K tile is 128).
extern "C" int pseg_fused_matmul_bn_bwd_dw_wgmma(
    const void* x, const void* scale, const void* shift, const void* dy_tot,
    void* partials, int act, int64_t n, int k, int m, int bn, int splits,
    int64_t rows_per_split, void* stream) {
  if (bad_shape(n, k, m) || act < 0 || act > 2 || n > 2147483647LL ||
      (bn != 64 && bn != 128) || bad_split(n, splits, rows_per_split)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tx, tdy;
  int err = hop::bind_context();
  if (err != 0) return err;
  err = hop::encode(&tx, x, k, n, hop::kGroupRows);
  if (err == 0) err = hop::encode(&tdy, dy_tot, m, n, hop::kGroupRows);
  if (err != 0) return hop::kTensorMapError + err;
  const int64_t m_tiles = ceil_div(m, bn);
  const int64_t tiles = ceil_div(k, hop::kBM) * m_tiles;
  if (tiles * splits > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PSEG_LAUNCH(BN)                                                       \
  do {                                                                        \
    const size_t bytes = hop::Cfg<BN>::bytes(hop::kBM);                       \
    err = allow_shared(hop::dw_wgmma_kernel<BN>, bytes);                      \
    if (err != 0) return err;                                                 \
    hop::dw_wgmma_kernel<BN>                                                  \
        <<<(unsigned)(tiles * splits), hop::kThreads, bytes, s>>>(            \
            tx, tdy, (const float*)scale, (const float*)shift,                \
            (float*)partials, (int)n, k, m, act, (int)m_tiles, (int)tiles,    \
            (int)rows_per_split);                                             \
  } while (0)
  if (bn == 64) {
    PSEG_LAUNCH(64);
  } else {
    PSEG_LAUNCH(128);
  }
#undef PSEG_LAUNCH
  return (int)cudaGetLastError();
}

// The dynamic shared memory a Hopper kernel of `tile` columns asks for, with
// the fold of `k` columns (0: the dz grid and the channels-major product,
// which have none; 128: dW, whose fold covers its K tile); -1 for a tile it
// does not have or a fold that does not fit.
extern "C" int pseg_fused_matmul_bn_wgmma_smem(int tile, int k) {
  return hop::shared_bytes(tile, k);
}

// The channels-major product: w [co, ci] and x [ci, pix] bf16, y [co, pix]
// f32; ci and pix multiples of 8. Tiles of 128 co x 128 pix, or of 64 x 128
// with the pixels split between the warpgroups where co <= 64.
extern "C" int pseg_cmajor_matmul(const void* w, const void* x, void* y,
                                  int co, int ci, int64_t pix, void* stream) {
  if (co < 1 || ci < 8 || pix < 8 || ci % 8 != 0 || pix % 8 != 0 ||
      pix > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  if (co <= hop::kGroupRows) {
    return hop::launch_product<false, true, true>(w, x, y, co, pix, ci,
                                                  stream);
  }
  return hop::launch_product<false, true, false>(w, x, y, co, pix, ci,
                                                 stream);
}

// The same loop with each operand in either major-ness, for the test that
// holds the wgmma descriptors against known products: c [rows, cols] f32 =
// A @ B, where a holds A [rows, depth] (a_mn 0) or A^T [depth, rows] (1)
// and b holds B^T [cols, depth] (b_mn 0) or B [depth, cols] (1), bf16;
// every extent a multiple of 8.
extern "C" int pseg_wgmma_product(const void* a, const void* b, void* c,
                                  int rows, int cols, int depth, int a_mn,
                                  int b_mn, void* stream) {
  if (rows < 8 || cols < 8 || depth < 8 || rows % 8 != 0 || cols % 8 != 0 ||
      depth % 8 != 0 || (a_mn != 0 && a_mn != 1) || (b_mn != 0 && b_mn != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a_mn == 0 && b_mn == 0) {
    return hop::launch_product<false, false, false>(a, b, c, rows, cols,
                                                    depth, stream);
  }
  if (a_mn == 0) {
    return hop::launch_product<false, true, false>(a, b, c, rows, cols,
                                                   depth, stream);
  }
  if (b_mn == 0) {
    return hop::launch_product<true, false, false>(a, b, c, rows, cols,
                                                   depth, stream);
  }
  return hop::launch_product<true, true, false>(a, b, c, rows, cols, depth,
                                                stream);
}
