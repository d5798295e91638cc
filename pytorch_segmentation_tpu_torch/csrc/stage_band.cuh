// Shared by the banded kernels of softmax_ce.cu (the CE forward and
// backward), eval_confusion.cu (upsample+argmax+confusion) and
// upsample_argmax.cu (upsample+argmax): the bilinear taps of an axis, the
// plans' tiles, staging a band of source rows in shared memory, the staged
// rows' argmax loop of the two argmax kernels (band_argmax), and the opt-in
// to more than 48 KB of shared memory. The plans that size the tiles and
// the shared-memory layout are in ops/kernels/softmax_ce.py (_stage_smem,
// fwd_plan, bwd_plan), ops/kernels/eval_confusion.py (eval_plan) and
// ops/kernels/upsample_argmax.py (argmax_plan). Each source that includes
// this header builds into a library of its own (ops/kernels/build.py, whose
// digest covers every header here, so an edit rebuilds every source).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Forward taps of one axis: output index -> two source indices and weights.
struct Taps {
  const int* i0;
  const int* i1;
  const float* w0;
  const float* w1;
};

// One tile of an axis (the plans' tables, int32 [n, 4]): output indices
// [out_lo, out_hi) and the source indices [src_lo, src_hi] those outputs
// read. bwd_plan tiles the source (the outputs are those that read the
// tile's source indices), fwd_plan the output.
struct AxisTile {
  int out_lo, out_hi, src_lo, src_hi;
};

// Stages rows [row_lo, row_lo + n_rows) of `src` (the logits of one sample,
// already offset to the first staged column and class), columns [0,
// n_cols), classes [0, cn), in shared memory: row r at stage + row_base[r],
// [column][class]. A row's slot holds `slot` elements, a whole number of
// 16-byte vectors (the plans' _stage_smem layout). Where a row is one
// contiguous run (channels-last logits, every class staged) it is read in
// 16-byte loads and placed at its source's offset modulo 16 bytes;
// otherwise through the strides, the smaller of s_c and s_w fastest.
// Called by every thread of the block; ends with a barrier.
template <typename T>
__device__ __forceinline__ void stage_band(
    const T* __restrict__ src, int64_t s_h, int64_t s_w, int64_t s_c,
    int num_classes, int row_lo, int n_rows, int n_cols, int cn, int slot,
    T* stage, int* row_base) {
  const bool packed = s_c == 1 && s_w == num_classes && cn == num_classes;
  const int row_len = n_cols * cn;  // a staged row: [column][class]
  const int tid = threadIdx.x;
  for (int r = tid; r < n_rows; r += blockDim.x) {
    int base = r * slot;
    if (packed)
      base += (int)((reinterpret_cast<uintptr_t>(
                         src + (int64_t)(row_lo + r) * s_h) & 15) /
                    sizeof(T));
    row_base[r] = base;
  }
  __syncthreads();
  if (n_cols > 0) {
    if (packed) {  // 16-byte loads, the row's head and tail one by one
      constexpr int v = 16 / (int)sizeof(T);
      for (int r = 0; r < n_rows; ++r) {
        const T* g = src + (int64_t)(row_lo + r) * s_h;
        T* d = stage + row_base[r];
        const int head = min(
            row_len,
            (int)((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) /
                (int)sizeof(T));
        const int n_vec = (row_len - head) / v;
        const uint4* gv = reinterpret_cast<const uint4*>(g + head);
        uint4* dv = reinterpret_cast<uint4*>(d + head);
        for (int i = tid; i < n_vec; i += blockDim.x) dv[i] = __ldg(gv + i);
        for (int i = tid; i < head; i += blockDim.x) d[i] = g[i];
        for (int i = head + n_vec * v + tid; i < row_len; i += blockDim.x)
          d[i] = g[i];
      }
    } else {  // through the strides, the smaller of s_c and s_w fastest
      const int total = n_rows * row_len;
      const bool class_fastest = s_c <= s_w;
      for (int i = tid; i < total; i += blockDim.x) {
        int col, c;
        if (class_fastest) {
          c = i % cn;
          col = (i / cn) % n_cols;
        } else {
          col = i % n_cols;
          c = (i / n_cols) % cn;
        }
        const int r = i / row_len;
        stage[row_base[r] + col * cn + c] =
            src[(int64_t)(row_lo + r) * s_h + (int64_t)col * s_w +
                (int64_t)c * s_c];
      }
    }
  }
  __syncthreads();
}

// The staged loop of the banded argmax kernels (eval_band_kernel in
// eval_confusion.cu, argmax_band_kernel in upsample_argmax.cu) over one
// block's band of output rows and tile of output columns. For each class
// chunk, ascending: stage the band's source rows (stage_band), call
// hook.chunk(last), then for each output row Y of the band, ascending:
// hook.row(Y); (a) interpolate the staged rows along H once per staged
// column and class, in f32, into the shared buffer of Y's parity (one
// barrier a row); (b) the thread of output column X (has_x) walks the
// chunk's classes in ascending order, interpolates along W from that buffer
// and keeps the argmax, strict '>' from -1e30 in the select form (no
// branch), so the lowest class id wins a tie and a NaN is never taken;
// after the last chunk, hook.done(Y, pred), called by every thread of the
// block (a warp-collective hook may rely on it). Every value is the
// expression of the one-thread-a-pixel gather kernel the two kernels
// replaced (hw0 * p0 + hw1 * p1 along H, then ww0 * a0 + ww1 * a1), on the
// same operands in the same order, so the predictions are that kernel's.
// With several chunks the plan gives bands of one row, so a pixel's (best,
// pred) carries from chunk to chunk in registers.
//
// src: the sample's logits at the tile's first staged column; x0 / x1: the
// offsets of the thread's two W taps in an H-interpolated row (staged column
// times a_stride), ww0 / ww1 their weights. Shared memory as the plans lay
// it out: the staged rows (stage, row_base), then two f32 buffers of
// n_cols x a_stride (rows_h). a_stride is odd, so a warp's neighbouring
// pixels, which read ~9 neighbouring columns at one class, read distinct
// banks or the same word.
template <typename T, typename Hook>
__device__ __forceinline__ void band_argmax(
    const T* __restrict__ src, int64_t s_h, int64_t s_w, int64_t s_c,
    int num_classes, Taps th, AxisTile band, int n_cols,
    int chunk, int slot, int a_stride, T* stage, int* row_base,
    float* rows_h, bool has_x, int x0, int x1, float ww0, float ww1,
    Hook& hook) {
  const int tid = threadIdx.x;
  const int n_rows = band.src_hi - band.src_lo + 1;
  // step (a)'s share of this thread: staged columns a_col, a_col + a_lanes,
  // ... at classes a_cls, a_cls + a_groups, ... of the chunk
  const int a_lanes = min(n_cols, (int)blockDim.x);
  const int a_groups = blockDim.x / a_lanes;
  const int a_col = tid % a_lanes, a_cls = tid / a_lanes;
  float best = -1e30f;
  int pred = 0;
  for (int c0 = 0; c0 < num_classes; c0 += chunk) {
    const int cn = min(chunk, num_classes - c0);
    // the same for the whole block, so every lane of a warp reaches a
    // warp-collective hook.done
    const bool last = c0 + cn == num_classes;
    // The previous chunk's last row ended in a barrier after every read
    // of the staged rows, so they may be overwritten now.
    stage_band(src + (int64_t)c0 * s_c, s_h, s_w, s_c, num_classes,
               band.src_lo, n_rows, n_cols, cn, slot, stage, row_base);
    hook.chunk(last);
    for (int Y = band.out_lo; Y < band.out_hi; ++Y) {
      hook.row(Y);
      // (a) output row Y along H at every staged column and class. The
      //     buffer of this parity was last read in row Y - 2, before the
      //     barrier of row Y - 1.
      float* a = rows_h + (Y & 1) * n_cols * a_stride;
      const T* r0 = stage + row_base[th.i0[Y] - band.src_lo];
      const T* r1 = stage + row_base[th.i1[Y] - band.src_lo];
      const float hw0 = th.w0[Y], hw1 = th.w1[Y];
      if (a_cls < a_groups)
        for (int col = a_col; col < n_cols; col += a_lanes) {
          const T* p0 = r0 + col * cn;
          const T* p1 = r1 + col * cn;
          float* q = a + col * a_stride;
          for (int c = a_cls; c < cn; c += a_groups)
            q[c] = hw0 * to_f32(p0[c]) + hw1 * to_f32(p1[c]);
        }
      __syncthreads();
      // (b) pixel (Y, X) along W, class by class in ascending order
      if (has_x) {
        if (c0 == 0) {
          best = -1e30f;
          pred = 0;
        }
        const float* a0 = a + x0;
        const float* a1 = a + x1;
        for (int c = 0; c < cn; ++c) {
          const float up = ww0 * a0[c] + ww1 * a1[c];
          const bool take = up > best;
          best = take ? up : best;
          pred = take ? c0 + c : pred;
        }
      }
      if (last) hook.done(Y, pred);
    }
  }
}

}  // namespace

// Lets a kernel have `bytes` of dynamic shared memory: above 48 KB only
// after this call, which is per device, so it is made at every such launch.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}
