// Shared by the banded kernels of softmax_ce.cu (the CE forward and
// backward) and eval_confusion.cu (upsample+argmax+confusion): the bilinear
// taps of an axis, the plans' tiles, staging a band of source rows in
// shared memory, and the opt-in to more than 48 KB of it. The plans that
// size the tiles and the shared-memory layout are in
// ops/kernels/softmax_ce.py (_stage_smem, fwd_plan, bwd_plan) and
// ops/kernels/eval_confusion.py (eval_plan). Each source that includes this
// header builds into a library of its own (ops/kernels/build.py, whose
// digest covers every header here, so an edit rebuilds both).

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
