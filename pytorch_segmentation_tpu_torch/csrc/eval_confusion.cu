// Fused bilinear upsample + argmax + per-class confusion counts, written for
// Hopper (sm_90a).
//
// Replaces pytorch_segmentation_tpu/ops/pallas/eval_confusion.py
// (fused_eval_confusion -> _eval_kernel). Per sample b and class c it counts,
// over the H x W pixels of the label map,
//
//     pred[b, y, x] = argmax_c sum_{i,j} Mh[y, i] * logits[b, i, j, c] * Mw[x, j]
//     counts[b, 0, c] = #{pred == c and label == c}        (tp)
//     counts[b, 1, c] = #{label == c}                      (tp + fn)
//     counts[b, 2, c] = #{pred == c}                       (tp + fp)
//
// and writes neither the upsampled logits nor the predicted mask: a
// prediction lives in a register from its argmax to its three counts. A
// label outside [0, C) matches no class: it adds nothing to rows 0 and 1,
// and its pixel still counts in row 2 for the predicted class, as in the TPU
// kernel's compares. The wrapper masks padded samples, sums over the batch
// and forms fn and fp.
//
// The TPU kernel multiplies class planes by dense interpolation matrices and
// keeps f32 counts in a VMEM tile, because a TPU neither gathers nor reduces
// integers. Here the first half is the gather of upsample_argmax.cu (one
// thread per output pixel, 2x2 taps and weights from ops/resize._interp_weights
// via the Python wrapper, f32, H then W, strict '>' from -1e30 in ascending
// class order, so the lowest class id wins a tie). The second half counts in
// int32: each block lies inside one sample and keeps a 3 x C table in shared
// memory. A warp first groups its lanes by equal key (__match_any_sync) and
// one lane per group adds the group's size, so the large uniform regions of a
// label map cost one shared atomic per warp, not 32 serialized ones. At its
// end the block adds its nonzero entries to the sample's counts in device
// memory. Integer sums commute: two runs give the same bits.
//
// What bounds it on an H100: memory. At the eval shape (logits
// [32,129,129,21] bf16, labels [32,513,513] int32) it reads 22 MB of logits,
// which stay in the L2 across the 16x reuse of each source pixel, and 34 MB
// of labels, and writes 8 KB: about 17 us at 3.35 TB/s. Neighbouring threads
// take neighbouring pixels, so the label loads are coalesced; the logits are
// read through strides (a channels_last tensor needs no copy). The table is
// dynamic shared memory of 12 C bytes within the 48 KB that need no opt-in:
// at most 4096 classes (the wrapper refuses more).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// table[key] += (lanes of this warp holding `key`), for key >= 0. Every lane
// of the warp calls it.
__device__ __forceinline__ void warp_count(int* table, int key, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && lane == __ffs(peers) - 1) {
    atomicAdd(&table[key], __popc(peers));
  }
}

template <typename T, typename L>
__global__ void eval_confusion_kernel(
    const T* __restrict__ logits, int64_t s_b, int64_t s_h, int64_t s_w,
    int64_t s_c, int num_classes, int out_h, int out_w,
    const L* __restrict__ labels,
    const int* __restrict__ h_i0, const int* __restrict__ h_i1,
    const float* __restrict__ h_w0, const float* __restrict__ h_w1,
    const int* __restrict__ w_i0, const int* __restrict__ w_i1,
    const float* __restrict__ w_w0, const float* __restrict__ w_w1,
    int32_t* __restrict__ counts) {
  extern __shared__ int table[];  // [3, C]: tp, labels, preds
  const int entries = 3 * num_classes;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) table[i] = 0;
  __syncthreads();

  const int64_t b = blockIdx.y;
  const int64_t pixels = (int64_t)out_h * out_w;
  const T* base = logits + b * s_b;
  const L* sample_labels = labels + b * pixels;
  const int lane = threadIdx.x & 31;

  // the loop bound is the same for the whole block, so every lane reaches
  // the warp-wide match below
  for (int64_t start = (int64_t)blockIdx.x * blockDim.x; start < pixels;
       start += (int64_t)gridDim.x * blockDim.x) {
    const int64_t p = start + threadIdx.x;
    int pred = -1, label = -1;
    if (p < pixels) {
      const int x = (int)(p % out_w);
      const int y = (int)(p / out_w);
      const float hw0 = h_w0[y], hw1 = h_w1[y];
      const float ww0 = w_w0[x], ww1 = w_w1[x];
      const T* p00 = base + h_i0[y] * s_h + w_i0[x] * s_w;
      const T* p01 = base + h_i0[y] * s_h + w_i1[x] * s_w;
      const T* p10 = base + h_i1[y] * s_h + w_i0[x] * s_w;
      const T* p11 = base + h_i1[y] * s_h + w_i1[x] * s_w;
      float best = -1e30f;
      pred = 0;
      for (int c = 0; c < num_classes; ++c) {
        const int64_t o = c * s_c;
        const float a0 = hw0 * to_f32(p00[o]) + hw1 * to_f32(p10[o]);
        const float a1 = hw0 * to_f32(p01[o]) + hw1 * to_f32(p11[o]);
        const float up = ww0 * a0 + ww1 * a1;
        if (up > best) {
          best = up;
          pred = c;
        }
      }
      const int64_t l = (int64_t)sample_labels[p];
      if (l >= 0 && l < num_classes) label = (int)l;
    }
    warp_count(table, pred == label ? pred : -1, lane);
    warp_count(table + num_classes, label, lane);
    warp_count(table + 2 * num_classes, pred, lane);
  }
  __syncthreads();

  int32_t* sample_counts = counts + b * entries;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    const int v = table[i];
    if (v != 0) atomicAdd(&sample_counts[i], v);
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16;
// label_dtype: 0 = int32, 1 = int64. Strides are in elements; labels are
// contiguous [B, out_h, out_w]; counts is int32 [B, 3, C], zeroed by the
// caller. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int pseg_eval_confusion(
    const void* logits, int dtype, int batch, int num_classes, int64_t s_b,
    int64_t s_h, int64_t s_w, int64_t s_c, int out_h, int out_w,
    const void* labels, int label_dtype,
    const void* h_i0, const void* h_i1, const void* h_w0, const void* h_w1,
    const void* w_i0, const void* w_i1, const void* w_w0, const void* w_w1,
    void* counts, void* stream) {
  const int64_t pixels = (int64_t)out_h * out_w;
  if (batch == 0 || pixels == 0) return 0;
  const size_t shared = sizeof(int) * 3 * (size_t)num_classes;
  if (shared > 48 * 1024 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)kThreads * kPixelsPerThread;
  const dim3 grid((unsigned)((pixels + per_block - 1) / per_block),
                  (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
#define PSEG_LAUNCH(T, L)                                                    \
  eval_confusion_kernel<T, L><<<grid, kThreads, shared, s>>>(                \
      (const T*)logits, s_b, s_h, s_w, s_c, num_classes, out_h, out_w,       \
      (const L*)labels, (const int*)h_i0, (const int*)h_i1,                  \
      (const float*)h_w0, (const float*)h_w1, (const int*)w_i0,              \
      (const int*)w_i1, (const float*)w_w0, (const float*)w_w1,              \
      (int32_t*)counts)
  if (dtype == 0 && label_dtype == 0) {
    PSEG_LAUNCH(float, int32_t);
  } else if (dtype == 0 && label_dtype == 1) {
    PSEG_LAUNCH(float, int64_t);
  } else if (dtype == 1 && label_dtype == 0) {
    PSEG_LAUNCH(__nv_bfloat16, int32_t);
  } else if (dtype == 1 && label_dtype == 1) {
    PSEG_LAUNCH(__nv_bfloat16, int64_t);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PSEG_LAUNCH
  return (int)cudaGetLastError();
}
