// Fused bilinear upsample + argmax over classes, written for Hopper (sm_90a).
//
// Replaces pytorch_segmentation_tpu/ops/pallas/upsample_argmax.py
// (fused_upsample_argmax -> _argmax_kernel). It computes
//
//     mask[b, y, x] = argmax_c  sum_{i,j} Mh[y, i] * logits[b, i, j, c] * Mw[x, j]
//
// and never writes the upsampled logits. The TPU kernel contracts against the
// dense interpolation matrices Mh, Mw because the TPU cannot gather; every row
// of those matrices has at most two nonzero entries, so here each output pixel
// gathers its 2x2 taps directly. The taps (i0, i1) and weights (w0, w1) of each
// axis come from ops/resize._interp_weights via the Python wrapper, so both
// align_corners settings and the edge clamping have one source; where a row of
// the matrix collapses to one entry (i0 == i1) the wrapper passes that entry as
// w0 and 0 as w1.
//
// Arithmetic per class and pixel, in f32: interpolate along H in the two
// source columns, then along W (the order of Mh . L . Mw^T). The argmax walks
// the classes in ascending order with a strict '>' from -1e30, so the lowest
// class id wins a tie, as in torch.argmax and jnp.argmax.
//
// What bounds it on an H100: memory. At the serving shape (logits
// [8,129,129,21] bf16 -> mask [8,513,513] int32) it reads 5.6 MB of logits,
// which stay in the 50 MB L2 across the 16x reuse of each source pixel, and
// writes 8.4 MB of mask: about 4 us at 3.35 TB/s. One thread per output pixel,
// neighbouring threads on neighbouring output columns, keeps the mask stores
// coalesced; the logits are read through strides, so an NCHW-contiguous or a
// channels_last tensor needs no copy. Any class count is accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void upsample_argmax_kernel(
    const T* __restrict__ logits, int64_t s_b, int64_t s_h, int64_t s_w,
    int64_t s_c, int num_classes, int out_h, int out_w, int64_t total,
    const int* __restrict__ h_i0, const int* __restrict__ h_i1,
    const float* __restrict__ h_w0, const float* __restrict__ h_w1,
    const int* __restrict__ w_i0, const int* __restrict__ w_i1,
    const float* __restrict__ w_w0, const float* __restrict__ w_w1,
    int32_t* __restrict__ out) {
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int x = (int)(idx % out_w);
    const int64_t row = idx / out_w;
    const int y = (int)(row % out_h);
    const int64_t b = row / out_h;

    const float hw0 = h_w0[y], hw1 = h_w1[y];
    const float ww0 = w_w0[x], ww1 = w_w1[x];
    const T* base = logits + b * s_b;
    const T* p00 = base + h_i0[y] * s_h + w_i0[x] * s_w;
    const T* p01 = base + h_i0[y] * s_h + w_i1[x] * s_w;
    const T* p10 = base + h_i1[y] * s_h + w_i0[x] * s_w;
    const T* p11 = base + h_i1[y] * s_h + w_i1[x] * s_w;

    float best = -1e30f;
    int32_t pred = 0;
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
    out[idx] = pred;
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16. Strides
// are in elements. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int pseg_upsample_argmax(
    const void* logits, int dtype, int batch, int num_classes, int64_t s_b,
    int64_t s_h, int64_t s_w, int64_t s_c, int out_h, int out_w,
    const void* h_i0, const void* h_i1, const void* h_w0, const void* h_w1,
    const void* w_i0, const void* w_i1, const void* w_w0, const void* w_w1,
    void* out, void* stream) {
  const int64_t total = (int64_t)batch * out_h * out_w;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  cudaStream_t s = (cudaStream_t)stream;
#define PSEG_LAUNCH(T)                                                       \
  upsample_argmax_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(            \
      (const T*)logits, s_b, s_h, s_w, s_c, num_classes, out_h, out_w,       \
      total, (const int*)h_i0, (const int*)h_i1, (const float*)h_w0,         \
      (const float*)h_w1, (const int*)w_i0, (const int*)w_i1,                \
      (const float*)w_w0, (const float*)w_w1, (int32_t*)out)
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
