// Row resampler of the augmentation warp, written for Hopper (sm_90a).
//
// Replaces pytorch_segmentation_tpu/ops/pallas/banded_resample.py
// (banded_resample_rows -> _kernel). For value planes [B, 4, R, C] (bf16:
// r, g, b and the label id) and per-row source columns coords [B, R, W]
// (f32, in [0, C-1]) it computes
//
//     out[b, p, r, x] = sum_j w_p(coords[b, r, x], j) * planes[b, p, r, j]
//
// with the bilinear weight wb(c, j) = bf16(max(1 - |c - j|, 0)) (computed in
// f32, rounded to bf16 to nearest even) or the nearest one-hot at
// floorf(c + 0.5f). Planes 0-2 take wb where use_bil[b] is set and the
// one-hot otherwise; plane 3 (labels) always takes the one-hot. Products are
// bf16 x bf16 (exact in f32) and at most two are non-zero, so the f32 sum
// has one rounding and the result equals the plain PyTorch version bit for
// bit, in f32 and after the cast to bf16.
//
// The TPU kernel multiplies by a banded interpolation matrix that it builds
// in fast memory because the TPU cannot gather, and it walks a window of
// 4 x 128 source columns into which the caller clamps the coordinates.
// Hopper gathers: each thread reads its coordinate once, works out the two
// taps and both weight pairs once, and produces all four planes. There is no
// window, so every coordinate in [0, C-1] is resampled exactly. A tap
// outside [0, C-1] (the second tap at c = C-1, whose weight is 0) is never
// read.
//
// What bounds it on an H100: memory. At the path shape ([32, 4, 513, 513]
// bf16 in and out, f32 coordinates) it must move 67 + 34 + 67 MB, about 50 us
// at 3.35 TB/s; the ~10 f32 operations per output element are far below
// that. A block is 32 output columns by 8 rows: the coordinate loads and the
// four stores of a warp are coalesced, and the plane loads are nearly so
// because coordinates move slowly along a row. The planes are read through
// their strides, so a transposed view needs no copy; then a warp's taps fall
// into separate cache lines, which the 8 rows of a block share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void banded_resample_kernel(
    const __nv_bfloat16* __restrict__ planes, int64_t s_b, int64_t s_p,
    int64_t s_r, int64_t s_c, const float* __restrict__ coords,
    const uint8_t* __restrict__ use_bil, OutT* __restrict__ out, int rows,
    int cols, int out_w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int64_t b = blockIdx.z;
  if (x >= out_w || r >= rows) return;

  const float c = coords[(b * rows + r) * out_w + x];
  const float f0 = floorf(c);
  const int j0 = (int)f0;
  const int j1 = j0 + 1;
  const int jn = (int)floorf(c + 0.5f);
  // one-hot of the nearest tap, on the same two columns
  const float n0 = jn == j0 ? 1.0f : 0.0f;
  const float n1 = jn == j1 ? 1.0f : 0.0f;
  float w0 = n0, w1 = n1;
  if (use_bil[b]) {
    w0 = bf16_round(fmaxf(1.0f - fabsf(c - f0), 0.0f));
    w1 = bf16_round(fmaxf(1.0f - fabsf(c - (f0 + 1.0f)), 0.0f));
  }
  const bool in0 = j0 >= 0 && j0 < cols;
  const bool in1 = j1 >= 0 && j1 < cols;

  const __nv_bfloat16* src = planes + b * s_b + r * s_r;
  const int64_t plane_out = (int64_t)rows * out_w;
  OutT* dst = out + (b * 4 * rows + r) * out_w + x;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const __nv_bfloat16* row = src + p * s_p;
    const float v0 = in0 ? __bfloat162float(row[j0 * s_c]) : 0.0f;
    const float v1 = in1 ? __bfloat162float(row[j1 * s_c]) : 0.0f;
    const float a0 = p < 3 ? w0 : n0;
    const float a1 = p < 3 ? w1 : n1;
    // both products are exact in f32; one rounding in the sum
    store(dst + p * plane_out, a0 * v0 + a1 * v1);
  }
}

}  // namespace

// Plain C entry point for ctypes. planes: bf16 with strides in elements;
// coords: contiguous f32 [batch, rows, out_w]; use_bil: one byte per sample;
// out: contiguous [batch, 4, rows, out_w], out_dtype 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int pseg_banded_resample(
    const void* planes, int64_t s_b, int64_t s_p, int64_t s_r, int64_t s_c,
    int batch, int rows, int cols, const void* coords, int out_w,
    const void* use_bil, void* out, int out_dtype, void* stream) {
  if (batch == 0 || rows == 0 || out_w == 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((out_w + block.x - 1) / block.x,
                  (rows + block.y - 1) / block.y, batch);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PSEG_LAUNCH(T)                                                      \
  banded_resample_kernel<T><<<grid, block, 0, s>>>(                         \
      (const __nv_bfloat16*)planes, s_b, s_p, s_r, s_c,                     \
      (const float*)coords, (const uint8_t*)use_bil, (T*)out, rows, cols,   \
      out_w)
  if (out_dtype == 0) {
    PSEG_LAUNCH(float);
  } else if (out_dtype == 1) {
    PSEG_LAUNCH(__nv_bfloat16);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef PSEG_LAUNCH
  return (int)cudaGetLastError();
}
