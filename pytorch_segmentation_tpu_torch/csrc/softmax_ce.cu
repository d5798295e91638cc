// Fused bilinear upsample + softmax cross-entropy, forward and backward,
// written for Hopper (sm_90a).
//
// Replaces pytorch_segmentation_tpu/ops/pallas/softmax_ce.py
// (fused_upsample_ce / fused_upsample_ce_per_sample -> _fwd_kernel,
// _fwd_lse_kernel, _bwd_kernel, _bwd_cb_kernel). With
//
//     up[b, Y, X, c] = sum_{y,x} Mh[Y, y] * logits[b, y, x, c] * Mw[X, x]
//
// the forward computes, per sample, sum_{Y,X} (logsumexp_c up - up[label]),
// and the backward
//
//     dlogits[b, y, x, c] = g/N * sum_{Y,X} Mh[Y, y] * Mw[X, x]
//                           * (exp(up[b,Y,X,c] - lse[b,Y,X]) - [label == c])
//
// and neither ever writes `up`. The TPU kernels contract against the dense
// interpolation matrices (a TPU cannot gather), unroll the classes, cap them
// at 128 and come in two pairs sized to VMEM. None of that is kept: every row
// of Mh and Mw has at most two nonzero entries, so a pixel gathers its 2x2
// taps, and one forward and one backward kernel take any class count.
//
// Forward: one thread per output pixel. Per class, in f32, interpolate along
// H in the two source columns, then along W (the order of Mh . L . Mw^T);
// an online logsumexp walks the classes in ascending order; the label's
// upsampled logit is picked by comparison, so a label outside [0, C) matches
// no class and contributes a true logit of 0, as the TPU kernel's one-hot
// compare does. Each block writes one partial sum (shuffle tree, fixed
// order); a second small kernel adds a sample's partials in a fixed order.
// No atomics: the loss is the same bits on every run. The forward also writes
// lse [B, H, W] f32 for the backward unless the caller passes no buffer.
//
// Backward, gather form: one thread per (b, y, x, c) of the low-resolution
// logits walks the output rows and columns whose taps touch (y, x), read from
// a transposed tap table (per input index: first output index, count, and
// the matrix column's weights), recomputes up_c there from its four taps,
// and sums weight * (softmax - onehot): columns first, then rows, the order
// of Mh^T (R Mw). It multiplies by g/N in f32 and casts once to the logits'
// dtype. No atomics either, so the gradient is bit-reproducible.
//
// What bounds them on an H100: at [32,129,129,21] bf16 -> 513^2 the forward
// must move 22 MB of logits + 34 MB of int32 labels in and 34 MB of lse out
// (27 us at 3.35 TB/s); the function itself, with the interpolation done
// separably, needs 1.4 GFLOP of f32 arithmetic (20 us at 67 TFLOP/s). The
// backward moves 22 + 34 + 34 MB in and 22 MB out (34 us) and needs 1.9
// GFLOP (28 us). So the bound is tens of microseconds, by bytes, with the
// operations close behind. As written they take 0.6 and 2.1 ms: the count
// of load instructions and exps limits them. Every output pixel's softmax term
// is recomputed by each of the up to four source pixels it touches, and
// every tap is a separate load that hits L1/L2. Threads run with the class
// fastest, so the loads of a warp are contiguous for channels-last logits;
// other layouts work through the strides, slower. Staging source rows in
// shared memory is the open speed-up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Forward taps of one axis: output index -> two source indices and weights.
struct Taps {
  const int* i0;
  const int* i1;
  const float* w0;
  const float* w1;
};

// Transposed taps of one axis: source index -> first output index, how many
// consecutive outputs touch it, and their weights (row-major [in, width]).
struct TapsT {
  const int* start;
  const int* count;
  const float* weight;
  int width;
};

// Sum over the block, valid in thread 0. blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    v = lane < n_warps ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T, typename L>
__global__ void ce_fwd_kernel(
    const T* __restrict__ logits, int64_t s_b, int64_t s_h, int64_t s_w,
    int64_t s_c, int num_classes, int out_h, int out_w, int blocks_per_sample,
    const L* __restrict__ labels, Taps th, Taps tw, float* __restrict__ lse_out,
    float* __restrict__ partials) {
  const int64_t b = blockIdx.x / blocks_per_sample;
  const int chunk = blockIdx.x % blocks_per_sample;
  const int64_t npix = (int64_t)out_h * out_w;
  const int64_t p = (int64_t)chunk * blockDim.x + threadIdx.x;
  float loss = 0.0f;
  if (p < npix) {
    const int x = (int)(p % out_w);
    const int y = (int)(p / out_w);
    const float hw0 = th.w0[y], hw1 = th.w1[y];
    const float ww0 = tw.w0[x], ww1 = tw.w1[x];
    const T* base = logits + b * s_b;
    const T* p00 = base + th.i0[y] * s_h + tw.i0[x] * s_w;
    const T* p01 = base + th.i0[y] * s_h + tw.i1[x] * s_w;
    const T* p10 = base + th.i1[y] * s_h + tw.i0[x] * s_w;
    const T* p11 = base + th.i1[y] * s_h + tw.i1[x] * s_w;
    const int64_t label = (int64_t)labels[b * npix + p];

    float m = -1e30f, s = 0.0f, true_logit = 0.0f;
    for (int c = 0; c < num_classes; ++c) {
      const int64_t o = c * s_c;
      const float a0 = hw0 * to_f32(p00[o]) + hw1 * to_f32(p10[o]);
      const float a1 = hw0 * to_f32(p01[o]) + hw1 * to_f32(p11[o]);
      const float up = ww0 * a0 + ww1 * a1;
      if (up > m) {  // new running max: rescale the sum
        s = s * expf(m - up) + 1.0f;
        m = up;
      } else {
        s += expf(up - m);
      }
      if (label == c) true_logit = up;
    }
    const float lse = m + logf(s);
    if (lse_out != nullptr) lse_out[b * npix + p] = lse;
    loss = lse - true_logit;
  }
  const float total = block_sum(loss);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// sums[b] = sum of partials[b, :], one block per sample, fixed order.
__global__ void ce_sum_kernel(const float* __restrict__ partials,
                              int blocks_per_sample,
                              float* __restrict__ sums) {
  const float* row = partials + (int64_t)blockIdx.x * blocks_per_sample;
  float v = 0.0f;
  for (int i = threadIdx.x; i < blocks_per_sample; i += blockDim.x) v += row[i];
  v = block_sum(v);
  if (threadIdx.x == 0) sums[blockIdx.x] = v;
}

template <typename T, typename L>
__global__ void ce_bwd_kernel(
    const T* __restrict__ logits, int64_t s_b, int64_t s_h, int64_t s_w,
    int64_t s_c, T* __restrict__ dlogits, int64_t d_b, int64_t d_h,
    int64_t d_w, int64_t d_c, int in_h, int in_w, int num_classes, int out_h,
    int out_w, int64_t total, const L* __restrict__ labels,
    const float* __restrict__ lse, Taps th, Taps tw, TapsT tth, TapsT ttw,
    const float* __restrict__ grad_out, float inv_n) {
  const float scale = grad_out[0] * inv_n;
  const int64_t npix = (int64_t)out_h * out_w;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % num_classes);
    int64_t rest = idx / num_classes;
    const int x = (int)(rest % in_w);
    rest /= in_w;
    const int y = (int)(rest % in_h);
    const int64_t b = rest / in_h;

    const T* base = logits + b * s_b + c * s_c;
    const L* lab = labels + b * npix;
    const float* ls = lse + b * npix;
    const int y_start = tth.start[y], y_count = tth.count[y];
    const int x_start = ttw.start[x], x_count = ttw.count[x];
    const float* wy = tth.weight + (int64_t)y * tth.width;
    const float* wx = ttw.weight + (int64_t)x * ttw.width;

    float acc = 0.0f;
    for (int ky = 0; ky < y_count; ++ky) {
      const int yy = y_start + ky;
      const T* r0 = base + th.i0[yy] * s_h;
      const T* r1 = base + th.i1[yy] * s_h;
      const float hw0 = th.w0[yy], hw1 = th.w1[yy];
      float row_acc = 0.0f;
      for (int kx = 0; kx < x_count; ++kx) {
        const int xx = x_start + kx;
        const int64_t o0 = tw.i0[xx] * s_w, o1 = tw.i1[xx] * s_w;
        const float a0 = hw0 * to_f32(r0[o0]) + hw1 * to_f32(r1[o0]);
        const float a1 = hw0 * to_f32(r0[o1]) + hw1 * to_f32(r1[o1]);
        const float up = tw.w0[xx] * a0 + tw.w1[xx] * a1;
        const int64_t q = (int64_t)yy * out_w + xx;
        const float onehot = ((int64_t)lab[q] == c) ? 1.0f : 0.0f;
        row_acc += wx[kx] * (expf(up - ls[q]) - onehot);
      }
      acc += wy[ky] * row_acc;
    }
    store_f32(dlogits + b * d_b + y * d_h + x * d_w + c * d_c, acc * scale);
  }
}

}  // namespace

// Plain C entry points for ctypes. dtype: 0 = float32, 1 = bfloat16 (logits
// and dlogits); label_dtype: 0 = int32, 1 = int64. Strides are in elements.
// Labels and lse are contiguous [B, out_h, out_w]. Each returns
// cudaGetLastError() after its launches (0 = success).

#define PSEG_DISPATCH(CALL)                                      \
  if (dtype == 0 && label_dtype == 0) {                          \
    CALL(float, int32_t);                                        \
  } else if (dtype == 0 && label_dtype == 1) {                   \
    CALL(float, int64_t);                                        \
  } else if (dtype == 1 && label_dtype == 0) {                   \
    CALL(__nv_bfloat16, int32_t);                                \
  } else if (dtype == 1 && label_dtype == 1) {                   \
    CALL(__nv_bfloat16, int64_t);                                \
  } else {                                                       \
    return (int)cudaErrorInvalidValue;                           \
  }

// partials: f32 scratch [batch * blocks_per_sample] with blocks_per_sample =
// ceil(out_h * out_w / 256); sums: f32 [batch]; lse: f32 [B, out_h, out_w] or
// null when the caller wants the forward only.
extern "C" int pseg_softmax_ce_fwd(
    const void* logits, int dtype, int batch, int num_classes, int64_t s_b,
    int64_t s_h, int64_t s_w, int64_t s_c, int out_h, int out_w,
    const void* labels, int label_dtype, const void* h_i0, const void* h_i1,
    const void* h_w0, const void* h_w1, const void* w_i0, const void* w_i1,
    const void* w_w0, const void* w_w1, void* lse, void* partials, void* sums,
    void* stream) {
  const int threads = 256;
  const int64_t npix = (int64_t)out_h * out_w;
  if (batch == 0 || npix == 0) return 0;
  const int64_t bps = (npix + threads - 1) / threads;
  const int64_t blocks = bps * batch;
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Taps th = {(const int*)h_i0, (const int*)h_i1, (const float*)h_w0,
                   (const float*)h_w1};
  const Taps tw = {(const int*)w_i0, (const int*)w_i1, (const float*)w_w0,
                   (const float*)w_w1};
#define PSEG_FWD(T, L)                                                      \
  ce_fwd_kernel<T, L><<<(unsigned)blocks, threads, 0, s>>>(                 \
      (const T*)logits, s_b, s_h, s_w, s_c, num_classes, out_h, out_w,      \
      (int)bps, (const L*)labels, th, tw, (float*)lse, (float*)partials)
  PSEG_DISPATCH(PSEG_FWD)
#undef PSEG_FWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_sum_kernel<<<(unsigned)batch, threads, 0, s>>>(
      (const float*)partials, (int)bps, (float*)sums);
  return (int)cudaGetLastError();
}

// dlogits has the logits' shape [B, in_h, in_w, C] and dtype, with its own
// strides; grad_out is one f32 on the device (the cotangent of the mean
// loss); inv_n = 1 / (B * out_h * out_w).
extern "C" int pseg_softmax_ce_bwd(
    const void* logits, int dtype, int batch, int in_h, int in_w,
    int num_classes, int64_t s_b, int64_t s_h, int64_t s_w, int64_t s_c,
    void* dlogits, int64_t d_b, int64_t d_h, int64_t d_w, int64_t d_c,
    int out_h, int out_w, const void* labels, int label_dtype,
    const void* lse, const void* h_i0, const void* h_i1, const void* h_w0,
    const void* h_w1, const void* w_i0, const void* w_i1, const void* w_w0,
    const void* w_w1, const void* ht_start, const void* ht_count,
    const void* ht_weight, int ht_width, const void* wt_start,
    const void* wt_count, const void* wt_weight, int wt_width,
    const void* grad_out, float inv_n, void* stream) {
  const int64_t total = (int64_t)batch * in_h * in_w * num_classes;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  cudaStream_t s = (cudaStream_t)stream;
  const Taps th = {(const int*)h_i0, (const int*)h_i1, (const float*)h_w0,
                   (const float*)h_w1};
  const Taps tw = {(const int*)w_i0, (const int*)w_i1, (const float*)w_w0,
                   (const float*)w_w1};
  const TapsT tth = {(const int*)ht_start, (const int*)ht_count,
                     (const float*)ht_weight, ht_width};
  const TapsT ttw = {(const int*)wt_start, (const int*)wt_count,
                     (const float*)wt_weight, wt_width};
#define PSEG_BWD(T, L)                                                      \
  ce_bwd_kernel<T, L><<<(unsigned)blocks, threads, 0, s>>>(                 \
      (const T*)logits, s_b, s_h, s_w, s_c, (T*)dlogits, d_b, d_h, d_w,     \
      d_c, in_h, in_w, num_classes, out_h, out_w, total, (const L*)labels,  \
      (const float*)lse, th, tw, tth, ttw, (const float*)grad_out, inv_n)
  PSEG_DISPATCH(PSEG_BWD)
#undef PSEG_BWD
  return (int)cudaGetLastError();
}
