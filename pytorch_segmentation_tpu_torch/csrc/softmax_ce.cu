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
// Forward, banded (ce_fwd_band_kernel): a block takes one sample, a band of
// output rows and a tile of output columns, sized by fwd_plan in
// softmax_ce.py, and a thread one output column of the tile. The block
// stages the source rows and columns those outputs read in shared memory,
// as the backward does (one staging routine, stage_band.cuh, serves both and
// the eval kernel of eval_confusion.cu). For each output row Y of the band,
// ascending, the block interpolates the staged rows along H once per staged
// column and class, in f32, into a shared buffer (two of them, by the parity
// of Y: one barrier a row). Then the thread of output
// column X walks the classes in ascending order: interpolate along W from
// that buffer and update an online logsumexp, without a branch (both
// updates computed, one selected). The label's upsampled logit is computed
// again after the loop with the same expression; a label outside [0, C)
// matches no class and contributes a true logit of 0, as the TPU kernel's
// one-hot compare does. Every value is the expression of the
// one-thread-a-pixel gather kernel this one replaced, on the same operands
// in the same order, so lse keeps its bits (and the backward, which reads
// lse, its gradient). Where a staged row of every class does not fit, the
// plan gives bands of one row and the block walks class chunks in
// ascending order, restaging each and carrying each pixel's (max, sum, true
// logit) in registers. Each block writes one partial sum (shuffle tree,
// fixed order); a second small kernel adds a sample's partials in a fixed
// order. No atomics: the loss is the same bits on every run. The forward
// also writes lse [B, H, W] f32 for the backward unless the caller passes
// no buffer.
//
// Backward, banded (ce_bwd_band_kernel): a block takes one sample, a band
// of source rows, a tile of source columns and a chunk of classes, sized by
// bwd_plan in softmax_ce.py. It stages the source rows that the band's
// output rows read, halo included, in shared memory: 16-byte loads where the
// logits are channels-last and the chunk holds every class, through the
// strides otherwise. A thread owns 4 source columns and 3 classes.
// For each output row Y that reads the band, in ascending order, it
// interpolates Y along H at its columns and their neighbours, computes the
// softmax term of each output column X whose taps touch its columns once,
// and adds the term's two weighted shares to its columns' sums in ascending
// X; then it adds those sums, weighted, into source rows i0(Y) and i0(Y)+1.
// Only the band's rows are ever stored, each once its last output row has
// passed. The sums run in the order of the gather kernel this one replaced
// (columns ascending within an output row, then rows ascending) with the
// same expressions, so the gradient keeps that kernel's bits; no atomics, so
// it is bit-reproducible.
//
// What bounds them on an H100: at [32,129,129,21] bf16 -> 513^2 the forward
// must move 22 MB of logits + 34 MB of int32 labels in and 34 MB of lse out
// (27 us at 3.35 TB/s); the function itself, with the interpolation done
// separably, needs 1.4 GFLOP of f32 arithmetic (20 us at 67 TFLOP/s). The
// backward moves 22 + 34 + 34 MB in and 22 MB out (34 us) and needs 1.9
// GFLOP (28 us). So the bound is tens of microseconds, by bytes, with the
// operations close behind. On an NVIDIA H100 80GB HBM3 at 700 W the
// forward takes 0.28-0.30 ms and the backward 0.43-0.47 ms
// (tools/bench_ce.py; PERF.md). The forward spends ~19 instructions on each
// of the 177 M (pixel, class) terms: two shared loads, the W interpolation,
// the accurate expf and the selects of the logsumexp step, plus ~0.26 H
// interpolations a term (a staged column serves ~4 output columns). It runs
// at ~60% of that issue bound; neither shared loads, nor a second pixel a
// thread, nor idle lanes, nor the label and lse traffic moved it. The
// backward computes each softmax term 1.1-1.2x (a band's halo output rows)
// times 1.25x (output columns between two threads' columns) as often as the
// function needs, and spends ~22 instructions on each (the accurate expf,
// the tap products, the label compare, the two shares): instruction issue
// bounds it, not bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_band.cuh"

namespace {

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

// A label's class within the chunk [c0, c0 + cn), or -1: compared in 32
// bits once per pixel instead of in the label's width once per class.
__device__ __forceinline__ int chunk_label(int32_t v, int c0, int cn) {
  const unsigned d = (unsigned)v - (unsigned)c0;
  return d < (unsigned)cn ? (int)d : -1;
}
__device__ __forceinline__ int chunk_label(int64_t v, int c0, int cn) {
  const uint64_t d = (uint64_t)v - (uint64_t)c0;
  return d < (uint64_t)cn ? (int)d : -1;
}

// The forward kernel's largest block (fwd_plan's threads): one thread for
// each output column of a tile.
constexpr int kFwdMaxThreads = 256;

// One step of the online logsumexp: a new running max rescales the sum;
// another class adds to it. Both sides are computed and one is selected, so
// a warp's pixels do not diverge. The exp's operand is that of the
// branching form `up > m ? s * expf(m - up) + 1 : s + expf(up - m)`:
// fl(m - up) = -fl(up - m), and up > m exactly when up - m > 0.
__device__ __forceinline__ void lse_step(float up, float& m, float& s) {
  const bool new_max = up > m;
  const float e = expf(-fabsf(up - m));
  s = new_max ? s * e + 1.0f : s + e;
  m = new_max ? up : m;
}

// Block: (sample, band of output rows, tile of output columns), decoded with
// the tile fastest. Thread: output column tile.out_lo + threadIdx.x (the plan
// gives no tile more columns than threads). Shared memory (fwd_plan's
// layout): the staged rows as stage_band lays them out (stage_rows slots of
// `slot` elements, then one int per row), then two f32 buffers of n_cols x
// a_stride: an output row interpolated along H at every staged column and
// class of the chunk, by the parity of Y. a_stride is odd, so a warp's
// neighbouring pixels, which read ~9 neighbouring columns at one class, read
// distinct banks or the same word.
template <typename T, typename L>
__global__ void __launch_bounds__(kFwdMaxThreads) ce_fwd_band_kernel(
    const T* __restrict__ logits, int64_t s_b, int64_t s_h, int64_t s_w,
    int64_t s_c, int num_classes, int out_h, int out_w,
    const L* __restrict__ labels, Taps th, Taps tw,
    const AxisTile* __restrict__ bands, int n_bands,
    const AxisTile* __restrict__ tiles, int n_tiles, int chunk,
    int stage_rows, int slot, int a_stride, float* __restrict__ lse_out,
    float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t blk = blockIdx.x;
  const int ti = (int)(blk % n_tiles);
  blk /= n_tiles;
  const int bi = (int)(blk % n_bands);
  const int64_t b = blk / n_bands;
  const AxisTile band = bands[bi], tile = tiles[ti];
  const int n_rows = band.src_hi - band.src_lo + 1;
  const int n_cols = tile.src_hi - tile.src_lo + 1;
  T* stage = reinterpret_cast<T*>(smem);
  int* row_base = reinterpret_cast<int*>(
      smem + (size_t)stage_rows * slot * sizeof(T));
  float* rows_h = reinterpret_cast<float*>(row_base + stage_rows);
  const int tid = threadIdx.x;
  const int64_t npix = (int64_t)out_h * out_w;
  const L* lab = labels + b * npix;
  float* lse = lse_out == nullptr ? nullptr : lse_out + b * npix;

  // this thread's output column: its two taps as offsets into an
  // H-interpolated row, and their weights
  const int X = tile.out_lo + tid;
  const bool has_x = X < tile.out_hi;
  int x0 = 0, x1 = 0;
  float ww0 = 0.0f, ww1 = 0.0f;
  if (has_x) {
    x0 = (tw.i0[X] - tile.src_lo) * a_stride;
    x1 = (tw.i1[X] - tile.src_lo) * a_stride;
    ww0 = tw.w0[X];
    ww1 = tw.w1[X];
  }
  const T* src = logits + b * s_b + (int64_t)tile.src_lo * s_w;
  // step (a)'s share of this thread: staged columns a_col, a_col + a_lanes,
  // ... at classes a_cls, a_cls + a_groups, ... of the chunk
  const int a_lanes = min(n_cols, (int)blockDim.x);
  const int a_groups = blockDim.x / a_lanes;
  const int a_col = tid % a_lanes, a_cls = tid / a_lanes;
  // one pixel's online logsumexp; with several chunks the band has one row,
  // so the pixel's state carries from chunk to chunk
  float m = -1e30f, s = 0.0f, true_logit = 0.0f, loss = 0.0f;
  for (int c0 = 0; c0 < num_classes; c0 += chunk) {
    const int cn = min(chunk, num_classes - c0);
    // The previous chunk's last row ended in a barrier after every read
    // of the staged rows, so they may be overwritten now.
    stage_band(src + (int64_t)c0 * s_c, s_h, s_w, s_c, num_classes,
               band.src_lo, n_rows, n_cols, cn, slot, stage, row_base);
    // labels are read one row ahead: a row's work hides the next load
    L lab_next = has_x ? lab[(int64_t)band.out_lo * out_w + X] : L(0);
    for (int Y = band.out_lo; Y < band.out_hi; ++Y) {
      const L lab_y = lab_next;
      if (has_x && Y + 1 < band.out_hi)
        lab_next = lab[(int64_t)(Y + 1) * out_w + X];
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
          m = -1e30f;
          s = 0.0f;
          true_logit = 0.0f;
        }
        const float* a0 = a + x0;
        const float* a1 = a + x1;
        for (int c = 0; c < cn; ++c)
          lse_step(ww0 * a0[c] + ww1 * a1[c], m, s);
        // the label's upsampled logit: the loop's expression again
        const int label = chunk_label(lab_y, c0, cn);
        if (label >= 0) true_logit = ww0 * a0[label] + ww1 * a1[label];
        if (c0 + cn == num_classes) {
          const float v = m + logf(s);
          if (lse != nullptr) lse[(int64_t)Y * out_w + X] = v;
          loss += v - true_logit;
        }
      }
    }
  }
  const float total = block_sum(loss);
  if (tid == 0) partials[blockIdx.x] = total;
}

// The backward kernel's largest block (bwd_plan's max_threads): with up to
// 128 registers a thread, two blocks an SM.
constexpr int kBwdMaxThreads = 256;
// Source columns and classes a thread owns (BWD_RUN and
// BWD_CLASSES_PER_THREAD in softmax_ce.py).
constexpr int kBwdRun = 4;
constexpr int kBwdClasses = 3;

// Block: (sample, band of source rows, tile of source columns, chunk of
// classes), decoded with the chunk fastest so that neighbouring bands, which
// share their halo rows, run together. Thread: the RUN columns [xa, xa +
// RUN) of the band, xa = x0 + (t / lanes) * RUN, and CPT classes of the
// chunk, t % lanes + k * lanes for k < CPT (lanes = ceil(cn / CPT)).
// Shared memory (bwd_plan's layout): stage_rows slots of `slot` elements,
// `slot` a whole number of 16-byte vectors, then one int per row.
template <typename T, typename L>
__global__ void __launch_bounds__(kBwdMaxThreads, 2) ce_bwd_band_kernel(
    const T* __restrict__ logits, int64_t s_b, int64_t s_h, int64_t s_w,
    int64_t s_c, T* __restrict__ dlogits, int64_t d_b, int64_t d_h,
    int64_t d_w, int64_t d_c, int in_h, int in_w, int num_classes, int out_h,
    int out_w, const L* __restrict__ labels, const float* __restrict__ lse,
    Taps th, const AxisTile* __restrict__ bands, int band_rows,
    int n_bands, const AxisTile* __restrict__ tiles, int tile_cols,
    int n_tiles, const int* __restrict__ col_first,
    const float2* __restrict__ col_w, int chunk, int stage_rows, int slot,
    const float* __restrict__ grad_out, float inv_n) {
  constexpr int RUN = kBwdRun, CPT = kBwdClasses;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_chunks = (num_classes + chunk - 1) / chunk;
  int64_t blk = blockIdx.x;
  const int ci = (int)(blk % n_chunks);
  blk /= n_chunks;
  const int ti = (int)(blk % n_tiles);
  blk /= n_tiles;
  const int bi = (int)(blk % n_bands);
  const int64_t b = blk / n_bands;
  const int c0 = ci * chunk, cn = min(chunk, num_classes - c0);
  const int x0 = ti * tile_cols, y0 = bi * band_rows;
  const int y_end = min(y0 + band_rows, in_h);
  const AxisTile band = bands[bi], tile = tiles[ti];
  const int n_rows = band.src_hi - band.src_lo + 1;
  const int n_cols = tile.src_hi - tile.src_lo + 1;
  // stage_rows slots of staged rows, then one int per row: where its
  // values start in the slots
  T* stage = reinterpret_cast<T*>(smem);
  int* row_base = reinterpret_cast<int*>(
      smem + (size_t)stage_rows * slot * sizeof(T));

  // 1. Stage source rows [src_lo, src_hi] of the band, columns [src_lo,
  //    src_hi] of the tile, the chunk's classes.
  const T* src = logits + b * s_b + (int64_t)tile.src_lo * s_w +
                 (int64_t)c0 * s_c;
  stage_band(src, s_h, s_w, s_c, num_classes, band.src_lo, n_rows, n_cols,
             cn, slot, stage, row_base);
  const int tid = threadIdx.x;

  const int lanes = (cn + CPT - 1) / CPT;
  const int lane = tid % lanes;
  const int xa = x0 + (tid / lanes) * RUN;
  if (xa >= min(x0 + tile_cols, in_w)) return;  // no barrier follows
  // this thread's classes within the chunk; a class past the chunk reads
  // the chunk's last one and is never stored
  int cls[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) cls[k] = lane + k * lanes;

  // Output columns whose first tap is xa - 1 + j: [xb[j], xb[j + 1]) (none
  // for column -1), cut to the tile's outputs: the ones outside give these
  // columns only zero weights.
  int xb[RUN + 2];
#pragma unroll
  for (int j = 0; j < RUN + 2; ++j) {
    const int col = min(max(xa - 1 + j, 0), in_w);
    xb[j] = min(max(col_first[col], tile.out_lo), tile.out_hi);
  }

  const float scale = grad_out[0] * inv_n;
  const L* lab_b = labels + b * (int64_t)out_h * out_w;
  const float* lse_b = lse + b * (int64_t)out_h * out_w;
  T* out = dlogits + b * d_b + (int64_t)c0 * d_c;

  // Rows accumulate in ascending Y, as the parent order: acc0 holds row
  // `row`, acc1 row + 1. Every output row reads source rows i0 and i0 + 1
  // (or i0 alone at the clamped edge), and i0 does not fall as Y grows, so
  // the rows below i0 are complete: they are stored (those of the band) and
  // the accumulators shift up. Rows that no output reads leave as 0; the
  // halo rows y0 - 1 and y_end are accumulated and never stored.
  float acc0[CPT][RUN], acc1[CPT][RUN];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
#pragma unroll
    for (int x = 0; x < RUN; ++x) acc0[k][x] = acc1[k][x] = 0.0f;
  int row = y0 - 1;
  for (int Y = band.out_lo;; ++Y) {
    const bool done = Y >= band.out_hi;
    const int i0 = done ? y_end : th.i0[Y];
    for (; row < i0; ++row) {
      if (row >= y0 && row < y_end) {
#pragma unroll
        for (int k = 0; k < CPT; ++k)
#pragma unroll
          for (int x = 0; x < RUN; ++x)
            if (cls[k] < cn && xa + x < in_w)
              store_f32(out + (int64_t)row * d_h + (int64_t)(xa + x) * d_w +
                            (int64_t)cls[k] * d_c,
                        acc0[k][x] * scale);
      }
#pragma unroll
      for (int k = 0; k < CPT; ++k)
#pragma unroll
        for (int x = 0; x < RUN; ++x) {
          acc0[k][x] = acc1[k][x];
          acc1[k][x] = 0.0f;
        }
    }
    if (done) break;
    const int i1 = th.i1[Y];
    const float hw0 = th.w0[Y], hw1 = th.w1[Y];
    float g[CPT][RUN];
#pragma unroll
    for (int k = 0; k < CPT; ++k)
#pragma unroll
      for (int x = 0; x < RUN; ++x) g[k][x] = 0.0f;
    // a tile that no output reads (downsampling) staged nothing and gets 0
    if (n_cols > 0) {
      // (a) this output row interpolated along H at columns xa - 1 ..
      //     xa + RUN
      const T* r0 = stage + row_base[i0 - band.src_lo];
      const T* r1 = stage + row_base[i1 - band.src_lo];
      float av[CPT][RUN + 2];
#pragma unroll
      for (int j = 0; j < RUN + 2; ++j) {
        const int col = min(max(xa - 1 + j, tile.src_lo), tile.src_hi);
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const int o = (col - tile.src_lo) * cn + min(cls[k], cn - 1);
          av[k][j] = hw0 * to_f32(r0[o]) + hw1 * to_f32(r1[o]);
        }
      }
      // (b) + (c) each output column once: its softmax term, then its two
      // weighted shares, each source column's in ascending X
      const L* lab = lab_b + (int64_t)Y * out_w;
      const float* ls = lse_b + (int64_t)Y * out_w;
#pragma unroll
      for (int j = 0; j <= RUN; ++j) {  // first tap xa - 1 + j
        for (unsigned X = xb[j]; X < (unsigned)xb[j + 1]; ++X) {
          const float2 ww = col_w[X];
          const float lse_x = ls[X];
          const int label = chunk_label(lab[X], c0, cn);
#pragma unroll
          for (int k = 0; k < CPT; ++k) {
            const float up = ww.x * av[k][j] + ww.y * av[k][j + 1];
            const float onehot = (label == cls[k]) ? 1.0f : 0.0f;
            const float p = expf(up - lse_x) - onehot;
            if (j > 0) g[k][j - 1] += ww.x * p;
            if (j < RUN) g[k][j] += ww.y * p;
          }
        }
      }
    }
    // (d) into the two source rows of this output row
#pragma unroll
    for (int k = 0; k < CPT; ++k)
#pragma unroll
      for (int x = 0; x < RUN; ++x) acc0[k][x] += hw0 * g[k][x];
    if (i1 != i0) {
#pragma unroll
      for (int k = 0; k < CPT; ++k)
#pragma unroll
        for (int x = 0; x < RUN; ++x) acc1[k][x] += hw1 * g[k][x];
    }
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

// The tiling comes from fwd_plan (softmax_ce.py): bands / tiles int32 [n, 4]
// (AxisTile) of output rows / columns, the band's rows and the tile's
// columns at most, the class chunk (below num_classes only with bands of
// one row), the largest band's staged rows, the elements of a staged row's
// slot, the f32 stride of a column in the H-interpolated rows, the dynamic
// shared memory in bytes and the block size. partials: f32 scratch [batch *
// n_bands * n_tiles]; sums: f32 [batch]; lse: f32 [B, out_h, out_w] or null
// when the caller wants the forward only.
extern "C" int pseg_softmax_ce_fwd(
    const void* logits, int dtype, int batch, int num_classes, int64_t s_b,
    int64_t s_h, int64_t s_w, int64_t s_c, int out_h, int out_w,
    const void* labels, int label_dtype, const void* h_i0, const void* h_i1,
    const void* h_w0, const void* h_w1, const void* w_i0, const void* w_i1,
    const void* w_w0, const void* w_w1, const void* bands, int band_rows,
    int n_bands, const void* tiles, int tile_cols, int n_tiles, int chunk,
    int stage_rows, int slot, int a_stride, int smem_bytes, int threads,
    void* lse, void* partials, void* sums, void* stream) {
  if (batch == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  if (chunk < 1 || (chunk < num_classes && band_rows != 1) ||
      band_rows < 1 || tile_cols < 1 || tile_cols > threads ||
      threads < 32 || threads > kFwdMaxThreads || threads % 32 != 0 ||
      a_stride < min(chunk, num_classes) || slot < 1 ||
      slot * elem % 16 != 0 ||
      (int64_t)stage_rows * (slot * elem + 4) > smem_bytes)
    return (int)cudaErrorInvalidValue;
  const int64_t bps = (int64_t)n_bands * n_tiles;
  const int64_t blocks = bps * batch;
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Taps th = {(const int*)h_i0, (const int*)h_i1, (const float*)h_w0,
                   (const float*)h_w1};
  const Taps tw = {(const int*)w_i0, (const int*)w_i1, (const float*)w_w0,
                   (const float*)w_w1};
#define PSEG_FWD(T, L)                                                       \
  do {                                                                       \
    const cudaError_t e = allow_smem(ce_fwd_band_kernel<T, L>, smem_bytes);  \
    if (e != cudaSuccess) return (int)e;                                     \
    ce_fwd_band_kernel<T, L><<<(unsigned)blocks, threads,                    \
                               (size_t)smem_bytes, s>>>(                     \
        (const T*)logits, s_b, s_h, s_w, s_c, num_classes, out_h, out_w,     \
        (const L*)labels, th, tw, (const AxisTile*)bands, n_bands,           \
        (const AxisTile*)tiles, n_tiles, chunk, stage_rows, slot, a_stride,  \
        (float*)lse, (float*)partials);                                      \
  } while (0)
  PSEG_DISPATCH(PSEG_FWD)
#undef PSEG_FWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_sum_kernel<<<(unsigned)batch, 256, 0, s>>>((const float*)partials,
                                                (int)bps, (float*)sums);
  return (int)cudaGetLastError();
}

// dlogits has the logits' shape [B, in_h, in_w, C] and dtype, with its own
// strides; grad_out is one f32 on the device (the cotangent of the mean
// loss); inv_n = 1 / (B * out_h * out_w). The tiling comes from bwd_plan
// (softmax_ce.py): bands / tiles int32 [n, 4] (AxisTile), col_first int32
// [in_w + 1], col_w f32 [out_w, 2] (each output column's two tap weights),
// the class chunk, the largest band's staged rows, the elements of a staged
// row's slot, the dynamic shared memory in bytes and the block size.
extern "C" int pseg_softmax_ce_bwd(
    const void* logits, int dtype, int batch, int in_h, int in_w,
    int num_classes, int64_t s_b, int64_t s_h, int64_t s_w, int64_t s_c,
    void* dlogits, int64_t d_b, int64_t d_h, int64_t d_w, int64_t d_c,
    int out_h, int out_w, const void* labels, int label_dtype,
    const void* lse, const void* h_i0, const void* h_i1, const void* h_w0,
    const void* h_w1, const void* bands, int band_rows, int n_bands,
    const void* tiles, int tile_cols, int n_tiles, const void* col_first,
    const void* col_w, int chunk, int stage_rows, int slot, int smem_bytes,
    int threads, const void* grad_out, float inv_n, void* stream) {
  if (batch == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  if (chunk < 1 || band_rows < 1 || tile_cols < 1 || threads < 32 ||
      threads > kBwdMaxThreads || threads % 32 != 0 ||
      (int64_t)((chunk + kBwdClasses - 1) / kBwdClasses) *
              ((tile_cols + kBwdRun - 1) / kBwdRun) >
          threads ||
      slot < 1 || slot * elem % 16 != 0 ||
      (int64_t)stage_rows * (slot * elem + 4) > smem_bytes)
    return (int)cudaErrorInvalidValue;
  const int64_t n_chunks = (num_classes + chunk - 1) / chunk;
  const int64_t blocks = (int64_t)batch * n_bands * n_tiles * n_chunks;
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Taps th = {(const int*)h_i0, (const int*)h_i1, (const float*)h_w0,
                   (const float*)h_w1};
#define PSEG_BWD(T, L)                                                        \
  do {                                                                        \
    const cudaError_t e = allow_smem(ce_bwd_band_kernel<T, L>, smem_bytes);  \
    if (e != cudaSuccess) return (int)e;                                      \
    ce_bwd_band_kernel<T, L><<<(unsigned)blocks, threads, (size_t)smem_bytes, \
                               s>>>(                                          \
        (const T*)logits, s_b, s_h, s_w, s_c, (T*)dlogits, d_b, d_h, d_w, d_c, \
        in_h, in_w, num_classes, out_h, out_w, (const L*)labels,              \
        (const float*)lse, th, (const AxisTile*)bands, band_rows, n_bands,    \
        (const AxisTile*)tiles, tile_cols, n_tiles, (const int*)col_first,    \
        (const float2*)col_w, chunk, stage_rows, slot, (const float*)grad_out, \
        inv_n);                                                               \
  } while (0)
  PSEG_DISPATCH(PSEG_BWD)
#undef PSEG_BWD
  return (int)cudaGetLastError();
}
