// Fused bilinear upsample + argmax over classes, written for Hopper (sm_90a).
//
// Replaces pytorch_segmentation_tpu/ops/pallas/upsample_argmax.py
// (fused_upsample_argmax -> _argmax_kernel). It computes
//
//     mask[b, y, x] = argmax_c  sum_{i,j} Mh[y, i] * logits[b, i, j, c] * Mw[x, j]
//
// and never writes the upsampled logits. The TPU kernel contracts against the
// dense interpolation matrices Mh, Mw because the TPU cannot gather; every row
// of those matrices has at most two nonzero entries, so here the upsample is
// two taps an axis. The taps (i0, i1) and weights (w0, w1) of each axis come
// from ops/resize._interp_weights via the Python wrapper (ops/kernels/taps.py),
// so both align_corners settings and the edge clamping have one source; where
// a row of the matrix collapses to one entry (i0 == i1) the wrapper passes
// that entry as w0 and 0 as w1.
//
// Layout: the eval kernel's (eval_band_kernel in eval_confusion.cu), writing
// a mask instead of counts. A block takes one sample, a band of output rows
// and a tile of output columns, sized by argmax_plan in upsample_argmax.py
// (fwd_plan's tables with nothing after the two buffers), and a thread one
// output column of the tile. The block stages the source rows and columns
// those outputs read in shared memory (stage_band) and runs band_argmax
// (both in stage_band.cuh): each output row interpolated along H once per
// staged column and class into a shared buffer, then each thread's pixel
// along W and the select-form argmax over the classes in ascending order
// (strict '>' from -1e30: the lowest class id wins a tie, as in
// torch.argmax and jnp.argmax), class chunks where a staged row of every
// class does not fit. After each row every thread stores its pixel's class,
// one coalesced int32 store a warp. Every value is the expression of the
// one-thread-a-pixel gather kernel this one replaced (hw0 * p0 + hw1 * p1
// along H, then ww0 * a0 + ww1 * a1), on the same operands in the same
// order, so the mask is that kernel's bit for bit, and the eval kernel's
// counts are the counts of this mask. The logits are read through their
// strides (16-byte loads where they are channels-last), so an
// NCHW-contiguous or a channels_last tensor needs no copy. Any class count
// is accepted.
//
// What bounds it on an H100: memory. At the serving shape (logits
// [8,129,129,21] bf16 -> mask [8,513,513] int32) it must read 5.6 MB of
// logits and write 8.4 MB of mask: about 4 us at 3.35 TB/s. On an NVIDIA
// H100 80GB HBM3 at 700 W it takes 0.042 ms of device time there, bf16 or
// f32 (tools/bench_upsample_argmax.py; PERF.md), against 0.061 for the
// gather kernel it replaced (four scalar tap loads a class through L1, each
// H interpolation done ~4x over): ~10x its bound, held, as kernel 3 is, by
// the staging, step (a) and the barrier a row. Bands of 8 or 4 rows, tiles
// of 57 or 103 columns and an unrolled class loop were no faster. Where the
// logits are wider than the mask (columns downsampled ~10x) the plan stages
// every source column between a tile's taps: 0.48 ms at [1,4,3000,150] f32
// -> (6, 300), where the gather kernel took 0.035.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_band.cuh"

namespace {

// The largest block (argmax_plan's threads): one thread for each output
// column of a tile.
constexpr int kArgmaxMaxThreads = 256;

// band_argmax's hook for the mask: after the last chunk, each row's pixels
// stored, one int32 a thread.
struct StoreMask {
  int32_t* row0;  // the sample's mask at column X of row 0
  int out_w;
  bool has_x;

  __device__ __forceinline__ void chunk(bool) {}
  __device__ __forceinline__ void row(int) {}
  __device__ __forceinline__ void done(int Y, int pred) {
    if (has_x) row0[(int64_t)Y * out_w] = pred;
  }
};

// Block: (sample, band of output rows, tile of output columns), decoded with
// the tile fastest. Thread: output column tile.out_lo + threadIdx.x (the plan
// gives no tile more columns than threads). Shared memory (argmax_plan's
// layout): the staged rows as stage_band lays them out (stage_rows slots of
// `slot` elements, then one int per row), then two f32 buffers of
// stage_cols x a_stride.
template <typename T>
__global__ void __launch_bounds__(kArgmaxMaxThreads) argmax_band_kernel(
    const T* __restrict__ logits, int64_t s_b, int64_t s_h, int64_t s_w,
    int64_t s_c, int num_classes, int out_h, int out_w, Taps th, Taps tw,
    const AxisTile* __restrict__ bands, int n_bands,
    const AxisTile* __restrict__ tiles, int n_tiles, int chunk,
    int stage_rows, int slot, int a_stride, int32_t* __restrict__ mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  // 32-bit: the launcher keeps the grid below 2^31 blocks
  int blk = (int)blockIdx.x;
  const int ti = blk % n_tiles;
  blk /= n_tiles;
  const int bi = blk % n_bands;
  const int64_t b = blk / n_bands;
  const AxisTile band = bands[bi], tile = tiles[ti];
  const int n_cols = tile.src_hi - tile.src_lo + 1;
  T* stage = reinterpret_cast<T*>(smem);
  int* row_base = reinterpret_cast<int*>(
      smem + (size_t)stage_rows * slot * sizeof(T));
  float* rows_h = reinterpret_cast<float*>(row_base + stage_rows);

  // this thread's output column: its two taps as offsets into an
  // H-interpolated row, and their weights
  const int X = tile.out_lo + threadIdx.x;
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
  StoreMask store{mask + b * (int64_t)out_h * out_w + X, out_w, has_x};
  band_argmax(src, s_h, s_w, s_c, num_classes, th, band, n_cols, chunk, slot,
              a_stride, stage, row_base, rows_h, has_x, x0, x1, ww0, ww1,
              store);
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16. Strides
// are in elements; mask is contiguous int32 [B, out_h, out_w]. The tiling
// comes from argmax_plan (upsample_argmax.py): bands / tiles int32 [n, 4]
// (AxisTile) of output rows / columns, the band's rows and the tile's
// columns at most, the class chunk (below num_classes only with bands of one
// row), the largest band's staged rows and the largest tile's staged
// columns, the elements of a staged row's slot, the f32 stride of a column
// in the H-interpolated rows, the dynamic shared memory in bytes and the
// block size. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int pseg_upsample_argmax(
    const void* logits, int dtype, int batch, int num_classes, int64_t s_b,
    int64_t s_h, int64_t s_w, int64_t s_c, int out_h, int out_w,
    const void* h_i0, const void* h_i1, const void* h_w0, const void* h_w1,
    const void* w_i0, const void* w_i1, const void* w_w0, const void* w_w1,
    const void* bands, int band_rows, int n_bands, const void* tiles,
    int tile_cols, int n_tiles, int chunk, int stage_rows, int stage_cols,
    int slot, int a_stride, int smem_bytes, int threads, void* mask,
    void* stream) {
  if (batch == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  if (num_classes < 1 || chunk < 1 ||
      (chunk < num_classes && band_rows != 1) || band_rows < 1 ||
      tile_cols < 1 || tile_cols > threads || threads < 32 ||
      threads > kArgmaxMaxThreads || threads % 32 != 0 ||
      a_stride < min(chunk, num_classes) || stage_cols < 1 || slot < 1 ||
      slot * elem % 16 != 0 ||
      (int64_t)stage_rows * (slot * elem + 4) +
              (int64_t)8 * stage_cols * a_stride >
          smem_bytes)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)batch * n_bands * n_tiles;
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Taps th = {(const int*)h_i0, (const int*)h_i1, (const float*)h_w0,
                   (const float*)h_w1};
  const Taps tw = {(const int*)w_i0, (const int*)w_i1, (const float*)w_w0,
                   (const float*)w_w1};
#define PSEG_LAUNCH(T)                                                        \
  do {                                                                        \
    const cudaError_t e = allow_smem(argmax_band_kernel<T>, smem_bytes);      \
    if (e != cudaSuccess) return (int)e;                                      \
    argmax_band_kernel<T><<<(unsigned)blocks, threads, (size_t)smem_bytes,    \
                            s>>>(                                             \
        (const T*)logits, s_b, s_h, s_w, s_c, num_classes, out_h, out_w, th,  \
        tw, (const AxisTile*)bands, n_bands, (const AxisTile*)tiles, n_tiles, \
        chunk, stage_rows, slot, a_stride, (int32_t*)mask);                   \
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
