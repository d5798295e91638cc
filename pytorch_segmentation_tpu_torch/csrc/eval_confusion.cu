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
// integers. Here every row of Mh and Mw has at most two nonzero entries, so
// the upsample is two taps an axis, laid out as the CE forward
// (ce_fwd_band_kernel in softmax_ce.cu) lays them out. A block takes one
// sample, a band of output rows and a tile of output columns, sized by
// eval_plan in eval_confusion.py, and a thread one output column of the
// tile. The block stages the source rows and columns those outputs read in
// shared memory (stage_band, stage_band.cuh). The loop that follows is
// band_argmax (stage_band.cuh), which the argmax kernel of
// upsample_argmax.cu runs too: for each output row Y of the band, ascending, the block interpolates the staged rows along H once per
// staged column and class, in f32, into a shared buffer (two of them, by the
// parity of Y: one barrier a row). Then the thread of output column X walks
// the classes in ascending order: interpolate along W from that buffer and
// keep the argmax, strict '>' from -1e30 in the select form (no branch), so
// the lowest class id wins a tie and a NaN is never taken. Every value is
// the expression of the one-thread-a-pixel gather kernel this one replaced
// (hw0 * p0 + hw1 * p1 along H, then ww0 * a0 + ww1 * a1), on the same
// operands in the same order, so the predictions, and with them the counts,
// are that kernel's. Where a staged row of every class does not fit, the
// plan gives bands of one row and the block walks class chunks in ascending
// order, restaging each and carrying each pixel's (best, pred) in registers;
// a pixel is counted after the last chunk.
//
// The counts are int32. The block keeps a 3 x C table in dynamic shared
// memory after the staged rows and the two buffers. Each row, a warp's lanes
// hold 32 adjacent pixels of one output row; for each of tp, label and pred
// the warp first groups its lanes by equal key (__match_any_sync) and one
// lane per group adds the group's size, so the large uniform regions of a
// label map cost one shared atomic per warp, not 32 serialized ones. At its
// end the block adds its nonzero entries to the sample's counts in device
// memory. Integer sums commute: two runs give the same bits.
//
// What bounds it on an H100: at the eval shape (logits [32,129,129,21] bf16,
// labels [32,513,513] int32) it must read 22 MB of logits and 34 MB of labels
// and write 8 KB: about 17 us at 3.35 TB/s; the separable interpolation and
// the compare are 0.84 GFLOP (13 us at 67 TFLOP/s). The old kernel spent its
// time on loads, not bytes: four scalar tap loads a class through L1 and each
// H interpolation done ~4x over (a source column serves ~4 output columns).
// Here a (pixel, class) term is two shared loads, two FMAs, a compare and two
// selects, plus ~0.26 H interpolations; the labels are read one row ahead.
// On an NVIDIA H100 80GB HBM3 at 700 W it takes 0.169 ms of device time in
// bf16 (0.181 f32) against 0.255 for the gather kernel it replaced
// (tools/bench_eval_confusion.py; PERF.md): ~10x its bound. Variants built
// to find where that goes kept most of the time without the argmax loop and
// all of it without the counts or the label loads: staging, step (a) and
// the barrier of each row hold most of it. The H taps held in shared
// memory, (a0, a1) read as one float2, and 32 or 72 registers instead of 40
// were each slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_band.cuh"

namespace {

// The largest block (eval_plan's threads): one thread for each output column
// of a tile.
constexpr int kEvalMaxThreads = 256;

// table[key] += (lanes of this warp holding `key`), for key >= 0. Every lane
// of the warp calls it.
__device__ __forceinline__ void warp_count(int* table, int key, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && lane == __ffs(peers) - 1) {
    atomicAdd(&table[key], __popc(peers));
  }
}

// band_argmax's hook for the counts. The labels are read one row ahead, so
// that a row's work hides the next load; after the last chunk each row's
// pixels are counted with three warp_count calls (a lane without a pixel
// passes -1).
template <typename L>
struct EvalCounts {
  const L* lab;  // the sample's labels [out_h, out_w]
  int out_w, X;
  bool has_x;
  AxisTile band;
  int num_classes;
  int* table;
  int lane;
  bool read;
  L lab_next, lab_y;

  __device__ __forceinline__ void chunk(bool last) {
    read = has_x && last;
    lab_next = read ? lab[(int64_t)band.out_lo * out_w + X] : L(0);
  }
  __device__ __forceinline__ void row(int Y) {
    lab_y = lab_next;
    if (read && Y + 1 < band.out_hi)
      lab_next = lab[(int64_t)(Y + 1) * out_w + X];
  }
  // (c) the pixel's three counts
  __device__ __forceinline__ void done(int, int pred) {
    int p = -1, label = -1;
    if (has_x) {
      p = pred;
      const int64_t l = (int64_t)lab_y;
      if (l >= 0 && l < num_classes) label = (int)l;
    }
    warp_count(table, p == label ? p : -1, lane);
    warp_count(table + num_classes, label, lane);
    warp_count(table + 2 * num_classes, p, lane);
  }
};

// Block: (sample, band of output rows, tile of output columns), decoded with
// the tile fastest. Thread: output column tile.out_lo + threadIdx.x (the plan
// gives no tile more columns than threads). Shared memory (eval_plan's
// layout): the staged rows as stage_band lays them out (stage_rows slots of
// `slot` elements, then one int per row), then two f32 buffers of
// stage_cols x a_stride (an output row interpolated along H at every staged
// column and class of the chunk, by the parity of Y; a_stride is odd, so a
// warp's neighbouring pixels, which read ~9 neighbouring columns at one
// class, read distinct banks or the same word), then the int32 count table
// [3, C]: tp, labels, preds.
template <typename T, typename L>
__global__ void __launch_bounds__(kEvalMaxThreads) eval_band_kernel(
    const T* __restrict__ logits, int64_t s_b, int64_t s_h, int64_t s_w,
    int64_t s_c, int num_classes, int out_h, int out_w,
    const L* __restrict__ labels, Taps th, Taps tw,
    const AxisTile* __restrict__ bands, int n_bands,
    const AxisTile* __restrict__ tiles, int n_tiles, int chunk,
    int stage_rows, int stage_cols, int slot, int a_stride,
    int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t blk = blockIdx.x;
  const int ti = (int)(blk % n_tiles);
  blk /= n_tiles;
  const int bi = (int)(blk % n_bands);
  const int64_t b = blk / n_bands;
  const AxisTile band = bands[bi], tile = tiles[ti];
  const int n_cols = tile.src_hi - tile.src_lo + 1;
  T* stage = reinterpret_cast<T*>(smem);
  int* row_base = reinterpret_cast<int*>(
      smem + (size_t)stage_rows * slot * sizeof(T));
  float* rows_h = reinterpret_cast<float*>(row_base + stage_rows);
  int* table = reinterpret_cast<int*>(rows_h + 2 * stage_cols * a_stride);
  const int tid = threadIdx.x, lane = tid & 31;
  const int entries = 3 * num_classes;
  // the barriers in stage_band order these stores before the first count
  for (int i = tid; i < entries; i += blockDim.x) table[i] = 0;

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
  EvalCounts<L> counter{labels + b * (int64_t)out_h * out_w, out_w, X,
                        has_x, band, num_classes, table, lane, false, L(0),
                        L(0)};
  band_argmax(src, s_h, s_w, s_c, num_classes, th, band, n_cols, chunk, slot,
              a_stride, stage, row_base, rows_h, has_x, x0, x1, ww0, ww1,
              counter);
  __syncthreads();

  int32_t* sample_counts = counts + b * entries;
  for (int i = tid; i < entries; i += blockDim.x) {
    const int v = table[i];
    if (v != 0) atomicAdd(&sample_counts[i], v);
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype: 0 = float32, 1 = bfloat16;
// label_dtype: 0 = int32, 1 = int64. Strides are in elements; labels are
// contiguous [B, out_h, out_w]; counts is int32 [B, 3, C], zeroed by the
// caller. The tiling comes from eval_plan (eval_confusion.py): bands / tiles
// int32 [n, 4] (AxisTile) of output rows / columns, the band's rows and the
// tile's columns at most, the class chunk (below num_classes only with bands
// of one row), the largest band's staged rows and the largest tile's staged
// columns, the elements of a staged row's slot, the f32 stride of a column
// in the H-interpolated rows, the dynamic shared memory in bytes and the
// block size. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int pseg_eval_confusion(
    const void* logits, int dtype, int batch, int num_classes, int64_t s_b,
    int64_t s_h, int64_t s_w, int64_t s_c, int out_h, int out_w,
    const void* labels, int label_dtype, const void* h_i0, const void* h_i1,
    const void* h_w0, const void* h_w1, const void* w_i0, const void* w_i1,
    const void* w_w0, const void* w_w1, const void* bands, int band_rows,
    int n_bands, const void* tiles, int tile_cols, int n_tiles, int chunk,
    int stage_rows, int stage_cols, int slot, int a_stride, int smem_bytes,
    int threads, void* counts, void* stream) {
  if (batch == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  if (num_classes < 1 || chunk < 1 ||
      (chunk < num_classes && band_rows != 1) || band_rows < 1 ||
      tile_cols < 1 || tile_cols > threads || threads < 32 ||
      threads > kEvalMaxThreads || threads % 32 != 0 ||
      a_stride < min(chunk, num_classes) || stage_cols < 1 || slot < 1 ||
      slot * elem % 16 != 0 ||
      (int64_t)stage_rows * (slot * elem + 4) +
              (int64_t)8 * stage_cols * a_stride + (int64_t)12 * num_classes >
          smem_bytes)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)batch * n_bands * n_tiles;
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Taps th = {(const int*)h_i0, (const int*)h_i1, (const float*)h_w0,
                   (const float*)h_w1};
  const Taps tw = {(const int*)w_i0, (const int*)w_i1, (const float*)w_w0,
                   (const float*)w_w1};
#define PSEG_LAUNCH(T, L)                                                     \
  do {                                                                        \
    const cudaError_t e = allow_smem(eval_band_kernel<T, L>, smem_bytes);     \
    if (e != cudaSuccess) return (int)e;                                      \
    eval_band_kernel<T, L><<<(unsigned)blocks, threads, (size_t)smem_bytes,   \
                             s>>>(                                            \
        (const T*)logits, s_b, s_h, s_w, s_c, num_classes, out_h, out_w,      \
        (const L*)labels, th, tw, (const AxisTile*)bands, n_bands,            \
        (const AxisTile*)tiles, n_tiles, chunk, stage_rows, stage_cols, slot, \
        a_stride, (int32_t*)counts);                                          \
  } while (0)
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
