"""Fused bilinear upsample + softmax cross-entropy: logits [B, h, w, C] and
labels [B, H, W] -> mean over pixels of `logsumexp_c(up) - up[label]`, where
`up` is the bilinear upsampling of the logits to the labels' size, without
ever writing `up` (port of pytorch_segmentation_tpu/ops/pallas/softmax_ce.py).

On a CUDA tensor `fused_upsample_ce` goes through a `torch.autograd.Function`
whose forward and backward launch the hand-written kernels in
`csrc/softmax_ce.cu`. Both stage the source rows a block reads in shared
memory. Forward (tiled by `fwd_plan`): a block per band of output rows and
tile of output columns interpolates each output row along H once per staged
column and class, then a thread per output column interpolates along W and
runs an online logsumexp over the classes. Backward (tiled by `bwd_plan`):
bands of source rows, each output pixel's softmax term computed once per
band and gathered in the order of the matrix product. No atomics; see the
note there for what bounds them. On a CPU tensor it runs
`upsample_ce_reference`, the plain PyTorch version that autograd
differentiates and that the tests hold against the JAX package. There is no
fallback from one to the other: a CUDA tensor gets the kernels or an
exception.

A label outside [0, C) matches no class: its true logit counts as 0 and its
one-hot row is empty, as in the TPU kernel's compare. `ignore_index` is not
part of the fused path (nor is it in the JAX package's).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from ..resize import _interp_weights, resize_bilinear
from .build import load_kernel_library
from .taps import device_taps, interp_taps

__all__ = ["fused_upsample_ce", "fused_upsample_ce_per_sample",
           "upsample_ce_reference", "interp_taps_transposed", "fwd_plan",
           "bwd_plan",
           "launch_count", "reset_launch_count"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_CODE = {torch.int32: 0, torch.int64: 1}
_launches = {"fwd": 0, "bwd": 0}


def launch_count() -> dict:
    """How many times each CUDA kernel has been launched in this process:
    {'fwd': n, 'bwd': n}."""
    return dict(_launches)


def reset_launch_count() -> None:
    _launches["fwd"] = 0
    _launches["bwd"] = 0


def _per_pixel_reference(logits, labels, align_corners):
    """f32 `lse - true_logit` per pixel [B, H, W], plain PyTorch."""
    up = resize_bilinear(logits.float(), labels.shape[1:3],
                         align_corners=align_corners)
    lse = torch.logsumexp(up, dim=-1)
    labels = labels.long()
    inside = (labels >= 0) & (labels < up.shape[-1])
    safe = torch.where(inside, labels, torch.zeros_like(labels))
    true_logit = up.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    return lse - true_logit * inside.to(up.dtype)


def upsample_ce_reference(logits: torch.Tensor, labels: torch.Tensor,
                          align_corners: bool = True) -> torch.Tensor:
    """The plain PyTorch version: f32 bilinear upsample, logsumexp minus the
    label's logit, mean over all pixels. Differentiable by autograd."""
    return _per_pixel_reference(logits, labels, align_corners).mean()


@functools.lru_cache(maxsize=64)
def interp_taps_transposed(in_size: int, out_size: int, align_corners: bool):
    """The columns of `_interp_weights(in_size, out_size)`, one per source
    index: (start int32 [in], count int32 [in], weight f32 [in, width]),
    numpy. Source index i is touched by the `count[i]` consecutive output
    indices from `start[i]`, with the matrix's own entries
    `weight[i, :count[i]]` (zero beyond). A source index that no output reads
    (downsampling) has count 0."""
    mat = _interp_weights(in_size, out_size, align_corners)
    touched = mat != 0
    any_touch = touched.any(axis=0)
    first = np.where(any_touch, touched.argmax(axis=0), 0)
    last = np.where(any_touch, out_size - 1 - touched[::-1].argmax(axis=0), -1)
    count = (last - first + 1).astype(np.int32)
    width = max(int(count.max()), 1)
    weight = np.zeros((in_size, width), np.float32)
    for i in range(in_size):
        weight[i, :count[i]] = mat[first[i]:first[i] + count[i], i]
    table = (first.astype(np.int32), count, weight)
    for a in table:
        a.flags.writeable = False
    return table


# The kernels' tilings (see the note in csrc/softmax_ce.cu). A backward
# block covers one sample, a band of source rows, a tile of source columns and
# a chunk of classes; a thread owns BWD_CLASSES_PER_THREAD classes of BWD_RUN
# consecutive columns of the band. A forward block covers one sample, a band
# of output rows and a tile of output columns, a thread one output column.
BWD_BAND_ROWS = 16          # the most source rows a band has
BWD_RUN = 4                 # kBwdRun in softmax_ce.cu
BWD_CLASSES_PER_THREAD = 3  # kBwdClasses in softmax_ce.cu
BWD_MAX_THREADS = 256       # kBwdMaxThreads in softmax_ce.cu
BWD_MAX_CHUNK = 32          # classes per block at most
FWD_BAND_ROWS = 16          # the most output rows a band has
FWD_MAX_THREADS = 256       # kFwdMaxThreads: the widest tile of columns
_SMEM_TWO_BLOCKS = 113 * 1024  # two blocks' worth of an SM's 228 KB
# bands are halved until the grid has this many warps per SM: two waves of
# the 16 an SM holds at the backward's 128 registers a thread
_FILL_WARPS_PER_SM = 32


def _stage_smem(stage_rows, stage_cols, chunk, elem_size):
    """Both kernels' staged source rows in dynamic shared memory
    (`stage_band` in the .cu): `stage_rows` slots of `slot` elements, each
    whole 16-byte vectors with one spare vector (a staged row starts at its
    source's offset modulo 16 bytes), then one int per row (where its values
    start). -> (slot, bytes); the kernels read the layout from these two
    numbers."""
    vec = 16 // elem_size
    slot = -(-(stage_cols * chunk) // vec) * vec + vec
    return slot, stage_rows * (slot * elem_size + 4)


def _axis_tiles(in_size, out_size, align_corners, tile):
    """Per tile of `tile` consecutive source indices: the output indices
    [lo, hi) that read any of them, and the source indices [first, last]
    that those outputs read, int32 [n, 4]; (0, 0, 0, -1) where no output
    reads the tile (downsampling)."""
    i0, i1, _, _ = interp_taps(in_size, out_size, align_corners)
    start, count, _ = interp_taps_transposed(in_size, out_size, align_corners)
    n = -(-in_size // tile)
    table = np.zeros((n, 4), np.int32)
    table[:, 3] = -1
    for t in range(n):
        part = slice(t * tile, min(in_size, (t + 1) * tile))
        read = count[part] > 0
        if read.any():
            lo = int(start[part][read].min())
            hi = int((start[part] + count[part])[read].max())
            table[t] = (lo, hi, i0[lo:hi].min(), i1[lo:hi].max())
    return table


BwdPlan = collections.namedtuple("BwdPlan", [
    "band_rows", "bands", "chunk", "tile_cols", "tiles", "col_first",
    "col_w", "threads", "stage_rows", "slot", "smem_bytes"])


@functools.lru_cache(maxsize=64)
def bwd_plan(b, h, w, c, out_h, out_w, align_corners, elem_size=4, sms=132,
             band_rows=None, max_threads=BWD_MAX_THREADS,
             max_chunk=BWD_MAX_CHUNK):
    """How the backward kernel tiles logits [b, h, w, c] -> labels
    [b, out_h, out_w] on a card with `sms` SMs: the row bands and column
    tiles (`_axis_tiles`), the class chunk, `col_first` (int32 [w + 1]: the
    first output column whose first tap is at or right of each source
    column), `col_w` (f32 [out_w, 2]: each output column's tap weights), the
    block size and the shared memory (`_stage_smem`). Bands have
    BWD_BAND_ROWS rows, halved until two blocks fit an SM and the grid
    fills the card. Numpy tables; the kernel and the CPU model in the tests
    both follow them. The kernel always runs the defaults; the CPU model
    passes smaller `band_rows`, `max_threads` and `max_chunk` (a given
    `band_rows` is only halved to fit) to reach ragged bands, tiles and
    chunks at small shapes."""
    chunk = c if c <= max_chunk else -(-c // -(-c // max_chunk))
    lanes = -(-chunk // BWD_CLASSES_PER_THREAD)  # threads per run of columns
    runs = -(-w // BWD_RUN)
    per_block = max(1, max_threads // lanes)
    tiles_n = -(-runs // per_block)
    tile_cols = -(-runs // tiles_n) * BWD_RUN
    i0_cols, _, w0_cols, w1_cols = interp_taps(w, out_w, align_corners)
    col_first = np.searchsorted(i0_cols, np.arange(w + 1),
                                side="left").astype(np.int32)
    col_w = np.stack([w0_cols, w1_cols], axis=1)
    tiles = _axis_tiles(w, out_w, align_corners, tile_cols)
    stage_cols = max(1, int((tiles[:, 3] - tiles[:, 2] + 1).max()))
    threads = -(-lanes * (tile_cols // BWD_RUN) // 32) * 32
    blocks_per_band = b * len(tiles) * -(-c // chunk)
    fill = band_rows is None
    band_rows = band_rows or BWD_BAND_ROWS
    while True:
        bands = _axis_tiles(h, out_h, align_corners, band_rows)
        stage_rows = max(1, int((bands[:, 3] - bands[:, 2] + 1).max()))
        slot, smem = _stage_smem(stage_rows, stage_cols, chunk, elem_size)
        warps = blocks_per_band * len(bands) * (threads // 32)
        if band_rows == 1 or (smem <= _SMEM_TWO_BLOCKS and not (
                fill and warps < _FILL_WARPS_PER_SM * sms)):
            break
        band_rows //= 2
    for a in (bands, tiles, col_first, col_w):
        a.flags.writeable = False
    return BwdPlan(band_rows, bands, chunk, tile_cols, tiles, col_first,
                   col_w, threads, stage_rows, slot, smem)


@functools.lru_cache(maxsize=64)
def _device_bwd_plan(b, h, w, c, out_h, out_w, align_corners, elem_size,
                     device):
    """`bwd_plan` for `device`'s SM count and its tables on `device`, copied
    there once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = bwd_plan(b, h, w, c, out_h, out_w, align_corners, elem_size, sms)
    return plan, [torch.tensor(a, device=device) for a in (
        plan.bands, plan.tiles, plan.col_first, plan.col_w)]


def _output_tiles(in_size, out_size, align_corners, tile):
    """Per tile of `tile` consecutive output indices (the last one ragged):
    the indices [lo, hi) and the source indices [first, last] they read,
    int32 [n, 4]."""
    i0, i1, _, _ = interp_taps(in_size, out_size, align_corners)
    lo = np.arange(0, out_size, tile)
    return np.stack([lo, np.minimum(lo + tile, out_size),
                     np.minimum.reduceat(i0, lo),
                     np.maximum.reduceat(i1, lo)], axis=1).astype(np.int32)


FwdPlan = collections.namedtuple("FwdPlan", [
    "band_rows", "bands", "tile_cols", "tiles", "chunk", "threads",
    "stage_rows", "stage_cols", "slot", "a_stride", "smem_bytes"])


@functools.lru_cache(maxsize=64)
def fwd_plan(b, h, w, c, out_h, out_w, align_corners, elem_size=4, sms=132,
             band_rows=None, tile_cols=None, max_chunk=None, extra_smem=0):
    """How the forward kernel tiles logits [b, h, w, c] -> labels
    [b, out_h, out_w] on a card with `sms` SMs: bands of output rows and
    tiles of output columns (`_output_tiles`; the columns spread evenly
    over the tiles), the class chunk, the block size (a thread per column
    of a tile) and the shared memory: the staged rows (`_stage_smem`) and
    two f32 buffers of `stage_cols` x `a_stride` (an output row interpolated
    along H; `a_stride` the chunk made odd, for the banks). Bands have
    FWD_BAND_ROWS rows and tiles FWD_MAX_THREADS columns, the rows halved,
    then the columns, until two blocks fit an SM and the grid fills the card
    (the backward's rule); a stage of every class that still does not fit
    is cut into class chunks, and with several chunks a band has one row.
    Numpy tables; the kernel and the CPU model in the tests both follow
    them. The kernel always runs the defaults; the CPU model passes smaller
    `band_rows`, `tile_cols` and `max_chunk` (each only ever cut further)
    to reach ragged bands, tiles and chunks at small shapes. `extra_smem`:
    bytes a block keeps after the two buffers (the eval kernel's count
    table, `eval_confusion.eval_plan`), counted in `smem_bytes` and in the
    budget."""
    fill = band_rows is None and tile_cols is None
    rows = band_rows or FWD_BAND_ROWS
    cols = min(tile_cols or FWD_MAX_THREADS, FWD_MAX_THREADS)
    n_chunks = 1 if max_chunk is None else -(-c // max_chunk)
    while True:
        chunk = -(-c // n_chunks)
        if chunk < c:  # a pixel's state carries over chunks in registers
            rows = 1
        tile = -(-out_w // -(-out_w // cols))
        bands = _output_tiles(h, out_h, align_corners, rows)
        tiles = _output_tiles(w, out_w, align_corners, tile)
        stage_rows = int((bands[:, 3] - bands[:, 2] + 1).max())
        stage_cols = int((tiles[:, 3] - tiles[:, 2] + 1).max())
        a_stride = chunk | 1
        slot, staged = _stage_smem(stage_rows, stage_cols, chunk, elem_size)
        smem = staged + 2 * stage_cols * a_stride * 4 + extra_smem
        threads = -(-tile // 32) * 32
        warps = b * len(bands) * len(tiles) * (threads // 32)
        fits = smem <= _SMEM_TWO_BLOCKS
        if fits and not (fill and warps < _FILL_WARPS_PER_SM * sms):
            break
        if rows > 1:
            rows //= 2
        elif tile > 32:
            cols = tile // 2
        elif not fits and chunk > 1:
            n_chunks += 1
        else:
            break
    for a in (bands, tiles):
        a.flags.writeable = False
    return FwdPlan(rows, bands, tile, tiles, chunk, threads, stage_rows,
                   stage_cols, slot, a_stride, smem)


@functools.lru_cache(maxsize=64)
def _device_fwd_plan(b, h, w, c, out_h, out_w, align_corners, elem_size,
                     device):
    """`fwd_plan` for `device`'s SM count and its tables on `device`, copied
    there once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = fwd_plan(b, h, w, c, out_h, out_w, align_corners, elem_size, sms)
    return plan, [torch.tensor(a, device=device)
                  for a in (plan.bands, plan.tiles)]


@functools.lru_cache(maxsize=1)
def _kernel_fns():
    lib = load_kernel_library("softmax_ce")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fwd = lib.pseg_softmax_ce_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = ([ptr, i32, i32, i32] + [i64] * 4 + [i32, i32, ptr, i32]
                    + [ptr] * 8 + [ptr, i32, i32, ptr] + [i32] * 8
                    + [ptr] * 4)
    bwd = lib.pseg_softmax_ce_bwd
    bwd.restype = ctypes.c_int
    bwd.argtypes = ([ptr] + [i32] * 5 + [i64] * 4 + [ptr] + [i64] * 4
                    + [i32, i32, ptr, i32, ptr] + [ptr] * 4
                    + [ptr, i32, i32, ptr, i32, i32, ptr, ptr] + [i32] * 5
                    + [ptr, ctypes.c_float, ptr])
    return fwd, bwd


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 4:
        raise ValueError(f"logits must be [B, h, w, C], got "
                         f"{tuple(logits.shape)}")
    if labels.dim() != 3 or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"labels must be [B, H, W] with the logits' batch, "
                         f"got {tuple(labels.shape)} for logits "
                         f"{tuple(logits.shape)}")
    if (labels.dtype.is_floating_point or labels.dtype.is_complex
            or labels.dtype == torch.bool):
        raise TypeError(f"labels must be integers, not {labels.dtype}")
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"softmax_ce takes float32 or bfloat16 logits, not "
                        f"{logits.dtype}")
    if labels.device != logits.device:
        raise ValueError(f"logits on {logits.device}, labels on "
                         f"{labels.device}")


def _kernel_inputs(logits, labels):
    if any(s < 0 for s in logits.stride()):
        raise ValueError("softmax_ce kernels need non-negative strides")
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1], labels.shape[2]
    if min(b, h, w, c, out_h, out_w) < 1:
        raise ValueError(f"empty softmax_ce input {tuple(logits.shape)} -> "
                         f"{(out_h, out_w)}")
    if max(b, c, h, w, out_h, out_w) >= 2 ** 31:  # passed to C as int
        raise ValueError("softmax_ce shape out of range")
    if labels.dtype not in _LABEL_CODE:
        labels = labels.to(torch.int32)
    return labels.contiguous()


def _launch_fwd(logits, labels, align_corners, want_lse):
    """-> (per-sample sums of the pixel losses f32 [B], lse f32 [B, H, W] or
    None, the labels as the kernels read them)."""
    labels = _kernel_inputs(logits, labels)
    fwd, _ = _kernel_fns()
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1], labels.shape[2]
    dev = logits.device
    th = device_taps(h, out_h, align_corners, dev)
    tw = device_taps(w, out_w, align_corners, dev)
    plan, (bands, tiles) = _device_fwd_plan(
        b, h, w, c, out_h, out_w, align_corners, logits.element_size(), dev)
    partials = torch.empty((b, len(plan.bands) * len(plan.tiles)),
                           dtype=torch.float32, device=dev)
    sums = torch.empty((b,), dtype=torch.float32, device=dev)
    lse = (torch.empty((b, out_h, out_w), dtype=torch.float32, device=dev)
           if want_lse else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fwd(logits.data_ptr(), _DTYPE_CODE[logits.dtype], b, c,
                  *logits.stride(), out_h, out_w, labels.data_ptr(),
                  _LABEL_CODE[labels.dtype],
                  *(t.data_ptr() for t in th), *(t.data_ptr() for t in tw),
                  bands.data_ptr(), plan.band_rows, len(plan.bands),
                  tiles.data_ptr(), plan.tile_cols, len(plan.tiles),
                  plan.chunk, plan.stage_rows, plan.slot, plan.a_stride,
                  plan.smem_bytes, plan.threads,
                  lse.data_ptr() if want_lse else None, partials.data_ptr(),
                  sums.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"softmax_ce forward kernel launch failed: CUDA "
                           f"error {err}")
    _launches["fwd"] += 1
    return sums, lse, labels


def _launch_bwd(logits, labels, lse, grad_out, align_corners):
    """dlogits, in the logits' dtype and layout, from what the forward kept
    (`labels` as `_launch_fwd` returned them) and the 0-d cotangent."""
    _, bwd = _kernel_fns()
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1], labels.shape[2]
    dev = logits.device
    th = device_taps(h, out_h, align_corners, dev)
    plan, (bands, tiles, col_first, col_w) = _device_bwd_plan(
        b, h, w, c, out_h, out_w, align_corners, logits.element_size(), dev)
    dlogits = torch.empty_like(logits)  # dense logits keep their strides
    grad_out = grad_out.to(torch.float32).reshape(1).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = bwd(logits.data_ptr(), _DTYPE_CODE[logits.dtype], b, h, w, c,
                  *logits.stride(), dlogits.data_ptr(), *dlogits.stride(),
                  out_h, out_w, labels.data_ptr(), _LABEL_CODE[labels.dtype],
                  lse.data_ptr(), *(t.data_ptr() for t in th),
                  bands.data_ptr(), plan.band_rows, len(plan.bands),
                  tiles.data_ptr(), plan.tile_cols, len(plan.tiles),
                  col_first.data_ptr(), col_w.data_ptr(), plan.chunk,
                  plan.stage_rows, plan.slot, plan.smem_bytes, plan.threads,
                  grad_out.data_ptr(), 1.0 / (b * out_h * out_w), stream)
    if err != 0:
        raise RuntimeError(f"softmax_ce backward kernel launch failed: CUDA "
                           f"error {err}")
    _launches["bwd"] += 1
    return dlogits


class _FusedUpsampleCE(torch.autograd.Function):
    """Mean upsample+CE through the CUDA kernels; the backward kernel reads
    the logits, the labels and the forward's per-pixel logsumexp."""

    @staticmethod
    def forward(ctx, logits, labels, align_corners):
        want_grad = ctx.needs_input_grad[0]
        sums, lse, labels = _launch_fwd(logits, labels, align_corners,
                                        want_lse=want_grad)
        if want_grad:
            ctx.save_for_backward(logits, labels, lse)
            ctx.align_corners = align_corners
        n = logits.shape[0] * labels.shape[1] * labels.shape[2]
        return sums.sum() / n

    @staticmethod
    def backward(ctx, grad_out):
        logits, labels, lse = ctx.saved_tensors
        return (_launch_bwd(logits, labels, lse, grad_out,
                            ctx.align_corners), None, None)


def fused_upsample_ce(logits: torch.Tensor, labels: torch.Tensor,
                      align_corners: bool = True) -> torch.Tensor:
    """logits [B, h, w, C] (f32 or bf16, any strides), labels [B, H, W]
    (integers) -> the mean softmax cross-entropy of the bilinearly upsampled
    logits, a 0-d f32 tensor. The gradient comes back in the logits' dtype.

    CUDA tensors go through the hand-written kernels, CPU tensors through
    `upsample_ce_reference`; any other device raises."""
    _check(logits, labels)
    if logits.device.type == "cuda":
        return _FusedUpsampleCE.apply(logits, labels, bool(align_corners))
    if logits.device.type == "cpu":
        return upsample_ce_reference(logits, labels, align_corners)
    raise ValueError(f"fused_upsample_ce: no path for device {logits.device}")


def fused_upsample_ce_per_sample(logits: torch.Tensor, labels: torch.Tensor,
                                 align_corners: bool = True) -> torch.Tensor:
    """Per-sample mean cross-entropy f32 [B], forward only (no gradient):
    lets an eval loop mask padded samples out of the loss."""
    _check(logits, labels)
    logits = logits.detach()
    if logits.device.type == "cuda":
        sums, _, _ = _launch_fwd(logits, labels, bool(align_corners),
                                 want_lse=False)
        return sums / (labels.shape[1] * labels.shape[2])
    if logits.device.type == "cpu":
        return _per_pixel_reference(logits, labels,
                                    align_corners).mean(dim=(1, 2))
    raise ValueError(f"fused_upsample_ce_per_sample: no path for device "
                     f"{logits.device}")
