"""Fused bilinear upsample + argmax + per-class confusion counts: logits
[B, h, w, C] and labels [B, H, W] -> (tp, fn, fp) f32 [C] over the real
samples of the batch, without writing the upsampled logits or the predicted
mask (port of pytorch_segmentation_tpu/ops/pallas/eval_confusion.py).

On a CUDA tensor `fused_eval_confusion` launches the hand-written kernel in
`csrc/eval_confusion.cu`, tiled by `eval_plan`: a block per band of output
rows and tile of output columns stages the source rows it reads in shared
memory and interpolates each output row along H once per staged column and
class; a thread per output column then interpolates along W, keeps the
argmax over the classes and counts its pixel into a per-block shared-memory
table (see the note there for what bounds it). On a CPU tensor it runs
`eval_confusion_reference`, the plain PyTorch version the tests hold against
the JAX package. There is no fallback from one to the other: a CUDA tensor
gets the kernel or an exception.

A label outside [0, C) matches no class: it adds nothing to `tp` or `fn`, and
its pixel still counts as a false positive of the predicted class, as in the
TPU kernel's compares. Counts are integers summed exactly (int32 per sample
in the kernel, int64 over the batch) and rounded to f32 once, on return.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..metrics import sample_valid_mask
from ..resize import resize_bilinear
from .build import load_kernel_library
from .softmax_ce import fwd_plan
from .taps import device_taps

__all__ = ["fused_eval_confusion", "eval_confusion_reference", "eval_plan",
           "MAX_CLASSES", "launch_count", "reset_launch_count"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_CODE = {torch.int32: 0, torch.int64: 1}
# the kernel's count table is 3 x C int32 in a block's shared memory; at this
# many classes it takes 48 KB, and the plan still fits two blocks an SM
MAX_CLASSES = 48 * 1024 // (3 * 4)
_launches = 0


def launch_count() -> int:
    """How many times the CUDA kernel has been launched in this process."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _finish(per_sample: torch.Tensor, valid):
    """int [B, 3, C] rows (tp, labels, preds) per sample -> (tp, fn, fp) f32
    [C] over the valid samples, summed in int64."""
    mask = sample_valid_mask(valid, per_sample.shape[0], per_sample.device)
    total = (per_sample * mask[:, None, None]).sum(dim=0, dtype=torch.int64)
    fn, fp = (total[1:] - total[0]).float()
    return total[0].float(), fn, fp


def eval_confusion_reference(logits: torch.Tensor, labels: torch.Tensor,
                             valid, align_corners: bool = True):
    """The plain PyTorch version: f32 bilinear upsample, argmax, counts by
    `bincount` per sample."""
    b, c = logits.shape[0], logits.shape[-1]
    up = resize_bilinear(logits.float(), labels.shape[1:3],
                         align_corners=align_corners)
    pred = torch.argmax(up, dim=-1).reshape(b, -1)
    labels = labels.reshape(b, -1).long()
    inside = (labels >= 0) & (labels < c)
    bucket = torch.full_like(pred, c)  # keys that count for no class
    offset = (c + 1) * torch.arange(b, device=pred.device)[:, None]

    def count(keys):
        return torch.bincount((keys + offset).reshape(-1),
                              minlength=b * (c + 1)).reshape(b, c + 1)[:, :c]

    per_sample = torch.stack([
        count(torch.where(pred == labels, pred, bucket)),
        count(torch.where(inside, labels, bucket)),
        count(pred)], dim=1)
    return _finish(per_sample, valid)


def eval_plan(b, h, w, c, out_h, out_w, align_corners, elem_size=4, sms=132,
              band_rows=None, tile_cols=None, max_chunk=None):
    """How the kernel tiles logits [b, h, w, c] -> labels [b, out_h, out_w]
    on a card with `sms` SMs: the CE forward's rule and tables
    (`softmax_ce.fwd_plan`: bands of output rows, tiles of output columns,
    class chunks, the staged rows and the two H-interpolated row buffers),
    with the block's 3 x C int32 count table, 12 * c bytes, in its shared
    memory and budget. The kernel always runs the defaults; the CPU model
    in the tests passes smaller `band_rows`, `tile_cols` and `max_chunk`."""
    return fwd_plan(b, h, w, c, out_h, out_w, align_corners, elem_size, sms,
                    band_rows, tile_cols, max_chunk, extra_smem=12 * c)


@functools.lru_cache(maxsize=64)
def _device_eval_plan(b, h, w, c, out_h, out_w, align_corners, elem_size,
                      device):
    """`eval_plan` for `device`'s SM count and its tables on `device`,
    copied there once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = eval_plan(b, h, w, c, out_h, out_w, align_corners, elem_size, sms)
    return plan, [torch.tensor(a, device=device)
                  for a in (plan.bands, plan.tiles)]


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    fn = load_kernel_library("eval_confusion").pseg_eval_confusion
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.restype = ctypes.c_int
    fn.argtypes = ([ptr, i32, i32, i32] + [i64] * 4 + [i32, i32, ptr, i32]
                   + [ptr] * 8 + [ptr, i32, i32, ptr] + [i32] * 9
                   + [ptr, ptr])
    return fn


def _launch(logits, labels, align_corners: bool) -> torch.Tensor:
    """-> int32 [B, 3, C] per-sample rows (tp, labels, preds)."""
    global _launches
    if any(s < 0 for s in logits.stride()):
        raise ValueError("eval_confusion kernel needs non-negative strides")
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1], labels.shape[2]
    if min(b, h, w, c, out_h, out_w) < 1:
        raise ValueError(f"empty eval_confusion input {tuple(logits.shape)} "
                         f"-> {(out_h, out_w)}")
    if c > MAX_CLASSES:
        raise ValueError(f"eval_confusion kernel takes at most {MAX_CLASSES} "
                         f"classes (its count table lives in 48 KB of shared "
                         f"memory), got {c}")
    # per-sample counts are int32; sizes are passed to C as int
    if out_h * out_w >= 2 ** 31 or max(b, h, w) >= 2 ** 31:
        raise ValueError("eval_confusion shape out of range")
    if labels.dtype not in _LABEL_CODE:
        labels = labels.to(torch.int32)
    labels = labels.contiguous()
    fn = _kernel_fn()
    dev = logits.device
    th = device_taps(h, out_h, align_corners, dev)
    tw = device_taps(w, out_w, align_corners, dev)
    plan, (bands, tiles) = _device_eval_plan(
        b, h, w, c, out_h, out_w, align_corners, logits.element_size(), dev)
    counts = torch.zeros((b, 3, c), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(logits.data_ptr(), _DTYPE_CODE[logits.dtype], b, c,
                 *logits.stride(), out_h, out_w, labels.data_ptr(),
                 _LABEL_CODE[labels.dtype],
                 *(t.data_ptr() for t in th), *(t.data_ptr() for t in tw),
                 bands.data_ptr(), plan.band_rows, len(plan.bands),
                 tiles.data_ptr(), plan.tile_cols, len(plan.tiles),
                 plan.chunk, plan.stage_rows, plan.stage_cols, plan.slot,
                 plan.a_stride, plan.smem_bytes, plan.threads,
                 counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"eval_confusion kernel launch failed: CUDA error "
                           f"{err}")
    _launches += 1
    return counts


def fused_eval_confusion(logits: torch.Tensor, labels: torch.Tensor, valid,
                         align_corners: bool = True):
    """logits [B, h, w, C] (f32 or bf16, any strides), labels [B, H, W]
    (integers), valid = the number of real samples (the first `valid` of the
    batch) or a per-sample bool mask [B]. Returns (tp, fn, fp), f32 [C], of
    the argmax of the bilinearly upsampled logits against the labels, with
    the other samples left out.

    CUDA tensors go through the hand-written kernel (at most `MAX_CLASSES`
    classes, else a ValueError), CPU tensors through
    `eval_confusion_reference`; any other device raises."""
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
        raise TypeError(f"eval_confusion takes float32 or bfloat16 logits, "
                        f"not {logits.dtype}")
    if labels.device != logits.device:
        raise ValueError(f"logits on {logits.device}, labels on "
                         f"{labels.device}")
    logits = logits.detach()
    if logits.device.type == "cuda":
        return _finish(_launch(logits, labels, bool(align_corners)), valid)
    if logits.device.type == "cpu":
        return eval_confusion_reference(logits, labels, valid, align_corners)
    raise ValueError(f"fused_eval_confusion: no path for device "
                     f"{logits.device}")
