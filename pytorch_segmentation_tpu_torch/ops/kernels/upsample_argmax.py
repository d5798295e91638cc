"""Fused bilinear upsample + argmax: logits [B, h, w, C] -> int32 mask
[B, H, W], without writing the upsampled logits (port of
pytorch_segmentation_tpu/ops/pallas/upsample_argmax.py).

On a CUDA tensor `fused_upsample_argmax` launches the hand-written kernel in
`csrc/upsample_argmax.cu`, tiled by `argmax_plan`: a block per band of output
rows and tile of output columns stages the source rows it reads in shared
memory and interpolates each output row along H once per staged column and
class; a thread per output column then interpolates along W, keeps the
argmax over the classes and stores its pixel: the eval kernel's layout
(`eval_confusion.py`), with a mask in place of the counts (see the note in
the source for what bounds it). On a CPU tensor it runs `upsample_argmax_reference`, the plain PyTorch version the tests hold
against the JAX package. There is no fallback from one to the other: a CUDA
tensor gets the kernel or an exception.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..resize import resize_bilinear
from .build import load_kernel_library
from .softmax_ce import fwd_plan
from .taps import device_taps, interp_taps

__all__ = ["fused_upsample_argmax", "upsample_argmax_reference",
           "argmax_plan", "interp_taps", "launch_count",
           "reset_launch_count"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_launches = 0


def launch_count() -> int:
    """How many times the CUDA kernel has been launched in this process."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def upsample_argmax_reference(logits: torch.Tensor, out_hw,
                              align_corners: bool = True) -> torch.Tensor:
    """argmax of the f32 bilinear upsampling of `logits` [B, h, w, C]."""
    up = resize_bilinear(logits.float(), out_hw, align_corners=align_corners)
    return torch.argmax(up, dim=-1).to(torch.int32)


def argmax_plan(b, h, w, c, out_h, out_w, align_corners, elem_size=4,
                sms=132, band_rows=None, tile_cols=None, max_chunk=None):
    """How the kernel tiles logits [b, h, w, c] -> a mask [b, out_h, out_w]
    on a card with `sms` SMs: the CE forward's rule and tables
    (`softmax_ce.fwd_plan`: bands of output rows, tiles of output columns,
    class chunks, the staged rows and the two H-interpolated row buffers),
    with nothing after the buffers. The kernel always runs the defaults;
    the CPU model in the tests passes smaller `band_rows`, `tile_cols` and
    `max_chunk`."""
    return fwd_plan(b, h, w, c, out_h, out_w, align_corners, elem_size, sms,
                    band_rows, tile_cols, max_chunk, extra_smem=0)


@functools.lru_cache(maxsize=64)
def _device_argmax_plan(b, h, w, c, out_h, out_w, align_corners, elem_size,
                        device):
    """`argmax_plan` for `device`'s SM count and its tables on `device`,
    copied there once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = argmax_plan(b, h, w, c, out_h, out_w, align_corners, elem_size,
                       sms)
    return plan, [torch.tensor(a, device=device)
                  for a in (plan.bands, plan.tiles)]


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    fn = load_kernel_library("upsample_argmax").pseg_upsample_argmax
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.restype = ctypes.c_int
    fn.argtypes = ([ptr, i32, i32, i32] + [i64] * 4 + [i32, i32]
                   + [ptr] * 8 + [ptr, i32, i32, ptr] + [i32] * 9
                   + [ptr, ptr])
    return fn


def _launch(logits: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    global _launches
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"upsample_argmax kernel takes float32 or bfloat16 "
                        f"logits, not {logits.dtype}")
    if any(s < 0 for s in logits.stride()):
        raise ValueError("upsample_argmax kernel needs non-negative strides")
    b, h, w, c = logits.shape
    out_h, out_w = out_hw
    if min(b, h, w, c) < 1 or out_h < 1 or out_w < 1:
        raise ValueError(f"empty upsample_argmax input {tuple(logits.shape)} "
                         f"-> {tuple(out_hw)}")
    if max(b, c, h, w, out_h, out_w) >= 2 ** 31:  # passed to C as int
        raise ValueError("upsample_argmax shape out of range")
    fn = _kernel_fn()
    dev = logits.device
    th = device_taps(h, out_h, align_corners, dev)
    tw = device_taps(w, out_w, align_corners, dev)
    plan, (bands, tiles) = _device_argmax_plan(
        b, h, w, c, out_h, out_w, align_corners, logits.element_size(), dev)
    out = torch.empty((b, out_h, out_w), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(logits.data_ptr(), _DTYPE_CODE[logits.dtype], b, c,
                 *logits.stride(), out_h, out_w,
                 *(t.data_ptr() for t in th), *(t.data_ptr() for t in tw),
                 bands.data_ptr(), plan.band_rows, len(plan.bands),
                 tiles.data_ptr(), plan.tile_cols, len(plan.tiles),
                 plan.chunk, plan.stage_rows, plan.stage_cols, plan.slot,
                 plan.a_stride, plan.smem_bytes, plan.threads,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"upsample_argmax kernel launch failed: CUDA "
                           f"error {err}")
    _launches += 1
    return out


def fused_upsample_argmax(logits: torch.Tensor, out_hw,
                          align_corners: bool = True) -> torch.Tensor:
    """logits [B, h, w, C] (f32 or bf16, any strides) -> argmax over classes
    of the bilinearly upsampled logits at `out_hw`, int32 [B, *out_hw].

    CUDA tensors go through the hand-written kernel, CPU tensors through
    `upsample_argmax_reference`; any other device raises."""
    if logits.dim() != 4:
        raise ValueError(f"logits must be [B, h, w, C], got "
                         f"{tuple(logits.shape)}")
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if logits.device.type == "cuda":
        return _launch(logits, out_hw, bool(align_corners))
    if logits.device.type == "cpu":
        return upsample_argmax_reference(logits, out_hw, align_corners)
    raise ValueError(f"fused_upsample_argmax: no path for device "
                     f"{logits.device}")
