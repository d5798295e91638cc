"""Fused bilinear upsample + argmax: logits [B, h, w, C] -> int32 mask
[B, H, W], without writing the upsampled logits (port of
pytorch_segmentation_tpu/ops/pallas/upsample_argmax.py).

On a CUDA tensor `fused_upsample_argmax` launches the hand-written kernel in
`csrc/upsample_argmax.cu` (one thread per output pixel, 2x2 tap gather,
online argmax; see the note there for what bounds it). On a CPU tensor it
runs `upsample_argmax_reference`, the plain PyTorch version the tests hold
against the JAX package. There is no fallback from one to the other: a CUDA
tensor gets the kernel or an exception.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..resize import _interp_weights, resize_bilinear
from .build import load_kernel_library

__all__ = ["fused_upsample_argmax", "upsample_argmax_reference",
           "interp_taps", "launch_count", "reset_launch_count"]

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


@functools.lru_cache(maxsize=64)
def interp_taps(in_size: int, out_size: int, align_corners: bool):
    """Two taps per output row of `_interp_weights(in_size, out_size)`:
    (i0, i1) int32 and (w0, w1) f32, numpy. The weights are the matrix's own
    entries; where a row collapses to one entry (i0 == i1 at a clamped edge)
    that entry is w0 and w1 is 0, so the gather gives what the matrix
    product gives."""
    mat = _interp_weights(in_size, out_size, align_corners)
    rows = np.arange(out_size)
    i0 = np.argmax(mat != 0, axis=1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w0 = mat[rows, i0]
    w1 = np.where(i1 > i0, mat[rows, i1], np.float32(0))
    taps = (i0.astype(np.int32), i1.astype(np.int32),
            w0.astype(np.float32), w1.astype(np.float32))
    for a in taps:
        a.flags.writeable = False
    return taps


@functools.lru_cache(maxsize=64)
def _device_taps(in_size, out_size, align_corners, device):
    return [torch.tensor(a, device=device)
            for a in interp_taps(in_size, out_size, align_corners)]


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    fn = load_kernel_library("upsample_argmax").pseg_upsample_argmax
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_int64] * 4 + [ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 10)
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
    if max(b, c, out_h, out_w) >= 2 ** 31:  # passed to C as int
        raise ValueError("upsample_argmax shape out of range")
    fn = _kernel_fn()
    dev = logits.device
    th = _device_taps(h, out_h, align_corners, dev)
    tw = _device_taps(w, out_w, align_corners, dev)
    out = torch.empty((b, out_h, out_w), dtype=torch.int32, device=dev)
    s_b, s_h, s_w, s_c = logits.stride()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(logits.data_ptr(), _DTYPE_CODE[logits.dtype], b, c,
                 s_b, s_h, s_w, s_c, out_h, out_w,
                 *(t.data_ptr() for t in th), *(t.data_ptr() for t in tw),
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
