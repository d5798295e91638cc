"""Row resampler of the augmentation warp: the last axis of value planes
[B, 4, R, C] resampled at per-row coordinates [B, R, W] (port of
pytorch_segmentation_tpu/ops/pallas/banded_resample.py).

On a CUDA tensor `banded_resample_rows` launches the hand-written kernel in
`csrc/banded_resample.cu` (one thread per output position: two taps, all
four planes; see the note there for what bounds it). On a CPU tensor it runs
`banded_resample_reference`, the plain PyTorch version the tests hold
against the JAX package. There is no fallback from one to the other: a CUDA
tensor gets the kernel or an exception.

The function has no window: the TPU kernel's clamp of the coordinates into
4 x 128 source columns is not carried over, so every coordinate in
[0, C-1] is resampled exactly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_kernel_library

__all__ = ["banded_resample_rows", "banded_resample_reference",
           "launch_count", "reset_launch_count"]

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
_launches = 0


def launch_count() -> int:
    """How many times the CUDA kernel has been launched in this process."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def banded_resample_reference(planes: torch.Tensor, coords: torch.Tensor,
                              use_bil: torch.Tensor,
                              out_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """The two-tap form in plain PyTorch: gathers on f32 copies of the bf16
    values, bilinear weights computed in f32 and rounded to bf16, the
    nearest tap at floor(c + 0.5) with the sum taken in f32. Both products
    are exact in f32, so the sum has one rounding. A tap outside [0, C-1]
    contributes nothing."""
    c = planes.shape[-1]
    values = planes.float()
    f0 = torch.floor(coords)
    f1 = f0 + 1.0
    fn = torch.floor(coords + 0.5)
    n0 = (fn == f0).float()
    n1 = (fn == f1).float()
    wb0 = (1.0 - (coords - f0).abs()).clamp_min(0.0).bfloat16().float()
    wb1 = (1.0 - (coords - f1).abs()).clamp_min(0.0).bfloat16().float()
    bil = use_bil.bool()[:, None, None]
    w0 = torch.where(bil, wb0, n0)
    w1 = torch.where(bil, wb1, n1)
    in0 = ((f0 >= 0) & (f0 <= c - 1)).float()
    in1 = ((f1 >= 0) & (f1 <= c - 1)).float()
    j0 = f0.clamp(0, c - 1).long()[:, None].expand(-1, 4, -1, -1)
    j1 = f1.clamp(0, c - 1).long()[:, None].expand(-1, 4, -1, -1)
    v0 = torch.gather(values, 3, j0) * in0[:, None]
    v1 = torch.gather(values, 3, j1) * in1[:, None]
    img = w0[:, None] * v0[:, :3] + w1[:, None] * v1[:, :3]
    seg = n0 * v0[:, 3] + n1 * v1[:, 3]
    return torch.cat([img, seg[:, None]], 1).to(out_dtype)


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    fn = load_kernel_library("banded_resample").pseg_banded_resample
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(planes, coords, use_bil, out_dtype) -> torch.Tensor:
    global _launches
    if planes.dtype != torch.bfloat16:
        raise TypeError(f"banded_resample kernel takes bfloat16 planes, not "
                        f"{planes.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"banded_resample kernel takes float32 coordinates, "
                        f"not {coords.dtype}")
    if use_bil.dtype != torch.bool:
        raise TypeError(f"use_bil must be bool, not {use_bil.dtype}")
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"banded_resample kernel writes float32 or bfloat16, "
                        f"not {out_dtype}")
    if coords.device != planes.device or use_bil.device != planes.device:
        raise ValueError("planes, coords and use_bil must share one device")
    if any(s < 0 for s in planes.stride()):
        raise ValueError("banded_resample kernel needs non-negative strides")
    b, _, r, c = planes.shape
    w = coords.shape[-1]
    if max(b, r, c, w) >= 2 ** 31:  # passed to C as int
        raise ValueError("banded_resample shape out of range")
    fn = _kernel_fn()
    coords = coords.contiguous()
    use_bil = use_bil.contiguous()
    out = torch.empty((b, 4, r, w), dtype=out_dtype, device=planes.device)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        err = fn(planes.data_ptr(), *planes.stride(), b, r, c,
                 coords.data_ptr(), w, use_bil.data_ptr(), out.data_ptr(),
                 _OUT_CODE[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"banded_resample kernel launch failed: CUDA "
                           f"error {err}")
    _launches += 1
    return out


def banded_resample_rows(planes: torch.Tensor, coords: torch.Tensor,
                         use_bil: torch.Tensor, *,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Resample the last axis of `planes` at per-row coordinates.

    planes:  [B, 4, R, C] bf16 (any strides): r, g, b and label-id planes
    coords:  [B, R, W] f32 source columns, in [0, C-1]
    use_bil: [B] bool: bilinear image taps where set, nearest otherwise;
             plane 3 (labels) is always nearest
    Returns [B, 4, R, W] `out_dtype` (f32 or bf16; the sum is taken in f32
    either way, and the label plane holds exact ids).

    CUDA tensors go through the hand-written kernel, CPU tensors through
    `banded_resample_reference`; any other device raises."""
    if planes.dim() != 4 or planes.shape[1] != 4:
        raise ValueError(f"planes must be [B, 4, R, C], got "
                         f"{tuple(planes.shape)}")
    if (coords.dim() != 3
            or tuple(coords.shape[:2]) != (planes.shape[0], planes.shape[2])
            or tuple(use_bil.shape) != (planes.shape[0],)):
        raise ValueError(f"coords {tuple(coords.shape)} / use_bil "
                         f"{tuple(use_bil.shape)} do not fit planes "
                         f"{tuple(planes.shape)}")
    if planes.device.type == "cuda":
        return _launch(planes, coords, use_bil, out_dtype)
    if planes.device.type == "cpu":
        return banded_resample_reference(planes, coords, use_bil, out_dtype)
    raise ValueError(f"banded_resample_rows: no path for device "
                     f"{planes.device}")
