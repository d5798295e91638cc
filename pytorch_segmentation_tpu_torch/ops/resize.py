"""Bilinear and nearest resizing of NHWC tensors (port of
pytorch_segmentation_tpu/ops/resize.py).

Bilinear resizing is two contractions against small dense interpolation
matrices, one along H and one along W, exactly as the JAX package does it, so
the coordinate conventions (PyTorch's, for both `align_corners` settings)
and the roundings are the same on both sides. The matrices come from
`_interp_weights`, which the fused upsample+argmax kernel also reads its taps
from.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_bilinear", "resize_bilinear_nchw", "resize_nearest",
           "upsample2x"]


@functools.lru_cache(maxsize=256)
def _interp_weights_cached(in_size: int, out_size: int, align_corners: bool):
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    out = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            src = np.zeros(1, dtype=np.float64)
        else:
            src = out * (in_size - 1) / (out_size - 1)
    else:
        src = (out + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    i0 = np.floor(src).astype(np.int64)
    i0 = np.clip(i0, 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    w0 = 1.0 - w1
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    mat[np.arange(out_size), i0] += w0
    mat[np.arange(out_size), i1] += w1
    mat.flags.writeable = False
    return mat


def _interp_weights(in_size: int, out_size: int, align_corners: bool):
    """Dense [out_size, in_size] f32 bilinear interpolation matrix, equal bit
    for bit to the JAX package's. Returns a fresh copy: the cached matrix is
    shared between callers and read-only."""
    return _interp_weights_cached(int(in_size), int(out_size),
                                  bool(align_corners)).copy()


@functools.lru_cache(maxsize=256)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    # torch 'nearest' convention: src = floor(out * in / out_size)
    idx = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
    idx = np.clip(idx.astype(np.int64), 0, in_size - 1)
    idx.flags.writeable = False
    return idx


@functools.lru_cache(maxsize=256)
def _device_weights(in_size: int, out_size: int, align_corners: bool,
                    compute_dtype, device) -> torch.Tensor:
    """`_interp_weights` on `device`, rounded to `compute_dtype` and held as
    f32: copied there once and shared (never written to), since a copy from
    pageable host memory waits for all the work queued on the stream. Made
    outside inference mode, so that a matrix first used while serving can
    take part in a later training graph."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_weights(
            in_size, out_size, align_corners)).to(
                device=device, dtype=compute_dtype).float()


@functools.lru_cache(maxsize=256)
def _device_nearest_indices(in_size: int, out_size: int, device):
    with torch.inference_mode(False):
        return torch.tensor(_nearest_indices(in_size, out_size),
                            device=device)


def resize_bilinear(x: torch.Tensor, out_hw,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear-resize NHWC (or HWC) `x` to `out_hw=(H, W)`.

    The interpolation matrices are cast to the compute dtype (f32 for an f32
    or f64 input, bf16 otherwise), and each contraction runs in f32 and
    rounds to the compute dtype, as the JAX package's HIGHEST-precision
    einsums do. The output has the input's dtype."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x[0] if squeeze else x
    orig_dtype = x.dtype
    compute_dtype = (torch.float32 if x.dtype in (torch.float32, torch.float64)
                     else torch.bfloat16)
    mh = _device_weights(h, oh, bool(align_corners), compute_dtype, x.device)
    mw = _device_weights(w, ow, bool(align_corners), compute_dtype, x.device)
    y = x.to(compute_dtype).float()
    # [oh,h] x [b,h,w,c] -> [b,oh,w,c]; then [ow,w] x [b,oh,w,c] -> [b,oh,ow,c]
    y = torch.einsum("oh,bhwc->bowc", mh, y).to(compute_dtype).float()
    y = torch.einsum("pw,bowc->bopc", mw, y).to(compute_dtype)
    y = y.to(orig_dtype)
    return y[0] if squeeze else y


def resize_bilinear_nchw(x: torch.Tensor, out_hw,
                         align_corners: bool = False) -> torch.Tensor:
    """`resize_bilinear` of an NCHW tensor (through NHWC views, so a
    channels_last input stays channels_last)."""
    return resize_bilinear(x.permute(0, 2, 3, 1), out_hw,
                           align_corners=align_corners).permute(0, 3, 1, 2)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC / NHW (or HW) tensors, for masks."""
    spatial_offset = 1 if x.dim() >= 3 else 0
    h = x.shape[spatial_offset]
    w = x.shape[spatial_offset + 1]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    hi = _device_nearest_indices(h, oh, x.device)
    wi = _device_nearest_indices(w, ow, x.device)
    x = torch.index_select(x, spatial_offset, hi)
    return torch.index_select(x, spatial_offset + 1, wi)


def upsample2x(x: torch.Tensor, align_corners: bool = True) -> torch.Tensor:
    """scale_factor=2 bilinear upsampling of NHWC `x`: `resize_bilinear` to
    (2h, 2w)."""
    _, h, w, _ = x.shape
    return resize_bilinear(x, (2 * h, 2 * w), align_corners=align_corners)
