"""The two taps a bilinear output index reads along one axis, as the banded
and gather kernels take them: shared by `upsample_argmax`, `softmax_ce` and
`eval_confusion`, which import each other's plans, so the taps live here
and none of the three imports another to reach them."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..resize import _interp_weights

__all__ = ["interp_taps", "device_taps"]


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
def device_taps(in_size, out_size, align_corners, device):
    """`interp_taps` as four tensors on `device`, copied there once."""
    return [torch.tensor(a, device=device)
            for a in interp_taps(in_size, out_size, align_corners)]
