"""Host-side resizes: the multi-scale size set (copy of
pytorch_segmentation_tpu/data/resize_host.py, which is standard library
only) and, in numpy, the `cv2.resize` calls of the JAX package's datasets
and `inference()`, so that a host without OpenCV reads the same records.

  - `resize_u8(img, (w, h), "nearest")`: cv2.INTER_NEAREST, bit-equal
    (source index floor(x * src / dst) in float64, as cv2's `resizeNN`);
  - `resize_u8(img, (w, h), "cubic" | "linear")`: cv2.INTER_CUBIC /
    INTER_LINEAR on uint8, in cv2's fixed-point arithmetic (taps from the
    float32 source position, coefficients rounded to 11 bits, the horizontal
    pass summed in int32; the cubic vertical pass rounded off 22 bits, the
    linear one in the form of cv2's vectorised pass). cv2 rounds some sums
    another way, so a pixel may differ by one level
    (tests/test_torch_datasets.py states the largest difference and share);
  - `resize_probs(probs, (h, w))`: cv2.INTER_LINEAR of a float [.., H, W, C]
    map in plain torch (half-pixel centres), on the tensor's device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["multi_scale_sizes", "resize_u8", "resize_probs"]


@functools.lru_cache(maxsize=64)
def multi_scale_sizes(base_hw, lo: float = 0.7, hi: float = 1.5,
                      snap: int = 32):
    """All (h, w) the multi-scale resize can produce: a bounded set."""
    h, w = base_hw
    sizes = set()
    # one scale drives both axes;
    # sampling the scale range densely enumerates every reachable snapped pair
    scales = [lo + i * (hi - lo) / 256 for i in range(257)]
    for s in scales:
        hh = int(h * s / snap) * snap
        ww = int(w * s / snap) * snap
        if hh > 0 and ww > 0:
            sizes.add((hh, ww))
    return sorted(sizes)


_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE: 11-bit coefficients


@functools.lru_cache(maxsize=128)
def _nearest_index(src: int, dst: int) -> np.ndarray:
    scale = 1.0 / (dst / src)  # cv2: ifx = 1 / inv_scale_x, in double
    idx = np.floor(np.arange(dst) * scale).astype(np.int64)
    return np.minimum(idx, src - 1)


@functools.lru_cache(maxsize=128)
def _taps(src: int, dst: int, cubic: bool):
    """(index [dst, k] int64, coefficient [dst, k] int32) of one axis: the
    source taps of each output position, clamped to the edge as cv2's
    BORDER_REPLICATE, and their 11-bit fixed-point weights."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if cubic:
        a = np.float32(-0.75)
        one = np.float32(1.0)
        x1 = f + one
        c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
        c1 = ((a + 2) * f - (a + 3)) * f * f + one
        r = one - f
        c2 = ((a + 2) * r - (a + 3)) * r * r + one
        c3 = one - c0 - c1 - c2
        coef = np.stack([c0, c1, c2, c3], axis=1)
        idx = s[:, None] + np.arange(-1, 3)
    else:
        # linear: a position left of the first or right of the last source
        # sample takes that sample alone (cv2 clamps fx and sx there)
        low, high = s < 0, s >= src - 1
        f = np.where(low | high, np.float32(0), f)
        s = np.where(low, 0, np.where(high, src - 1, s))
        coef = np.stack([np.float32(1) - f, f], axis=1)
        idx = s[:, None] + np.arange(2)
    coef = np.rint(coef.astype(np.float32) * np.float32(_COEF_SCALE))
    return np.clip(idx, 0, src - 1), coef.astype(np.int32)


def resize_u8(img: np.ndarray, size_wh, interpolation: str) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> [h, w(, C)] for `size_wh` = (w, h), as
    `cv2.resize(img, (w, h), interpolation=...)`: "nearest" bit-equal,
    "cubic" and "linear" within one level (see the module docstring)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_u8 takes uint8, not {img.dtype}")
    w, h = (int(v) for v in size_wh)
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return np.ascontiguousarray(img)
    if interpolation == "nearest":
        return np.ascontiguousarray(
            img[_nearest_index(sh, h)[:, None], _nearest_index(sw, w)])
    if interpolation not in ("cubic", "linear"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    cubic = interpolation == "cubic"
    xi, xc = _taps(sw, w, cubic)
    yi, yc = _taps(sh, h, cubic)
    extra = (None,) * (img.ndim - 2)
    src = img.astype(np.int32)
    # horizontal pass: int32 sums of u8 x 11-bit weights over the taps
    rows = src[:, xi[:, 0]] * xc[(slice(None), 0, *extra)]
    for k in range(1, xi.shape[1]):
        rows += src[:, xi[:, k]] * xc[(slice(None), k, *extra)]
    beta = [yc[(slice(None), k, None, *extra)] for k in range(yi.shape[1])]
    if cubic:
        # vertical pass, then the 22 fractional bits rounded off
        out = rows[yi[:, 0]] * beta[0]
        for k in range(1, 4):
            out += rows[yi[:, k]] * beta[k]
        out += 1 << 21
        out >>= 22
    else:
        # cv2's vectorised vertical pass: each row sum shifted right by 4,
        # multiplied by its 16-bit weight keeping the high 16 bits, the two
        # added and rounded off 2 more bits
        out = ((rows[yi[:, 0]] >> 4) * beta[0]) >> 16
        out += ((rows[yi[:, 1]] >> 4) * beta[1]) >> 16
        out += 2
        out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_probs(probs: torch.Tensor, out_hw) -> torch.Tensor:
    """Float [H, W, C] or [B, H, W, C] -> [(B,) h, w, C]: bilinear with
    half-pixel centres (cv2.INTER_LINEAR on float data; the taps are
    clamped at the edges as cv2 clamps them), on the tensor's device."""
    squeeze = probs.dim() == 3
    x = probs[None] if squeeze else probs
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                        mode="bilinear", align_corners=False,
                        antialias=False).permute(0, 2, 3, 1)
    return out[0] if squeeze else out
