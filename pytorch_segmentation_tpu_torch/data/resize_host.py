"""Host-side helper for multi-scale size selection: scale ~ U(0.7, 1.5),
snapped to multiples of 32 (copy of
pytorch_segmentation_tpu/data/resize_host.py, which is standard library
only)."""

from __future__ import annotations

import functools

__all__ = ["multi_scale_sizes"]


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
