"""Shared pieces of the PyTorch port's CPU tests (tests/test_torch_*.py)."""

from __future__ import annotations

import numpy as np

# mask criterion: pixels whose top-2 gap in the f32 upsampled logits is
# above GAP must agree exactly (a closer pair may flip under another FMA or
# summation order); overall agreement at least AGREEMENT
GAP = 1e-4
AGREEMENT = 0.999


def assert_masks_agree(got, want, up, gap=GAP, agreement=AGREEMENT):
    """got/want: int masks [B, H, W]; up: the f32 upsampled logits
    [B, H, W, C] both masks are argmaxes of (up to rounding)."""
    got, want, up = np.asarray(got), np.asarray(want), np.asarray(up)
    assert got.shape == want.shape == up.shape[:-1]
    ranked = -np.sort(-up, axis=-1)
    if up.shape[-1] == 1:  # one class: no runner-up, every pixel is clear
        clear = np.ones(got.shape, bool)
    else:
        clear = (ranked[..., 0] - ranked[..., 1]) > gap
    wrong = int(((got != want) & clear).sum())
    agreed = float((got == want).mean())
    assert wrong == 0, f"{wrong} pixels with a clear top-2 gap disagree"
    assert agreed >= agreement, agreed
