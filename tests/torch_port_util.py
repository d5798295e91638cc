"""Shared pieces of the PyTorch port's CPU tests (tests/test_torch_*.py)."""

from __future__ import annotations

import numpy as np

from pytorch_segmentation_tpu_torch.ops.kernels import softmax_ce as ce
from pytorch_segmentation_tpu_torch.ops.kernels.upsample_argmax import (
    interp_taps)

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


# (b, h, w, c, out_h, out_w, align_corners, elem_size) that the output-band
# plans (`softmax_ce.fwd_plan`, `eval_confusion.eval_plan`) are held to
BAND_PLAN_SHAPES = [
    (32, 129, 129, 21, 513, 513, True, 2),      # the path shape, bf16
    (32, 129, 129, 21, 513, 513, True, 4),      # and f32
    (32, 65, 65, 21, 513, 513, True, 2),        # PSPNet, FastFCN: 8x
    (32, 33, 33, 21, 513, 513, True, 2),        # FastFCN's aux head: 16x
    (8, 128, 128, 21, 512, 512, False, 2),      # FPN served: 4x
    (2, 65, 97, 150, 257, 385, False, 2),
    (32, 45, 37, 97, 177, 145, False, 4),
    (1, 4, 3000, 150, 6, 300, True, 4),         # bands, tiles and chunks
    (1, 3, 2000, 32, 5, 16, True, 4),           # columns downsampled 125x
    (1, 1, 1, 1, 1, 1, True, 4),
    (3, 4, 5, 2, 4, 5, True, 4),                # same size, an even chunk
]


def assert_output_band_plan(plan, args, table_bytes=0):
    """`plan` (`softmax_ce.fwd_plan` or `eval_confusion.eval_plan` of
    `args` = (b, h, w, c, out_h, out_w, align_corners, elem_size)) puts
    every output pixel in exactly one block, stages what each block reads,
    and fits its shared memory (staged rows, two H-interpolated row
    buffers, then `table_bytes`) into two blocks an SM."""
    b, h, w, c, out_h, out_w, align, elem = args
    for table, size, step in ((plan.bands, out_h, plan.band_rows),
                              (plan.tiles, out_w, plan.tile_cols)):
        lo, hi = table[:, 0], table[:, 1]
        # consecutive, ascending, each `step` long but the last: every
        # output index in exactly one band (tile)
        assert lo[0] == 0 and hi[-1] == size
        assert np.array_equal(lo[1:], hi[:-1])
        assert bool((hi - lo <= step).all() and (hi[:-1] - lo[:-1] == step)
                    .all())
    for table, n_in, n_out, staged in (
            (plan.bands, h, out_h, plan.stage_rows),
            (plan.tiles, w, out_w, plan.stage_cols)):
        i0, i1, _, _ = interp_taps(n_in, n_out, align)
        for lo, hi, first, last in table:
            assert first <= i0[lo:hi].min() and i1[lo:hi].max() <= last
            assert 0 <= first <= last < n_in and last - first < staged
    assert plan.tile_cols <= plan.threads <= ce.FWD_MAX_THREADS
    assert plan.threads % 32 == 0
    assert plan.a_stride % 2 == 1 and plan.a_stride >= plan.chunk
    assert plan.chunk == c or plan.band_rows == 1
    slot, staged = ce._stage_smem(plan.stage_rows, plan.stage_cols,
                                  plan.chunk, elem)
    assert plan.slot == slot and plan.slot * elem % 16 == 0
    assert plan.smem_bytes == (staged + 8 * plan.stage_cols * plan.a_stride
                               + table_bytes)
    assert plan.smem_bytes <= ce._SMEM_TWO_BLOCKS
