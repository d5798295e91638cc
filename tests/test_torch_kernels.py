"""PyTorch port: resizing and the upsample+argmax kernel module against the
JAX package (CPU; the JAX Pallas kernel runs in interpret mode), and the CUDA
kernel's tiling (`argmax_plan`) and arithmetic, modelled in plain torch,
against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.ops import resize as jresize
from pytorch_segmentation_tpu.ops.pallas.upsample_argmax import (
    fused_upsample_argmax as jax_fused_upsample_argmax)
from pytorch_segmentation_tpu_torch.ops import resize as tresize
from pytorch_segmentation_tpu_torch.ops.kernels import upsample_argmax as ua
from torch_port_util import (BAND_PLAN_SHAPES, assert_masks_agree,
                             assert_output_band_plan)

torch.set_num_threads(1)

SIZES = (1, 2, 3, 5, 8, 17, 33, 65, 129, 513)


@pytest.mark.parametrize("align", [True, False])
def test_interp_weights_bit_equal(align):
    for n_in in SIZES:
        for n_out in SIZES:
            want = jresize._interp_weights(n_in, n_out, align)
            got = tresize._interp_weights(n_in, n_out, align)
            assert got.dtype == np.float32
            assert np.array_equal(got, want), (n_in, n_out, align)
    # callers get a copy: writing to it leaves the cached matrix alone
    tresize._interp_weights(9, 33, align)[:] = 7.0
    assert np.array_equal(tresize._interp_weights(9, 33, align),
                          jresize._interp_weights(9, 33, align))


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 9, 11, 3), (33, 41)),   # upsample, ragged sizes
    ((2, 16, 12, 4), (5, 7)),    # downsample
    ((9, 11, 3), (9, 20)),       # HWC input, one axis unchanged
])
@pytest.mark.parametrize("align", [True, False])
def test_resize_bilinear_f32(shape, out_hw, align):
    # f32 end to end; both sides sum the same two nonzero taps per output
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw,
                                              align_corners=align))
    got = tresize.resize_bilinear(torch.from_numpy(x), out_hw,
                                  align_corners=align)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_resize_bilinear_bf16():
    # bf16 in: matrices and the intermediate round to bf16 on both sides;
    # allow one bf16 ulp (2^-8 relative) for where the rounding lands
    x = np.random.default_rng(1).standard_normal((2, 9, 11, 3))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jresize.resize_bilinear(xb, (33, 41), True)
                      .astype(jnp.float32))
    got = tresize.resize_bilinear(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        (33, 41), align_corners=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=2 ** -8)


def test_resize_nearest_equal():
    m = np.random.default_rng(2).integers(0, 21, (2, 13, 17)).astype(np.int32)
    for out_hw in ((40, 51), (6, 5), (13, 17)):
        want = np.asarray(jresize.resize_nearest(jnp.asarray(m), out_hw))
        got = tresize.resize_nearest(torch.from_numpy(m), out_hw).numpy()
        assert np.array_equal(got, want), out_hw


def _jax_up(logits, out_hw, align):
    return np.asarray(jresize.resize_bilinear(
        jnp.asarray(logits, jnp.float32), out_hw, align_corners=align))


@pytest.mark.parametrize("case", ["align_true", "align_false", "ragged_rows",
                                  "bf16"])
def test_upsample_argmax_plain_vs_jax_kernel(case):
    rng = np.random.default_rng(3)
    shape, out_hw, align, dtype = {
        "align_true": ((2, 9, 11, 5), (33, 41), True, np.float32),
        "align_false": ((2, 9, 11, 5), (33, 41), False, np.float32),
        # 19 output rows: not a multiple of the Pallas row tile
        "ragged_rows": ((1, 5, 7, 3), (19, 23), False, np.float32),
        "bf16": ((2, 9, 11, 5), (33, 41), True, jnp.bfloat16),
    }[case]
    x = jnp.asarray(rng.standard_normal(shape), dtype)
    want = np.asarray(jax_fused_upsample_argmax(x, out_hw, align_corners=align,
                                                tile=8, interpret=True))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        xt = xt.bfloat16()  # exact: the values are bf16 already
    before = ua.launch_count()
    got = ua.fused_upsample_argmax(xt, out_hw, align_corners=align)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert ua.launch_count() == before  # CPU tensor: plain version
    assert_masks_agree(got.numpy(), want, _jax_up(xt.float().numpy(), out_hw,
                                                  align))


def test_upsample_argmax_150_classes():
    # beyond the Pallas kernel's 128-class cap: JAX argmax(resize) only
    x = np.random.default_rng(4).standard_normal((1, 7, 9, 150)
                                                 ).astype(np.float32)
    up = _jax_up(x, (25, 33), True)
    got = ua.fused_upsample_argmax(torch.from_numpy(x), (25, 33), True)
    assert_masks_agree(got.numpy(), up.argmax(-1), up)


def test_upsample_argmax_ties_lowest_class_wins():
    x = np.random.default_rng(5).standard_normal((2, 6, 7, 6)
                                                 ).astype(np.float32)
    x[..., 4] = x[..., 1]  # exact duplicates: class 1 must win over 4
    x[..., 5] = x[..., 0]
    want = np.asarray(jax_fused_upsample_argmax(jnp.asarray(x), (17, 19),
                                                tile=8, interpret=True))
    got = ua.fused_upsample_argmax(torch.from_numpy(x), (17, 19)).numpy()
    assert np.array_equal(got, want)
    assert not np.isin(got, [4, 5]).any()
    assert {0, 1} <= set(np.unique(got))


def _tap_gather(logits, out_hw, align):
    """The CUDA kernel's arithmetic, in torch: per pixel the 2x2 taps from
    interp_taps, H first then W, in f32; argmax lowest id first."""
    _, h, w, _ = logits.shape
    hi0, hi1, hw0, hw1 = (torch.from_numpy(np.array(a))
                          for a in ua.interp_taps(h, out_hw[0], align))
    wi0, wi1, ww0, ww1 = (torch.from_numpy(np.array(a))
                          for a in ua.interp_taps(w, out_hw[1], align))
    x = logits.float()

    def rows(i):
        return x[:, i.long()]

    def cols(t, i):
        return t[:, :, i.long()]

    hw0, hw1 = hw0[None, :, None, None], hw1[None, :, None, None]
    ww0, ww1 = ww0[None, None, :, None], ww1[None, None, :, None]
    a0 = hw0 * cols(rows(hi0), wi0) + hw1 * cols(rows(hi1), wi0)
    a1 = hw0 * cols(rows(hi0), wi1) + hw1 * cols(rows(hi1), wi1)
    return ww0 * a0 + ww1 * a1


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 9, 11, 5), (33, 41)),   # upsample
    ((1, 9, 11, 4), (9, 5)),     # identity rows, downsampled columns
    ((1, 1, 6, 3), (7, 1)),      # one source row, one output column
])
@pytest.mark.parametrize("align", [True, False])
def test_kernel_tap_arithmetic_matches_matrix_form(shape, out_hw, align):
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(shape)
                         .astype(np.float32))
    up = _tap_gather(x, out_hw, align)
    ref_up = tresize.resize_bilinear(x, out_hw, align_corners=align)
    # two products and one add per axis on both sides; only FMA may differ
    torch.testing.assert_close(up, ref_up, rtol=1e-6, atol=1e-6)
    assert_masks_agree(up.argmax(-1).numpy(),
                       ua.upsample_argmax_reference(x, out_hw, align).numpy(),
                       ref_up.numpy())


def test_wrapper_routes_and_checks():
    x = torch.randn(2, 3, 7, 9)  # NCHW memory, read as NHWC through strides
    logits = x.permute(0, 2, 3, 1)
    before = ua.launch_count()
    got = ua.fused_upsample_argmax(logits, (13, 17))
    assert torch.equal(got, ua.upsample_argmax_reference(
        logits.contiguous(), (13, 17)))
    assert ua.launch_count() == before
    with pytest.raises(ValueError):
        ua.fused_upsample_argmax(logits[0], (13, 17))
    with pytest.raises(ValueError, match="no path"):
        ua.fused_upsample_argmax(logits.to("meta"), (13, 17))


@pytest.mark.parametrize("args", BAND_PLAN_SHAPES)
def test_argmax_plan_covers_every_pixel_and_fits(args):
    """`argmax_plan` is the CE forward's output-band plan with nothing after
    the two row buffers: every pixel in one block, what each block reads
    staged, two blocks an SM."""
    assert_output_band_plan(ua.argmax_plan(*args), args, table_bytes=0)


def _argmax_banded_arithmetic(logits, out_hw, align, **tiling):
    """The kernel's arithmetic, in torch, block by block as `argmax_plan`
    tiles it: per band of output rows and tile of output columns the staged
    source rows and columns, then per class chunk (ascending) each output
    row interpolated along H at every staged column, each pixel along W,
    and the argmax over the chunk's classes in the select form (strict '>'
    from -1e30), its (best, pred) carried from chunk to chunk. -> (the mask
    int32 [B, H, W]; how many blocks wrote each pixel)."""
    b, h, w, c = logits.shape
    out_h, out_w = out_hw
    plan = ua.argmax_plan(b, h, w, c, out_h, out_w, align, **tiling)
    hi0, hi1, hw0, hw1 = (torch.from_numpy(np.array(a))
                          for a in ua.interp_taps(h, out_h, align))
    wi0, wi1, ww0, ww1 = (torch.from_numpy(np.array(a))
                          for a in ua.interp_taps(w, out_w, align))
    x = logits.float()
    mask = torch.full((b, out_h, out_w), -1, dtype=torch.int32)
    writes = torch.zeros((b, out_h, out_w), dtype=torch.int64)
    for y_lo, y_hi, r_lo, r_hi in plan.bands:
        ys = torch.arange(y_lo, y_hi)
        for x_lo, x_hi, c_lo, c_hi in plan.tiles:
            xs = torch.arange(x_lo, x_hi)
            staged = x[:, r_lo:r_hi + 1, c_lo:c_hi + 1]
            shape = (b, len(ys), len(xs))
            best = torch.full(shape, -1e30)
            pred = torch.zeros(shape, dtype=torch.int32)
            for c0 in range(0, c, plan.chunk):
                cs = slice(c0, min(c, c0 + plan.chunk))
                a = (hw0[ys][None, :, None, None]
                     * staged[:, (hi0[ys] - r_lo).long(), :, cs]
                     + hw1[ys][None, :, None, None]
                     * staged[:, (hi1[ys] - r_lo).long(), :, cs])
                up = (ww0[xs][None, None, :, None]
                      * a[:, :, (wi0[xs] - c_lo).long()]
                      + ww1[xs][None, None, :, None]
                      * a[:, :, (wi1[xs] - c_lo).long()])
                for k in range(up.shape[-1]):
                    take = up[..., k] > best
                    best = torch.where(take, up[..., k], best)
                    pred = torch.where(take, c0 + k, pred)
            mask[:, y_lo:y_hi, x_lo:x_hi] = pred
            writes[:, y_lo:y_hi, x_lo:x_hi] += 1
    return mask, writes


# name -> (logits shape, mask (H, W), align_corners, argmax_plan tiling)
ARGMAX_BANDED_CASES = {
    # 33 output rows in bands of 4 (the last of 1), 41 columns in 3 tiles
    "ragged_align_true": ((2, 9, 11, 5), (33, 41), True,
                          dict(band_rows=4, tile_cols=15)),
    "ragged_align_false": ((2, 9, 11, 5), (33, 41), False,
                           dict(band_rows=4, tile_cols=15)),
    # 7 classes in chunks of 3, 3, 1 (bands of one row); class 5 duplicates
    # class 1, across chunks: class 1 must win every tie
    "class_chunks_tie": ((1, 7, 19, 7), (29, 31), False,
                         dict(tile_cols=8, max_chunk=3)),
    "downsampled_both": ((1, 20, 30, 5), (7, 9), False,
                         dict(band_rows=2, tile_cols=4, max_chunk=2)),
    "one_source_row": ((2, 1, 6, 4), (5, 13), True,
                       dict(band_rows=2, tile_cols=6)),
    "defaults_c21": ((2, 17, 13, 21), (65, 49), True, {}),
}


@pytest.mark.parametrize("case", sorted(ARGMAX_BANDED_CASES))
def test_argmax_banded_arithmetic_agrees_with_plain(case):
    """The kernel's tiling and arithmetic against the plain version: every
    pixel written by one block, the masks equal where the top-2 gap is
    clear (the same f32 values in another interpolation order), and a tie
    kept by the lower class."""
    shape, out_hw, align, tiling = ARGMAX_BANDED_CASES[case]
    x = np.random.default_rng(13).standard_normal(shape).astype(np.float32)
    if case.endswith("_tie"):
        x[..., 5] = x[..., 1]
    logits = torch.from_numpy(x)
    plan = ua.argmax_plan(*shape, *out_hw, align, **tiling)
    if tiling:  # the tiling the case names is the one the model follows
        assert len(plan.bands) > 1 or shape[1] == 1 or out_hw[0] == 1
        assert (plan.chunk < shape[-1]) == ("max_chunk" in tiling)
    got, writes = _argmax_banded_arithmetic(logits, out_hw, align, **tiling)
    assert bool((writes == 1).all())
    want = ua.upsample_argmax_reference(logits, out_hw, align)
    up = tresize.resize_bilinear(logits, out_hw, align_corners=align)
    assert_masks_agree(got.numpy(), want.numpy(), up.numpy())
    if case.endswith("_tie"):
        assert not bool((got == 5).any()) and bool((got == 1).any())
