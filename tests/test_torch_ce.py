"""PyTorch port: the fused upsample + cross-entropy module and ops/loss.py
against the JAX package on the same numpy inputs (CPU; the JAX Pallas kernels
run in interpret mode). On the CPU the port's wrapper runs its plain version;
the CUDA kernels' arithmetic is emulated here in torch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pytorch_segmentation_tpu.ops import loss as jloss
from pytorch_segmentation_tpu.ops.pallas import softmax_ce as jce
from pytorch_segmentation_tpu_torch.ops import loss as tloss
from pytorch_segmentation_tpu_torch.ops import resize as tresize
from pytorch_segmentation_tpu_torch.ops.kernels import softmax_ce as ce
from pytorch_segmentation_tpu_torch.ops.kernels.upsample_argmax import (
    interp_taps)
from torch_port_util import BAND_PLAN_SHAPES, assert_output_band_plan

torch.set_num_threads(1)

# name -> (logits shape, label (H, W), align_corners)
CASES = {
    "align_true_c5": ((2, 9, 11, 5), (33, 41), True),
    "align_false_c5": ((2, 9, 11, 5), (33, 41), False),
    # 19 output rows: not a multiple of the Pallas row tile
    "ragged_rows_c3": ((1, 5, 7, 3), (19, 23), False),
    "c21": ((2, 8, 8, 21), (16, 16), True),
    # 65..128 classes: the JAX _fwd_lse / _bwd_cb kernel pair
    "c81": ((1, 8, 8, 81), (16, 16), True),
}


def _inputs(shape, out_hw, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, shape[-1], (shape[0],) + out_hw).astype(np.int32)
    return logits, labels


def _torch_value_and_grad(fn, logits, labels, dtype=torch.float32):
    x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    value = fn(x, torch.from_numpy(labels))
    value.backward()
    assert x.grad.dtype == dtype and value.dtype == torch.float32
    return float(value.detach()), x.grad


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_ce_matches_jax_reference_and_kernel(case):
    shape, out_hw, align = CASES[case]
    logits, labels = _inputs(shape, out_hw)
    before = ce.launch_count()
    got, got_grad = _torch_value_and_grad(
        lambda x, y: ce.fused_upsample_ce(x, y, align_corners=align),
        logits, labels)
    assert ce.launch_count() == before  # CPU tensor: plain version

    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    ref, ref_grad = jax.value_and_grad(
        lambda l: jloss.compute_loss(l, jy, align_corners=align))(jl)
    with pltpu.force_tpu_interpret_mode():
        ker, ker_grad = jax.value_and_grad(
            lambda l: jce.fused_upsample_ce(l, jy, align_corners=align,
                                            tile=8, interpret=True))(jl)
    # f32 on all sides; only the summation order differs
    for want, want_grad in ((ref, ref_grad), (ker, ker_grad)):
        np.testing.assert_allclose(got, float(want), rtol=1e-5)
        np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                                   rtol=0, atol=1e-6)


def test_plain_ce_150_classes():
    """Beyond the Pallas kernels' 128-class cap the JAX package falls back
    to compute_loss; the port has one path for every class count."""
    logits, labels = _inputs((1, 7, 9, 150), (25, 33), seed=4)
    got, got_grad = _torch_value_and_grad(ce.fused_upsample_ce, logits,
                                          labels)
    jy = jnp.asarray(labels)
    ref, ref_grad = jax.value_and_grad(
        lambda l: jce.fused_upsample_ce(l, jy, tile=8, interpret=True))(
            jnp.asarray(logits))
    np.testing.assert_allclose(got, float(ref), rtol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(ref_grad),
                               rtol=0, atol=1e-6)


def test_per_sample_matches_jax_kernel():
    logits, labels = _inputs((4, 16, 16, 5), (64, 64), seed=1)
    want = np.asarray(jce.fused_upsample_ce_per_sample(
        jnp.asarray(logits), jnp.asarray(labels), interpret=True))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = ce.fused_upsample_ce_per_sample(x, torch.from_numpy(labels))
    assert got.shape == (4,) and not got.requires_grad  # forward only
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # the mean of the per-sample losses is the batch loss
    np.testing.assert_allclose(
        float(got.mean()),
        float(ce.fused_upsample_ce(x, torch.from_numpy(labels))), rtol=1e-6)


def test_bf16_logits_give_bf16_gradient():
    """bf16 logits are upcast exactly and all arithmetic is f32 on both
    sides; the gradient rounds to bf16 once at the end, so it may land one
    rounding step away: two bf16 ulps (2^-7 relative) of the JAX one."""
    logits, labels = _inputs((2, 9, 11, 5), (33, 41), seed=2)
    jl = jnp.asarray(logits, jnp.bfloat16)
    jy = jnp.asarray(labels)
    with pltpu.force_tpu_interpret_mode():
        want, want_grad = jax.value_and_grad(
            lambda l: jce.fused_upsample_ce(l, jy, tile=8, interpret=True))(jl)
    assert want_grad.dtype == jnp.bfloat16
    exact = np.array(jl.astype(jnp.float32))
    got, got_grad = _torch_value_and_grad(ce.fused_upsample_ce, exact, labels,
                                          dtype=torch.bfloat16)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    want_grad = np.asarray(want_grad.astype(jnp.float32))
    np.testing.assert_allclose(got_grad.float().numpy(), want_grad,
                               rtol=2 ** -7, atol=2 ** -7 * 1e-6)


def test_labels_outside_the_classes_match_no_class():
    """As the TPU kernel's one-hot compare: true logit 0, empty one-hot."""
    logits, labels = _inputs((1, 5, 7, 3), (19, 23), seed=3)
    labels[0, :4] = 7
    labels[0, 4:6] = -1
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    with pltpu.force_tpu_interpret_mode():
        want, want_grad = jax.value_and_grad(
            lambda l: jce._fused_ce(l, jy, (19, 23), True, 8))(jl)
    got, got_grad = _torch_value_and_grad(ce.fused_upsample_ce, logits,
                                          labels)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("align", [True, False])
def test_interp_taps_transposed_are_the_matrix_columns(align):
    for n_in, n_out in [(1, 1), (1, 7), (5, 5), (5, 17), (9, 33), (129, 513),
                        (20, 7), (33, 1)]:
        mat = tresize._interp_weights(n_in, n_out, align)
        start, count, weight = ce.interp_taps_transposed(n_in, n_out, align)
        assert start.dtype == count.dtype == np.int32
        assert weight.dtype == np.float32
        rebuilt = np.zeros_like(mat)
        for i in range(n_in):
            rebuilt[start[i]:start[i] + count[i], i] = weight[i, :count[i]]
            assert not weight[i, count[i]:].any()
        assert np.array_equal(rebuilt, mat), (n_in, n_out, align)


def _kernel_arithmetic(logits, labels, align):
    """The CUDA kernels' arithmetic, in torch. Forward: per output pixel the
    2x2 taps (H first, then W), logsumexp over classes, the label's logit by
    comparison. Backward: per source pixel and class, the transposed tap
    table's outputs, columns summed first, then rows. -> (loss, dlogits,
    lse [B, H, W])."""
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1:]
    hi0, hi1, hw0, hw1 = (torch.from_numpy(np.array(a))
                          for a in interp_taps(h, out_h, align))
    wi0, wi1, ww0, ww1 = (torch.from_numpy(np.array(a))
                          for a in interp_taps(w, out_w, align))
    x = logits.float()
    hw0, hw1 = hw0[None, :, None, None], hw1[None, :, None, None]
    ww0, ww1 = ww0[None, None, :, None], ww1[None, None, :, None]
    r0, r1 = x[:, hi0.long()], x[:, hi1.long()]
    a0 = hw0 * r0[:, :, wi0.long()] + hw1 * r1[:, :, wi0.long()]
    a1 = hw0 * r0[:, :, wi1.long()] + hw1 * r1[:, :, wi1.long()]
    up = ww0 * a0 + ww1 * a1
    lse = torch.logsumexp(up, dim=-1)
    onehot = (labels.long()[..., None] == torch.arange(c)).float()
    loss = (lse - (up * onehot).sum(-1)).mean()

    resid = torch.exp(up - lse[..., None]) - onehot       # [B, H, W, C]
    ys, yc, yw = ce.interp_taps_transposed(h, out_h, align)
    xs, xc, xw = ce.interp_taps_transposed(w, out_w, align)
    dlogits = torch.zeros_like(x)
    for i in range(h):
        for j in range(w):
            rows = resid[:, ys[i]:ys[i] + yc[i], xs[j]:xs[j] + xc[j]]
            row_acc = (rows * torch.from_numpy(xw[j, :xc[j]].copy())
                       [None, None, :, None]).sum(2)
            dlogits[:, i, j] = (row_acc * torch.from_numpy(
                yw[i, :yc[i]].copy())[None, :, None]).sum(1)
    return loss, dlogits / (b * out_h * out_w), lse


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 5, 7, 4), (17, 23)),    # upsample
    ((1, 9, 6, 3), (9, 4)),      # identity rows, downsampled columns
    ((1, 1, 4, 5), (7, 1)),      # one source row, one output column
])
@pytest.mark.parametrize("align", [True, False])
def test_kernel_arithmetic_matches_autograd_of_plain(shape, out_hw, align):
    logits, labels = _inputs(shape, out_hw, seed=6)
    labels[0, 0, 0] = shape[-1]  # one label outside the classes
    want, want_grad = _torch_value_and_grad(
        lambda x, y: ce.upsample_ce_reference(x, y, align), logits, labels)
    got, got_grad, _ = _kernel_arithmetic(torch.from_numpy(logits),
                                          torch.from_numpy(labels), align)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    torch.testing.assert_close(got_grad, want_grad, rtol=0, atol=1e-6)


def _banded_arithmetic(logits, labels, align, **tiling):
    """The backward kernel's arithmetic, in torch, block by block as
    `bwd_plan` tiles it: per band of source rows (with the output rows of
    its halo), tile of source columns and chunk of classes; per output row
    the H-interpolated row `a`, then each output column's softmax term P,
    then each source column's weighted share of P gathered in ascending X,
    then only the rows inside the band. Entries no block writes stay NaN."""
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1:]
    plan = ce.bwd_plan(b, h, w, c, out_h, out_w, align, **tiling)
    hi0, hi1, hw0, hw1 = interp_taps(h, out_h, align)
    wi0, wi1, ww0, ww1 = (torch.from_numpy(np.array(a)).long() if k < 2
                          else torch.from_numpy(np.array(a))
                          for k, a in enumerate(interp_taps(w, out_w, align)))
    x = logits.float()
    a_all = (torch.from_numpy(np.array(hw0))[None, :, None, None]
             * x[:, torch.from_numpy(np.array(hi0)).long()]
             + torch.from_numpy(np.array(hw1))[None, :, None, None]
             * x[:, torch.from_numpy(np.array(hi1)).long()])
    up = (ww0[None, None, :, None] * a_all[:, :, wi0]
          + ww1[None, None, :, None] * a_all[:, :, wi1])
    lse = torch.logsumexp(up, dim=-1)
    first = plan.col_first
    dlogits = torch.full_like(x, float("nan"))
    for bi, (y_lo, y_hi, _, _) in enumerate(plan.bands):
        y0 = bi * plan.band_rows
        y1 = min(h, y0 + plan.band_rows)
        for ti, (x_lo, x_hi, _, _) in enumerate(plan.tiles):
            x0 = ti * plan.tile_cols
            x1 = min(w, x0 + plan.tile_cols)
            if x_hi == x_lo:  # no output reads the tile
                dlogits[:, y0:y1, x0:x1] = 0.0
                continue
            # per source column of the tile: its outputs in ascending X
            # (first tap x - 1 with weight w1, then first tap x with w0),
            # padded with weight 0
            spans = [(max(first[max(col - 1, 0)], x_lo),
                      min(first[col], x_hi), min(first[col + 1], x_hi))
                     for col in range(x0, x1)]
            width = max([1] + [hi_ - lo for lo, _, hi_ in spans])
            idx = torch.zeros(x1 - x0, width, dtype=torch.long)
            wt = torch.zeros(x1 - x0, width)
            for j, (lo, mid, hi_) in enumerate(spans):
                if x0 + j == 0:
                    lo = max(first[0], x_lo)
                for k, col_x in enumerate(range(lo, hi_)):
                    idx[j, k] = col_x - x_lo
                    wt[j, k] = ww1[col_x] if col_x < mid else ww0[col_x]
            for c0 in range(0, c, plan.chunk):
                cs = slice(c0, min(c, c0 + plan.chunk))
                classes = torch.arange(c)[cs]
                acc = torch.zeros(b, h + 1, x1 - x0, len(classes))
                cols = torch.arange(x_lo, x_hi)
                for yy in range(y_lo, y_hi):
                    a = hw0[yy] * x[:, hi0[yy], :, cs] + hw1[yy] * x[
                        :, hi1[yy], :, cs]
                    row = (ww0[cols][None, :, None] * a[:, wi0[cols]]
                           + ww1[cols][None, :, None] * a[:, wi1[cols]])
                    onehot = (labels[:, yy, cols].long()[..., None]
                              == classes).float()
                    p = torch.exp(row - lse[:, yy, cols, None]) - onehot
                    g = torch.zeros(b, x1 - x0, len(classes))
                    for k in range(width):
                        g = g + wt[None, :, k, None] * p[:, idx[:, k]]
                    acc[:, hi0[yy]] += hw0[yy] * g
                    if hi1[yy] != hi0[yy]:
                        acc[:, hi1[yy]] += hw1[yy] * g
                dlogits[:, y0:y1, x0:x1, cs] = acc[:, y0:y1]
    return dlogits / (b * out_h * out_w)


# name -> (logits shape, label (H, W), align_corners, bwd_plan tiling)
BANDED_CASES = {
    # 9 rows in bands of 4, 5 classes in chunks of 2, 11 columns in tiles
    # of 8: none divides its axis
    "ragged_align_true": ((2, 9, 11, 5), (33, 41), True,
                          dict(band_rows=4, max_chunk=2, max_threads=4)),
    "ragged_align_false": ((2, 9, 11, 5), (33, 41), False,
                           dict(band_rows=4, max_chunk=2, max_threads=4)),
    # chunks of one class: a thread's two other classes past the chunk
    "one_class_a_thread": ((1, 7, 19, 7), (29, 31), False,
                           dict(band_rows=3, max_chunk=1, max_threads=2)),
    "downsampled_rows": ((1, 20, 9, 3), (7, 17), True,
                         dict(band_rows=3, max_chunk=2, max_threads=4)),
    "downsampled_both": ((1, 20, 30, 5), (7, 9), False, dict(band_rows=4)),
    "one_source_row": ((2, 1, 6, 4), (5, 13), True,
                       dict(band_rows=2, max_chunk=3, max_threads=8)),
    "same_size": ((1, 6, 5, 3), (6, 5), True, dict(band_rows=4)),
    # 60 columns down to 4 in tiles of 8: tiles 1, 3 and 6 are read by no
    # output column
    "tiles_no_output_reads": ((1, 3, 60, 4), (5, 4), True,
                              dict(band_rows=2, max_chunk=4, max_threads=4)),
    "defaults_c21": ((2, 17, 13, 21), (65, 49), True, {}),
    # the batch-32 plans' bands at 8x (PSPNet, FastFCN) and 16x (FastFCN's
    # aux head), one sample
    "x8_65_to_513": ((1, 65, 65, 21), (513, 513), True, dict(band_rows=2)),
    "x16_33_to_513": ((1, 33, 33, 21), (513, 513), True,
                      dict(band_rows=1)),
}


@pytest.mark.parametrize("case", sorted(BANDED_CASES))
def test_banded_arithmetic_matches_kernel_arithmetic_and_autograd(case):
    shape, out_hw, align, tiling = BANDED_CASES[case]
    logits, labels = _inputs(shape, out_hw, seed=9)
    labels[0, 0, :2] = shape[-1]  # labels outside the classes
    labels[-1, -1, -1] = -1
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    got = _banded_arithmetic(x, y, align, **tiling)
    assert not bool(got.isnan().any())  # every entry written by one block
    _, want, _ = _kernel_arithmetic(x, y, align)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    _, ref_grad = _torch_value_and_grad(
        lambda v, t: ce.upsample_ce_reference(v, t, align), logits, labels)
    torch.testing.assert_close(got, ref_grad, rtol=0, atol=1e-6)


def _fwd_banded_arithmetic(logits, labels, align, **tiling):
    """The forward kernel's arithmetic, in torch, block by block as
    `fwd_plan` tiles it: per band of output rows and tile of output columns
    the staged source rows and columns, then per class chunk (ascending)
    each output row interpolated along H at every staged column, each pixel
    along W, and the online logsumexp over the chunk's classes, its (max,
    sum, true logit) carried from chunk to chunk. -> (lse [B, H, W], NaN
    where no block wrote; how many blocks wrote each pixel; per-sample sums
    of the blocks' partials in block order)."""
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1:]
    plan = ce.fwd_plan(b, h, w, c, out_h, out_w, align, **tiling)
    hi0, hi1, hw0, hw1 = (torch.from_numpy(np.array(a))
                          for a in interp_taps(h, out_h, align))
    wi0, wi1, ww0, ww1 = (torch.from_numpy(np.array(a))
                          for a in interp_taps(w, out_w, align))
    x, lab = logits.float(), labels.long()
    lse = torch.full((b, out_h, out_w), float("nan"))
    writes = torch.zeros((b, out_h, out_w), dtype=torch.int64)
    partials = []
    for y_lo, y_hi, r_lo, r_hi in plan.bands:
        ys = torch.arange(y_lo, y_hi)
        for x_lo, x_hi, c_lo, c_hi in plan.tiles:
            xs = torch.arange(x_lo, x_hi)
            staged = x[:, r_lo:r_hi + 1, c_lo:c_hi + 1]
            shape = (b, len(ys), len(xs))
            m, s, t = torch.full(shape, -1e30), torch.zeros(shape), \
                torch.zeros(shape)
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
                block_lab = lab[:, y_lo:y_hi, x_lo:x_hi]
                for k in range(up.shape[-1]):
                    u = up[..., k]
                    new_max = u > m
                    s = torch.where(new_max, s * torch.exp(m - u) + 1.0,
                                    s + torch.exp(u - m))
                    m = torch.where(new_max, u, m)
                    t = torch.where(block_lab == c0 + k, u, t)
            pixel = m + torch.log(s)
            lse[:, y_lo:y_hi, x_lo:x_hi] = pixel
            writes[:, y_lo:y_hi, x_lo:x_hi] += 1
            partials.append((pixel - t).sum((1, 2)))
    return lse, writes, torch.stack(partials, 1).sum(1)


# name -> (logits shape, label (H, W), align_corners, fwd_plan tiling)
FWD_BANDED_CASES = {
    # 33 output rows in bands of 4 (the last of 1), 41 columns in 3 tiles
    # of 14 (the last of 13)
    "ragged_align_true": ((2, 9, 11, 5), (33, 41), True,
                          dict(band_rows=4, tile_cols=15)),
    "ragged_align_false": ((2, 9, 11, 5), (33, 41), False,
                           dict(band_rows=4, tile_cols=15)),
    # 7 classes in chunks of 3, 3, 1 (bands of one row)
    "class_chunks": ((1, 7, 19, 7), (29, 31), False,
                     dict(tile_cols=8, max_chunk=3)),
    "downsampled_rows": ((1, 20, 9, 3), (7, 17), True,
                         dict(band_rows=3, tile_cols=5)),
    "downsampled_both": ((1, 20, 30, 5), (7, 9), False,
                         dict(band_rows=2, tile_cols=4, max_chunk=2)),
    "one_source_row": ((2, 1, 6, 4), (5, 13), True,
                       dict(band_rows=2, tile_cols=6)),
    "same_size": ((1, 6, 5, 3), (6, 5), True, dict(band_rows=4)),
    "defaults_c21": ((2, 17, 13, 21), (65, 49), True, {}),
    # the batch-32 plans at 8x and 16x, one sample
    "x8_65_to_513": ((1, 65, 65, 21), (513, 513), True,
                     dict(band_rows=16, tile_cols=171)),
    "x16_33_to_513": ((1, 33, 33, 21), (513, 513), True,
                      dict(band_rows=16, tile_cols=171)),
}


@pytest.mark.parametrize("case", sorted(FWD_BANDED_CASES))
def test_fwd_banded_arithmetic_matches_kernel_arithmetic(case):
    """The forward tiling against the per-pixel arithmetic it replaced and
    the plain version: f32 on both sides, lse to 2e-6 (the online
    logsumexp against torch.logsumexp of the same upsampled logits, |lse| <
    10), the loss to 1e-6 relative (another summation order)."""
    shape, out_hw, align, tiling = FWD_BANDED_CASES[case]
    logits, labels = _inputs(shape, out_hw, seed=11)
    labels[0, 0, :2] = shape[-1]  # labels outside the classes
    labels[-1, -1, -1] = -1
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    plan = ce.fwd_plan(*shape, *out_hw, align, **tiling)
    if tiling:  # the tiling the case names is the one the model follows
        assert (len(plan.bands) > 1 or shape[1] == 1 or out_hw[0] == 1)
        assert (plan.chunk < shape[-1]) == ("max_chunk" in tiling)
    got, writes, sums = _fwd_banded_arithmetic(x, y, align, **tiling)
    assert bool((writes == 1).all())  # every pixel in exactly one block
    want_loss, _, want_lse = _kernel_arithmetic(x, y, align)
    torch.testing.assert_close(got, want_lse, rtol=0, atol=2e-6)
    loss = float(sums.sum()) / (shape[0] * out_hw[0] * out_hw[1])
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(
        loss, float(ce.upsample_ce_reference(x, y, align)), rtol=1e-6)


@pytest.mark.parametrize("args", BAND_PLAN_SHAPES)
def test_fwd_plan_covers_every_pixel_once_and_fits(args):
    c = args[3]
    plan = ce.fwd_plan(*args)
    assert_output_band_plan(plan, args)
    if args[:7] == (32, 129, 129, 21, 513, 513, True):
        # bands of 16 rows, 513 columns in 3 tiles of 171, every class
        assert (plan.band_rows, len(plan.tiles), plan.tile_cols,
                plan.chunk) == (16, 3, 171, 21)
    if args[2] == 3000:
        assert len(plan.bands) > 1 and len(plan.tiles) > 1
        assert plan.chunk < c


def test_wrapper_routes_and_checks():
    logits, labels = _inputs((2, 5, 7, 4), (17, 23))
    x = torch.from_numpy(logits).permute(0, 3, 1, 2).contiguous()
    nhwc_view = x.permute(0, 2, 3, 1)           # NCHW memory, NHWC view
    y = torch.from_numpy(labels)
    before = ce.launch_count()
    assert set(before) == {"fwd", "bwd"}
    got = ce.fused_upsample_ce(nhwc_view, y.long())  # int64 labels too
    assert torch.equal(got, ce.upsample_ce_reference(
        torch.from_numpy(logits), y))
    assert ce.launch_count() == before
    with pytest.raises(ValueError, match=r"\[B, h, w, C\]"):
        ce.fused_upsample_ce(nhwc_view[0], y)
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        ce.fused_upsample_ce(nhwc_view, y[0])
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        ce.fused_upsample_ce(nhwc_view, y[:1])
    with pytest.raises(TypeError, match="integers"):
        ce.fused_upsample_ce(nhwc_view, y.float())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ce.fused_upsample_ce(nhwc_view.half(), y)
    with pytest.raises(ValueError, match="no path"):
        ce.fused_upsample_ce(nhwc_view.to("meta"), y.to("meta"))
    with pytest.raises(ValueError, match="no path"):
        ce.fused_upsample_ce_per_sample(nhwc_view.to("meta"), y.to("meta"))


@pytest.mark.parametrize("ignore_index", [None, 2])
def test_softmax_cross_entropy_matches_jax(ignore_index):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 6, 7)).astype(np.int32)
    want, want_grad = jax.value_and_grad(
        lambda l: jloss.softmax_cross_entropy(
            l, jnp.asarray(labels), ignore_index=ignore_index))(
                jnp.asarray(logits))
    got, got_grad = _torch_value_and_grad(
        lambda x, y: tloss.softmax_cross_entropy(x, y,
                                                 ignore_index=ignore_index),
        logits, labels)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("align", [True, False])
def test_compute_loss_and_loss_fn_routing(align, monkeypatch):
    logits, labels = _inputs((2, 9, 11, 5), (33, 41), seed=8)
    labels[0, :3] = 4
    want = float(jloss.compute_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    ignore_index=4, align_corners=align))
    got = tloss.compute_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels), ignore_index=4,
                             align_corners=align)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)

    # make_loss_fn: the fused wrapper exactly where the logits are below the
    # label resolution; compute_loss at the same resolution or when asked
    calls = []
    real = tloss.fused_upsample_ce

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tloss, "fused_upsample_ce", counting)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    low = tloss.make_loss_fn(align_corners=align)(x, y)
    assert calls == [{"align_corners": align}]
    np.testing.assert_allclose(
        float(low), float(jloss.compute_loss(jnp.asarray(logits),
                                             jnp.asarray(labels),
                                             align_corners=align)), rtol=1e-5)
    same = torch.from_numpy(_inputs((2, 33, 41, 5), (33, 41))[0])
    tloss.make_loss_fn(align_corners=align)(same, y)
    tloss.make_loss_fn(align_corners=align, use_pallas=False)(x, y)
    assert len(calls) == 1
