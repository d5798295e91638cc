"""PyTorch port: the streaming metrics and the upsample+argmax+confusion
kernel module against the JAX package (CPU; the JAX Pallas kernel runs in
interpret mode, the port's wrapper takes its plain version on CPU tensors),
and the CUDA kernel's tiling (`eval_plan`) and arithmetic, modelled in plain
torch, against the plain version. Counts are integers and must be equal; the
metrics are f32 on both sides and agree to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.engine.steps import (
    sample_valid_mask as jax_sample_valid_mask)
from pytorch_segmentation_tpu.ops import metrics as jmetrics
from pytorch_segmentation_tpu.ops.pallas.eval_confusion import (
    fused_eval_confusion as jax_fused_eval_confusion)
from pytorch_segmentation_tpu.ops.resize import resize_bilinear as jax_resize
from pytorch_segmentation_tpu_torch.ops import metrics as tmetrics
from pytorch_segmentation_tpu_torch.ops.kernels import eval_confusion as ec
from pytorch_segmentation_tpu_torch.ops.kernels.upsample_argmax import (
    interp_taps)
from torch_port_util import BAND_PLAN_SHAPES, assert_output_band_plan

torch.set_num_threads(1)


def _inputs(shape, out_hw, seed=0, tie=None):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape).astype(np.float32)
    if tie is not None:  # class tie[1] duplicates tie[0]: tie[0] must win
        logits[..., tie[1]] = logits[..., tie[0]]
    labels = rng.integers(0, shape[-1], (shape[0],) + out_hw).astype(np.int32)
    return logits, labels


def _both(logits, labels, valid, align, tile=16, jdtype=jnp.float32):
    """(tp, fn, fp) of the JAX kernel in interpret mode and of the port's
    wrapper on CPU tensors, from the same numpy inputs."""
    want = jax_fused_eval_confusion(
        jnp.asarray(logits, jdtype), jnp.asarray(labels), jnp.asarray(valid),
        align_corners=align, tile=tile, interpret=True)
    tdtype = torch.bfloat16 if jdtype == jnp.bfloat16 else torch.float32
    got = ec.fused_eval_confusion(
        torch.from_numpy(logits).to(tdtype), torch.from_numpy(labels),
        valid if isinstance(valid, int) else torch.from_numpy(valid),
        align_corners=align)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_counts_equal(got, want):
    for g, w, name in zip(got, want, ("tp", "fn", "fp")):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# the three cases of tests/test_pallas_eval.py
@pytest.mark.parametrize("shape,out_hw,align,valid", [
    ((3, 16, 16, 5), (64, 64), True, 3),
    ((3, 16, 16, 5), (64, 64), True, 2),
    ((1, 11, 13, 3), (50, 52), False, 1),     # ragged rows
    ((2, 8, 8, 65), (16, 16), True, 2),       # 65..128 classes (COCO-81)
])
def test_reference_matches_jax_kernel(shape, out_hw, align, valid):
    logits, labels = _inputs(shape, out_hw)
    got, want = _both(logits, labels, valid, align)
    _assert_counts_equal(got, want)
    assert (got[0] + got[1]).sum() == valid * out_hw[0] * out_hw[1]
    assert (got[0] + got[2]).sum() == valid * out_hw[0] * out_hw[1]


def test_reference_matches_jax_kernel_bf16():
    """bf16 logits are upcast exactly and interpolated in f32 on both sides.
    The two f32 interpolations (a dense matrix product there, two einsums
    here) can differ in the last bit, so a pixel whose top-2 gap is below
    1e-5 may flip: none does at this seed, and the counts are equal."""
    logits, labels = _inputs((2, 9, 11, 7), (33, 41), seed=1)
    got, want = _both(logits, labels, 2, True, jdtype=jnp.bfloat16)
    _assert_counts_equal(got, want)


def test_reference_matches_jax_kernel_bool_mask():
    logits, labels = _inputs((4, 8, 8, 5), (32, 32), seed=2)
    mask = np.array([True, False, True, True])
    got, want = _both(logits, labels, mask, True)
    _assert_counts_equal(got, want)
    assert (got[0] + got[1]).sum() == 3 * 32 * 32
    # a count and the mask of the same samples agree
    first, _ = _both(logits, labels, 2, True)
    same, _ = _both(logits, labels, np.array([True, True, False, False]),
                    True)
    _assert_counts_equal(first, same)


def test_out_of_range_labels_match_jax_kernel():
    """A label outside [0, C) adds nothing to tp or fn; its pixel still
    counts as a false positive of the predicted class."""
    logits, labels = _inputs((2, 8, 8, 4), (32, 32), seed=3)
    labels[0, :5] = 255
    labels[1, 7, 3:9] = -1
    labels[1, 9, :4] = 4
    got, want = _both(logits, labels, 2, True)
    _assert_counts_equal(got, want)
    outside = 5 * 32 + 6 + 4
    assert (got[0] + got[1]).sum() == 2 * 32 * 32 - outside
    assert (got[0] + got[2]).sum() == 2 * 32 * 32


def test_planted_tie_lowest_class_wins():
    logits, labels = _inputs((2, 8, 8, 6), (32, 32), seed=4, tie=(1, 4))
    got, want = _both(logits, labels, 2, False)
    _assert_counts_equal(got, want)
    assert got[0][4] == 0 and got[2][4] == 0     # class 4 is never predicted
    assert got[0][1] + got[2][1] > 0


def test_label_dtypes_and_batch_sum_is_exact():
    """u8 / int32 / int64 labels give the same counts; the batch sum is an
    integer sum rounded to f32 once."""
    logits, labels = _inputs((2, 8, 8, 5), (16, 16), seed=5)
    x = torch.from_numpy(logits)
    base = ec.fused_eval_confusion(x, torch.from_numpy(labels), 2)
    for dtype in (torch.uint8, torch.int64):
        other = ec.fused_eval_confusion(
            x, torch.from_numpy(labels).to(dtype), 2)
        for a, b in zip(base, other):
            assert torch.equal(a, b)
    # 2^24 + 1 pixels of one class is not an f32, but the int64 sum under it
    # is exact: per-sample rows of 2^23 + 1 each, summed over two samples
    rows = torch.zeros((2, 3, 1), dtype=torch.int32)
    rows[:, 0] = rows[:, 1] = rows[:, 2] = 2 ** 23 + 1
    tp, fn, fp = ec._finish(rows, 2)
    assert float(tp) == float(torch.tensor(2 ** 24 + 2).float())
    assert float(fn) == 0 and float(fp) == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 4, 3))
    y = torch.zeros((1, 8, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        ec.fused_eval_confusion(x.half(), y, 1)
    with pytest.raises(TypeError):
        ec.fused_eval_confusion(x, y.float(), 1)
    with pytest.raises(ValueError):
        ec.fused_eval_confusion(x[0], y, 1)
    with pytest.raises(ValueError):
        ec.fused_eval_confusion(x, y[0], 1)
    with pytest.raises(ValueError, match="mask of shape"):
        ec.fused_eval_confusion(x, y, torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="no path"):
        ec.fused_eval_confusion(x.to("meta"), y.to("meta"), 1)
    assert ec.MAX_CLASSES == 4096 and ec.launch_count() == 0


@pytest.mark.parametrize("valid", [3, np.int64(0), np.array(2),
                                   np.array([True, False, True])])
def test_sample_valid_mask_matches_jax(valid):
    want = np.asarray(jax_sample_valid_mask(valid, 3))
    got = tmetrics.sample_valid_mask(valid, 3, "cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_confusion_update_matches_jax():
    rng = np.random.default_rng(6)
    pred = rng.integers(0, 7, (2, 20, 30)).astype(np.int32)
    target = rng.integers(0, 7, (2, 20, 30)).astype(np.int32)
    want = jmetrics.confusion_update(jnp.asarray(pred), jnp.asarray(target), 7)
    got = tmetrics.confusion_update(torch.from_numpy(pred),
                                    torch.from_numpy(target), 7)
    _assert_counts_equal([g.numpy() for g in got],
                         [np.asarray(w) for w in want])
    assert float(sum(g.sum() for g in got[:2])) == pred.size


@pytest.mark.parametrize("as_tensor", [True, False])
def test_compute_metrics_matches_jax_with_zero_guards(as_tensor):
    """Class 2 never occurs and is never predicted (every denominator 0),
    class 3 is predicted but never occurs, class 4 occurs and is never
    predicted: the guards give 0, not NaN."""
    tp = np.array([5.0, 120.0, 0.0, 0.0, 0.0])
    fn = np.array([3.0, 0.0, 0.0, 0.0, 9.0])
    fp = np.array([2.0, 40.0, 0.0, 7.0, 0.0])
    want = jmetrics.compute_metrics(tp, fn, fp)
    args = [torch.from_numpy(a) for a in (tp, fn, fp)] if as_tensor else (
        tp, fn, fp)
    got = tmetrics.compute_metrics(*args)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor if as_tensor else np.ndarray)
        g = g.numpy() if as_tensor else g
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=0)


def test_upsampled_argmax_is_what_both_count():
    """The counts are those of confusion_update on the argmax of the f32
    upsampled logits (the JAX package's plain path)."""
    logits, labels = _inputs((2, 9, 11, 5), (33, 41), seed=7)
    up = jax_resize(jnp.asarray(logits), (33, 41), align_corners=True)
    want = jmetrics.confusion_update(jnp.argmax(up, -1), jnp.asarray(labels),
                                     5)
    got = ec.eval_confusion_reference(torch.from_numpy(logits),
                                      torch.from_numpy(labels), 2)
    _assert_counts_equal([g.numpy() for g in got],
                         [np.asarray(w) for w in want])


# ------------------------------------- the kernel's banded tiling, plain torch

@pytest.mark.parametrize("args", BAND_PLAN_SHAPES + [
    (1, 5, 5, 4096, 9, 9, True, 2),            # MAX_CLASSES: a 48 KB table
])
def test_eval_plan_covers_every_pixel_once_and_fits(args):
    c = args[3]
    plan = ec.eval_plan(*args)
    assert_output_band_plan(plan, args, table_bytes=12 * c)
    if args[:7] == (32, 129, 129, 21, 513, 513, True):
        # bands of 16 rows, 513 columns in 3 tiles of 171, every class:
        # 3,168 blocks
        assert (plan.band_rows, len(plan.tiles), plan.tile_cols,
                plan.chunk) == (16, 3, 171, 21)
        assert args[0] * len(plan.bands) * len(plan.tiles) == 3168
    if args[2] == 3000:
        assert len(plan.bands) > 1 and len(plan.tiles) > 1
        assert plan.chunk < c
    if c == ec.MAX_CLASSES:  # above 48 KB: the launch opts in to more
        assert plan.chunk < c and plan.smem_bytes > 48 * 1024


def _eval_banded_arithmetic(logits, labels, align, **tiling):
    """The kernel's arithmetic, in torch, block by block as `eval_plan`
    tiles it: per band of output rows and tile of output columns the staged
    source rows and columns, then per class chunk (ascending) each output
    row interpolated along H at every staged column, each pixel along W,
    and the argmax over the chunk's classes in the select form (strict '>'
    from -1e30), its (best, pred) carried from chunk to chunk; after the
    last chunk the block's counts. -> (int64 per-sample rows [B, 3, C] of
    tp, labels, preds; how many blocks counted each pixel)."""
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1:]
    plan = ec.eval_plan(b, h, w, c, out_h, out_w, align, **tiling)
    hi0, hi1, hw0, hw1 = (torch.from_numpy(np.array(a))
                          for a in interp_taps(h, out_h, align))
    wi0, wi1, ww0, ww1 = (torch.from_numpy(np.array(a))
                          for a in interp_taps(w, out_w, align))
    x, lab = logits.float(), labels.long()
    counts = torch.zeros((b, 3, c), dtype=torch.int64)
    writes = torch.zeros((b, out_h, out_w), dtype=torch.int64)
    for y_lo, y_hi, r_lo, r_hi in plan.bands:
        ys = torch.arange(y_lo, y_hi)
        for x_lo, x_hi, c_lo, c_hi in plan.tiles:
            xs = torch.arange(x_lo, x_hi)
            staged = x[:, r_lo:r_hi + 1, c_lo:c_hi + 1]
            shape = (b, len(ys), len(xs))
            best = torch.full(shape, -1e30)
            pred = torch.zeros(shape, dtype=torch.int64)
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
            block_lab = lab[:, y_lo:y_hi, x_lo:x_hi]
            inside = (block_lab >= 0) & (block_lab < c)
            for i in range(b):
                p, t = pred[i].reshape(-1), block_lab[i].reshape(-1)
                for row, keys in enumerate((p[p == t], t[inside[i]
                                                          .reshape(-1)], p)):
                    counts[i, row] += torch.bincount(keys, minlength=c)
            writes[:, y_lo:y_hi, x_lo:x_hi] += 1
    return counts, writes


# name -> (logits shape, label (H, W), align_corners, eval_plan tiling)
EVAL_BANDED_CASES = {
    # 33 output rows in bands of 4 (the last of 1), 41 columns in 3 tiles
    # of 14 (the last of 13)
    "ragged_align_true": ((2, 9, 11, 5), (33, 41), True,
                          dict(band_rows=4, tile_cols=15)),
    "ragged_align_false": ((2, 9, 11, 5), (33, 41), False,
                           dict(band_rows=4, tile_cols=15)),
    # 7 classes in chunks of 3, 3, 1 (bands of one row); class 5 duplicates
    # class 1, across chunks: class 1 must win every tie
    "class_chunks_tie": ((1, 7, 19, 7), (29, 31), False,
                         dict(tile_cols=8, max_chunk=3)),
    "downsampled_rows": ((1, 20, 9, 3), (7, 17), True,
                         dict(band_rows=3, tile_cols=5)),
    "downsampled_both": ((1, 20, 30, 5), (7, 9), False,
                         dict(band_rows=2, tile_cols=4, max_chunk=2)),
    "one_source_row": ((2, 1, 6, 4), (5, 13), True,
                       dict(band_rows=2, tile_cols=6)),
    "same_size": ((1, 6, 5, 3), (6, 5), True, dict(band_rows=4)),
    "defaults_c21": ((2, 17, 13, 21), (65, 49), True, {}),
}


@pytest.mark.parametrize("case", sorted(EVAL_BANDED_CASES))
def test_eval_banded_arithmetic_counts_equal_plain(case):
    """The kernel's tiling and arithmetic against the plain version, per
    sample: integer counts, equal; every pixel counted by one block; labels
    outside the classes count for no class's tp or label row."""
    shape, out_hw, align, tiling = EVAL_BANDED_CASES[case]
    tie = (1, 5) if case.endswith("_tie") else None
    logits, labels = _inputs(shape, out_hw, seed=12, tie=tie)
    labels[0, 0, :2] = shape[-1]  # labels outside the classes
    labels[-1, -1, -1] = -1
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    plan = ec.eval_plan(*shape, *out_hw, align, **tiling)
    if tiling:  # the tiling the case names is the one the model follows
        assert (len(plan.bands) > 1 or shape[1] == 1 or out_hw[0] == 1)
        assert (plan.chunk < shape[-1]) == ("max_chunk" in tiling)
    counts, writes = _eval_banded_arithmetic(x, y, align, **tiling)
    assert bool((writes == 1).all())  # every pixel in exactly one block
    for i in range(shape[0]):
        got = ec._finish(counts[i:i + 1], 1)
        want = ec.eval_confusion_reference(x[i:i + 1], y[i:i + 1], 1, align)
        for g, r in zip(got, want):
            assert torch.equal(g, r)
    pixels = out_hw[0] * out_hw[1]
    assert bool((counts[:, 2].sum(1) == pixels).all())
    assert int(counts[:, 1].sum()) == shape[0] * pixels - 3
    if tie is not None:
        assert int(counts[:, 2, tie[1]].sum()) == 0
        assert int(counts[:, 2, tie[0]].sum()) > 0


def test_library_name_follows_the_sources_and_headers(tmp_path, monkeypatch):
    """A kernel's library is named by a hash of its source, of every header
    in csrc/ and of the flags: an edited header gives another library (the
    eval and CE kernels share stage_band.cuh), so no stale build is loaded."""
    from pytorch_segmentation_tpu_torch.ops.kernels import build
    assert (build.CSRC_DIR / "stage_band.cuh").exists()
    for name in ("eval_confusion", "softmax_ce"):
        assert '#include "stage_band.cuh"' in (
            build.CSRC_DIR / f"{name}.cu").read_text()
    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "h.cuh").write_text("// header\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k")
    assert first.parent == build.BUILD_DIR and first.name.startswith("k-")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// header, edited\n")
    second = build.library_path("k")
    (tmp_path / "k.cu").write_text("// kernel, edited\n")
    assert len({first, second, build.library_path("k")}) == 3
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-g",))
    assert build.library_path("k") not in (first, second)
