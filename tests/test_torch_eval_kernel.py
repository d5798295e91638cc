"""PyTorch port: the streaming metrics and the upsample+argmax+confusion
kernel module against the JAX package (CPU; the JAX Pallas kernel runs in
interpret mode, the port's wrapper takes its plain version on CPU tensors).
Counts are integers and must be equal; the metrics are f32 on both sides and
agree to 1e-6."""

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
