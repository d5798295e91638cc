"""Streaming segmentation metrics (port of
pytorch_segmentation_tpu/ops/metrics.py).

`confusion_update` counts per-class tp/fn/fp of one batch on the tensors'
device with one `bincount`; the eval loop sums the vectors on the host in
float64 and calls `compute_metrics` once per report. `compute_metrics` keeps
the zero-guards of the JAX package: a non-positive denominator becomes 1, so
a class that never occurs scores 0 and never NaN.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["confusion_update", "compute_metrics", "sample_valid_mask"]


@functools.lru_cache(maxsize=64)
def _arange(b: int, device) -> torch.Tensor:
    # made once per device and outside inference mode (shared, never written
    # to): a fresh tensor from host data per batch is a copy from pageable
    # memory, which waits for all the work queued on the stream
    with torch.inference_mode(False):
        return torch.arange(b, device=device)


def sample_valid_mask(valid, b: int, device) -> torch.Tensor:
    """Per-sample bool mask [b] on `device` from either the count of real
    samples (the first `valid` are real; a Python or numpy integer, or a 0-d
    tensor) or an explicit per-sample mask [b]."""
    if isinstance(valid, (int, np.integer)):
        return _arange(b, torch.device(device)) < int(valid)
    valid = torch.as_tensor(valid).to(device)
    if valid.dim() == 0:
        return _arange(b, torch.device(device)) < valid
    if valid.shape != (b,):
        raise ValueError(f"valid must be a count or a mask of shape ({b},), "
                         f"got {tuple(valid.shape)}")
    return valid.to(torch.bool)


def confusion_update(pred: torch.Tensor, target: torch.Tensor,
                     num_classes: int):
    """Per-class (tp, fn, fp) counts for one batch.

    pred/target: integer tensors of one shape (any rank) with values in
    [0, num_classes). Returns three f32 vectors of length num_classes, from
    one bincount over `target * C + pred`."""
    idx = target.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    cm = torch.bincount(idx, minlength=num_classes * num_classes)
    cm = cm[:num_classes * num_classes].reshape(num_classes, num_classes)
    tp = cm.diagonal()
    fn = cm.sum(dim=1) - tp  # target == c, pred != c
    fp = cm.sum(dim=0) - tp  # pred == c, target != c
    return tp.float(), fn.float(), fp.float()


def compute_metrics(tp, fn, fp):
    """(T, P, R, miou, F1) per class, f32, with the zero-guards. Tensors in,
    tensors out; anything else (numpy arrays, lists) in, numpy out."""
    if not isinstance(tp, torch.Tensor):
        return tuple(m.numpy() for m in compute_metrics(
            *(torch.from_numpy(np.asarray(a, dtype=np.float32))
              for a in (tp, fn, fp))))
    tp, fn, fp = tp.float(), fn.float(), fp.float()

    def guard(x):
        return torch.where(x <= 0, torch.ones_like(x), x)

    miou = tp / guard(tp + fp + fn)
    T = tp + fn
    P = tp / guard(tp + fp)
    R = tp / guard(tp + fn)
    F1 = 2 * tp / guard(2 * tp + fp + fn)
    return T, P, R, miou, F1
