#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
kernels from the sources in this checkout, holds each against its plain
PyTorch version, serves full-width DeepLabV3+ (ResNet-50, 21 classes,
513x513, bf16, batch 8, weights made from a seed) through the port's
MaskServer, trains the same model (batch 32, SGD with momentum) through the
port's Trainer on one fixed batch, serves masks from the checkpoint it saved,
evaluates it (`engine.test`: 80 images at batch 32 through the eval step,
whose loss and confusion counts come from the upsample+CE and
upsample+argmax+confusion kernels; train -> eval -> save(best) -> reload ->
the same counts; then each option of the eval step once: flip and
multi-scale TTA, sliding-window tiles, ignore_index, Boundary IoU), trains
it end to end from u8 host batches (an in-memory dataset -> DataLoader ->
Fetcher -> PostFetch, the default augmentation policy on the card, whose
warp runs the row-resample kernel twice per batch -> Trainer), and then
trains it with the fused 1x1 switch on (`nn.blocks.set_force_fused_1x1`:
conv1 and conv3 of every bottleneck through the fused BN-apply + ReLU +
product + BN-statistics forward, dx and dW kernels, 32 launches of each per
step) beside the figures of the same run with the switch off. The layout
benchmark `tools/bench_cmajor.py` runs once with its channels-major kernel.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --profile  # also torch.profiler tables, by op, of
                                     # the train step (switch off and on),
                                     # the eval step and the augmentation

Every phase prints one line; any failure raises, so the exit code is not 0.
The line before the last is a JSON object with each kernel's launches on its
main-path run (serving, training, evaluation, training end to end, training
with the fused 1x1 switch on, or the layout benchmark), its error against
the plain version, its time, the plain version's, one library call's where
there is one, and the card's bound for the same work; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pytorch_segmentation_tpu_torch.data import augment as taug
from pytorch_segmentation_tpu_torch.data.loader import DataLoader, Fetcher
from pytorch_segmentation_tpu_torch.data.pipeline import (PostFetch,
                                                          normalize_images)
from pytorch_segmentation_tpu_torch.engine import test as run_eval
from pytorch_segmentation_tpu_torch.engine.checkpoint import load_model_bundle
from pytorch_segmentation_tpu_torch.engine.steps import (make_eval_step,
                                                         nhwc_forward)
from pytorch_segmentation_tpu_torch.engine.trainer import Trainer
from pytorch_segmentation_tpu_torch.inference import (_tile_offsets,
                                                      make_mask_fn,
                                                      make_tiled_mask_fn)
from pytorch_segmentation_tpu_torch.models import build_model
from pytorch_segmentation_tpu_torch.nn import blocks
from pytorch_segmentation_tpu_torch.ops.boundary import (boundary_confusion,
                                                         boundary_pixels)
from pytorch_segmentation_tpu_torch.ops.kernels import banded_resample as br
from pytorch_segmentation_tpu_torch.ops.kernels import build
from pytorch_segmentation_tpu_torch.ops.kernels import cmajor_matmul as cm
from pytorch_segmentation_tpu_torch.ops.kernels import eval_confusion as ec
from pytorch_segmentation_tpu_torch.ops.kernels import fused_matmul_bn as fm
from pytorch_segmentation_tpu_torch.ops.kernels import softmax_ce as ce
from pytorch_segmentation_tpu_torch.ops.kernels import upsample_argmax as ua
from pytorch_segmentation_tpu_torch.ops.metrics import (confusion_update,
                                                        sample_valid_mask)
from pytorch_segmentation_tpu_torch.ops.resize import (resize_bilinear,
                                                       resize_nearest)
from pytorch_segmentation_tpu_torch.serving import MaskServer
from pytorch_segmentation_tpu_torch.tools import bench_cmajor
from pytorch_segmentation_tpu_torch.utils.png import decode_png, encode_png
from pytorch_segmentation_tpu_torch.utils.runtime import require_cuda
from pytorch_segmentation_tpu_torch.utils.weights import seeded_state_dict

SEED = 0
IMG = 513
BATCH = 8
TRAIN_BATCH = 32
EVAL_BATCH = 32
EVAL_IMAGES = 80   # 3 eval batches, valid = 32, 32, 16
NUM_CLASSES = 21
GAP = 1e-4       # pixels with a larger top-2 gap must agree exactly
AGREEMENT = 0.999
# upsample+CE kernels against the plain version and autograd on the same
# values: the loss to LOSS_RTOL (f32, another summation order); f32 dlogits
# to GRAD_TOL of the gradient's largest entry; bf16 dlogits to two bf16 ulps
# (2^-7 relative) of the plain f32 gradient rounded to bf16, with the f32
# bound as the floor for entries near zero
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
BF16_2ULP = 2.0 ** -7
# small_train_check, final tensors on the card against the CPU, relative to
# each tensor's largest entry. The updates of convolutions that feed a
# BatchNorm over 50 values per channel are sums that cancel: two f32 runs
# differ by up to a third in them (8e-4 of the tensor's largest entry
# between this package and the JAX package on one CPU, 3e-4 between an
# H100 and the CPU).
SMALL_TRAIN_TOL = 2e-3
# small_augment_check, the policy applied on the card (kernel) against the
# CPU (plain version) under the same drawn parameters. The two differ only
# in f32 rounding (the 3x3 inverse, sin/cos/exp, the filters' summation
# order): that moves a coordinate by ~1e-5 px and a bilinear sample by a
# fraction of a count, which the u8 requantisation turns into whole counts
# on a few pixels and later ops amplify. Shares of labels / image elements
# that may differ, and the largest mean absolute image difference in counts.
AUG_LABEL_SHARE = 1e-3
AUG_IMAGE_SHARE = 1e-2
AUG_IMAGE_MEAN = 0.01
# the card's published peaks (H100 SXM): HBM bytes/s, f32 FLOP/s outside
# the tensor cores (where the gather kernels' arithmetic runs) and dense
# bf16 FLOP/s in them (where the fused 1x1 products belong)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
# fused 1x1 kernels against their plain versions on the same tensors. Both
# sum the same exact products in f32 in another order and round once, so y
# and dy_tot land within one ulp of the operand type (bf16: 2^-7 relative;
# f32: nothing beyond the floor), dx (one more product and rounding on top
# of dy_tot) within two; FUSED_FLOOR of the tensor's largest entry is the
# floor for entries near zero, where the f32 sums' own difference shows
# (dx has a second floor, what one flipped dy_tot entry moves: fused_case).
# Vectors and dW (f32 sums over up to 532,512 rows; dW and dscale also
# inherit dy_tot's one-ulp flips) to FUSED_SUM_TOL of their largest entry.
FUSED_FLOOR = 1e-5
FUSED_SUM_TOL = 1e-3
# step 1 of the full-width bf16 model with the fused 1x1 switch on against
# off, same weights and batch: the folded path takes its BN statistics from
# the f32 sums, the plain path from the rounded bf16 output, and the two
# products sum in another order, so activations part by bf16 ulps per layer
FUSED_LOSS_RTOL = 2e-2


def log(phase: str, **fields):
    print(f"{phase}: " + json.dumps(fields), flush=True)


def mask_check(pred, ref, up, gap=GAP):
    """Hold an argmax mask against the reference mask of the same f32
    upsampled logits `up` [B, H, W, C]: exact where the top-2 gap is above
    `gap` (a closer pair may flip under another FMA or summation order),
    and at least AGREEMENT overall. Returns the agreement and the largest
    loss in logit value from taking `pred` instead of the best class."""
    top2 = up.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > gap
    wrong_clear = int(((pred != ref) & clear).sum())
    agreement = float((pred == ref).float().mean())
    chosen = up.gather(-1, pred.long().unsqueeze(-1)).squeeze(-1)
    max_abs_err = float((top2[..., 0] - chosen).max())
    if wrong_clear or agreement < AGREEMENT:
        raise AssertionError(f"masks disagree: {wrong_clear} pixels with a "
                             f"clear top-2 gap, agreement {agreement:.6f}")
    return agreement, max_abs_err


def cuda_median_ms(fn, warmup=3, reps=20):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes, n_ops, flops=F32_FLOPS):
    """The least time the card could take, ms: the larger of the bytes that
    must move over the memory rate and the operations over the peak rate
    for their type (f32 outside the tensor cores unless told otherwise)."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * n_ops / flops
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def interp_flops(w, out_w):
    """Flops per output pixel and class of the bilinear upsampling, counted
    for the cheapest way to compute the function, which is separable: the
    rows first (two taps: 2 multiplies and an add on an out_h x w map), then
    the columns (the same on the out_h x out_w map)."""
    return 3.0 * w / out_w + 3.0


def kernel_case(name, shape, out_hw, dtype, align, device, tie=None):
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal(shape).astype(np.float32)
    if tie is not None:  # class tie[1] duplicates tie[0]: tie[0] must win
        x[..., tie[1]] = x[..., tie[0]]
    logits = torch.from_numpy(x).to(device=device, dtype=dtype)
    got = ua.fused_upsample_argmax(logits, out_hw, align_corners=align)
    ref = ua.upsample_argmax_reference(logits, out_hw, align_corners=align)
    torch.cuda.synchronize()
    up = resize_bilinear(logits.float(), out_hw, align_corners=align)
    agreement, err = mask_check(got, ref, up)
    if tie is not None and int((got == tie[1]).sum()):
        raise AssertionError("a tied higher class id won")
    ms = cuda_median_ms(lambda: ua.fused_upsample_argmax(
        logits, out_hw, align_corners=align))
    plain_ms = cuda_median_ms(lambda: ua.upsample_argmax_reference(
        logits, out_hw, align_corners=align))
    # logits read once, int32 mask written once; per output pixel and class
    # the separable interpolation and one compare
    b, _, w, c = shape
    pixels = b * out_hw[0] * out_hw[1]
    least = bound(logits.numel() * logits.element_size() + 4 * pixels,
                  (interp_flops(w, out_hw[1]) + 1) * pixels * c)
    log("kernel", case=name, shape=list(shape), out_hw=list(out_hw),
        dtype=str(dtype).replace("torch.", ""), align_corners=align,
        agreement=agreement, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **least)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **least,
            "library_ms": None}


def peak_mb(fn):
    """Peak device memory `fn` adds to what is allocated now, MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def ce_case(name, shape, out_hw, dtype, align, device,
            label_dtype=torch.int32, nchw=False):
    """The upsample+CE kernels against the plain version and autograd.
    `nchw=True` hands them the [B, h, w, C] logits as the permuted view of
    a contiguous [B, C, h, w] tensor, not as a contiguous one."""
    rng = np.random.default_rng(SEED)
    b, _, w, c = shape
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device=device, dtype=dtype)
    if nchw:
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    x.requires_grad_(True)
    y = torch.from_numpy(rng.integers(0, c, (b,) + tuple(out_hw))).to(
        device=device, dtype=label_dtype)
    before = ce.launch_count()
    loss = ce.fused_upsample_ce(x, y, align_corners=align)
    (grad,) = torch.autograd.grad(loss, x, retain_graph=True)
    after = ce.launch_count()
    if (after["fwd"], after["bwd"]) != (before["fwd"] + 1, before["bwd"] + 1):
        raise AssertionError(f"launch counts {before} -> {after}")
    xr = x.detach().float().requires_grad_(True)
    ref = ce.upsample_ce_reference(xr, y, align)
    (ref_grad,) = torch.autograd.grad(ref, xr)
    torch.cuda.synchronize()
    loss_value, ref_value = float(loss.detach()), float(ref.detach())
    loss_err = abs(loss_value - ref_value)
    if not loss_err <= LOSS_RTOL * abs(ref_value):
        raise AssertionError(f"{name}: loss {loss_value} vs plain "
                             f"{ref_value}")
    if grad.dtype != dtype or grad.shape != x.shape:
        raise AssertionError(f"{name}: dlogits {grad.dtype} "
                             f"{tuple(grad.shape)}")
    top = float(ref_grad.abs().max())
    want = ref_grad if dtype == torch.float32 else ref_grad.to(dtype).float()
    diff = (grad.float() - want).abs()
    grad_err = float(diff.max())
    allowed = GRAD_TOL * top
    if dtype != torch.float32:
        allowed = BF16_2ULP * want.abs() + allowed
    if not bool((diff <= allowed).all()):
        raise AssertionError(f"{name}: dlogits differ by {grad_err} "
                             f"(largest entry {top})")
    del xr, ref, ref_grad, want, diff, allowed

    fwd_ms = cuda_median_ms(lambda: ce.fused_upsample_ce(
        x, y, align_corners=align))
    bwd_ms = cuda_median_ms(lambda: torch.autograd.grad(
        loss, x, retain_graph=True))
    with torch.no_grad():
        plain_fwd_ms = cuda_median_ms(lambda: ce.upsample_ce_reference(
            x, y, align))
    plain_loss = ce.upsample_ce_reference(x, y, align)
    plain_bwd_ms = cuda_median_ms(lambda: torch.autograd.grad(
        plain_loss, x, retain_graph=True))
    del plain_loss

    def plain_both():
        torch.autograd.grad(ce.upsample_ce_reference(x, y, align), x)

    def kernel_both():
        torch.autograd.grad(ce.fused_upsample_ce(x, y, align_corners=align),
                            x)

    plain_both_ms = cuda_median_ms(plain_both)
    kernel_mb, plain_mb = peak_mb(kernel_both), peak_mb(plain_both)
    # each input read once, each output written once; per output pixel and
    # class the separable interpolation, then 4 flops of the logsumexp
    # (forward) or 3 of the softmax term and the transposed separable
    # interpolation (backward)
    pixels = b * out_hw[0] * out_hw[1]
    logits_bytes = x.numel() * x.element_size()
    label_bytes = y.numel() * y.element_size()
    interp = interp_flops(w, out_hw[1])
    fwd = bound(logits_bytes + label_bytes + 4 * pixels,
                (interp + 4) * pixels * c)
    bwd = bound(2 * logits_bytes + label_bytes + 4 * pixels,
                (2 * interp + 3) * pixels * c)
    log("kernel", case=name, kernel="softmax_ce", shape=list(shape),
        out_hw=list(out_hw), dtype=str(dtype).replace("torch.", ""),
        logits_strides=list(x.stride()), align_corners=align,
        loss=loss_value, loss_abs_err=loss_err,
        dlogits_max_abs_err=grad_err, dlogits_largest=top, fwd_ms=fwd_ms,
        bwd_ms=bwd_ms, plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
        plain_fwd_bwd_ms=plain_both_ms, fwd_bound_ms=fwd["bound_ms"],
        fwd_bound_by=fwd["bound_by"], bwd_bound_ms=bwd["bound_ms"],
        bwd_bound_by=bwd["bound_by"], kernel_peak_mb=kernel_mb,
        plain_peak_mb=plain_mb)
    return {"strides": tuple(x.stride()),
            "fwd": {"max_abs_err": loss_err, "ms": fwd_ms,
                    "plain_ms": plain_fwd_ms, **fwd, "library_ms": None},
            "bwd": {"max_abs_err": grad_err, "ms": bwd_ms,
                    "plain_ms": plain_bwd_ms, **bwd, "library_ms": None}}


def resample_case(name, planes, coords, use_bil, out_dtype):
    """The row-resample kernel against its plain version on the same
    tensors: equal bit for bit (two exact bf16 x bf16 products and one f32
    sum on both sides), so the label plane is exact too."""
    before = br.launch_count()
    got = br.banded_resample_rows(planes, coords, use_bil,
                                  out_dtype=out_dtype)
    if br.launch_count() != before + 1:
        raise AssertionError(f"{name}: the wrapper did not count its launch")
    want = br.banded_resample_reference(planes, coords, use_bil, out_dtype)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.dtype != out_dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel and plain version differ by "
                             f"{err}")
    del got, want
    ms = cuda_median_ms(lambda: br.banded_resample_rows(
        planes, coords, use_bil, out_dtype=out_dtype))
    plain_ms = cuda_median_ms(lambda: br.banded_resample_reference(
        planes, coords, use_bil, out_dtype))
    # planes and coordinates read once, the output written once; per output
    # position the two weights and the nearest tap (~10 f32 operations),
    # then two products and a sum for each of the four planes
    positions = coords.numel()
    out_bytes = 4 * positions * torch.empty((), dtype=out_dtype).element_size()
    least = bound(planes.numel() * planes.element_size() + 4 * positions
                  + use_bil.numel() + out_bytes, (10 + 4 * 3) * positions)
    log("kernel", case=name, kernel="banded_resample",
        planes=list(planes.shape), planes_strides=list(planes.stride()),
        out_w=coords.shape[-1], out_dtype=str(out_dtype).replace("torch.", ""),
        bilinear_samples=int(use_bil.sum()), max_abs_err=err, equal=True,
        ms=ms, plain_ms=plain_ms, **least)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **least,
            "library_ms": None}


def capture_resample_calls(fn):
    """Run `fn()` with the augmentation's resampler wrapped so that the
    arguments of every call are kept: [(planes, coords, use_bil, kwargs)]."""
    calls = []
    real = taug.banded_resample_rows

    def recording(planes, coords, use_bil, **kwargs):
        calls.append((planes, coords, use_bil, kwargs))
        return real(planes, coords, use_bil, **kwargs)

    taug.banded_resample_rows = recording
    try:
        fn()
    finally:
        taug.banded_resample_rows = real
    return calls


def resample_cases(device, dataset):
    """The kernel at the two calls the default policy makes on a real batch
    (first pass: a contiguous source; second pass: the transposed view of the
    first pass's output, read through its strides), the same to f32, a copy
    of the strided source (is materialising the transpose worth it?), and a
    ragged non-square shape with coordinates at 0 and C-1."""
    post = PostFetch(taug.make_augment_fn(), dtype=torch.bfloat16, seed=SEED,
                     device=device)
    batch = next(iter(DataLoader(dataset, TRAIN_BATCH)))
    calls = capture_resample_calls(lambda: post(batch))
    if len(calls) != 2:
        raise AssertionError(f"one augmented batch made {len(calls)} "
                             f"resampler calls, not 2")
    (p1, c1, ub, kw1), (p2, c2, _, _) = calls
    if kw1 != {"out_dtype": torch.bfloat16} or p2.is_contiguous():
        raise AssertionError(f"unexpected resampler calls: {kw1}, second "
                             f"source strides {p2.stride()}")
    for c in (c1, c2):
        if float(c.min()) < 0 or float(c.max()) > IMG - 1:
            raise AssertionError("a coordinate left [0, C-1]")
    pass1 = resample_case("path_pass1_bf16", p1, c1, ub, torch.bfloat16)
    pass2 = resample_case("path_pass2_bf16_transposed_view", p2, c2, ub,
                          torch.bfloat16)
    resample_case("path_pass1_f32", p1, c1, ub, torch.float32)
    copy_ms = cuda_median_ms(lambda: p2.contiguous())
    resample_case("path_pass2_bf16_copied_source", p2.contiguous(), c2, ub,
                  torch.bfloat16)
    log("transpose", copy_of_the_transposed_source_ms=copy_ms)

    rng = np.random.default_rng(SEED)
    planes = rng.uniform(0, 255, (2, 4, 37, 211)).astype(np.float32)
    planes[:, 3] = rng.integers(0, NUM_CLASSES, (2, 37, 211))
    coords = rng.uniform(0, 210, (2, 37, 150)).astype(np.float32)
    coords[:, :, 0], coords[:, :, -1] = 0.0, 210.0
    resample_case("ragged_211_to_150",
                  torch.from_numpy(planes).to(device, torch.bfloat16),
                  torch.from_numpy(coords).to(device),
                  torch.tensor([True, False], device=device), torch.float32)
    # one figure per launch on the path: the mean of the two passes
    mean = {key: (pass1[key] + pass2[key]) / 2
            for key in ("ms", "plain_ms", "bound_ms")}
    return {"max_abs_err": max(pass1["max_abs_err"], pass2["max_abs_err"]),
            **mean, "bound_by": pass1["bound_by"], "library_ms": None,
            "pass_ms": [pass1["ms"], pass2["ms"]]}


def eval_case(name, shape, out_hw, dtype, align, device, valid=None,
              label_dtype=torch.int32, nchw=False, tie=None, outside_rows=0):
    """The upsample+argmax+confusion kernel against its plain version on the
    same tensors: integer counts, so equal exactly, and equal between two
    launches (integer atomics commute). `valid` is a count or a bool mask
    (default: every sample); `outside_rows` rows of sample 0 get the label
    255, which must count for no class's tp or fn."""
    rng = np.random.default_rng(SEED)
    b, _, w, c = shape
    x = rng.standard_normal(shape).astype(np.float32)
    if tie is not None:  # class tie[1] duplicates tie[0]: tie[0] must win
        x[..., tie[1]] = x[..., tie[0]]
    logits = torch.from_numpy(x).to(device=device, dtype=dtype)
    if nchw:
        logits = logits.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    labels = rng.integers(0, c, (b,) + tuple(out_hw))
    labels[0, :outside_rows] = 255
    labels = torch.from_numpy(labels).to(device=device, dtype=label_dtype)
    valid = b if valid is None else valid
    mask = sample_valid_mask(valid, b, device)

    before = ec.launch_count()
    got = ec.fused_eval_confusion(logits, labels, valid, align_corners=align)
    again = ec.fused_eval_confusion(logits, labels, valid,
                                    align_corners=align)
    if ec.launch_count() != before + 2:
        raise AssertionError(f"{name}: the wrapper did not count its launch")
    want = ec.eval_confusion_reference(logits, labels, valid, align)
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max()) for g, r in zip(got, want))
    for g, r, a in zip(got, want, again):
        if g.dtype != torch.float32 or not torch.equal(g, r):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"by {err}")
        if not torch.equal(g, a):
            raise AssertionError(f"{name}: two launches differ")
    tp, fn, fp = (v.double() for v in got)
    pixels = int(mask.sum()) * out_hw[0] * out_hw[1]
    outside = outside_rows * out_hw[1] * int(mask[0])
    if (float((tp + fn).sum()), float((tp + fp).sum())) != (
            pixels - outside, pixels):
        raise AssertionError(f"{name}: {float((tp + fn).sum())} labelled and "
                             f"{float((tp + fp).sum())} predicted pixels "
                             f"counted, not {pixels - outside} and {pixels}")
    if tie is not None and float(tp[tie[1]] + fp[tie[1]]):
        raise AssertionError(f"{name}: a tied higher class id won")
    ms = cuda_median_ms(lambda: ec.fused_eval_confusion(
        logits, labels, valid, align_corners=align))
    plain_ms = cuda_median_ms(lambda: ec.eval_confusion_reference(
        logits, labels, valid, align))
    # the wrapper without its masked sum over the batch: the zeroed count
    # buffer and the kernel
    launch_ms = cuda_median_ms(lambda: ec._launch(logits, labels, align))
    # logits and labels read once, 3 x C counts written; per output pixel
    # and class the separable interpolation and one compare
    all_pixels = b * out_hw[0] * out_hw[1]
    least = bound(logits.numel() * logits.element_size()
                  + labels.numel() * labels.element_size() + 3 * c * 4,
                  (interp_flops(w, out_hw[1]) + 1) * all_pixels * c)
    log("kernel", case=name, kernel="eval_confusion", shape=list(shape),
        out_hw=list(out_hw), dtype=str(dtype).replace("torch.", ""),
        label_dtype=str(label_dtype).replace("torch.", ""),
        logits_strides=list(logits.stride()), align_corners=align,
        valid_samples=int(mask.sum()), pixels_counted=pixels,
        labels_outside=outside, max_abs_err=err, equal=True,
        two_launches_bit_equal=True, ms=ms, launch_only_ms=launch_ms,
        plain_ms=plain_ms, **least)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **least,
            "library_ms": None}


def eval_cases(device):
    """The path shape (what `test()` hands the kernel at batch 32) with every
    sample valid, with a count of 20, with a mask that has holes, in f32 and
    from NCHW memory; a ragged 150-class shape with align_corners=False,
    int64 labels, a planted tie and labels of 255; 81 classes."""
    shape, out_hw = (EVAL_BATCH, 129, 129, NUM_CLASSES), (IMG, IMG)
    path = eval_case("eval_path_bf16", shape, out_hw, torch.bfloat16, True,
                     device)
    eval_case("eval_path_bf16_valid20", shape, out_hw, torch.bfloat16, True,
              device, valid=20)
    holes = torch.arange(EVAL_BATCH, device=device) % 3 != 1
    eval_case("eval_path_bf16_mask_with_holes", shape, out_hw, torch.bfloat16,
              True, device, valid=holes)
    eval_case("eval_path_f32", shape, out_hw, torch.float32, True, device)
    eval_case("eval_path_bf16_nchw", shape, out_hw, torch.bfloat16, True,
              device, nchw=True)
    eval_case("eval_ragged_c150", (2, 65, 97, 150), (257, 385),
              torch.bfloat16, False, device, label_dtype=torch.int64,
              tie=(3, 7), outside_rows=5)
    eval_case("eval_c81_f32", (2, 33, 33, 81), (129, 129), torch.float32,
              True, device)
    return path


def within(got, want, ulps, dtype, extra_floor=0.0):
    """Whether `got` lies within `ulps` ulps of `dtype` (bf16: 2^-7
    relative each; f32: none) of `want`, plus a floor of FUSED_FLOOR of
    want's largest entry and `extra_floor`. Returns (ok, largest difference,
    largest entry, a description of the worst entry)."""
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    diff = (got - want).abs()
    rel = ulps * 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    over = diff - (rel * want.abs() + FUSED_FLOOR * top + extra_floor)
    worst = int(over.argmax())
    detail = (f"worst excess {float(over.flatten()[worst])} at flat index "
              f"{worst}: {float(got.flatten()[worst])} against "
              f"{float(want.flatten()[worst])}; {int((over > 0).sum())} "
              f"entries over")
    return bool((over <= 0).all()), float(diff.max()), top, detail


def fused_case(name, n, k, m, dtype, act, device, nchw=False):
    """The three fused 1x1 kernels against the plain forward and the plain
    backward on the same tensors, with cotangents on y, col_sum and
    col_sumsq; two launches of each bit-equal; then their times beside the
    plain versions', one `torch.matmul` of the same product each, and the
    card's bound. `nchw=True` hands x over as the [N, K] view of memory in
    which the rows are not contiguous (what an NCHW-contiguous activation
    is): the wrapper must make one counted copy."""
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape, std=1.0, dt=torch.float32):
        return (torch.randn(*shape, generator=gen, device=device) * std
                ).to(dt)

    x = randn(n, k, dt=dtype)
    if nchw:
        x = x.t().contiguous().t()
    scale = (0.5 + torch.rand(k, generator=gen, device=device))
    shift = randn(k, std=0.2)
    w = randn(k, m, std=0.1)
    gy = randn(n, m, dt=dtype)
    gs, gss = randn(m, std=0.01), randn(m, std=0.001)
    leaves = [t.requires_grad_(True) for t in (x, scale, shift, w)]

    def run():
        out = fm.fused_bn_act_matmul(x, scale, shift, w, act=act)
        return out, torch.autograd.grad(out, leaves, (gy, gs, gss))

    before, copies = fm.launch_count(), fm.layout_copy_count()
    (y, s, ss), grads = run()
    (y2, s2, ss2), grads2 = run()
    after = fm.launch_count()
    if any(after[key] != before[key] + 2 for key in before):
        raise AssertionError(f"{name}: launch counts {before} -> {after}")
    copies = fm.layout_copy_count() - copies
    if copies != (2 if nchw else 0):
        raise AssertionError(f"{name}: {copies} layout copies")
    for a, b in zip((y, s, ss, *grads), (y2, s2, ss2, *grads2)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two launches differ")
    del y2, s2, ss2, grads2

    with torch.no_grad():
        xd, wd = x.detach().contiguous(), w.detach()
        ry, rs, rss = fm.bn_act_matmul_reference(xd, scale, shift, wd, act)
        rdx, rdscale, rdshift, rdy_tot = fm.bn_act_matmul_dx_reference(
            xd, scale, shift, wd, gy, gs, gss, act)
        rdw = fm.bn_act_matmul_dw_reference(xd, scale, shift, rdy_tot, act)
        mask = fm._act_grad_mask(xd.float() * scale + shift, act)
        torch.cuda.synchronize()
        errors, largest = {}, {}
        wc = w.detach().to(dtype)
        wt = wc.t().contiguous()
        dy_tot = fm._launch_bwd_dx(xd, scale, shift, wc, gy, gs, gss, act,
                                   wt)[3]
        # a bf16 dy_tot entry that rounds the other way (one ulp) moves
        # every dx of its row by up to that ulp times |w * scale|: the floor
        # of dx, which shows on entries near zero
        inherited = 0.0
        if dtype == torch.bfloat16:
            inherited = (2.0 ** -7 * float(rdy_tot.abs().max())
                         * float(wc.abs().max()) * float(scale.abs().max()))
        checks = [("y", y, ry, 1, 0.0), ("dy_tot", dy_tot, rdy_tot, 1, 0.0),
                  ("dx", grads[0], rdx, 2, inherited)]
        for key, got, want, ulps, floor in checks:
            ok, err, top, detail = within(got, want, ulps, dtype, floor)
            errors[key], largest[key] = err, top
            if got.dtype != dtype or got.shape != want.shape or not ok:
                raise AssertionError(f"{name}: {key} differs from the plain "
                                     f"version by {err} (largest {top}; "
                                     f"{detail})")
        del dy_tot
        for key, got, want in (("col_sum", s, rs), ("col_sumsq", ss, rss),
                               ("dscale", grads[1], rdscale),
                               ("dshift", grads[2], rdshift),
                               ("dw", grads[3], rdw)):
            top = float(want.abs().max())
            err = float((got - want).abs().max())
            errors[key], largest[key] = err, top
            if (got.dtype != torch.float32 or got.shape != want.shape
                    or not err <= FUSED_SUM_TOL * top):
                raise AssertionError(f"{name}: {key} differs from the plain "
                                     f"version by {err} (largest {top})")
        # the activation's mask, exactly: no gradient at all where the plain
        # version's f32 pre says none; where it says one, a wrongly masked
        # entry would be a zero against a value, which the bound on dx above
        # catches. (The zero patterns themselves may differ: sums of exact
        # bf16 products do cancel to 0.0 in one summation order and not in
        # another, once in 1e8 entries.)
        stray = int((grads[0][~mask] != 0).sum())
        one_sided = int(((grads[0] != 0) != (rdx != 0)).sum())
        if stray:
            raise AssertionError(f"{name}: {stray} gradients where the "
                                 f"plain version's mask is off")
        del ry, rs, rss, rdx, rdscale, rdshift, rdw, mask

        # times: the forward wrapper; the backward kernels through their
        # launchers on the operands the wrapper hands them
        fwd_ms = cuda_median_ms(lambda: fm.fused_bn_act_matmul(
            xd, scale, shift, wd, act=act))
        dx_ms = cuda_median_ms(lambda: fm._launch_bwd_dx(
            xd, scale, shift, wc, gy, gs, gss, act, wt))
        dw_ms = cuda_median_ms(lambda: fm._launch_bwd_dw(
            xd, scale, shift, rdy_tot, act))
        plain = {
            "fwd": cuda_median_ms(lambda: fm.bn_act_matmul_reference(
                xd, scale, shift, wd, act), reps=5),
            "bwd_dx": cuda_median_ms(lambda: fm.bn_act_matmul_dx_reference(
                xd, scale, shift, wd, gy, gs, gss, act), reps=5),
            "bwd_dw": cuda_median_ms(lambda: fm.bn_act_matmul_dw_reference(
                xd, scale, shift, rdy_tot, act), reps=5)}
        # one library product of the same size each, as a yardstick only:
        # no prologue, no statistics, no mask
        wct = wc.t().contiguous()
        library = {
            "fwd": cuda_median_ms(lambda: torch.matmul(xd, wc)),
            "bwd_dx": cuda_median_ms(lambda: torch.matmul(gy, wct)),
            "bwd_dw": cuda_median_ms(lambda: torch.matmul(xd.t(), gy))}
    # each input read once, each output written once; 2 N K M operations per
    # product (what the function needs, not what the backward recomputes),
    # at the tensor cores' bf16 rate or, for f32, the CUDA cores'
    e = x.element_size()
    rate = BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    ops = 2.0 * n * k * m
    bounds = {
        "fwd": bound(e * (n * k + k * m + n * m) + 8 * (k + m),
                     ops + 3.0 * n * (k + m), rate),
        "bwd_dx": bound(e * (2 * n * k + k * m + n * m) + 16 * (k + m),
                        ops + 8.0 * n * k, rate),
        "bwd_dw": bound(e * (n * k + n * m) + 4 * k * m + 8 * k,
                        ops + 2.0 * n * k, rate)}
    ms = {"fwd": fwd_ms, "bwd_dx": dx_ms, "bwd_dw": dw_ms}
    splits, rows = fm.dw_split(n, k, m)
    log("kernel", case=name, kernel="fused_matmul_bn", n=n, k=k, m=m,
        dtype=str(dtype).replace("torch.", ""), act=act,
        rows_contiguous=not nchw, layout_copies=copies,
        max_abs_err=errors, largest_entry=largest, mask_equal=True,
        dx_zero_on_one_side_only=one_sided, two_launches_bit_equal=True, ms=ms, plain_ms=plain,
        library_ms=library, tflops={key: ops / v / 1e9
                                    for key, v in ms.items()},
        bound_ms={key: b["bound_ms"] for key, b in bounds.items()},
        bound_by={key: b["bound_by"] for key, b in bounds.items()},
        wgmma_tiles=fm.wgmma_tiles(k, m),
        dw_split=[splits, rows], dw_last_split_rows=n - (splits - 1) * rows)
    worst = {"fwd": errors["y"], "bwd_dx": errors["dx"],
             "bwd_dw": errors["dw"]}
    return {key: {"max_abs_err": worst[key], "ms": ms[key],
                  "plain_ms": plain[key], **bounds[key],
                  "library_ms": library[key], "shape": [n, k, m]}
            for key in ms}


def fused_cases(device):
    """The extreme shapes of the fused train step's path (ResNet-50 at batch
    32, 513x513: stage 1 at 532,512 rows, stage 4 at 34,848), bf16; then
    f32, the ragged MobileNetV2 widths with the other two prologues, and an
    input whose rows are not contiguous. Returns the first and the third
    case's figures for the kernels' line."""
    bf16 = torch.bfloat16
    first = fused_case("fused_532512_256_64", 532512, 256, 64, bf16, "relu",
                       device)
    fused_case("fused_532512_64_256", 532512, 64, 256, bf16, "relu", device)
    second = fused_case("fused_34848_2048_512", 34848, 2048, 512, bf16,
                        "relu", device)
    fused_case("fused_34848_512_2048", 34848, 512, 2048, bf16, "relu", device)
    fused_case("fused_f32_3000_64_256", 3000, 64, 256, torch.float32, "relu",
               device)
    fused_case("fused_ragged_1237_24_144_relu6", 1237, 24, 144, bf16, "relu6",
               device)
    fused_case("fused_ragged_1237_144_24_none", 1237, 144, 24, bf16, "none",
               device)
    fused_case("fused_nchw_memory_4096_64_256", 4096, 64, 256, bf16, "relu",
               device, nchw=True)
    # dx's two grids at a wide shape whose rows end inside a tile, and a
    # call with fewer rows than one tile
    fused_case("fused_ragged_34849_1024_256", 34849, 1024, 256, bf16, "relu",
               device)
    fused_case("fused_short_77_64_256", 77, 64, 256, bf16, "relu", device)
    # dW over a split of N whose last run of rows is shorter than the
    # others and ends inside a stage, at K below one 64-column box
    n, k, m = 4133, 56, 72
    splits, rows = fm.dw_split(n, k, m)
    last = n - (splits - 1) * rows
    if not (splits > 1 and last < rows and last % 64 and k < 64):
        raise AssertionError(f"dw_split{(n, k, m)} = {(splits, rows)} has "
                             f"no partial last split")
    fused_case("fused_dw_partial_split_4133_56_72", n, k, m, bf16, "relu6",
               device)
    return {key: {**first[key], "second_shape": second[key]}
            for key in first}


def cmajor_phase(device):
    """The layout benchmark's own run on the card: it holds the
    channels-major kernel against its plain version at two ragged shapes
    and its three timed shapes (and two launches against each other), then
    times it beside its yardsticks. Returns the kernel's launches and the
    256 -> 64 figures."""
    cm.reset_launch_count()
    rows, ragged = bench_cmajor.main(device)
    launches = cm.launch_count()
    first = rows[0]
    least = bound(first["bytes"], first["flops"], BF16_TENSOR_FLOPS)
    log("cmajor", launches=launches, tolerance=bench_cmajor.TOLERANCE,
        ragged=ragged, shapes=[
            {**{key: row[key] for key in (
                "ci", "co", "pix", "max_abs_err", "largest",
                "kernel_channels_major", "plain_channels_major",
                "matmul_channels_major", "matmul_pixels_major",
                "conv2d_channels_last")},
             **bound(row["bytes"], row["flops"], BF16_TENSOR_FLOPS)}
            for row in rows], **least)
    return launches, {"max_abs_err": first["max_abs_err"],
                      "ms": first["kernel_channels_major"],
                      "plain_ms": first["plain_channels_major"], **least,
                      "library_ms": first["matmul_channels_major"],
                      "shape": [first["co"], first["ci"], first["pix"]]}


def small_model_check(device):
    """The f32 model at small size on the card (kernel) against the CPU
    (plain version), same seeded weights and images, TF32 off. A pixel can
    only flip where its top-2 gap is below twice the largest logit
    difference between the two devices."""
    def build_small(dev):
        m = build_model("deeplabv3plus", NUM_CLASSES,
                        backbone_layers=(1, 1, 1, 1), dtype=torch.float32,
                        full_res_output=False)
        return load_model_bundle(m, None, dev, seed=SEED)

    imgs = np.random.default_rng(SEED + 1).integers(
        0, 256, (2, 65, 65, 3), dtype=np.uint8)
    cpu_model, gpu_model = build_small("cpu"), build_small(device)
    cpu_mask = make_mask_fn(cpu_model)(imgs)
    before = ua.launch_count()
    gpu_mask = make_mask_fn(gpu_model)(imgs).cpu()
    if ua.launch_count() != before + 1:
        raise AssertionError("small model on the card skipped the kernel")
    with torch.inference_mode():
        x = normalize_images(torch.from_numpy(imgs)).permute(0, 3, 1, 2)
        lc = cpu_model(x).permute(0, 2, 3, 1)
        lg = gpu_model(x.to(device)).permute(0, 2, 3, 1).cpu()
    logit_diff = float((lc - lg).abs().max())
    up = resize_bilinear(lc.float(), (65, 65), align_corners=True)
    agreement, _ = mask_check(gpu_mask, cpu_mask, up,
                              gap=max(GAP, 2 * logit_diff + 1e-6))
    log("small_model", logits_max_abs_diff=logit_diff, agreement=agreement)


def small_train_check(device, fused=False):
    """3 SGD steps of the small f32 model through the Trainer's deferred
    upsample, on the card (kernels) against the CPU (plain version), from
    the same seeded weights on the same numpy batch, TF32 off: per-step
    losses within 1e-4 relative, final tensors within SMALL_TRAIN_TOL of
    their largest entry. With `fused` both runs have the fused 1x1 switch
    on: the four bottlenecks' conv1 and conv3 go through the f32 fused
    kernels on the card and their plain versions on the CPU. The weights come from a `.pt`: seeded, with
    non-trivial BN affines, so that every tensor has entries of order 0.1 to
    hold the updates against, and with uniform conv kernels (see
    `seeded_state_dict`: under the He kernels the f32 gradient at this size
    is too badly conditioned to hold two devices against each other)."""
    rng = np.random.default_rng(SEED + 3)
    batch = (rng.standard_normal((2, 65, 65, 3)).astype(np.float32),
             rng.integers(0, 5, (2, 65, 65)).astype(np.int32), 2)

    def build_small():
        return build_model("deeplabv3plus", 5, backbone_layers=(1, 1, 1, 1),
                           dtype=torch.float32, full_res_output=True)

    with tempfile.TemporaryDirectory() as tmp:
        start = os.path.join(tmp, "start.pt")
        torch.save({"model": seeded_state_dict(build_small(), SEED,
                                               init="uniform")}, start)

        def run(dev):
            model = build_small()
            trainer = Trainer(model, [batch], lr=1e-3, momentum=0.9,
                              weights=start, log=False,
                              log_dir=os.path.join(tmp, f"runs_{dev}"),
                              device=dev)
            return ([trainer.step() for _ in range(3)],
                    {k: v.detach().cpu() for k, v in
                     model.state_dict().items()})

        blocks.set_force_fused_1x1("on" if fused else None)
        try:
            cpu_losses, cpu_sd = run("cpu")
            before, fused_before = ce.launch_count(), fm.launch_count()
            gpu_losses, gpu_sd = run(device)
            after, fused_after = ce.launch_count(), fm.launch_count()
        finally:
            blocks.set_force_fused_1x1(None)
    if (after["fwd"] - before["fwd"], after["bwd"] - before["bwd"]) != (3, 3):
        raise AssertionError(f"small train steps launched {before} -> "
                             f"{after}, not 3 forward and 3 backward")
    # 4 bottlenecks x (conv1, conv3) x 3 steps, or none with the switch off
    fused_launches = {key: fused_after[key] - fused_before[key]
                      for key in fused_after}
    if set(fused_launches.values()) != {24 if fused else 0}:
        raise AssertionError(f"small train steps launched the fused 1x1 "
                             f"kernels {fused_launches} times")
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gpu_losses,
                                                       cpu_losses))
    param_err = max(
        float((gpu_sd[k] - v).abs().max()) / float(v.abs().max())
        for k, v in cpu_sd.items() if v.dtype.is_floating_point)
    if not (loss_err <= 1e-4 and param_err <= SMALL_TRAIN_TOL):
        raise AssertionError(f"small train steps: losses {gpu_losses} vs "
                             f"{cpu_losses} on the CPU differ by "
                             f"{loss_err}, tensors by {param_err}")
    if fused:
        log("small_fused", losses=gpu_losses, loss_max_rel_diff=loss_err,
            tensor_max_rel_diff=param_err, launches=fused_launches)
    else:
        log("small_train", losses=gpu_losses, loss_max_rel_diff=loss_err,
            tensor_max_rel_diff=param_err)


def small_eval_check(device):
    """`test()` with the small f32 model over an in-memory dataset whose last
    batch is padded (6 images at batch 4), on the card (both kernels)
    against the CPU (their plain versions), TF32 off: counts equal, loss
    within 1e-5, mIoU within 1e-6."""
    rng = np.random.default_rng(SEED + 7)
    dataset = MemoryDataset(6, rng, hw=65, num_classes=5)

    def run(dev, tmp):
        model = build_model("deeplabv3plus", 5, backbone_layers=(1, 1, 1, 1),
                            dtype=torch.float32, full_res_output=True)
        model = load_model_bundle(model, None, dev, seed=SEED)
        fetcher = Fetcher(DataLoader(dataset, 4, num_workers=1),
                          PostFetch(device=dev))
        path = os.path.join(tmp, f"{torch.device(dev).type}.json")
        miou = run_eval(model, fetcher, show_first_batch=False, log=False,
                        report_path=path, device=dev)
        with open(path) as f:
            return miou, json.load(f)

    with tempfile.TemporaryDirectory() as tmp:
        cpu_miou, cpu = run("cpu", tmp)
        before = (ec.launch_count(), ce.launch_count()["fwd"])
        gpu_miou, gpu = run(device, tmp)
        launched = (ec.launch_count() - before[0],
                    ce.launch_count()["fwd"] - before[1])
    if launched != (2, 2):
        raise AssertionError(f"small eval on the card launched {launched} "
                             f"confusion and CE kernels, not (2, 2)")
    counts = [[c[k] for c in r["per_class"] for k in ("tp", "fn", "fp")]
              for r in (gpu, cpu)]
    loss_err = abs(gpu["val_loss"] - cpu["val_loss"]) / cpu["val_loss"]
    if (counts[0] != counts[1] or loss_err > 1e-5
            or abs(gpu_miou - cpu_miou) > 1e-6):
        raise AssertionError(f"small eval: counts equal "
                             f"{counts[0] == counts[1]}, loss {loss_err}, "
                             f"mIoU {gpu_miou} vs {cpu_miou}")
    log("small_eval", miou=gpu_miou, miou_cpu=cpu_miou,
        loss_rel_diff=loss_err, counts_equal=True,
        pixels_counted=sum(c["tp"] + c["fn"] for c in gpu["per_class"]))


def to_device(obj, device):
    """A nest of dicts, lists and tensors moved to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_device(v, device) for v in obj]
    return obj


def small_augment_check(device):
    """The default policy on a small batch, its parameters drawn once (on
    the CPU) and applied on the card (kernel) and on the CPU (plain
    version): see AUG_* above for the bounds and their reason."""
    rng = np.random.default_rng(SEED + 5)
    imgs = torch.from_numpy(np.stack([smooth_image(rng, 65, 65)
                                      for _ in range(8)]))
    segs = resize_nearest(torch.from_numpy(rng.integers(
        1, NUM_CLASSES, (8, 5, 5)).astype(np.uint8)), (65, 65))
    fn = taug.make_augment_fn()
    params = fn.draw(torch.Generator().manual_seed(SEED), 8, 65, 65)
    cpu_img, cpu_seg = fn.apply(params, imgs, segs)
    before = br.launch_count()
    gpu_img, gpu_seg = fn.apply(to_device(params, device), imgs.to(device),
                                segs.to(device))
    if br.launch_count() != before + 2:
        raise AssertionError("the policy on the card did not launch the "
                             "resampler twice")
    gpu_img, gpu_seg = gpu_img.cpu(), gpu_seg.cpu()
    label_share = float((gpu_seg != cpu_seg).float().mean())
    diff = (gpu_img - cpu_img).abs()
    image_share, image_mean = float((diff > 0).float().mean()), float(
        diff.mean())
    if not (label_share <= AUG_LABEL_SHARE and image_share <= AUG_IMAGE_SHARE
            and image_mean <= AUG_IMAGE_MEAN):
        raise AssertionError(
            f"small augment: labels differ on {label_share}, image elements "
            f"on {image_share} (mean {image_mean}, max {float(diff.max())})")
    if torch.equal(cpu_img, imgs.float()) or len(cpu_seg.unique()) < 3:
        raise AssertionError("the drawn policy changed nothing")
    log("small_augment", labels_differing_share=label_share,
        image_elements_differing_share=image_share,
        image_mean_abs_diff=image_mean, image_max_abs_diff=float(diff.max()),
        gates_per_sample=params["gates"].sum(1).tolist(),
        order=params["order"])


def post(url, body, timeout=120):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def smooth_image(rng, h, w):
    """A smooth random u8 image (bilinear up from 17x17), so that masks have
    regions."""
    small = torch.from_numpy(rng.integers(0, 256, (17, 17, 3)).astype(
        np.float32))
    return (resize_bilinear(small, (h, w), align_corners=True)
            .round().clamp(0, 255).to(torch.uint8).numpy())


def serve_phase(device):
    model = build_model("deeplabv3plus", NUM_CLASSES, dtype=torch.bfloat16,
                        full_res_output=False)
    model = load_model_bundle(model, None, device, seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    sizes = [(IMG, IMG)] * 10 + [(400, 600), (700, 300)]  # (H, W)
    imgs = [smooth_image(rng, h, w) for h, w in sizes]

    ua.reset_launch_count()
    server = MaskServer(model, img_size=(IMG, IMG), max_batch=BATCH)
    # record the padded u8 batches the server runs: on the card, bf16
    # logits of an image change with its position in the batch (a repeat
    # of the same batch is bit-exact), so the direct run below replays the
    # same batches
    ran = []
    serve_fn = server._mask_fn

    def recording(images_u8):
        ran.append(np.array(images_u8))
        return serve_fn(images_u8)

    server._mask_fn = recording
    host, port = server.start(port=0)[:2]
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if health["status"] != "ok":
            raise AssertionError(f"healthz: {health}")
        results = [None] * len(imgs)

        def worker(i):
            results[i] = post(base + "/predict?format=raw",
                              encode_png(imgs[i]))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        burst_s = time.perf_counter() - t0
        burst_batches = list(ran)
        lat = []
        for i in range(5):  # one request at a time
            t1 = time.perf_counter()
            status, _, body = post(base + "/predict", encode_png(imgs[i]))
            lat.append(time.perf_counter() - t1)
            color = decode_png(body)
            if status != 200 or color.shape != (IMG, IMG, 3):
                raise AssertionError(f"colorized response {status} "
                                     f"{color.shape}")
        launches = ua.launch_count()
    finally:
        server.stop()
    if any(r is None for r in results):
        raise AssertionError("a request got no response")
    masks = []
    for (h, w), (status, ctype, body) in zip(sizes, results):
        m = decode_png(body)
        if status != 200 or ctype != "image/png" or m.shape != (h, w):
            raise AssertionError(f"bad response {status} {ctype} {m.shape} "
                                 f"for a {h}x{w} request")
        masks.append(m)
    if launches < 1:
        raise AssertionError("the serving run never launched the kernel")

    # every 513^2 mask equals make_mask_fn run directly on the same arrays
    mask_fn = make_mask_fn(model, out_hw=(IMG, IMG))
    direct = [mask_fn(b).cpu().numpy() for b in burst_batches]
    n_classes = 0
    for img, size, served in zip(imgs, sizes, masks):
        if size != (IMG, IMG):
            continue
        slots = [(k, j) for k, b in enumerate(burst_batches)
                 for j in range(BATCH) if np.array_equal(b[j], img)]
        if len(slots) != 1:
            raise AssertionError(f"request found in {len(slots)} batch slots")
        want = direct[slots[0][0]][slots[0][1]]
        if not np.array_equal(served.astype(np.int32), want):
            raise AssertionError(f"served mask differs from make_mask_fn at "
                                 f"{int((served != want).sum())} pixels")
        n_classes = max(n_classes, len(np.unique(want)))
    if n_classes < 2:
        raise AssertionError("degenerate masks: one class everywhere")

    # device throughput of the serving function: u8 batch already on the card
    batch = torch.from_numpy(np.stack(imgs[:BATCH])).to(device)
    mask_fn(batch)
    torch.cuda.synchronize()
    # the wall time is partly host dispatch on a shared host: best of 10
    best = float("inf")
    for _ in range(10):
        t1 = time.perf_counter()
        for _ in range(10):
            out = mask_fn(batch)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t1) / 10)
    if out.shape != (BATCH, IMG, IMG):
        raise AssertionError(f"mask shape {tuple(out.shape)}")
    log("serve", requests=len(imgs), burst_s=burst_s,
        request_latency_ms_median=1e3 * statistics.median(lat),
        launches=launches, classes_present=n_classes,
        batches=server.stats["batches"], burst_batches=len(burst_batches),
        images_per_s_batch8=BATCH / best, ms_per_batch8=1e3 * best)
    return launches


class RepeatFetcher:
    """In-memory fetcher: the same (images, segs, valid) batch `n` times."""

    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def __len__(self):
        return self.n

    def __iter__(self):
        return (self.batch for _ in range(self.n))


def eval_report(model, dataset, device, tmp, **options):
    """`test()` over `dataset` at batch 32 (bf16 images, no augmentation, the
    last batch padded): the mIoU and the parsed report."""
    fetcher = Fetcher(DataLoader(dataset, EVAL_BATCH),
                      PostFetch(dtype=torch.bfloat16, device=device))
    path = os.path.join(tmp, "report.json")
    miou = run_eval(model, fetcher, log=False, report_path=path,
                    device=device, **options)
    with open(path) as f:
        return miou, json.load(f)


def train_batch(device):
    """The train phases' fixed batch: 32 smooth u8 images at 513x513 and, as
    labels, a 9x9 grid of classes per image, nearest-upsampled. Returns the
    u8 images (host) and the (images, segs, valid) batch on the card:
    loading is not part of the train-step slices."""
    rng = np.random.default_rng(SEED + 4)
    imgs_u8 = np.stack([smooth_image(rng, IMG, IMG)
                        for _ in range(TRAIN_BATCH)])
    grid = torch.from_numpy(rng.integers(0, NUM_CLASSES,
                                         (TRAIN_BATCH, 9, 9)).astype(np.int32))
    segs = resize_nearest(grid, (IMG, IMG))
    if len(torch.unique(segs)) < 3:
        raise AssertionError("labels have fewer than 3 classes")
    return imgs_u8, (normalize_images(torch.from_numpy(imgs_u8).to(device)),
                     segs.to(device), TRAIN_BATCH)


def train_phase(device, eval_set, profile=False):
    """Full-width DeepLabV3+ R50 through the port's Trainer: a
    full_res_output=True model, so the Trainer's deferred upsample is what
    routes the loss through the upsample+CE kernels. One fixed batch of 32
    at 513x513, bf16 compute over f32 parameters, SGD 1e-3 with momentum
    0.9: 3 warm-up steps, then 3 synchronised windows of 5 steps. Then
    save -> load_model_bundle -> make_mask_fn on 8 of the images, and what a
    training script does after an epoch: evaluate the live model, keep its
    mIoU, save(best), and find the same counts in the reloaded best.pt.
    Returns that reloaded model beside the train step's figures."""
    imgs_u8, batch = train_batch(device)

    model = build_model("deeplabv3plus", NUM_CLASSES, dtype=torch.bfloat16,
                        full_res_output=True)
    with tempfile.TemporaryDirectory() as tmp:
        fetcher = RepeatFetcher(batch, 1)
        trainer = Trainer(model, fetcher, workdir=os.path.join(tmp, "w"),
                          lr=1e-3, momentum=0.9, seed=SEED, log=False,
                          log_dir=os.path.join(tmp, "runs"), device=device)
        if trainer._train_module.full_res_output is not False:
            raise AssertionError("the Trainer did not defer the upsample")
        stem_mean = model.backbone.stem.bn.running_mean.clone()
        # the strides of the NHWC view of the logits that the step hands
        # the loss: they follow the layout cls_conv's output came in
        strides = set()
        strides_hook = trainer._train_module.register_forward_hook(
            lambda mod, args, out: strides.add(
                tuple(out.permute(0, 2, 3, 1).stride())))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ce.reset_launch_count()
        losses = [trainer.step() for _ in range(3)]  # warm-up, one by one
        fetcher.n = 5
        wall_ms, event_ms = [], []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            losses.append(trainer.step())  # ends by reading the last loss
            end.record()
            torch.cuda.synchronize()
            wall_ms.append(1e3 * (time.perf_counter() - t0) / 5)
            event_ms.append(start.elapsed_time(end) / 5)
        launches = ce.launch_count()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = trainer.state.step
        if not all(np.isfinite(losses)):
            raise AssertionError(f"a loss is not finite: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall on the repeated "
                                 f"batch: {losses}")
        if steps != 18 or launches != {"fwd": steps, "bwd": steps}:
            raise AssertionError(f"{steps} steps launched {launches}")
        if len(strides) != 1:
            raise AssertionError(f"logits reached the loss with strides "
                                 f"{strides}")
        if torch.equal(model.backbone.stem.bn.running_mean, stem_mean):
            raise AssertionError("BN running_mean did not move")
        if profile:
            profile_steps(trainer)

        # train -> save -> serve
        trainer.save()
        served = build_model("deeplabv3plus", NUM_CLASSES,
                             dtype=torch.bfloat16, full_res_output=False)
        served = load_model_bundle(served, os.path.join(tmp, "w", "last.pt"),
                                   device)

        # train -> eval -> save(best) -> reload -> the same evaluation
        strides_hook.remove()
        trainer.metrics, live = eval_report(trainer.model, eval_set, device,
                                            tmp, show_first_batch=False)
        trainer.save(best=True)
        best = os.path.join(tmp, "w", "best.pt")
        trained = load_model_bundle(
            build_model("deeplabv3plus", NUM_CLASSES, dtype=torch.bfloat16,
                        full_res_output=True), best, device)
        miou, reloaded = eval_report(trained, eval_set, device, tmp,
                                     show_first_batch=False)
        kept = torch.load(best, weights_only=True)["best_miou"]
    if not (reloaded == live and miou == trainer.metrics == kept):
        raise AssertionError(f"best.pt evaluates to mIoU {miou} (kept "
                             f"{kept}), the live model to {trainer.metrics}")
    if not (np.isfinite(live["val_loss"]) and 0.0 <= miou <= 1.0):
        raise AssertionError(f"eval after training: {live}")
    log("train_eval_save_best", miou=miou, val_loss=live["val_loss"],
        reloaded_report_equal=True)
    masks = make_mask_fn(served, out_hw=(IMG, IMG))(imgs_u8[:8])
    classes = len(torch.unique(masks))
    if masks.shape != (8, IMG, IMG) or masks.dtype != torch.int32:
        raise AssertionError(f"served masks {masks.dtype} "
                             f"{tuple(masks.shape)}")
    if classes < 2 or int(masks.max()) >= NUM_CLASSES:
        raise AssertionError(f"degenerate masks after training: {classes} "
                             f"classes")
    images_per_s = 1e3 * TRAIN_BATCH / min(wall_ms)
    log("train", batch=TRAIN_BATCH, steps=steps, first_loss=losses[0],
        window_mean_losses=losses[3:], images_per_s=images_per_s,
        ms_per_step_wall=wall_ms, ms_per_step_cuda_events=event_ms,
        peak_memory_gb=peak_gb, launches=launches,
        logits_strides=list(*strides),
        served_classes_after_training=classes)
    figures = {"first_loss": losses[0], "images_per_s": images_per_s,
               "ms_per_step_wall": wall_ms, "ms_per_step_cuda_events": event_ms,
               "peak_memory_gb": peak_gb}
    return launches, strides.pop(), figures, trained


def step_windows(trainer, windows, losses):
    """Wall and CUDA-event ms per step over `windows` synchronised calls of
    `trainer.step()` (an epoch of the trainer's fetcher each, 5 steps);
    appends each epoch's mean loss to `losses`."""
    wall_ms, event_ms = [], []
    steps = len(trainer.fetcher)
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        losses.append(trainer.step())
        end.record()
        torch.cuda.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0) / steps)
        event_ms.append(start.elapsed_time(end) / steps)
    return wall_ms, event_ms


def step_enqueue_ms(trainer, batch):
    """Host ms to enqueue one train step (the step function alone, its loss
    not read) on an idle stream; the median of 3. A full launch queue makes
    the host wait for the card, so this is at least the host's own time."""
    images, segs, _ = batch
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.state, _ = trainer._train_step(trainer.state, images, segs)
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def train_fused_phase(device, plain, profile=False):
    """The train phase's model, batch and optimizer with the fused 1x1
    switch on (`nn.blocks.set_force_fused_1x1("on")`): every bottleneck's
    conv1 and conv3 go through the fused forward, dx and dW kernels, 32 of
    each per step on ResNet-50. 3 warm-up steps, then 3 synchronised windows
    of 5, beside the figures `plain` of the same run's train phase (switch
    off, same weights and batch). Then one eval-mode forward with the switch
    on against the same forward with it off. Returns the fused kernels'
    launches."""
    imgs_u8, batch = train_batch(device)
    model = build_model("deeplabv3plus", NUM_CLASSES, dtype=torch.bfloat16,
                        full_res_output=True)
    blocks.set_force_fused_1x1("on")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            fetcher = RepeatFetcher(batch, 1)
            trainer = Trainer(model, fetcher, workdir=os.path.join(tmp, "w"),
                              lr=1e-3, momentum=0.9, seed=SEED, log=False,
                              log_dir=os.path.join(tmp, "runs"),
                              device=device)
            folded_bn = model.backbone.layer1_block0.conv1.bn
            before = (folded_bn.running_mean.clone(),
                      int(folded_bn.num_batches_tracked))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fm.reset_launch_count()
            fm.reset_layout_copy_count()
            ce.reset_launch_count()
            losses = [trainer.step() for _ in range(3)]
            fetcher.n = 5
            wall_ms, event_ms = step_windows(trainer, 3, losses)
            launches, copies = fm.launch_count(), fm.layout_copy_count()
            ce_launches = ce.launch_count()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            steps = trainer.state.step
            moved = (not torch.equal(folded_bn.running_mean, before[0]),
                     int(folded_bn.num_batches_tracked) - before[1])
            # the host's share: one step enqueued on an idle stream
            enqueue_ms = step_enqueue_ms(trainer, batch)
            if profile:
                profile_steps(trainer, phase="profile_fused")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"fused train losses {losses}")
        if steps != 18 or set(launches.values()) != {32 * steps}:
            raise AssertionError(f"{steps} fused steps launched {launches}, "
                                 f"not 32 of each kernel per step")
        if ce_launches != {"fwd": steps, "bwd": steps}:
            raise AssertionError(f"{steps} steps launched {ce_launches}")
        if moved != (True, steps):
            raise AssertionError("a folded BN's running statistics did not "
                                 "move once per step")
        loss_diff = abs(losses[0] - plain["first_loss"]) / plain["first_loss"]
        if not loss_diff <= FUSED_LOSS_RTOL:
            raise AssertionError(f"step 1's loss {losses[0]} with the switch "
                                 f"on, {plain['first_loss']} with it off")

        # one eval-mode forward of the stride-4 twin, switch on against off,
        # on the same 8 images at the same batch positions
        twin = copy.copy(trainer.model)
        twin.full_res_output = False
        images = batch[0][:BATCH]
        fwd = nhwc_forward(twin)
        with torch.inference_mode():
            fm.reset_launch_count()
            on = fwd(images).float()
            eval_launches = fm.launch_count()
            blocks.set_force_fused_1x1("off")
            off = fwd(images).float()
            blocks.set_force_fused_1x1("on")
            if eval_launches != {"fwd": 32, "bwd_dx": 0, "bwd_dw": 0}:
                raise AssertionError(f"the eval forward launched "
                                     f"{eval_launches}")
            logit_diff = float((on - off).abs().max())
            up = resize_bilinear(off, (IMG, IMG), align_corners=True)
            up_on = resize_bilinear(on, (IMG, IMG), align_corners=True)
            agreement, _ = mask_check(up_on.argmax(-1), up.argmax(-1), up,
                                      gap=max(GAP, 2 * logit_diff + 1e-6))
            logit_top = float(off.abs().max())
    finally:
        blocks.set_force_fused_1x1(None)
    images_per_s = 1e3 * TRAIN_BATCH / min(wall_ms)
    log("train_fused", batch=TRAIN_BATCH, steps=steps, first_loss=losses[0],
        first_loss_switch_off=plain["first_loss"],
        first_loss_rel_diff=loss_diff, window_mean_losses=losses[3:],
        images_per_s=images_per_s,
        images_per_s_switch_off=plain["images_per_s"],
        ms_per_step_wall=wall_ms,
        ms_per_step_wall_switch_off=plain["ms_per_step_wall"],
        ms_per_step_cuda_events=event_ms,
        ms_per_step_cuda_events_switch_off=plain["ms_per_step_cuda_events"],
        host_enqueue_ms_per_step=enqueue_ms,
        peak_memory_gb=peak_gb,
        peak_memory_gb_switch_off=plain["peak_memory_gb"],
        launches=launches, launches_per_step=32, ce_launches=ce_launches,
        layout_copies=copies, layout_copies_per_step=copies / steps,
        eval_forward_launches=eval_launches,
        eval_logits_max_abs_diff=logit_diff, eval_logits_largest=logit_top,
        eval_mask_agreement=agreement)
    return launches


class FixedLogits(torch.nn.Module):
    """A stand-in model that answers with logits captured earlier: the eval
    step's tail runs on exactly the tensor another route saw."""

    def __init__(self, logits_nchw):
        super().__init__()
        self.logits = logits_nchw

    def forward(self, x):
        return self.logits


def assert_results_equal(name, got, want, loss_rtol=0.0):
    """Eval-step results: the loss within `loss_rtol` (relative), the count
    vectors equal."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} results against "
                             f"{len(want)}")
    loss, ref = float(got[0]), float(want[0])
    if not (np.isfinite(loss) and abs(loss - ref) <= loss_rtol * abs(ref)):
        raise AssertionError(f"{name}: loss {loss} against {ref}")
    for g, w in zip(got[1:], want[1:]):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: counts differ by "
                                 f"{float((g - w).abs().max())}")
    return abs(loss - ref) / abs(ref)


def eval_phase(device, model, eval_set, profile=False):
    """The evaluation path at full width: `test()` over 80 images at batch
    32 (bf16, the stride-4 twin of the trained full_res_output model), so 3
    eval steps with 32, 32 and 16 real samples, each through the upsample+CE
    forward kernel and the upsample+argmax+confusion kernel; the first
    batch's picture goes through the upsample+argmax kernel. Then each
    option of the eval step once on one batch of 8, held against a
    composition by hand of the same forwards."""
    fetcher = Fetcher(DataLoader(eval_set, EVAL_BATCH),
                      PostFetch(dtype=torch.bfloat16, device=device))
    captured, batches = [], []
    # `test()` evaluates a shallow copy of the model, which shares its hooks
    hook = model.register_forward_hook(
        lambda mod, args, out: captured.append(out))

    class Recording:
        loader = fetcher.loader

        def __len__(self):
            return len(fetcher)

        def __iter__(self):
            for batch in fetcher:
                batches.append(batch)
                yield batch

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ec.reset_launch_count()
        ce.reset_launch_count()
        ua.reset_launch_count()
        miou = run_eval(model, Recording(), log=False,
                        report_path="report.json", device=device)
        launches = {"eval_confusion": ec.launch_count(),
                    "softmax_ce_fwd": ce.launch_count()["fwd"],
                    "upsample_argmax": ua.launch_count()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hook.remove()
        with open("report.json") as f:
            report = json.load(f)
        picture = decode_png(open("batch.png", "rb").read())
    valid_counts = [min(EVAL_BATCH, EVAL_IMAGES - i)
                    for i in range(0, EVAL_IMAGES, EVAL_BATCH)]
    steps = len(valid_counts)
    if launches != {"eval_confusion": steps, "softmax_ce_fwd": steps,
                    "upsample_argmax": 1}:
        raise AssertionError(f"the eval run launched {launches}")
    if picture.shape != (min(8, EVAL_BATCH) * IMG, 2 * IMG, 3):
        raise AssertionError(f"first-batch picture {picture.shape}")
    if [b[2] for b in batches] != valid_counts:
        raise AssertionError(f"valid counts {[b[2] for b in batches]}")
    counted = sum(c["tp"] + c["fn"] for c in report["per_class"])
    if counted != EVAL_IMAGES * IMG * IMG or not (
            np.isfinite(report["val_loss"]) and 0.0 <= miou <= 1.0
            and report["miou"] == miou):
        raise AssertionError(f"eval report: {counted} pixels counted, "
                             f"loss {report['val_loss']}, mIoU {miou}")

    # per batch, the fused route against the plain tail on the logits the
    # run produced (bf16 logits depend on the batch: never a second forward)
    # (the second forward of the run made the first batch's picture)
    logits = captured[:1] + captured[2:]
    if (len(logits) != steps or captured[1].shape[0] != min(8, EVAL_BATCH)
            or any(tuple(c.shape) != (EVAL_BATCH, NUM_CLASSES, 129, 129)
                   for c in logits)):
        raise AssertionError(f"captured {[tuple(c.shape) for c in captured]}")
    fused_step = make_eval_step(NUM_CLASSES)
    plain_step = make_eval_step(NUM_CLASSES, use_kernels=False)
    totals, loss_diff = None, 0.0
    for lg, (images, segs, valid) in zip(logits, batches):
        fixed = FixedLogits(lg).eval()
        fused = fused_step(fixed, images, segs, valid)
        plain = plain_step(fixed, images, segs, valid)
        loss_diff = max(loss_diff, assert_results_equal(
            "fused route against the plain tail", fused, plain, LOSS_RTOL))
        fused = [f.double() for f in fused]  # a sum may pass 2^24
        totals = fused if totals is None else [
            t + f for t, f in zip(totals, fused)]
    for row, key in zip(totals[1:], ("tp", "fn", "fp")):
        if row.tolist() != [c[key] for c in report["per_class"]]:
            raise AssertionError(f"the report's {key} is not the sum of the "
                                 f"steps' results")
    if abs(float(totals[0]) / steps - report["val_loss"]) > 1e-6 * report[
            "val_loss"]:
        raise AssertionError("the report's loss is not the steps' mean")

    # rate: whole passes of test(), host clock, synchronised at both ends
    pass_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_eval(model, fetcher, show_first_batch=False, log=False,
                 device=device)
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
    # the step alone on a batch already on the card, and its forward alone
    twin = copy.copy(model)
    twin.full_res_output = False
    images, segs, _ = batches[0]
    fwd = nhwc_forward(twin)
    with torch.inference_mode():
        step_ms = cuda_median_ms(
            lambda: fused_step(twin, images, segs, EVAL_BATCH), reps=10)
        forward_ms = cuda_median_ms(lambda: fwd(images), reps=10)
        t0 = time.perf_counter()
        for _ in range(5):
            fused_step(twin, images, segs, EVAL_BATCH)
        enqueue_ms = 1e3 * (time.perf_counter() - t0) / 5
        torch.cuda.synchronize()
        if profile:
            profile_table("profile_eval", lambda: fused_step(
                twin, images, segs, EVAL_BATCH), 3)
    log("eval", images=EVAL_IMAGES, batch=EVAL_BATCH, steps=steps, miou=miou,
        val_loss=report["val_loss"], launches=launches,
        pixels_counted=counted, fused_vs_plain_tail_counts_equal=True,
        fused_vs_plain_tail_loss_max_rel_diff=loss_diff,
        images_per_s=EVAL_IMAGES / min(pass_s),
        ms_per_pass=[1e3 * t for t in pass_s],
        ms_per_step_cuda_events=step_ms, forward_ms_cuda_events=forward_ms,
        forward_share=forward_ms / step_ms,
        step_host_enqueue_ms=enqueue_ms, peak_memory_gb=peak_gb)
    eval_options(device, twin, images[:BATCH], segs[:BATCH], eval_set)
    return launches


def eval_options(device, twin, images, segs, eval_set):
    """Each option of the eval step once, on one batch of 8 at full width,
    against a composition by hand of the same forwards (a repeat of the same
    forward on the card is bit-exact, so counts must be equal)."""
    fwd = nhwc_forward(twin)
    align = True

    def on(logits_nhwc, x, y, **options):
        """The plain or fused step on logits made by hand."""
        return make_eval_step(NUM_CLASSES, **options)(
            FixedLogits(logits_nhwc.permute(0, 3, 1, 2)).eval(), x, y, BATCH)

    def flipped(x):
        return (fwd(x) + fwd(x.flip(2)).flip(2)) * 0.5

    checked = {}
    with torch.inference_mode():
        got = make_eval_step(NUM_CLASSES, tta_flip=True)(twin, images, segs,
                                                         BATCH)
        checked["tta_flip"] = assert_results_equal(
            "tta_flip", got, on(flipped(images), images, segs), LOSS_RTOL)

        got = make_eval_step(NUM_CLASSES, tta_scales=(0.75, 1.25))(
            twin, images, segs, BATCH)
        base = fwd(images)
        acc = base.float()
        for size in ((384, 384), (640, 640)):
            scaled = resize_bilinear(images.float(), size,
                                     align_corners=align).to(images.dtype)
            acc = acc + resize_bilinear(fwd(scaled).float(), (129, 129),
                                        align_corners=align)
        checked["tta_scales"] = assert_results_equal(
            "tta_scales", got, on((acc / 3).to(base.dtype), images, segs),
            LOSS_RTOL)

        # sliding window: 513 tiles over a 769 batch, offsets (0, 256) twice
        big = resize_bilinear(images, (769, 769), align_corners=True)
        big_segs = resize_nearest(segs, (769, 769))
        got = make_eval_step(NUM_CLASSES, tile=(IMG, IMG))(twin, big,
                                                           big_segs, BATCH)
        offsets = _tile_offsets(769, IMG, 1 / 3)
        canvas = torch.zeros((BATCH, 769, 769, NUM_CLASSES), device=device)
        count = torch.zeros((1, 769, 769, 1), device=device)
        for y0 in offsets:
            for x0 in offsets:
                canvas[:, y0:y0 + IMG, x0:x0 + IMG] += resize_bilinear(
                    fwd(big[:, y0:y0 + IMG, x0:x0 + IMG]).float(),
                    (IMG, IMG), align_corners=align)
                count[:, y0:y0 + IMG, x0:x0 + IMG] += 1.0
        if offsets != (0, 256) or float(count.max()) != 4.0:
            raise AssertionError(f"tile offsets {offsets}")
        checked["tile"] = assert_results_equal(
            "tile", got, on(canvas / count, big, big_segs, use_kernels=False),
            LOSS_RTOL)
        tiled_masks = make_tiled_mask_fn(twin, tile_hw=(IMG, IMG),
                                         overlap=1 / 3)(
            torch.from_numpy(np.stack([smooth_image(
                np.random.default_rng(SEED + 8), 769, 769)] * 2)))
        del canvas, count, big, big_segs
        if (tiled_masks.shape != (2, 769, 769)
                or tiled_masks.dtype != torch.int32
                or int(tiled_masks.max()) >= NUM_CLASSES
                or len(torch.unique(tiled_masks)) < 2):
            raise AssertionError("make_tiled_mask_fn: bad masks")

        # ignore_index: torch's own cross_entropy per sample, and counts
        # over the pixels that are left
        ignored = segs.clone()
        ignored[:, :40] = 255
        ignored[0] = 255
        got = make_eval_step(NUM_CLASSES, ignore_index=255)(
            twin, images, ignored, BATCH)
        up = resize_bilinear(base.float(), (IMG, IMG), align_corners=align)
        per_sample = torch.stack([torch.nan_to_num(
            torch.nn.functional.cross_entropy(
                up[i].reshape(-1, NUM_CLASSES), ignored[i].reshape(-1).long(),
                ignore_index=255)) for i in range(BATCH)])
        keep = ignored != 255
        pred = up.argmax(-1)
        want = (per_sample.mean(), *confusion_update(pred[keep],
                                                     ignored[keep],
                                                     NUM_CLASSES))
        checked["ignore_index"] = assert_results_equal(
            "ignore_index", got, want, 1e-5)

        d = boundary_pixels(IMG, IMG, 0.02)
        got = make_eval_step(NUM_CLASSES, boundary_ratio=0.02)(
            twin, images, segs, BATCH)
        want = (*on(base, images, segs, use_kernels=False),
                *boundary_confusion(pred, segs, NUM_CLASSES, d))
        checked["boundary_ratio"] = assert_results_equal(
            "boundary_ratio", got, want, LOSS_RTOL)
        if d != 15 or not 0 < float(got[4].sum()) <= float(got[5].sum()):
            raise AssertionError(f"boundary sums {got[4]}, {got[5]} at d={d}")

        # serving with flip TTA: the same average, then the argmax kernel
        u8 = torch.from_numpy(eval_set.images[:BATCH]).to(device)
        before = ua.launch_count()
        masks = make_mask_fn(twin, tta_flip=True)(u8)
        want = ua.fused_upsample_argmax(flipped(normalize_images(u8)),
                                        (IMG, IMG), align_corners=align)
        if ua.launch_count() != before + 2 or not torch.equal(masks, want):
            raise AssertionError("make_mask_fn(tta_flip=True) differs from "
                                 "the average by hand")
    torch.cuda.synchronize()
    log("eval_options", loss_rel_diff=checked, counts_equal=True,
        boundary_band_px=d, tiled_mask_classes=len(torch.unique(tiled_masks)))


class MemoryDataset:
    """Seeded u8 images and labels held in host memory: smooth images and,
    as labels, a 9x9 grid of classes per image, nearest-upsampled."""

    def __init__(self, n, rng, hw=IMG, num_classes=NUM_CLASSES):
        self.classes = [f"class{i}" for i in range(num_classes)]
        self.images = np.stack([smooth_image(rng, hw, hw) for _ in range(n)])
        grid = torch.from_numpy(rng.integers(0, num_classes,
                                             (n, 9, 9)).astype(np.uint8))
        self.segs = resize_nearest(grid, (hw, hw)).numpy()

    def first(self, n):
        """The same dataset cut to its first `n` samples (no copy)."""
        cut = copy.copy(self)
        cut.images, cut.segs = self.images[:n], self.segs[:n]
        return cut

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.segs[i]


def label_sets(segs):
    """[B, 256] bool: which label values each sample holds."""
    flat = segs.reshape(segs.shape[0], -1).long()
    present = torch.zeros((segs.shape[0], 256), dtype=torch.bool,
                          device=segs.device)
    return present.scatter_(1, flat, True)


def augment_phase(device, dataset, train_images_per_s, resample_pass_ms,
                  profile=False):
    """The end-to-end train path at full width: u8 host batches from the
    in-memory dataset -> DataLoader(batch 32, shuffle, drop_last) -> Fetcher
    (a producer thread) -> PostFetch(default AugmentConfig, bf16) ->
    Trainer.step(). One warm-up epoch whose batches are checked, then timed
    epochs, each synchronised at its end."""
    n_batches = len(dataset) // TRAIN_BATCH
    fn = taug.make_augment_fn(taug.AugmentConfig())
    post = PostFetch(fn, dtype=torch.bfloat16, seed=SEED, device=device)

    # the augmentation alone on one host batch: device time (CUDA events,
    # the copy to the card included), host time to enqueue it, and both
    # together with a synchronise at the end
    batch = next(iter(DataLoader(dataset, TRAIN_BATCH)))
    for _ in range(2):
        post(batch)
    event_ms, enqueue_ms, wall_ms = [], [], []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        post(batch)
        end.record()
        enqueue_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        wall_ms.append(1e3 * (time.perf_counter() - t0))
        event_ms.append(start.elapsed_time(end))
    augment_peak_mb = peak_mb(lambda: post(batch))
    if profile:
        profile_table("profile_augment", lambda: post(batch), 3)

    # the main path, with every count at 0 and its own batch counter
    post = PostFetch(fn, dtype=torch.bfloat16, seed=SEED, device=device)
    checked = []

    def checking(host_batch):
        """PostFetch, and while `checked` is a list the batch's checks, kept
        on the card: finite images, and per sample no label but 0 or one of
        the input's."""
        images, segs, valid = post(host_batch)
        if checked is not None:
            allowed = label_sets(torch.from_numpy(host_batch.segs).to(device))
            allowed[:, 0] = True
            stray = (label_sets(segs) & ~allowed).any()
            checked.append(torch.stack([torch.isfinite(images).all(),
                                        ~stray]))
        return images, segs, valid

    loader = DataLoader(dataset, TRAIN_BATCH, shuffle=True, drop_last=True,
                        seed=SEED)
    model = build_model("deeplabv3plus", NUM_CLASSES, dtype=torch.bfloat16,
                        full_res_output=True)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(model, Fetcher(loader, checking),
                          workdir=os.path.join(tmp, "w"), lr=1e-3,
                          momentum=0.9, seed=SEED, log=False,
                          log_dir=os.path.join(tmp, "runs"), device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        br.reset_launch_count()
        ce.reset_launch_count()
        losses = [trainer.step()]                 # warm-up epoch, checked
        ok = torch.stack(checked).all(0).tolist()
        checked = None
        epoch_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.step())
            torch.cuda.synchronize()
            epoch_ms.append(1e3 * (time.perf_counter() - t0))
        resample_launches = br.launch_count()
        ce_launches = ce.launch_count()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = trainer.state.step
    if ok != [True, True]:
        raise AssertionError(f"augmented batches: images finite {ok[0]}, "
                             f"labels from the input {ok[1]}")
    if steps != 4 * n_batches or resample_launches != 2 * steps:
        raise AssertionError(f"{steps} steps, {resample_launches} resampler "
                             f"launches: not two per batch")
    if ce_launches != {"fwd": steps, "bwd": steps}:
        raise AssertionError(f"{steps} steps launched {ce_launches}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"end-to-end epoch losses {losses}")
    best = min(epoch_ms) / n_batches
    log("augment_train", batch=TRAIN_BATCH, steps=steps,
        epoch_mean_losses=losses,
        images_per_s_end_to_end=1e3 * TRAIN_BATCH / best,
        ms_per_step_end_to_end=[ms / n_batches for ms in epoch_ms],
        images_per_s_train_only=train_images_per_s,
        augment_ms_per_batch_cuda_events=statistics.median(event_ms),
        augment_ms_per_batch_host_enqueue=statistics.median(enqueue_ms),
        augment_ms_per_batch_wall=statistics.median(wall_ms),
        resample_kernel_ms_per_pass=resample_pass_ms,
        augment_peak_memory_mb=augment_peak_mb, peak_memory_gb=peak_gb,
        resample_launches=resample_launches, ce_launches=ce_launches)
    return resample_launches


def profile_steps(trainer, phase="profile"):
    """torch.profiler over one window of 3 steady steps."""
    trainer.fetcher.n = 3
    profile_table(phase, trainer.step, 1, per=3)


def profile_table(phase, fn, calls, per=None):
    """torch.profiler over `calls` calls of `fn`: device time by the PyTorch
    op that launched the kernels, ms per unit (`per` units in all; one per
    call by default), largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    per = per or calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # host-side op events only: each carries the device time of the kernels
    # it launched (the kernels' own events would count that time twice)
    rows = sorted(((e.self_device_time_total / (1e3 * per), e.count // per,
                    e.key[:60])
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    log(phase, device_ms_per_step=total,
        by_op=[{"op": k, "ms_per_step": round(ms, 3), "calls_per_step": n}
               for ms, n, k in rows[:25]])


def hopper_build_figures(ptxas):
    """Registers and spilled bytes of each Hopper kernel of
    fused_matmul_bn.cu (from ptxas -v, entry by entry) and the dynamic
    shared memory it asks for at the R50 step's widest and narrowest
    shapes."""
    if not ptxas:
        return {"note": "library already on disk: no ptxas output"}
    figures, entry = {}, None
    for line in ptxas.splitlines():
        # a template's arguments mangle as I L<type><value>E ... E
        found = re.search(r"Compiling entry function '\w*?hop\d+"
                          r"([a-z_]+_wgmma_kernel)I((?:L[a-z]+\d+E)+)E",
                          line)
        if "Compiling entry function" in line:
            entry = (f"{found.group(1)}<"
                     + ",".join(re.findall(r"L[a-z]+(\d+)E", found.group(2)))
                     + ">" if found else None)
            if entry:
                figures[entry] = {"spill_bytes": 0}
        elif entry and "spill" in line:
            figures[entry]["spill_bytes"] = sum(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif entry and "Used" in line:
            figures[entry]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    shapes = ((2048, 512), (512, 2048), (256, 64), (64, 256))
    # the channels-major product: the 128-column ring, no fold
    figures["cmajor_dynamic_smem_bytes"] = fm._kernel_fns()["smem"](128, 0)
    figures["dynamic_smem_bytes"] = {f"{k}->{m}": fm.wgmma_shared_bytes(k, m)
                                     for k, m in shapes}
    return figures


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print torch.profiler tables, by op, of "
                             "the train step (fused 1x1 switch off and on), "
                             "the eval step and the augmentation")
    args = parser.parse_args()
    device = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    def build_one(name):  # one nvcc per source, all started together
        t0 = time.perf_counter()
        build.load_kernel_library(name)
        return time.perf_counter() - t0

    names = ("upsample_argmax", "softmax_ce", "banded_resample",
             "eval_confusion", "fused_matmul_bn")
    with ThreadPoolExecutor(len(names)) as pool:
        for name, seconds in zip(names, pool.map(build_one, names)):
            ptxas = build.BUILD_LOGS.get(name, "")  # what ptxas -v printed
            extra = {}
            if name == "fused_matmul_bn":
                extra["hopper_kernels"] = hopper_build_figures(ptxas)
            log("build", kernel=name, seconds=seconds,
                registers=[int(n) for n in
                           re.findall(r"Used (\d+) registers", ptxas)],
                spill_bytes=sum(int(n) for n in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", ptxas)),
                flags=" ".join(build.NVCC_FLAGS + build.LINK_FLAGS), **extra)

    path = kernel_case("path_bf16", (BATCH, 129, 129, NUM_CLASSES),
                       (IMG, IMG), torch.bfloat16, True, device)
    kernel_case("path_f32", (BATCH, 129, 129, NUM_CLASSES), (IMG, IMG),
                torch.float32, True, device)
    kernel_case("ragged_c150", (2, 65, 97, 150), (257, 385), torch.bfloat16,
                False, device, tie=(3, 7))

    # the path shape in both layouts a convolution may leave its output in
    ce_paths = [ce_case(name, (TRAIN_BATCH, 129, 129, NUM_CLASSES),
                        (IMG, IMG), torch.bfloat16, True, device, nchw=nchw)
                for name, nchw in (("ce_path_bf16", False),
                                   ("ce_path_bf16_nchw", True))]
    ce_case("ce_path_f32", (TRAIN_BATCH, 129, 129, NUM_CLASSES), (IMG, IMG),
            torch.float32, True, device)
    ce_case("ce_ragged_c150", (2, 65, 97, 150), (257, 385), torch.bfloat16,
            False, device, label_dtype=torch.int64)
    ce_case("ce_c81_f32", (2, 33, 33, 81), (129, 129), torch.float32, True,
            device)

    # 4 batches' worth of u8 images and labels in host memory
    dataset = MemoryDataset(4 * TRAIN_BATCH, np.random.default_rng(SEED + 6))
    resample_path = resample_cases(device, dataset)
    eval_path = eval_cases(device)
    fused_path = fused_cases(device)
    cmajor_launches, cmajor_path = cmajor_phase(device)

    small_model_check(device)
    small_train_check(device)
    small_eval_check(device)
    small_augment_check(device)
    small_train_check(device, fused=True)
    launches = serve_phase(device)
    eval_set = dataset.first(EVAL_IMAGES)
    ce_launches, ce_strides, train_figures, trained = train_phase(
        device, eval_set, profile=args.profile)
    eval_launches = eval_phase(device, trained, eval_set,
                               profile=args.profile)
    del trained
    resample_launches = augment_phase(device, dataset,
                                      train_figures["images_per_s"],
                                      resample_path.pop("pass_ms"),
                                      profile=args.profile)
    fused_launches = train_fused_phase(device, train_figures,
                                       profile=args.profile)
    # the kernels' line reports the case in the layout the train step used
    ce_path = [p for p in ce_paths if p["strides"] == ce_strides]
    if len(ce_path) != 1:
        raise AssertionError(f"no kernel case had the train step's logits "
                             f"strides {ce_strides}")
    ce_path = ce_path[0]

    ce_source = "pytorch_segmentation_tpu_torch/csrc/softmax_ce.cu"
    fused_source = "pytorch_segmentation_tpu_torch/csrc/fused_matmul_bn.cu"
    fused_replaces = "pytorch_segmentation_tpu/ops/pallas/fused_matmul_bn.py:"
    ce_replaces = ("pytorch_segmentation_tpu/ops/pallas/softmax_ce.py:"
                   "83,114,153,188")
    print(json.dumps({"kernels": [
        {"name": "upsample_argmax", "route": "cuda",
         "source": "pytorch_segmentation_tpu_torch/csrc/upsample_argmax.cu",
         "replaces":
             "pytorch_segmentation_tpu/ops/pallas/upsample_argmax.py:31",
         "launches": launches, **path},
        {"name": "softmax_ce_fwd", "route": "cuda", "source": ce_source,
         "replaces": ce_replaces, "launches": ce_launches["fwd"],
         **ce_path["fwd"]},
        {"name": "softmax_ce_bwd", "route": "cuda", "source": ce_source,
         "replaces": ce_replaces, "launches": ce_launches["bwd"],
         **ce_path["bwd"]},
        # ms, plain_ms and bound_ms: per launch, the mean of the two passes
        {"name": "banded_resample", "route": "cuda",
         "source": "pytorch_segmentation_tpu_torch/csrc/banded_resample.cu",
         "replaces":
             "pytorch_segmentation_tpu/ops/pallas/banded_resample.py:60",
         "launches": resample_launches, **resample_path},
        {"name": "eval_confusion", "route": "cuda",
         "source": "pytorch_segmentation_tpu_torch/csrc/eval_confusion.cu",
         "replaces":
             "pytorch_segmentation_tpu/ops/pallas/eval_confusion.py:29",
         "launches": eval_launches["eval_confusion"], **eval_path},
        # ms, plain_ms, bound_ms, library_ms at (N, K, M) = `shape`, a
        # stage-1 shape of the step; `second_shape` has a stage-4 shape's
        {"name": "fused_matmul_bn_fwd", "route": "cuda",
         "source": fused_source, "replaces": fused_replaces + "91",
         "design": "hop::fwd_wgmma_kernel: TMA ring + wgmma, A = x K-major "
                   "through the prologue in shared memory",
         "launches": fused_launches["fwd"], **fused_path["fwd"]},
        {"name": "fused_matmul_bn_bwd_dx", "route": "cuda",
         "source": fused_source, "replaces": fused_replaces + "117",
         "design": "hop::dx_dy_tot_wgmma_kernel + hop::dx_dz_wgmma_kernel: "
                   "two full grids, K-major operands",
         "launches": fused_launches["bwd_dx"], **fused_path["bwd_dx"]},
        {"name": "fused_matmul_bn_bwd_dw", "route": "cuda",
         "source": fused_source, "replaces": fused_replaces + "156",
         "design": "hop::dw_wgmma_kernel: TMA ring + wgmma, A = z^T and "
                   "B = dy_tot MN-major, N split over blocks (dw_split), "
                   "f32 partials summed by partials.sum(0)",
         "launches": fused_launches["bwd_dw"], **fused_path["bwd_dw"]},
        {"name": "cmajor_matmul", "route": "cuda", "source": fused_source,
         "replaces": "tools/bench_cmajor.py:64",
         "design": "hop::cmajor_wgmma_kernel: TMA ring + wgmma, W K-major, "
                   "X MN-major, 64-row tiles split over the pixels where "
                   "co <= 64, f32 epilogue of 16-byte stores",
         "launches": cmajor_launches, **cmajor_path}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
