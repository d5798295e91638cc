#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
kernels and the host's C++ (the polygon fill and colour map, the JPEG codec)
from the sources in this checkout, holds the JPEG codec against the OpenCV
outputs committed in tests/torch_jpeg_fixtures (decodes, encodes, refused
files) and times it, holds each kernel against its plain PyTorch version,
serves full-width DeepLabV3+ (ResNet-50, 21 classes, 513x513, bf16, batch
8, weights made from a seed) through the port's MaskServer (PNG bodies,
then JPEG bodies beside PNG bodies of their decoded pixels and one
EXIF-rotated body), trains the same model (batch 32, SGD with momentum)
through the port's Trainer on one fixed batch, serves masks from the
checkpoint it saved,
evaluates it (`engine.test`: 80 images at batch 32 through the eval step,
whose loss and confusion counts come from the upsample+CE and
upsample+argmax+confusion kernels; train -> eval -> save(best) -> reload ->
the same counts; then each option of the eval step once: flip and
multi-scale TTA, sliding-window tiles, ignore_index, Boundary IoU), trains
it end to end from u8 host batches (an in-memory dataset -> DataLoader ->
Fetcher -> PostFetch, the default augmentation policy on the card, whose
warp runs the row-resample kernel twice per batch -> Trainer), drives the
command lines from files on disk (a seeded synthetic COCO set written as
JPEG, 96 + 32 images at 640x480 with 21 classes, four of the train images
rewritten as PNG with row filters 1-4: `train` for 2 epochs with
the per-epoch eval, `train --resume` to epoch 3, `test` on best.pt and
`inference` on the val images, held against `engine.test` and
`inference()` in the same process; the host's records/s beside), and then
trains it with the fused 1x1 switch on (`nn.blocks.set_force_fused_1x1`:
conv1 and conv3 of every bottleneck through the fused BN-apply + ReLU +
product + BN-statistics forward, dx and dW kernels, 32 launches of each per
step) beside the figures of the same run with the switch off. The layout
benchmark `tools/bench_cmajor.py` runs once with its channels-major kernel.
Last, the other families (`families`): UNet on MobileNetV2, HRNet-W32,
FPN-R50, DANet, LR-ASPP (MobileNetV3-Large), SegFormer-B0, UPerNet-R50,
Segmenter-B/16, UPerNet-Swin-T, BiSeNetV2, OCRNet-W32, SegNeXt-T and
MaskFormer-R50 at 512x512, PSPNet, FastFCN, FCN and DeepLabV3 at 513x513
(MaskFormer on its set criterion: 100 queries, 6 supervised decoder
layers, the Sinkhorn matcher; PSPNet, FastFCN,
FCN, DeepLabV3, DANet, both UPerNets, BiSeNetV2 with its four boosters and
OCRNet with its soft-region head trained with their auxiliary heads, each
head's loss weighted 0.4), served at batch 8, trained at batch 32 and
evaluated over 64 images, each kernel's result held against its plain
version on the logits the run produced (stride 2, align_corners True;
stride 4, False; stride 8, True, and FastFCN's aux logits at stride 16;
stride 8, False: 65 -> 513 and 64 -> 512; UPerNet's aux logits at stride
16, False: 32 -> 512; Segmenter's f32 logits at stride 16, False: 32 ->
512; SegNeXt's f32 logits at stride 8, False: 64 -> 512; MaskFormer's f32
scores at stride 4, False: 128 -> 512); SegFormer's attention and
Mix-FFN, Swin-T's window attention and MLP, and the ViT's attention and
MLP timed alone; UNet, PSPNet, DANet, UPerNet and MaskFormer trained with
the fused 1x1 switch on (UNet's 16 expand and 16 project products,
ResNet-50's 16 conv1 and 16 conv3, each distinct shape held against the
plain versions); MaskFormer's steps with the Hungarian matcher beside the
Sinkhorn ones; SegFormer-B2 with scan_blocks=True on the unrolled model's
weights stacked, one batch served (its logits equal the unrolled model's)
and one train step;
FPN-R34, FCN-R101, SegFormer-B2, UPerNet on MiT-B0, SegNeXt-B and
OCRNet-W48 serving one batch,
UPerNet on ConvNeXt-T and on ViT-B/16 serving one batch and taking one
train step; and the train command line with the root defaults (`--model
unet -s 320 320 -bs 32 -a 2`, one epoch), with `--model pspnet --aux-loss
0.4 -s 321 321`, with `--model fcn --aux-loss 0.4 -s 321 321`, with
`--model upernet --aux-loss 0.4 -s 321 321`, with `--model segmenter -s
320 320` (the bicubic position-grid resize: a 20 x 20 patch grid) and with
`--model bisenetv2 --aux-loss 0.4 -s 320 320` and with `--model
maskformer -s 320 320 -bs 32 -a 1`, then the test command line on the
checkpoint each wrote (PSPNet, FCN, UPerNet and BiSeNetV2 built
without the heads, whose entries it drops), kernels 1-4 held against their
plain versions on tensors those runs handed them.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --profile  # also torch.profiler tables, by op, of
                                     # the train step (switch off and on),
                                     # the eval step and the augmentation
    python3 chip_smoke.py --families maskformer segformer_scan
                                     # the builds, then the families phase
                                     # for these entries alone

Every phase prints one line; any failure raises, so the exit code is not 0.
The line before the last is a JSON object with each kernel's launches on its
main-path run (serving, training, evaluation, training end to end, training
with the fused 1x1 switch on, or the layout benchmark) and, for the four it
runs, on the command lines' run (`cli_launches`), on the families phase's
runs (`families_launches`, and by model in `families_launches_by_model`,
with each family's shape's figures under `families` for kernels 1-3), its
error against
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
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pytorch_segmentation_tpu_torch import _native as native
from pytorch_segmentation_tpu_torch.data import augment as taug
from pytorch_segmentation_tpu_torch.data.colormap import colorize_mask
from pytorch_segmentation_tpu_torch.data.loader import DataLoader, Fetcher
from pytorch_segmentation_tpu_torch.data.pipeline import (PostFetch,
                                                          normalize_images)
from pytorch_segmentation_tpu_torch.data.rasterize import (
    rasterize_annotations)
from pytorch_segmentation_tpu_torch.data.resize_host import resize_u8
from pytorch_segmentation_tpu_torch.engine import test as run_eval
from pytorch_segmentation_tpu_torch.engine.checkpoint import load_model_bundle
from pytorch_segmentation_tpu_torch.engine.steps import (make_eval_step,
                                                         nhwc_forward,
                                                         require_eval_mode)
from pytorch_segmentation_tpu_torch.engine.trainer import Trainer
from pytorch_segmentation_tpu_torch.inference import (_tile_offsets,
                                                      make_mask_fn,
                                                      make_tiled_mask_fn)
from pytorch_segmentation_tpu_torch.models import (build_model,
                                                   make_maskformer_loss,
                                                   variant_kwargs)
from pytorch_segmentation_tpu_torch.models import maskformer as mf
from pytorch_segmentation_tpu_torch.models.segformer import (
    stack_block_params)
from pytorch_segmentation_tpu_torch.nn import blocks
from pytorch_segmentation_tpu_torch.ops.boundary import (boundary_confusion,
                                                         boundary_pixels)
from pytorch_segmentation_tpu_torch.ops.loss import compute_loss
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
# device ms of a call without the host's enqueue: calls queued behind a
# sleep kernel
from pytorch_segmentation_tpu_torch.tools.bench_eval_confusion import (
    queued_ms)
from pytorch_segmentation_tpu_torch.utils import imgcodecs, jpeg, png
from pytorch_segmentation_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
from pytorch_segmentation_tpu_torch.utils.png import decode_png, encode_png
from pytorch_segmentation_tpu_torch.utils.runtime import require_cuda
from pytorch_segmentation_tpu_torch.utils.synthetic import make_synthetic_coco
from pytorch_segmentation_tpu_torch.utils.weights import seeded_state_dict

SEED = 0
IMG = 513
BATCH = 8
TRAIN_BATCH = 32
EVAL_BATCH = 32
EVAL_IMAGES = 80   # 3 eval batches, valid = 32, 32, 16
# the cli phase's synthetic COCO set: 20 categories + background
CLI_TRAIN, CLI_VAL, CLI_WH, CLI_CATEGORIES = 96, 32, (640, 480), 20
CLI_WORKERS = 4
NUM_CLASSES = 21
GAP = 1e-4       # pixels with a larger top-2 gap must agree exactly
# ... plus the f32 rounding of an interpolated logit under another order of
# its taps' products and sums (the kernels' two-tap lerps against the plain
# version's matrix products), relative to the largest logit: a few ulps
# (2^-23 relative each). It counts only where the taps are not short binary
# fractions (2x align True, 65 -> 513 align False), where neither side's
# sums are exact: full-width seeded logits reach |2e4|, whose ulp is 2e-3
ROUNDING_GAP = 2.0 ** -18
AGREEMENT = 0.999
# upsample+CE kernels against the plain version and autograd on the same
# values: the loss to LOSS_RTOL (f32, another summation order); f32 dlogits
# to GRAD_TOL of the gradient's largest entry; bf16 dlogits to two bf16 ulps
# (2^-7 relative) of the plain f32 gradient rounded to bf16, with the f32
# bound as the floor for entries near zero
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
BF16_2ULP = 2.0 ** -7
# the forward kernel's lse against the plain f32 logsumexp of the upsampled
# logits, absolute: both f32 with |lse| < 12 here; they differ by the online
# recurrence against torch's and another interpolation order, a few ulps
LSE_TOL = 1e-5
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


def tie_gap(up):
    """The top-2 gap at or below which a pixel of the f32 upsampled logits
    `up` is a near tie: GAP, plus ROUNDING_GAP of `up`'s largest logit."""
    return GAP + ROUNDING_GAP * float(up.abs().max())


def mask_check(pred, ref, up, gap=None):
    """Hold an argmax mask against the reference mask of the same f32
    upsampled logits `up` [B, H, W, C]: exact where the top-2 gap is above
    `gap` (default `tie_gap(up)`: a closer pair may flip under another FMA
    or summation order), and at least AGREEMENT overall. Returns the
    agreement and the largest loss in logit value from taking `pred`
    instead of the best class."""
    gap = tie_gap(up) if gap is None else gap
    top2 = up.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > gap
    wrong_clear = int(((pred != ref) & clear).sum())
    agreement = float((pred == ref).float().mean())
    chosen = up.gather(-1, pred.long().unsqueeze(-1)).squeeze(-1)
    max_abs_err = float((top2[..., 0] - chosen).max())
    if wrong_clear or agreement < AGREEMENT:
        gaps = (top2[..., 0] - top2[..., 1])[pred != ref]
        raise AssertionError(f"masks disagree: {wrong_clear} pixels with a "
                             f"top-2 gap above {gap}, agreement "
                             f"{agreement:.6f}, largest gap of a differing "
                             f"pixel {float(gaps.max())}")
    return agreement, max_abs_err


def near_ties(logits_nhwc, out_hw, align, samples=None):
    """Pixels of the f32 upsampled logits (of `samples`, a bool mask over
    the batch; default all) whose top-2 gap is at most `tie_gap` of their
    sample's. Where a tap weight is not a short binary fraction (2x with
    align_corners=True: 255/511 steps; 65 -> 513 with align_corners=False),
    the kernels' two-tap sums and the plain version's matrix product round
    a logit differently, and such a pixel's argmax may flip between the
    two."""
    count = 0
    for i in range(logits_nhwc.shape[0]):
        if samples is not None and not bool(samples[i]):
            continue
        up = resize_bilinear(logits_nhwc[i:i + 1].float(), out_hw,
                             align_corners=align)
        top2 = up.topk(2, dim=-1).values
        count += int(((top2[..., 0] - top2[..., 1]) <= tie_gap(up)).sum())
    return count


def counts_close(got, want, ties):
    """Confusion count vectors equal but for `ties` pixels, each of which
    moves at most two entries of a vector by one. Returns the largest L1
    difference of the vectors."""
    diff = max(float((g.double() - w.double()).abs().sum())
               for g, w in zip(got, want))
    return diff <= 2 * ties, diff


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


def kernel_case(name, shape, out_hw, dtype, align, device, tie=None,
                nchw=False):
    """The upsample+argmax kernel against its plain version (the top-2-gap
    rule) and against the eval kernel: its mask, counted against seeded
    labels with plain torch, gives kernel 3's counts on the same logits and
    labels exactly (the two run the same staged argmax)."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal(shape).astype(np.float32)
    if tie is not None:  # class tie[1] duplicates tie[0]: tie[0] must win
        x[..., tie[1]] = x[..., tie[0]]
    logits = torch.from_numpy(x).to(device=device, dtype=dtype)
    if nchw:
        logits = logits.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    got = ua.fused_upsample_argmax(logits, out_hw, align_corners=align)
    ref = ua.upsample_argmax_reference(logits, out_hw, align_corners=align)
    torch.cuda.synchronize()
    up = resize_bilinear(logits.float(), out_hw, align_corners=align)
    agreement, err = mask_check(got, ref, up)
    del up, ref
    if tie is not None and int((got == tie[1]).sum()):
        raise AssertionError("a tied higher class id won")
    labels = torch.from_numpy(rng.integers(0, shape[-1], (shape[0],)
                                           + tuple(out_hw))).to(device)
    counted = confusion_update(got, labels, shape[-1])
    for a, b in zip(counted, ec.fused_eval_confusion(
            logits, labels, shape[0], align_corners=align)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: the mask's counts differ from "
                                 f"the eval kernel's")
    ms = cuda_median_ms(lambda: ua.fused_upsample_argmax(
        logits, out_hw, align_corners=align))
    device_ms = queued_ms(lambda: ua._launch(logits, out_hw, align))
    plain_ms = cuda_median_ms(lambda: ua.upsample_argmax_reference(
        logits, out_hw, align_corners=align))
    # logits read once, int32 mask written once; per output pixel and class
    # the separable interpolation and one compare
    b, _, w, c = shape
    pixels = b * out_hw[0] * out_hw[1]
    least = bound(logits.numel() * logits.element_size() + 4 * pixels,
                  (interp_flops(w, out_hw[1]) + 1) * pixels * c)
    log("kernel", case=name, shape=list(shape), out_hw=list(out_hw),
        dtype=str(dtype).replace("torch.", ""),
        logits_strides=list(logits.stride()), align_corners=align,
        agreement=agreement, max_abs_err=err, counts_equal_eval_kernel=True,
        ms=ms, device_ms=device_ms, plain_ms=plain_ms, **least)
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, **least, "library_ms": None}


def peak_mb(fn):
    """Peak device memory `fn` adds to what is allocated now, MB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def ce_check(name, x, y, align):
    """The upsample+CE kernels on logits `x` [B, h, w, C] (a leaf that
    requires grad) and labels `y` against the plain version and autograd:
    the loss to LOSS_RTOL, f32 dlogits to GRAD_TOL of the largest entry,
    bf16 dlogits to two bf16 ulps of the plain f32 gradient rounded to
    bf16 (GRAD_TOL of the largest entry as the floor). Returns (the kernel's
    loss tensor, its value, the loss's and the gradient's largest absolute
    error, the gradient's largest entry)."""
    dtype = x.dtype
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
    return loss, loss_value, loss_err, grad_err, top


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
    loss, loss_value, loss_err, grad_err, top = ce_check(name, x, y, align)
    # the forward kernel alone: lse against the plain per-pixel logsumexp
    _, lse, _ = ce._launch_fwd(x.detach(), y, align, want_lse=True)
    with torch.no_grad():
        lse_ref = torch.logsumexp(resize_bilinear(
            x.detach().float(), tuple(out_hw), align_corners=align), dim=-1)
    torch.cuda.synchronize()
    lse_err = float((lse - lse_ref).abs().max())
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"{name}: lse differs by {lse_err}")
    del lse, lse_ref

    fwd_ms = cuda_median_ms(lambda: ce.fused_upsample_ce(
        x, y, align_corners=align))
    fwd_kernel_ms = cuda_median_ms(lambda: ce._launch_fwd(
        x.detach(), y, align, want_lse=True))
    bwd_ms = cuda_median_ms(lambda: torch.autograd.grad(
        loss, x, retain_graph=True))
    # the backward kernel alone, on what the forward saves for it
    _, lse, y_kernel = ce._launch_fwd(x.detach(), y, align, want_lse=True)
    one = torch.ones((), device=device)
    bwd_kernel_ms = cuda_median_ms(lambda: ce._launch_bwd(
        x.detach(), y_kernel, lse, one, align))
    del lse, y_kernel
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
        dlogits_max_abs_err=grad_err, dlogits_largest=top,
        lse_max_abs_err=lse_err, fwd_ms=fwd_ms, fwd_kernel_ms=fwd_kernel_ms,
        bwd_ms=bwd_ms, bwd_kernel_ms=bwd_kernel_ms,
        plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
        plain_fwd_bwd_ms=plain_both_ms, fwd_bound_ms=fwd["bound_ms"],
        fwd_bound_by=fwd["bound_by"], bwd_bound_ms=bwd["bound_ms"],
        bwd_bound_by=bwd["bound_by"], kernel_peak_mb=kernel_mb,
        plain_peak_mb=plain_mb)
    return {"strides": tuple(x.stride()),
            "fwd": {"max_abs_err": loss_err, "ms": fwd_ms,
                    "kernel_ms": fwd_kernel_ms, "lse_max_abs_err": lse_err,
                    "plain_ms": plain_fwd_ms, **fwd, "library_ms": None},
            "bwd": {"max_abs_err": grad_err, "ms": bwd_ms,
                    "kernel_ms": bwd_kernel_ms, "plain_ms": plain_bwd_ms,
                    **bwd, "library_ms": None}}


def resample_case(name, planes, coords, use_bil, out_dtype):
    """The row-resample kernel against its plain version on the same
    tensors: equal bit for bit (two exact bf16 x bf16 products and one f32
    sum on both sides), so the label plane is exact too; a second launch
    gives the same bits."""
    before = br.launch_count()
    got = br.banded_resample_rows(planes, coords, use_bil,
                                  out_dtype=out_dtype)
    if br.launch_count() != before + 1:
        raise AssertionError(f"{name}: the wrapper did not count its launch")
    again = br.banded_resample_rows(planes, coords, use_bil,
                                    out_dtype=out_dtype)
    want = br.banded_resample_reference(planes, coords, use_bil, out_dtype)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.dtype != out_dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel and plain version differ by "
                             f"{err}")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    del got, want, again
    ms = cuda_median_ms(lambda: br.banded_resample_rows(
        planes, coords, use_bil, out_dtype=out_dtype))
    device_ms = queued_ms(lambda: br._launch(planes, coords, use_bil,
                                             out_dtype))
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
        two_launches_bit_equal=True,
        ms=ms, device_ms=device_ms, plain_ms=plain_ms, **least)
    return {"max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, **least, "library_ms": None}


@contextlib.contextmanager
def keeping_launches(calls):
    """Wrap the launch functions `calls` names ({key: (module, attribute,
    n)}) so that the arguments and the result of each one's first n calls
    are kept, tensors cloned with their strides: yields {key: [(args,
    result)]}. The kernel wrappers find their launch function among their
    module's globals at each call, so the wrapped one runs."""
    kept = {key: [] for key in calls}
    real = {key: getattr(module, attr)
            for key, (module, attr, _) in calls.items()}

    def keep(value):
        if isinstance(value, torch.Tensor):
            return value.detach().clone()
        if isinstance(value, tuple):
            return tuple(keep(v) for v in value)
        return value

    def recording(key, n):
        def launch(*args, **kwargs):
            out = real[key](*args, **kwargs)
            if len(kept[key]) < n:
                kept[key].append((keep(args), keep(out)))
            return out
        return launch

    for key, (module, attr, n) in calls.items():
        setattr(module, attr, recording(key, n))
    try:
        yield kept
    finally:
        for key, (module, attr, _) in calls.items():
            setattr(module, attr, real[key])


def resample_cases(device, dataset):
    """The kernel at the two calls the default policy makes on a real batch
    (first pass: a contiguous source; second pass: the transposed view of the
    first pass's output, read through its strides), the same to f32, a copy
    of the strided source (is materialising the transpose worth it?), and a
    ragged non-square shape with coordinates at 0 and C-1."""
    post = PostFetch(taug.make_augment_fn(), dtype=torch.bfloat16, seed=SEED,
                     device=device)
    batch = next(iter(DataLoader(dataset, TRAIN_BATCH)))
    with keeping_launches({"banded_resample": (br, "_launch", 3)}) as kept:
        post(batch)
    calls = [args for args, _ in kept["banded_resample"]]
    if len(calls) != 2:
        raise AssertionError(f"one augmented batch made {len(calls)} "
                             f"resampler calls, not 2")
    (p1, c1, ub, dtype1), (p2, c2, _, _) = calls
    if dtype1 != torch.bfloat16 or p2.is_contiguous():
        raise AssertionError(f"unexpected resampler calls: {dtype1}, second "
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
    # the second pass's source with random coordinates: a warp's taps fall
    # into as many source columns as it has rows
    wide = torch.from_numpy(rng.uniform(0, IMG - 1, tuple(c2.shape)).astype(
        np.float32)).to(device)
    resample_case("wide_span_pass2_random", p2, wide, ub, torch.bfloat16)
    # one figure per launch on the path: the mean of the two passes
    mean = {key: (pass1[key] + pass2[key]) / 2
            for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
    return {"max_abs_err": max(pass1["max_abs_err"], pass2["max_abs_err"]),
            **mean, "bound_by": pass1["bound_by"], "library_ms": None,
            "pass_ms": [pass1["ms"], pass2["ms"]],
            "pass_device_ms": [pass1["device_ms"], pass2["device_ms"]]}


def eval_case(name, shape, out_hw, dtype, align, device, valid=None,
              label_dtype=torch.int32, nchw=False, tie=None, outside_rows=0,
              ties_allowed=False):
    """The upsample+argmax+confusion kernel against its plain version on the
    same tensors: integer counts, so equal exactly, and equal between two
    launches (integer atomics commute). `valid` is a count or a bool mask
    (default: every sample); `outside_rows` rows of sample 0 get the label
    255, which must count for no class's tp or fn. `ties_allowed`: the
    shape's taps are not short binary fractions, so the counts may differ
    by the pixels `near_ties` finds (each moves two entries by one)."""
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
    ties = 0
    if ties_allowed and not all(torch.equal(g, r) for g, r in zip(got, want)):
        ties = near_ties(logits, out_hw, align, mask)
    close, l1 = counts_close(got, want, ties)
    for g, r, a in zip(got, want, again):
        if g.dtype != torch.float32 or not close:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"by {err} ({l1} in all; {ties} pixels "
                                 f"with a top-2 gap <= tie_gap)")
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
        labels_outside=outside, max_abs_err=err, counts_l1_diff=l1,
        near_tie_pixels=ties, equal=l1 == 0,
        two_launches_bit_equal=True, ms=ms, launch_only_ms=launch_ms,
        plain_ms=plain_ms, **least)
    return {"max_abs_err": err, "ms": ms, "kernel_ms": launch_ms,
            "plain_ms": plain_ms, **least, "library_ms": None}


def eval_cases(device):
    """The path shape (what `test()` hands the kernel at batch 32) with every
    sample valid, with a count of 20, with a mask that has holes, in f32 and
    from NCHW memory; a ragged 150-class shape with align_corners=False,
    int64 labels, a planted tie and labels of 255; 81 classes; bands of one
    row, column tiles and class chunks."""
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
    # bands of one row, 18 column tiles and 4 chunks of 37-38 classes: each
    # pixel's (best, pred) carried from chunk to chunk
    chunked = (1, 4, 3000, 150)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ec.eval_plan(*chunked, 6, 300, True, 4, sms)
    if not (len(plan.bands) > 1 and len(plan.tiles) > 1
            and plan.chunk < chunked[-1]):
        raise AssertionError(f"{chunked} -> (6, 300): eval plan "
                             f"{len(plan.bands)} bands, {len(plan.tiles)} "
                             f"tiles, chunks of {plan.chunk}")
    eval_case("eval_chunks_c150", chunked, (6, 300), torch.float32, True,
              device, outside_rows=1)
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


def fused_case(name, n, k, m, dtype, act, device, nchw=False, reps=20):
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
            xd, scale, shift, wd, act=act), reps=reps)
        dx_ms = cuda_median_ms(lambda: fm._launch_bwd_dx(
            xd, scale, shift, wc, gy, gs, gss, act, wt), reps=reps)
        dw_ms = cuda_median_ms(lambda: fm._launch_bwd_dw(
            xd, scale, shift, rdy_tot, act), reps=reps)
        few = min(5, reps)
        plain = {
            "fwd": cuda_median_ms(lambda: fm.bn_act_matmul_reference(
                xd, scale, shift, wd, act), reps=few),
            "bwd_dx": cuda_median_ms(lambda: fm.bn_act_matmul_dx_reference(
                xd, scale, shift, wd, gy, gs, gss, act), reps=few),
            "bwd_dw": cuda_median_ms(lambda: fm.bn_act_matmul_dw_reference(
                xd, scale, shift, rdy_tot, act), reps=few)}
        # one library product of the same size each, as a yardstick only:
        # no prologue, no statistics, no mask
        wct = wc.t().contiguous()
        library = {
            "fwd": cuda_median_ms(lambda: torch.matmul(xd, wc), reps=reps),
            "bwd_dx": cuda_median_ms(lambda: torch.matmul(gy, wct),
                                     reps=reps),
            "bwd_dw": cuda_median_ms(lambda: torch.matmul(xd.t(), gy),
                                     reps=reps)}
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


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_jpeg_fixtures")


def host_ms(fn, reps=20):
    """Median host ms of `fn` over `reps` calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def jpeg_phase():
    """The JPEG codec on the card's host (no OpenCV there): every committed
    fixture (tests/torch_jpeg_fixtures, written by tests/torch_jpeg_util.py)
    decoded in colour and gray equal to the cv2 decodes committed beside it;
    `encode_jpeg` of each encode source equal to the bytes cv2 wrote; each
    corrupt, truncated or unsupported file raising ValueError with its own
    code. Then decode and encode ms per 640x480 and 513x513 image on one
    host thread (a smooth image with noise, quality 95, 4:2:0)."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)

    def read(name):
        with open(os.path.join(FIXTURES, name), "rb") as f:
            return f.read()

    for case in manifest["decode"]:
        data = read(case["jpeg"])
        for flags, key in ((imgcodecs.IMREAD_COLOR, "color"),
                           (imgcodecs.IMREAD_GRAYSCALE, "gray")):
            want = imgcodecs.imdecode(read(case[key]), flags)
            got = imgcodecs.imdecode(data, flags)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"jpeg {case['name']} ({key}): the "
                                     f"decode differs from cv2's")
    for case in manifest["encode"]:
        flags = (imgcodecs.IMREAD_GRAYSCALE if case["name"].startswith("gray")
                 else imgcodecs.IMREAD_COLOR)
        src = imgcodecs.imdecode(read(case["source"]), flags)
        if encode_jpeg(src, case["quality"]) != read(case["jpeg"]):
            raise AssertionError(f"jpeg encode {case['name']}: the bytes "
                                 f"differ from cv2's")
    for case in manifest["refuse"]:
        try:
            jpeg.decode_jpeg(read(case["jpeg"]))
        except ValueError as e:
            if getattr(e, "code", None) != case["code"]:
                raise AssertionError(f"jpeg {case['name']}: {e!r}, want "
                                     f"code {case['code']}") from None
        else:
            raise AssertionError(f"jpeg {case['name']} was decoded")
    rng = np.random.default_rng(SEED + 9)
    figures = {}
    for h, w in ((480, 640), (513, 513)):
        bgr = (smooth_image(rng, h, w).astype(np.float32)
               + rng.normal(0, 8, (h, w, 3))).clip(0, 255).astype(np.uint8)
        data = encode_jpeg(bgr)
        if decode_jpeg(data).shape != (h, w, 3):
            raise AssertionError("jpeg timing image")
        figures[f"decode_ms_{w}x{h}"] = host_ms(lambda: decode_jpeg(data))
        figures[f"decode_gray_ms_{w}x{h}"] = host_ms(
            lambda: decode_jpeg(data, jpeg.IMREAD_GRAYSCALE))
        figures[f"encode_ms_{w}x{h}"] = host_ms(lambda: encode_jpeg(bgr))
        figures[f"bytes_{w}x{h}"] = len(data)
    log("jpeg", decode_cases=len(manifest["decode"]),
        encode_cases=len(manifest["encode"]),
        refused_cases=len(manifest["refuse"]), threads=1, **figures)
    return figures


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


def exif_rotated(data, orientation):
    """JPEG bytes with an APP1 Exif segment after the SOI whose one IFD
    entry is the orientation tag (little-endian TIFF)."""
    tiff = (b"II" + struct.pack("<HIH", 42, 8, 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
            + data[2:])


def serve_jpeg_bodies(base, imgs):
    """JPEG request bodies beside PNG ones, one request at a time: each of
    `imgs` (RGB) as the `encode_jpeg` bytes, its raw mask equal to the mask
    of a PNG body that holds the JPEG's decoded pixels; the latency of the
    colorized JPEG request beside the PNG one's; one body EXIF-rotated
    (orientation 6) answered at the rotated size. Returns the figures."""
    lat = {"jpeg": [], "png": []}
    jpeg_bytes = []
    for image in imgs:
        body = encode_jpeg(np.ascontiguousarray(image[:, :, ::-1]))
        pixels = np.ascontiguousarray(decode_jpeg(body)[:, :, ::-1])
        as_png = encode_png(pixels)
        jpeg_bytes.append(len(body))
        masks = []
        for kind, data in (("jpeg", body), ("png", as_png)):
            masks.append(decode_png(post(base + "/predict?format=raw",
                                         data)[2]))
            t1 = time.perf_counter()
            status, _, out = post(base + "/predict", data)
            lat[kind].append(time.perf_counter() - t1)
            if status != 200 or decode_png(out).shape != image.shape:
                raise AssertionError(f"{kind} body: {status}")
        if masks[0].shape != image.shape[:2] or not np.array_equal(*masks):
            raise AssertionError(f"a JPEG body's mask differs from its "
                                 f"decoded pixels' PNG body's at "
                                 f"{int((masks[0] != masks[1]).sum())} "
                                 f"pixels")
    h, w = imgs[-1].shape[:2]
    rotated = exif_rotated(encode_jpeg(np.ascontiguousarray(
        imgs[-1][:, :, ::-1])), 6)
    mask = decode_png(post(base + "/predict?format=raw", rotated)[2])
    if mask.shape != (w, h):
        raise AssertionError(f"EXIF orientation 6 on {h}x{w}: mask "
                             f"{mask.shape}")
    for bad in (rotated[:len(rotated) // 2], b"\xff\xd8\xff\xe0 no body"):
        try:
            post(base + "/predict", bad)
        except urllib.error.HTTPError as e:
            if e.code != 400:
                raise
        else:
            raise AssertionError("a corrupt JPEG body got a 200")
    return {"jpeg_request_latency_ms_median":
            1e3 * statistics.median(lat["jpeg"]),
            "png_request_latency_ms_median":
            1e3 * statistics.median(lat["png"]),
            "jpeg_body_bytes_median": statistics.median(jpeg_bytes),
            "jpeg_requests": 2 * len(imgs) + 1,
            "exif_rotated_mask_shape": list(mask.shape)}


def serve_phase(device, name="deeplabv3plus", img=IMG, jpeg_bodies=False):
    """`name` (bf16, seeded weights, its stride-`output_stride` logits)
    behind MaskServer at batch 8: a burst of 12 requests from threads (10 at
    img x img, two of other sizes), then 5 one at a time, colorized; with
    `jpeg_bodies`, then JPEG bodies beside PNG ones (`serve_jpeg_bodies`:
    three images, one of them 400 x 600, and an EXIF-rotated body). Each
    batch the server ran gives the same mask when make_mask_fn runs it
    directly (on the card, bf16 logits of an image change with its position
    in the batch; a repeat of the same batch is bit-exact), and that mask
    (the upsample+argmax kernel, counted) is held against the plain version
    on the logits the batch produced; each img x img response equals its
    batch's mask. Then make_mask_fn's images/s on a batch already on the
    card, and the host time of the eval-mode check. Returns the kernel's
    launches and the figures."""
    model = load_model_bundle(family_model(
        name, dtype=torch.bfloat16, full_res_output=False),
        None, device, seed=SEED)
    align, hw = model.up_align_corners, (img, img)
    rng = np.random.default_rng(SEED + 2)
    sizes = [hw] * 10 + [(400, 600), (700, 300)]  # (H, W)
    imgs = [smooth_image(rng, h, w) for h, w in sizes]
    logits, ran = [], []
    hook = model.register_forward_hook(
        lambda mod, args, out: logits.append(out.detach()))
    server = MaskServer(model, img_size=hw, max_batch=BATCH)
    serve_fn = server._mask_fn

    def recording(images_u8):
        masks = serve_fn(images_u8)
        ran.append((np.array(images_u8), masks))
        return masks

    server._mask_fn = recording
    results = [None] * len(imgs)

    def worker(i):
        results[i] = post(base + "/predict?format=raw", encode_png(imgs[i]))

    ua.reset_launch_count()
    host, port = server.start(port=0)[:2]
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if health["status"] != "ok":
            raise AssertionError(f"healthz: {health}")
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        burst_s = time.perf_counter() - t0
        burst_batches = len(ran)
        lat = []
        for i in range(5):  # one request at a time
            t1 = time.perf_counter()
            status, _, body = post(base + "/predict", encode_png(imgs[i]))
            lat.append(time.perf_counter() - t1)
            color = decode_png(body)
            if status != 200 or color.shape != (img, img, 3):
                raise AssertionError(f"colorized response {status} "
                                     f"{color.shape}")
        jpeg_figures = (serve_jpeg_bodies(base, [imgs[0], imgs[1], imgs[10]])
                        if jpeg_bodies else {})
    finally:
        server.stop()
        hook.remove()
    launches = ua.launch_count()
    if launches != len(ran) or len(logits) != len(ran):
        raise AssertionError(f"{name}: {len(ran)} served batches launched "
                             f"the argmax kernel {launches} times")
    if any(r is None for r in results):
        raise AssertionError("a request got no response")
    mask_fn = make_mask_fn(model, out_hw=hw)
    low = -(-img // model.output_stride)  # 513 -> 129 at stride 4
    agreement = 1.0
    for lg, (batch, masks) in zip(logits, ran):
        if tuple(lg.shape[1:]) != (NUM_CLASSES, low, low):
            raise AssertionError(f"{name}: logits {tuple(lg.shape)}")
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{name}: served logits not finite")
        if not torch.equal(mask_fn(batch), masks):
            raise AssertionError(f"{name}: make_mask_fn run directly on a "
                                 f"served batch gives another mask")
        nhwc = lg.permute(0, 2, 3, 1)
        ref = ua.upsample_argmax_reference(nhwc, hw, align_corners=align)
        up = resize_bilinear(nhwc.float(), hw, align_corners=align)
        agreement = min(agreement, mask_check(masks, ref, up)[0])
        del ref, up
    n_classes = 0
    for image, size, (status, ctype, body) in zip(imgs, sizes, results):
        served = decode_png(body)
        if status != 200 or ctype != "image/png" or served.shape != size:
            raise AssertionError(f"bad response {status} {ctype} "
                                 f"{served.shape} for a {size} request")
        if size != hw:
            continue
        slots = [(masks, j) for batch, masks in ran[:burst_batches]
                 for j in range(len(batch)) if np.array_equal(batch[j], image)]
        if len(slots) != 1:
            raise AssertionError(f"request found in {len(slots)} batch slots")
        want = slots[0][0][slots[0][1]].cpu().numpy()
        if not np.array_equal(served.astype(np.int32), want):
            raise AssertionError(f"{name}: a response differs from its "
                                 f"batch's mask at "
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
    if out.shape != (BATCH, img, img):
        raise AssertionError(f"mask shape {tuple(out.shape)}")
    # the eval-mode check, host clock, us per call over 1000: over the
    # modules taken once (each mask function's call) and walking
    # model.modules() (each eval and predict step's call)
    modules = tuple(model.modules())
    check_us = []
    for walk in (lambda: modules, model.modules):
        t1 = time.perf_counter()
        for _ in range(1000):
            require_eval_mode(walk(), "serving")
        check_us.append(1e3 * (time.perf_counter() - t1))
    figures = {"burst_s": burst_s,
               "request_latency_ms_median": 1e3 * statistics.median(lat),
               "served_batches": len(ran), "burst_batches": burst_batches,
               "mask_agreement_min": agreement,
               "images_per_s_batch8": BATCH / best,
               "ms_per_batch8": 1e3 * best,
               "logits_shape": [BATCH, NUM_CLASSES, low, low],
               "logits_dtype": str(logits[0].dtype).replace("torch.", ""),
               "align_corners": align, **jpeg_figures}
    log("serve", model=name, img=img, requests=len(imgs), **figures,
        launches=launches, classes_present=n_classes,
        batches=server.stats["batches"], modules=len(modules),
        eval_mode_check_us=check_us[0], eval_mode_check_walk_us=check_us[1])
    return launches, figures


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


def train_batch(device, hw=IMG):
    """The train phases' fixed batch: 32 smooth u8 images at hw x hw and, as
    labels, a 9x9 grid of classes per image, nearest-upsampled. Returns the
    u8 images (host) and the (images, segs, valid) batch on the card:
    loading is not part of the train-step slices."""
    rng = np.random.default_rng(SEED + 4)
    imgs_u8 = np.stack([smooth_image(rng, hw, hw)
                        for _ in range(TRAIN_BATCH)])
    grid = torch.from_numpy(rng.integers(0, NUM_CLASSES,
                                         (TRAIN_BATCH, 9, 9)).astype(np.int32))
    segs = resize_nearest(grid, (hw, hw))
    if len(torch.unique(segs)) < 3:
        raise AssertionError("labels have fewer than 3 classes")
    return imgs_u8, (normalize_images(torch.from_numpy(imgs_u8).to(device)),
                     segs.to(device), TRAIN_BATCH)


def family_model(key, **kwargs):
    """The model of a family entry (`FAMILY_VARIANTS`' model and
    `--variant` where the key names one, else the model `key` at its
    defaults) with NUM_CLASSES classes; `kwargs` to its constructor."""
    name, variant = FAMILY_VARIANTS.get(key, (key, ""))
    return build_model(name, NUM_CLASSES, **variant_kwargs(name, variant),
                       **kwargs)


def make_trainer(device, name, batch, tmp, loss_fn=compute_loss, weights="",
                 **model_kwargs):
    """`family_model(name)` (bf16 compute over f32 parameters,
    full_res_output=True, so the Trainer's deferred upsample routes the loss
    through the upsample+CE kernels; `model_kwargs` to its constructor) in a
    Trainer on one fixed batch, SGD 1e-3 with momentum 0.9, the aux head's
    loss at the Trainer's default weight, from the seeded start: the same
    weights on every call. `loss_fn` replaces the CE (MaskFormer's set
    criterion: no deferred upsample then); `weights` is a checkpoint to
    start from."""
    model = family_model(name, dtype=torch.bfloat16, full_res_output=True,
                         **model_kwargs)
    trainer = Trainer(model, RepeatFetcher(batch, 1), loss_fn=loss_fn,
                      weights=weights, workdir=os.path.join(tmp, "w"),
                      lr=1e-3, momentum=0.9, seed=SEED, log=False,
                      log_dir=os.path.join(tmp, "runs"), device=device)
    if (trainer._train_module.full_res_output is not False) != (
            loss_fn is not compute_loss):
        raise AssertionError(f"{name}: the Trainer deferred the upsample "
                             f"{not trainer._train_module.full_res_output} "
                             f"for the loss {loss_fn}")
    return trainer


def timed_steps(trainer, warmup, windows):
    """From zeroed launch counts and peak memory: `warmup` steps one by
    one, then `windows` synchronised windows of 5 (`step_windows`). Returns
    the losses (each warm-up step's, then each window's mean), the wall and
    CUDA-event ms per step, the CE and fused kernels' launches and the peak
    device memory, GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce.reset_launch_count()
    fm.reset_launch_count()
    trainer.fetcher.n = 1
    losses = [trainer.step() for _ in range(warmup)]
    trainer.fetcher.n = 5
    wall_ms, event_ms = step_windows(trainer, windows, losses)
    return (losses, wall_ms, event_ms,
            {"softmax_ce": ce.launch_count(),
             "fused_matmul_bn": fm.launch_count()},
            torch.cuda.max_memory_allocated() / 1e9)


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
    with tempfile.TemporaryDirectory() as tmp:
        trainer = make_trainer(device, "deeplabv3plus", batch, tmp)
        model = trainer.model
        stem_mean = model.backbone.stem.bn.running_mean.clone()
        # the strides of the NHWC view of the logits that the step hands
        # the loss: they follow the layout cls_conv's output came in
        strides = set()
        strides_hook = trainer._train_module.register_forward_hook(
            lambda mod, args, out: strides.add(
                tuple(out.permute(0, 2, 3, 1).stride())))
        losses, wall_ms, event_ms, launches, peak_gb = timed_steps(trainer,
                                                                   3, 3)
        launches = launches["softmax_ce"]
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
    _, batch = train_batch(device)
    blocks.set_force_fused_1x1("on")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            trainer = make_trainer(device, "deeplabv3plus", batch, tmp)
            folded_bn = trainer.model.backbone.layer1_block0.conv1.bn
            before = (folded_bn.running_mean.clone(),
                      int(folded_bn.num_batches_tracked))
            fm.reset_layout_copy_count()
            losses, wall_ms, event_ms, counts, peak_gb = timed_steps(
                trainer, 3, 3)
            launches, ce_launches = (counts["fused_matmul_bn"],
                                     counts["softmax_ce"])
            copies = fm.layout_copy_count()
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
    return resample_launches, [ms / n_batches for ms in epoch_ms]


def encode_png_filtered(rgb, filter_type):
    """PNG bytes of uint8 RGB [H, W, 3] with every row filtered with
    `filter_type` 1..4 (PNG specification, section 9): decoding such a file
    runs the reconstruction that filter needs."""
    h, w, _ = rgb.shape
    x = rgb.reshape(h, w * 3).astype(np.int16)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]                       # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                             # up
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]                    # up-left
    pred = {1: a, 2: b, 3: (a + b) >> 1, 4: png._paeth(a, b, c)}[filter_type]
    rows = np.concatenate([np.full((h, 1), filter_type, np.int16),
                           (x - pred) & 255], axis=1).astype(np.uint8)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (png._SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + png._chunk(b"IEND", b""))


def host_record_rates(dataset, first, n):
    """Records/s of the host's per-record work on one thread, split into
    decode (the set's JPEG files), rasterize and the cubic (image) +
    nearest (labels) resize, over records first..first+n-1; the decode
    alone of the same records through CLI_WORKERS threads, and on one
    thread from PNG bytes of the same pixels (unfiltered rows, as
    `encode_png` writes them); and the whole record (decode to resized RGB)
    through the DataLoader's worker threads, over the dataset."""
    seconds = {"decode": 0.0, "rasterize": 0.0, "resize": 0.0}
    tw, th = dataset.img_size
    records = dataset.data[first:first + n]
    n = len(records)
    pngs = []
    for path, anns in records:
        t0 = time.perf_counter()
        img = imgcodecs.imread(path)
        t1 = time.perf_counter()
        seg = rasterize_annotations(img.shape[0], img.shape[1], anns)
        t2 = time.perf_counter()
        resize_u8(np.ascontiguousarray(img[:, :, ::-1]), (tw, th), "cubic")
        resize_u8(seg, (tw, th), "nearest")
        t3 = time.perf_counter()
        seconds["decode"] += t1 - t0
        seconds["rasterize"] += t2 - t1
        seconds["resize"] += t3 - t2
        pngs.append(encode_png(np.ascontiguousarray(img[:, :, ::-1])))
    rates = {f"{k}_records_per_s": n / v for k, v in seconds.items()}
    rates["one_thread_records_per_s"] = n / sum(seconds.values())
    paths = [path for path, _ in records]
    with ThreadPoolExecutor(CLI_WORKERS) as pool:
        list(pool.map(imgcodecs.imread, paths))  # warm the page cache
        t0 = time.perf_counter()
        list(pool.map(imgcodecs.imread, paths * 4))
        rates[f"jpeg_decode_{CLI_WORKERS}_threads_records_per_s"] = (
            4 * n / (time.perf_counter() - t0))
    t0 = time.perf_counter()
    for data in pngs:
        imgcodecs.imdecode(data)
    rates["png_decode_records_per_s"] = n / (time.perf_counter() - t0)
    loader = DataLoader(dataset, TRAIN_BATCH, num_workers=CLI_WORKERS)
    t0 = time.perf_counter()
    count = sum(batch.valid for batch in loader)
    rates[f"dataloader_{CLI_WORKERS}_workers_records_per_s"] = (
        count / (time.perf_counter() - t0))
    return rates


@contextlib.contextmanager
def working_dir(path):
    """The CLIs write weights/, runs/ and batch.png where they run."""
    before = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(before)


def cli_phase(device, e2e_ms_per_step):
    """The command lines from files on disk, at full width: a seeded
    synthetic COCO set written as JPEG (96 train and 32 val images at
    640x480, 20 categories + background; four train images rewritten as PNG
    files with row filters 1-4, train.json pointing at them, so the CLIs
    read both codecs), then `train` (2 epochs, the per-epoch eval),
    `train --resume` (to epoch 3), `test` on best.pt and `inference` on the
    val images, each through its module's `main` as `python -m` runs it.
    Checks: the resumed run starts at epoch 2 with the saved best mIoU and
    update count; the test CLI's mIoU is `engine.test`'s on the same weights
    and files; the inference CLI's masks are at each image's size and equal
    to `inference()`'s on the same batches. Kernels 1-4 must all launch."""
    from pytorch_segmentation_tpu_torch import inference as infer_cli
    from pytorch_segmentation_tpu_torch import test as test_cli
    from pytorch_segmentation_tpu_torch import train as train_cli
    from pytorch_segmentation_tpu_torch.data import CocoDataset

    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        t0 = time.perf_counter()
        data = make_synthetic_coco(os.path.join(tmp, "coco"), CLI_TRAIN,
                                   CLI_VAL, CLI_WH, seed=SEED,
                                   num_classes=CLI_CATEGORIES)
        train_json = os.path.join(data, "train.json")
        with open(train_json) as f:
            coco = json.load(f)
        for k in range(4):   # PNG files, rows filtered with types 1..4
            info = coco["images"][k]
            jpg = os.path.join(data, info["file_name"])
            bgr = imgcodecs.imread(jpg)
            info["file_name"] = f"train_{k:04d}.png"
            path = os.path.join(data, info["file_name"])
            with open(path, "wb") as f:
                f.write(encode_png_filtered(
                    np.ascontiguousarray(bgr[:, :, ::-1]), k + 1))
            os.unlink(jpg)
            if not np.array_equal(imgcodecs.imread(path), bgr):
                raise AssertionError(f"filter {k + 1}: the decode differs")
        with open(train_json, "w") as f:
            json.dump(coco, f)
        write_s = time.perf_counter() - t0
        train_set = CocoDataset(os.path.join(data, "train.json"),
                                img_size=(IMG, IMG))
        if [os.path.splitext(p)[1] for p, _ in train_set.data[:5]] != [
                ".png"] * 4 + [".jpg"]:
            raise AssertionError("the train set's first files")
        # the generator's JPEG files one by one; the filtered PNG four apart
        rates = host_record_rates(train_set, 4, 16)
        t0 = time.perf_counter()
        for path, _ in train_set.data[:4]:
            imgcodecs.imread(path)
        filtered_decode_ms = 1e3 * (time.perf_counter() - t0) / 4
        os.makedirs("imgs")
        for info in json.load(open(os.path.join(data, "val.json")))["images"]:
            os.symlink(os.path.join(data, info["file_name"]),
                       os.path.join("imgs", info["file_name"]))

        # the main path, with every count at 0
        argv = [data, "--model", "deeplabv3plus", "--dataset", "coco",
                "-s", str(IMG), str(IMG), "-bs", str(TRAIN_BATCH), "-a", "1",
                "-mp", "--num-workers", str(CLI_WORKERS)]
        for kernel in (ua, ce, br, ec):
            kernel.reset_launch_count()
        t0 = time.perf_counter()
        first = train_cli.main(argv + ["--epochs", "2"])
        saved = torch.load("weights/last.pt", weights_only=True)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = train_cli.main(argv + ["--epochs", "3", "--resume"])
        resume_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        miou = test_cli.main([os.path.join(data, "val.json"), "--model",
                              "deeplabv3plus", "--weights", "weights/best.pt",
                              "-s", str(IMG), str(IMG), "-bs",
                              str(EVAL_BATCH), "--num-workers",
                              str(CLI_WORKERS)])
        test_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        masks = infer_cli.main(["imgs", "out", "--model", "deeplabv3plus",
                                "-s", str(IMG), str(IMG), "-nc",
                                str(NUM_CLASSES), "--weights",
                                "weights/best.pt", "-bs", str(BATCH)])
        infer_s = time.perf_counter() - t0
        launches = {"upsample_argmax": ua.launch_count(),
                    "softmax_ce": ce.launch_count(),
                    "banded_resample": br.launch_count(),
                    "eval_confusion": ec.launch_count()}

        with open("runs/log.jsonl") as f:
            records = [json.loads(line) for line in f]
        epochs = [r for r in records if "steps" in r]
        val = [r for r in records if "val_miou" in r]
        per_epoch = CLI_TRAIN // TRAIN_BATCH
        if not (first.epoch == 2 and first.state.step == 2 * per_epoch
                and saved["epoch"] == 2 and saved["step"] == 2 * per_epoch
                and saved["best_miou"] == first.metrics > 0):
            raise AssertionError(f"train: epoch {first.epoch}, step "
                                 f"{first.state.step}, saved {saved['epoch']}"
                                 f" / {saved['step']} / {saved['best_miou']}")
        if not ([r["epoch"] for r in epochs] == [r["epoch"] for r in val]
                == [0, 1, 2] and resumed.epoch == 3
                and resumed.state.step == 3 * per_epoch
                and resumed.metrics == max(first.metrics,
                                           val[-1]["val_miou"])):
            raise AssertionError(f"resume: epochs {[r['epoch'] for r in val]}"
                                 f", step {resumed.state.step}, best "
                                 f"{resumed.metrics} after {first.metrics}")
        if not all(np.isfinite(r["loss"]) for r in epochs):
            raise AssertionError(f"epoch losses {epochs}")
        del first, resumed
        # 3 epochs; 3 per-epoch evals and the test CLI's, each with a
        # first-batch picture
        steps, tests = 3 * per_epoch, 4
        evals = tests * -(-CLI_VAL // EVAL_BATCH)
        want = {"upsample_argmax": tests,
                "softmax_ce": {"fwd": steps + evals, "bwd": steps},
                "banded_resample": 2 * steps, "eval_confusion": evals}
        if launches != want:
            raise AssertionError(f"cli launches {launches}, want {want}")

        # the same weights and files in this process
        model = load_model_bundle(build_model("deeplabv3plus", NUM_CLASSES),
                                  "weights/best.pt", device)
        val_set = CocoDataset(os.path.join(data, "val.json"),
                              img_size=(IMG, IMG), augments=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_miou = run_eval(model, Fetcher(
            DataLoader(val_set, EVAL_BATCH, num_workers=CLI_WORKERS),
            PostFetch(device=device)), log=False, show_first_batch=False,
            device=device)
        eval_s = time.perf_counter() - t0
        if miou != want_miou or not 0.0 <= miou <= 1.0:
            raise AssertionError(f"test CLI mIoU {miou}, engine.test "
                                 f"{want_miou}")
        names = sorted(masks)
        t0 = time.perf_counter()
        for start in range(0, len(names), BATCH):
            chunk = names[start:start + BATCH]
            imgs = [imgcodecs.imread(os.path.join("imgs", n)) for n in chunk]
            for name, img, mask in zip(chunk, imgs, infer_cli.inference(
                    model, imgs, (IMG, IMG))):
                if not mask.shape == img.shape[:2] == masks[name].shape:
                    raise AssertionError(f"{name}: mask {mask.shape}")
                if not np.array_equal(mask, masks[name]):
                    raise AssertionError(f"{name}: the CLI's mask differs")
        torch.cuda.synchronize()
        infer_images_s = len(names) / (time.perf_counter() - t0)
        written = imgcodecs.imread(os.path.join(
            "out", os.path.splitext(names[0])[0] + ".png"))
        if not np.array_equal(written, colorize_mask(masks[names[0]])):
            raise AssertionError("the written mask differs")
    step_ms = [1e3 * r["seconds"] / r["steps"] for r in epochs]
    log("cli", train_images=CLI_TRAIN, val_images=CLI_VAL,
        image_wh=list(CLI_WH), classes=NUM_CLASSES, batch=TRAIN_BATCH,
        write_dataset_s=write_s, **rates,
        filtered_png_decode_ms=filtered_decode_ms,
        step_records_per_s=1e3 * TRAIN_BATCH / min(e2e_ms_per_step),
        ms_per_step_cli=step_ms, ms_per_step_end_to_end_in_memory=(
            e2e_ms_per_step), val_miou=[r["val_miou"] for r in val],
        test_miou=miou, eval_images_per_s=CLI_VAL / eval_s,
        inference_images_per_s=infer_images_s,
        seconds={"train": first_s, "resume": resume_s, "test": test_s,
                 "inference": infer_s}, launches=launches)
    return launches


# the families' input sizes, as the JAX tools/bench_models.py sizes them:
# multiples of 32 for UNet, HRNet, FPN, DANet and LR-ASPP; 513 for PSPNet
# and FastFCN, whose stride-8 logits (65) and FastFCN's stride-16 aux
# logits (33) then upsample by 8x and 16x with align_corners=True and
# binary-fraction taps, and for FCN and DeepLabV3, whose 65 upsample to
# 513 with align_corners=False at the ratio 65/513 (not a short binary
# fraction: near-tie pixels may count apart, `near_ties`)
FAMILY_IMGS = {"unet": 512, "hrnet": 512, "fpn": 512, "pspnet": 513,
               "fastfcn": 513, "fcn": 513, "deeplabv3": 513, "danet": 512,
               "lraspp": 512, "segformer": 512, "upernet": 512,
               "segmenter": 512, "upernet_swin": 512, "bisenetv2": 512,
               "ocrnet": 512, "segnext": 512, "maskformer": 512}
# family entries that are a --variant of a model: key -> (model, variant);
# Segmenter runs at its default, ViT-B/16, OCRNet at W32 and SegNeXt at
# MSCAN-T
FAMILY_VARIANTS = {"upernet_swin": ("upernet", "swin-t"),
                   "upernet_cn": ("upernet", "cn-t"),
                   "upernet_vit": ("upernet", "vit-b16"),
                   "segformer_scan": ("segformer", "b2")}
# the families whose upsampling taps are not short binary fractions, or
# whose logits are f32 (Segmenter's and SegNeXt's: a tap of k/32 or k/16
# times an f32 logit rounds, where times a bf16 one it is exact), so that
# kernel 3's counts may differ from the plain version's by the near-tie
# pixels; every other family's counts must equal exactly (MaskFormer's f32
# scores at 4x count equal on the card: not listed)
NEAR_TIE_FAMILIES = ("unet", "fcn", "deeplabv3", "segmenter", "segnext")
# the constructor arguments each family is trained with (the aux heads'
# loss at the Trainer's and the train CLI's weight, AUX_WEIGHT)
FAMILY_KWARGS = {name: {"aux": True} for name in (
    "pspnet", "fastfcn", "fcn", "deeplabv3", "danet", "upernet",
    "upernet_swin", "upernet_cn", "upernet_vit", "bisenetv2", "ocrnet")}
# the logits an aux model's train step returns (DANet: the fused logits
# and both branch classifiers'; BiSeNetV2: the logits and its four
# boosters), each through the CE kernels; 2 where not listed
FAMILY_HEADS = {"danet": 3, "bisenetv2": 5}
# the families trained again with the fused 1x1 switch on, beside their
# switch-off figures, and the distinct kernel-5 shapes of each (FCN's and
# DeepLabV3's are PSPNet's; UPerNet's the non-dilated ResNet-50's at 512,
# 524288 rows down to 8192)
FUSED_FAMILIES = {"unet": 17, "pspnet": 12, "danet": 12, "upernet": 12,
                  "maskformer": 12}
# (family, variant) pairs that serve one batch
ONE_BATCH_VARIANTS = (("fpn", "r34"), ("fcn", "r101"), ("segformer", "b2"),
                      ("upernet", "mit-b0"), ("segnext", "b"),
                      ("ocrnet", "w48"))
# family entries that serve one batch and take one train step
ONE_STEP_FAMILIES = ("upernet_cn", "upernet_vit")
# SegFormer-B2 (FAMILY_VARIANTS) with scan_blocks=True on the unrolled
# model's weights stacked (`stack_block_params`): one batch served, one
# train step
SCAN_ENTRIES = ("segformer_scan",)
# the MaskFormer entry's steps with the Hungarian matcher (one checked,
# then timed)
HUNGARIAN_STEPS = 3
ONE_STEP_IMG = 512
AUX_WEIGHT = 0.4
FAMILY_EVAL_IMAGES = 64
FAMILY_WARMUP, FAMILY_STEPS, FAMILY_WINDOWS = 2, 5, 2
# MaskFormer's step-1 loss on the card against its criterion on the CPU
SET_LOSS_RTOL = 1e-4
ROOT_BATCH, ROOT_ACCUMULATE = 32, 2   # the root train CLI's -bs and -a
FUSED_PER_STEP = 32   # UNet's expand + project, ResNet-50's conv1 + conv3


def fused_product_shapes(model):
    """Forward hooks that record each folded block's 1x1 products as (N, K,
    M, act) while they are registered: an InvertedResidual's expand and
    project, a Bottleneck's conv1 and conv3."""
    from pytorch_segmentation_tpu_torch.nn.backbones.mobilenetv2 import (
        InvertedResidual)
    from pytorch_segmentation_tpu_torch.nn.backbones.resnet import Bottleneck
    shapes, handles = [], []

    def hook(mod, args, out):
        b, k, h, w = args[0].shape
        n_out = b * out.shape[2] * out.shape[3]
        if isinstance(mod, Bottleneck):
            width = mod.conv1.conv.out_channels
            shapes.append((b * h * w, k, width, "relu"))
            shapes.append((n_out, width, out.shape[1], "relu"))
            return
        hidden = mod.expand.conv.out_channels
        shapes.append((b * h * w, k, hidden, "none"))
        shapes.append((n_out, hidden, out.shape[1], "relu6"))

    for mod in model.modules():
        if (isinstance(mod, Bottleneck) or isinstance(mod, InvertedResidual)
                and mod.expand is not None):
            handles.append(mod.register_forward_hook(hook))
    return shapes, handles


def first_folded_bn(model):
    """A BatchNorm whose statistics come from kernel 5's epilogue with the
    switch on: UNet's stage 1 expand (stage 0's block has no expand), a
    ResNet's first conv1."""
    backbone = model.backbone
    if hasattr(backbone, "stage1_block0"):
        return backbone.stage1_block0.expand.bn
    return backbone.layer1_block0.conv1.bn


def flat_outputs(out):
    """A forward's logits as a flat tuple: (logits,), (logits, aux) or,
    for DANet, (logits, pam logits, cam logits)."""
    if isinstance(out, (tuple, list)):
        return tuple(t for o in out for t in flat_outputs(o))
    return (out,)


def family_train(device, name, plain=None):
    """`name` (with FAMILY_KWARGS) through `make_trainer` on one fixed batch
    of 32 at its FAMILY_IMGS size: 2 warm-up steps, then 2 synchronised
    windows of 5 (the first window after a model's warm-up runs slow on
    some hosts). The CE kernels are held against the plain version on the
    last step's logits and labels, the aux logits too. For an aux model
    each step launches the CE forward and backward once a head (the main
    and each aux head: FAMILY_HEADS), and step 1's loss must equal the
    plain version's loss of that step's logits plus AUX_WEIGHT times that
    of each of its aux logits (the function the deferred upsample
    computes). Given `plain`, the figures of
    the same model's run with the switch off, the fused 1x1 switch is on:
    the steps record the 1x1 products' shapes, step 1's loss is held
    against `plain`'s (the same weights and batch) and a folded BN's
    running statistics must move once a step. Returns the launches, the
    figures, the trained model and those shapes."""
    if name == "maskformer":
        return set_prediction_train(device, plain)
    fused = plain is not None
    hw = FAMILY_IMGS[name]
    aux = FAMILY_KWARGS.get(name, {}).get("aux", False)
    _, batch = train_batch(device, hw)
    blocks.set_force_fused_1x1("on" if fused else None)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            trainer = make_trainer(device, name, batch, tmp,
                                   **FAMILY_KWARGS.get(name, {}))
            kept = []   # the first and the last step's outputs

            def keep(mod, args, out):
                if len(kept) == 2:
                    kept.pop()
                kept.append(tuple(o.detach() for o in flat_outputs(out)))

            hooks = [trainer._train_module.register_forward_hook(keep)]
            shapes = []
            if fused:
                shapes, handles = fused_product_shapes(trainer.model)
                hooks += handles
                folded_bn = first_folded_bn(trainer.model)
                before = (folded_bn.running_mean.clone(),
                          int(folded_bn.num_batches_tracked))
            losses, wall_ms, event_ms, launches, peak_gb = timed_steps(
                trainer, FAMILY_WARMUP, FAMILY_WINDOWS)
            for hook in hooks:
                hook.remove()
    finally:
        blocks.set_force_fused_1x1(None)
    steps = trainer.state.step
    heads = FAMILY_HEADS.get(name, 2) if aux else 1
    if len(kept[0]) != heads:
        raise AssertionError(f"{name}: the train step returned "
                             f"{len(kept[0])} logits, not {heads}")
    if steps != FAMILY_WARMUP + FAMILY_WINDOWS * FAMILY_STEPS or launches[
            "softmax_ce"] != {"fwd": heads * steps, "bwd": heads * steps}:
        raise AssertionError(f"{name}: {steps} steps launched "
                             f"{launches['softmax_ce']}")
    per_step = FUSED_PER_STEP if fused else 0
    if (set(launches["fused_matmul_bn"].values()) != {per_step * steps}
            or len(shapes) != per_step * steps):
        raise AssertionError(f"{name}: {steps} steps launched "
                             f"{launches['fused_matmul_bn']}, "
                             f"{len(shapes)} products recorded")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: train losses {losses}")
    align = trainer.model.up_align_corners
    segs = batch[1]
    figures = {}
    if aux:
        # step 1's loss: the plain upsample+CE of its logits, + AUX_WEIGHT x
        # that of each of its aux logits, in f32
        main, *aux_heads = (o.permute(0, 2, 3, 1) for o in kept[0])
        plain_loss = float(
            ce.upsample_ce_reference(main, segs, align)
            + AUX_WEIGHT * sum(ce.upsample_ce_reference(a, segs, align)
                               for a in aux_heads))
        if not abs(losses[0] - plain_loss) <= LOSS_RTOL * plain_loss:
            raise AssertionError(f"{name}: step 1's loss {losses[0]}, the "
                                 f"plain version's {plain_loss}")
        figures["first_loss_plain"] = plain_loss
        figures["aux_logits"] = list(kept[0][1].shape)
    if fused:
        moved = (not torch.equal(folded_bn.running_mean, before[0]),
                 int(folded_bn.num_batches_tracked) - before[1])
        if moved != (True, steps):
            raise AssertionError(f"{name}: a folded BN's running statistics "
                                 f"did not move once per step: {moved}")
        loss_diff = (abs(losses[0] - plain["first_loss"])
                     / plain["first_loss"])
        if not loss_diff <= FUSED_LOSS_RTOL:
            raise AssertionError(f"{name}: step 1's loss {losses[0]} with "
                                 f"the switch on, {plain['first_loss']} "
                                 f"with it off")
        figures["first_loss_rel_diff_switch_off"] = loss_diff
    # the CE kernels on the last step's logits (and aux logits) and labels
    checked = {}
    head_names = ["logits", "aux_logits"] + [f"aux_logits_{i}" for i in
                                             range(1, heads - 1)]
    for head_name, out in zip(head_names, kept[-1]):
        x = out.permute(0, 2, 3, 1).requires_grad_(True)
        _, _, loss_err, grad_err, top = ce_check(
            f"{name}_step_{head_name}", x, segs, align)
        checked[head_name] = {"shape": list(x.shape),
                              "loss_abs_err": loss_err,
                              "dlogits_max_abs_err": grad_err,
                              "dlogits_largest": top}
    del kept
    figures.update({
        "first_loss": losses[0], "window_mean_losses": losses[-2:],
        "ms_per_step_wall": wall_ms, "ms_per_step_cuda_events": event_ms,
        "images_per_s": 1e3 * TRAIN_BATCH / min(wall_ms),
        "peak_memory_mb": 1e3 * peak_gb, "ce_on_step_logits": checked})
    return launches, figures, trainer.model, sorted(set(shapes))


def family_eval(device, name, model, eval_set):
    """`test()` of the trained `model` (its low-resolution twin) over
    `eval_set` at batch 32; each batch's loss and confusion counts held
    against the plain tail's on the logits the run produced (counts equal,
    or for NEAR_TIE_FAMILIES equal but for near-tie pixels, `near_ties`).
    Returns the launches and the figures."""
    align = model.up_align_corners
    captured, batches = [], []
    fetcher = Fetcher(DataLoader(eval_set, EVAL_BATCH),
                      PostFetch(dtype=torch.bfloat16, device=device))

    class Recording:
        loader = fetcher.loader

        def __len__(self):
            return len(fetcher)

        def __iter__(self):
            for batch in fetcher:
                batches.append(batch)
                yield batch

    hook = model.register_forward_hook(
        lambda mod, args, out: captured.append(out))
    ec.reset_launch_count()
    ce.reset_launch_count()
    t0 = time.perf_counter()
    miou = run_eval(model, Recording(), log=False, show_first_batch=False,
                    device=device)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {"eval_confusion": ec.launch_count(),
                "softmax_ce": ce.launch_count()}
    hook.remove()
    n_eval = len(eval_set) // EVAL_BATCH
    if launches != {"eval_confusion": n_eval, "softmax_ce": {
            "fwd": n_eval, "bwd": 0}} or len(captured) != n_eval:
        raise AssertionError(f"{name}: the eval run launched {launches}")
    kernel_step = make_eval_step(NUM_CLASSES, align_corners=align)
    plain_step = make_eval_step(NUM_CLASSES, align_corners=align,
                                use_kernels=False)
    ties = l1 = 0
    for lg, (images, segs, valid) in zip(captured, batches):
        fixed = FixedLogits(lg).eval()
        got = kernel_step(fixed, images, segs, valid)
        want = plain_step(fixed, images, segs, valid)
        loss, ref = float(got[0]), float(want[0])
        if not abs(loss - ref) <= LOSS_RTOL * abs(ref):
            raise AssertionError(f"{name} eval: loss {loss} against {ref}")
        batch_ties = 0
        if not all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])):
            batch_ties = near_ties(lg.permute(0, 2, 3, 1), segs.shape[1:],
                                   align, sample_valid_mask(
                                       valid, lg.shape[0], lg.device))
        close, batch_l1 = counts_close(got[1:], want[1:], batch_ties)
        if not close or batch_l1 and name not in NEAR_TIE_FAMILIES:
            raise AssertionError(f"{name} eval: counts differ by {batch_l1} "
                                 f"with {batch_ties} near-tie pixels")
        ties, l1 = ties + batch_ties, l1 + batch_l1
    if not 0.0 <= miou <= 1.0:
        raise AssertionError(f"{name}: mIoU {miou}")
    return launches, {"miou": miou, "images_per_s": len(eval_set) / eval_s,
                      "counts_l1_diff_plain_tail": l1,
                      "near_tie_pixels_where_counts_differ": ties}


def step_outputs(out):
    """A MaskFormer train-step dict, detached."""
    return {k: v.detach() for k, v in out.items()}


def set_prediction_loss_check(name, outputs, segs, matcher, loss):
    """The step's loss against the same criterion on CPU copies of the
    step's outputs and labels (rtol 1e-4). Returns the CPU loss."""
    cpu_loss = float(make_maskformer_loss(NUM_CLASSES, matcher=matcher)(
        {k: v.cpu() for k, v in outputs.items()}, segs.cpu()))
    if not abs(loss - cpu_loss) <= SET_LOSS_RTOL * abs(cpu_loss):
        raise AssertionError(f"{name}: step 1's loss {loss} on the card, "
                             f"{cpu_loss} on the CPU ({matcher})")
    return cpu_loss


def sinkhorn_figures(outputs, segs):
    """The Sinkhorn matcher on the step's own cost matrices (every
    supervised layer, from the step-1 outputs): on the card against the
    same function on a CPU copy of the costs, assignment for assignment, a
    class assigned otherwise allowed only where its matched cost is within
    1e-3 of the card's (a near tie of the decode); and beside Hungarian's
    exact optimum on the same costs: the queries given to two classes or
    more (collisions) and the matched costs' difference. Returns those
    figures."""
    targets = mf._targets(segs, outputs["mask"].shape[2:], NUM_CLASSES)
    present = targets[4]
    layers = [(outputs["cls"], outputs["mask"])] + list(zip(
        outputs["aux_cls"], outputs["aux_mask"]))
    figures = {"collisions": [], "cost_minus_hungarian_sum": [],
               "samples_equal_hungarian": [], "differs_cpu_near_ties": 0}
    for cls, mask in layers:
        cost = mf._layer_costs(cls, mask, targets, NUM_CLASSES)[3]
        got = mf._sinkhorn_assign(cost, present)
        want = mf._sinkhorn_assign(cost.cpu(), present.cpu()).to(cost.device)
        differs = (got != want).any(-1) & present            # [B, C]
        if bool(differs.any()):
            cost_t = cost.transpose(1, 2)                     # [B, C, Q]
            gap = (cost_t * got).sum(-1) - (cost_t * want).sum(-1)
            if float(gap[differs].abs().max()) > 1e-3:
                raise AssertionError(f"Sinkhorn on the card and on the CPU "
                                     f"differ by matched costs up to "
                                     f"{float(gap[differs].abs().max())}")
            figures["differs_cpu_near_ties"] += int(differs.sum())
        exact = mf._hungarian_assign(cost, present)
        cost_t = cost.transpose(1, 2)
        excess = (cost_t * got).sum((1, 2)) - (cost_t * exact).sum((1, 2))
        figures["collisions"].append(int((got.sum(1) > 1).sum()))
        figures["cost_minus_hungarian_sum"].append(float(excess.sum()))
        figures["samples_equal_hungarian"].append(
            int((got == exact).all(-1).all(-1).sum()))
    return figures


def set_prediction_train(device, plain=None, matcher="sinkhorn"):
    """MaskFormer (FAMILY_IMGS' size, aux_loss: 6 supervised layers) on its
    set criterion with `matcher` through `make_trainer` on the fixed batch
    of 32: 2 warm-up steps, then 2 synchronised windows of 5. No CE kernel
    runs in the step. Step 1's loss equals the criterion on CPU copies of
    its outputs; the Sinkhorn matcher on the step's own cost matrices is
    held against the CPU and set beside Hungarian's optimum
    (`sinkhorn_figures`); the loss is finite and falls; a backbone BN's
    running statistics move once a step. Given `plain` (the switch-off
    figures), the fused 1x1 switch is on: the 1x1 products' shapes are
    recorded and step 1's loss is held against `plain`'s. Returns
    family_train's four results."""
    name, fused = "maskformer", plain is not None
    _, batch = train_batch(device, FAMILY_IMGS[name])
    blocks.set_force_fused_1x1("on" if fused else None)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            trainer = make_trainer(device, name, batch, tmp,
                                   loss_fn=make_maskformer_loss(
                                       NUM_CLASSES, matcher=matcher))
            kept = []

            def keep(mod, args, out):
                if not kept:
                    kept.append(step_outputs(out))

            hooks = [trainer._train_module.register_forward_hook(keep)]
            shapes = []
            if fused:
                shapes, handles = fused_product_shapes(trainer.model)
                hooks += handles
            bn = first_folded_bn(trainer.model)
            before = (bn.running_mean.clone(), int(bn.num_batches_tracked))
            losses, wall_ms, event_ms, launches, peak_gb = timed_steps(
                trainer, FAMILY_WARMUP, FAMILY_WINDOWS)
            for hook in hooks:
                hook.remove()
    finally:
        blocks.set_force_fused_1x1(None)
    steps = trainer.state.step
    per_step = FUSED_PER_STEP if fused else 0
    if (steps != FAMILY_WARMUP + FAMILY_WINDOWS * FAMILY_STEPS
            or launches["softmax_ce"] != {"fwd": 0, "bwd": 0}
            or set(launches["fused_matmul_bn"].values()) != {per_step * steps}
            or len(shapes) != per_step * steps):
        raise AssertionError(f"{name}: {steps} steps launched {launches}, "
                             f"{len(shapes)} products recorded")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: train losses {losses}")
    moved = (not torch.equal(bn.running_mean, before[0]),
             int(bn.num_batches_tracked) - before[1])
    if moved != (True, steps):
        raise AssertionError(f"{name}: a BN's running statistics did not "
                             f"move once per step: {moved}")
    outputs, segs = kept[0], batch[1]
    figures = {"matcher": matcher, "first_loss_cpu": set_prediction_loss_check(
        name, outputs, segs, matcher, losses[0])}
    if fused:
        loss_diff = (abs(losses[0] - plain["first_loss"])
                     / plain["first_loss"])
        if not loss_diff <= FUSED_LOSS_RTOL:
            raise AssertionError(f"{name}: step 1's loss {losses[0]} with "
                                 f"the switch on, {plain['first_loss']} "
                                 f"with it off")
        figures["first_loss_rel_diff_switch_off"] = loss_diff
    else:
        figures["sinkhorn_step_costs"] = sinkhorn_figures(outputs, segs)
    figures["outputs"] = {k: list(v.shape) for k, v in outputs.items()}
    del kept, outputs
    figures.update({
        "first_loss": losses[0], "window_mean_losses": losses[-2:],
        "ms_per_step_wall": wall_ms, "ms_per_step_cuda_events": event_ms,
        "images_per_s": 1e3 * TRAIN_BATCH / min(wall_ms),
        "peak_memory_mb": 1e3 * peak_gb})
    return launches, figures, trainer.model, sorted(set(shapes))


def hungarian_steps(device, sinkhorn_ms):
    """The MaskFormer entry with the Hungarian matcher (scipy on the host,
    one round trip a supervised layer) from the seeded start on the fixed
    batch: step 1's loss finite and equal to the criterion on CPU copies of
    its outputs; then HUNGARIAN_STEPS - 1 steps timed in one synchronised
    window, beside the Sinkhorn run's ms a step. Returns the CE and fused
    kernels' launches (none)."""
    name = "maskformer"
    _, batch = train_batch(device, FAMILY_IMGS[name])
    with tempfile.TemporaryDirectory() as tmp:
        trainer = make_trainer(device, name, batch, tmp,
                               loss_fn=make_maskformer_loss(
                                   NUM_CLASSES, matcher="hungarian"))
        kept = []
        hook = trainer._train_module.register_forward_hook(
            lambda mod, args, out: kept.append(step_outputs(out))
            if not kept else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ce.reset_launch_count()
        fm.reset_launch_count()
        losses = [trainer.step()]
        hook.remove()
        trainer.fetcher.n = HUNGARIAN_STEPS - 1
        wall_ms, event_ms = step_windows(trainer, 1, losses)
        launches = {"softmax_ce": ce.launch_count(),
                    "fused_matmul_bn": fm.launch_count()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (np.isfinite(losses).all()
            and trainer.state.step == HUNGARIAN_STEPS
            and launches["softmax_ce"] == {"fwd": 0, "bwd": 0}):
        raise AssertionError(f"{name} hungarian: {trainer.state.step} "
                             f"steps, losses {losses}, {launches}")
    cpu_loss = set_prediction_loss_check(f"{name}_hungarian", kept[0],
                                         batch[1], "hungarian", losses[0])
    log("family_hungarian", model=name, img=FAMILY_IMGS[name],
        batch=TRAIN_BATCH, first_loss=losses[0], first_loss_cpu=cpu_loss,
        window_mean_loss=losses[-1], ms_per_step_wall=wall_ms,
        ms_per_step_cuda_events=event_ms,
        sinkhorn_ms_per_step_wall=sinkhorn_ms,
        peak_memory_mb=1e3 * peak_gb, launches=launches)
    return launches


def scan_entry(device, key):
    """SegFormer at `key`'s variant with scan_blocks=True, bf16, on
    the unrolled model's seeded serving weights stacked by
    `stack_block_params`: one batch of 8 smooth images through
    make_mask_fn (kernel 1 held against the plain version), its stride-4
    logits equal to the unrolled model's on the same batch, bit for bit;
    then one train step at batch 32 from the same weights for each layout:
    the CE kernels once each, the losses equal, the stacked parameters
    after the step beside the unrolled ones. Returns the kernels'
    launches."""
    name, variant = FAMILY_VARIANTS[key]
    hw = ONE_STEP_IMG
    kw = dict(dtype=torch.bfloat16, full_res_output=False,
              **variant_kwargs(name, variant))
    unrolled = load_model_bundle(build_model(name, NUM_CLASSES, **kw), None,
                                 device, seed=SEED)
    stacked_sd = stack_block_params(
        {k: v.cpu() for k, v in unrolled.state_dict().items()}, variant)
    scan = build_model(name, NUM_CLASSES, scan_blocks=True, **kw)
    scan.load_state_dict(stacked_sd, strict=True)
    scan = scan.to(device, memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(SEED + 3)
    images = np.stack([smooth_image(rng, hw, hw) for _ in range(BATCH)])
    logits = {}
    for label, model in (("unrolled", unrolled), ("scan", scan)):
        hook = model.register_forward_hook(
            lambda mod, args, out, label=label: logits.setdefault(
                label, out.detach()))
        ua.reset_launch_count()
        masks = make_mask_fn(model, out_hw=(hw, hw))(images)
        torch.cuda.synchronize()
        hook.remove()
    launches = ua.launch_count()
    if not torch.equal(logits["scan"], logits["unrolled"]):
        diff = float((logits["scan"].float()
                      - logits["unrolled"].float()).abs().max())
        raise AssertionError(f"{key}: the stacked model's logits differ from "
                             f"the unrolled model's by up to {diff}")
    nhwc = logits["scan"].permute(0, 2, 3, 1)
    agreement, err = mask_check(
        masks, ua.upsample_argmax_reference(nhwc, (hw, hw), align_corners=False),
        resize_bilinear(nhwc.float(), (hw, hw), align_corners=False))
    _, batch = train_batch(device, hw)
    step = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, sd, scan_blocks in (
                ("unrolled", unrolled.state_dict(), False),
                ("scan", stacked_sd, True)):
            path = os.path.join(tmp, f"{label}.pt")
            torch.save({"model": sd}, path)
            trainer = make_trainer(device, key, batch, tmp, weights=path,
                                   scan_blocks=scan_blocks)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ce.reset_launch_count()
            t0 = time.perf_counter()
            loss = trainer.step()
            torch.cuda.synchronize()
            step[label] = {"loss": loss, "launches": ce.launch_count(),
                           "ms_first_step_wall":
                               1e3 * (time.perf_counter() - t0),
                           "peak_memory_mb":
                               1e-6 * torch.cuda.max_memory_allocated(),
                           "state": {k: v.detach().cpu() for k, v in
                                     trainer.module.state_dict().items()}}
    after = stack_block_params(step["unrolled"].pop("state"), variant)
    got = step["scan"].pop("state")
    param_diff = max(float((got[k].float() - v.float()).abs().max())
                     for k, v in after.items())
    if (step["scan"]["launches"] != {"fwd": 1, "bwd": 1}
            or not np.isfinite(step["scan"]["loss"])
            or abs(step["scan"]["loss"] - step["unrolled"]["loss"])
            > LOSS_RTOL * abs(step["unrolled"]["loss"])):
        raise AssertionError(f"{key}: one step {step}")
    log("scan_entry", model=name, variant=variant, img=hw,
        logits_shape=list(logits["scan"].shape), logits_equal_unrolled=True,
        mask_agreement=agreement, max_abs_err=err, serve_launches=launches,
        train_step=step, params_after_step_max_abs_diff_unrolled=param_diff)
    return {"upsample_argmax": launches, "softmax_ce": step["scan"]["launches"]}


def danet_attention_ms(model, hw, step_ms):
    """CUDA-event ms of DANet's two attention blocks alone (`_pam`: the
    projections, the [B, N, N] scores, the f32 softmax and the product
    with v; `_cam`: the [B, C, C] energy and its softmax; each with its
    gate and residual), forward and backward (to the input and the blocks'
    parameters) at the train step's shape: batch 32, the branch width at
    stride 8, bf16, random inputs. With their share of the step's ms."""
    low = hw // model.output_stride
    x = torch.randn(TRAIN_BATCH, model.channels, low, low,
                    device=next(model.parameters()).device,
                    dtype=model.dtype).contiguous(
                        memory_format=torch.channels_last).requires_grad_()
    blocks_params = {
        "pam": (model._pam, [p for m in (model.pam_query, model.pam_key,
                                         model.pam_value, model.pam_gamma)
                             for p in m.parameters()]),
        "cam": (model._cam, list(model.cam_gamma.parameters()))}
    figures = {}
    for name, (fn, params) in blocks_params.items():
        grad_out = torch.randn_like(x)

        def fwd_bwd():
            torch.autograd.grad(fn(x), [x] + params, grad_out)

        figures[f"{name}_ms"] = cuda_median_ms(fwd_bwd, reps=5)
    figures["share_of_step"] = ((figures["pam_ms"] + figures["cam_ms"])
                                / step_ms)
    return figures


def segformer_blocks_ms(model, hw, step_ms):
    """CUDA-event ms of the parts of SegFormer's blocks alone, forward and
    backward (to the input and the part's parameters), at the train step's
    shapes: batch 32, each stage's tokens (N = (hw/4 / 2^i)^2 of width
    dim_i), bf16, random inputs. `attn` is the efficient self-attention (q,
    the sr x sr reduction and its LayerNorm, kv, the [B, heads, N, N/sr^2]
    scores, the f32 softmax, the product with v, proj), `ffn` the Mix-FFN
    (fc1, the 3x3 depthwise convolution, GELU, fc2); each timed on the
    stage's first block and counted depth times. With their shares of the
    step's ms."""
    mit = model.backbone
    device = next(model.parameters()).device
    side = -(-hw // 4)
    figures, totals = {}, {"attn": 0.0, "ffn": 0.0}
    for i, depth in enumerate(mit.depths):
        block = getattr(mit, f"block{i + 1}_0")
        dim = block.ln1.normalized_shape[0]
        x = torch.randn(TRAIN_BATCH, side * side, dim, device=device,
                        dtype=model.dtype, requires_grad=True)
        ms = parts_ms([(part, lambda t, m=getattr(block, part): m(t, side,
                                                                  side),
                        list(getattr(block, part).parameters()))
                       for part in totals], x)
        for part, value in ms.items():
            figures[f"stage{i + 1}_{part}_ms_per_block"] = value
            totals[part] += depth * value
        side = (side + 1) // 2
    for part, ms in totals.items():
        figures[f"{part}_ms"] = ms
        figures[f"{part}_share_of_step"] = ms / step_ms
    return figures


def parts_ms(parts, x):
    """CUDA-event ms of each `(name, fn, params)` of `parts` alone on `x`,
    forward and backward (to `x` and `params`), against a random
    gradient."""
    grad_out = torch.randn_like(x)
    figures = {}
    for part, fn, params in parts:
        def fwd_bwd():
            torch.autograd.grad(fn(x), [x] + params, grad_out)
        figures[part] = cuda_median_ms(fwd_bwd, reps=5)
    return figures


def swin_blocks_ms(model, hw, step_ms):
    """CUDA-event ms of the halves of the Swin trunk's blocks alone, forward
    and backward, at the train step's shapes: batch 32, each stage's NHWC
    map (hw/4 / 2^s a side, 96 * 2^s wide), bf16, random inputs.
    `attention` is `norm1`, the (shifted-)window attention (padding, roll,
    qkv, the [B, windows, heads, 49, 49] scores with the relative-position
    bias and the shift mask, the f32 softmax, the product with v, proj) and
    the residual; `mlp` is `norm2`, fc1, GELU, fc2 and the residual. Each
    stage's first block (no shift) and second (shifted) are timed and
    counted once for every block of their parity. With their shares of the
    step's ms."""
    swin = model.backbone
    device = next(model.parameters()).device
    side = hw // 4
    figures, totals = {}, {"attention": 0.0, "mlp": 0.0}
    for s, depth in enumerate(swin.depths):
        for b in range(min(depth, 2)):
            block = getattr(swin, f"stage{s}_block{b}")
            dim = block.norm1.normalized_shape[0]
            x = torch.randn(TRAIN_BATCH, side, side, dim, device=device,
                            dtype=model.dtype, requires_grad=True)
            ms = parts_ms((
                ("attention", block.attention,
                 [*block.norm1.parameters(), *block.attn.parameters()]),
                ("mlp", block.mlp, [*block.norm2.parameters(),
                                    *block.fc1.parameters(),
                                    *block.fc2.parameters()])), x)
            blocks_of_parity = (depth - b + 1) // 2
            for part, value in ms.items():
                figures[f"stage{s}_block{b}_{part}_ms"] = value
                totals[part] += blocks_of_parity * value
        side = (side + 1) // 2
    for part, ms in totals.items():
        figures[f"{part}_ms"] = ms
        figures[f"{part}_share_of_step"] = ms / step_ms
    return figures


def vit_blocks_ms(model, hw, step_ms):
    """CUDA-event ms of the halves of Segmenter's ViT blocks alone, forward
    and backward, at the train step's shapes: batch 32, bf16, random
    inputs; the encoder's first block on 1 + (hw/16)^2 tokens, counted for
    each of its blocks, and the decoder's first on (hw/16)^2 + K tokens,
    counted for each of its. `attention` is `ln1`, the fused qkv, the
    [B, heads, T, T] scores, the f32 softmax, the product with v, proj and
    the residual; `mlp` is `ln2`, fc1, GELU, fc2 and the residual. With
    their shares of the step's ms."""
    device = next(model.parameters()).device
    grid = (hw // 16) ** 2
    figures, total = {}, 0.0
    for stack, tokens, count in (
            ("encoder", 1 + grid, model.backbone.layers),
            ("decoder", grid + model.num_classes, model.decoder.n_layers)):
        block = (model.backbone if stack == "encoder"
                 else model.decoder).block0
        x = torch.randn(TRAIN_BATCH, tokens, block.dim, device=device,
                        dtype=model.dtype, requires_grad=True)
        ms = parts_ms((
            ("attention", block.attention,
             [*block.ln1.parameters(), *block.qkv.parameters(),
              *block.proj.parameters()]),
            ("mlp", block.mlp, [*block.ln2.parameters(),
                                *block.fc1.parameters(),
                                *block.fc2.parameters()])), x)
        for part, value in ms.items():
            figures[f"{stack}_{part}_ms_per_block"] = value
            figures[f"{stack}_{part}_ms"] = count * value
            total += count * value
        figures[f"{stack}_blocks"] = count
    figures["blocks_ms"] = total
    figures["blocks_share_of_step"] = total / step_ms
    return figures


def train_one_step(device, key):
    """One train step of the family entry `key` (with FAMILY_KWARGS' aux
    head) at batch 32 from the seeded start at ONE_STEP_IMG, on the train
    phases' fixed batch: the loss finite, the CE kernels launched once
    for each head, the step's wall ms (cuDNN's first-call choices included)
    and the peak device memory. Returns the CE kernels' launches."""
    hw = ONE_STEP_IMG
    heads = 2 if FAMILY_KWARGS.get(key, {}).get("aux", False) else 1
    _, batch = train_batch(device, hw)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = make_trainer(device, key, batch, tmp,
                               **FAMILY_KWARGS.get(key, {}))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ce.reset_launch_count()
        t0 = time.perf_counter()
        loss = trainer.step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    launches = ce.launch_count()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"fwd": heads, "bwd": heads} or not np.isfinite(loss):
        raise AssertionError(f"{key}: one step launched {launches}, loss "
                             f"{loss}")
    name, variant = FAMILY_VARIANTS[key]
    log("family_one_step", model=name, variant=variant, img=hw,
        batch=TRAIN_BATCH, heads=heads, loss=loss, ms_first_step_wall=ms,
        peak_memory_mb=1e3 * peak_gb, launches=launches)
    return {"softmax_ce": launches}


def serve_one_batch(device, name, variant, img):
    """`name` at `variant` (bf16, seeded weights, its stride-4 logits):
    make_mask_fn on one batch of 8 smooth u8 images, the mask held against
    the plain version on the logits the batch produced. Returns the
    argmax kernel's launches."""
    model = load_model_bundle(build_model(
        name, NUM_CLASSES, dtype=torch.bfloat16, full_res_output=False,
        **variant_kwargs(name, variant)), None, device, seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    images = np.stack([smooth_image(rng, img, img) for _ in range(BATCH)])
    logits = []
    hook = model.register_forward_hook(
        lambda mod, args, out: logits.append(out.detach()))
    hw = (img, img)
    ua.reset_launch_count()
    t0 = time.perf_counter()
    masks = make_mask_fn(model, out_hw=hw)(images)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ua.launch_count()
    hook.remove()
    nhwc = logits[0].permute(0, 2, 3, 1)
    if not bool(torch.isfinite(nhwc).all()):
        raise AssertionError(f"{name} {variant}: logits not finite")
    if launches != 1 or masks.shape != (BATCH, img, img):
        raise AssertionError(f"{name} {variant}: {launches} launches, mask "
                             f"{tuple(masks.shape)}")
    align = model.up_align_corners
    agreement, err = mask_check(
        masks, ua.upsample_argmax_reference(nhwc, hw, align_corners=align),
        resize_bilinear(nhwc.float(), hw, align_corners=align))
    log("serve_one_batch", model=name, variant=variant, img=img,
        logits_shape=list(logits[0].shape), mask_agreement=agreement,
        max_abs_err=err, seconds_first_call=seconds, launches=launches)
    return launches


def cli_kernel_checks(name, kept):
    """Kernels 1-4 held against their plain versions on the tensors the
    command lines' run handed them (`keeping_launches`): the upsample+CE
    kernels (forward and backward, `ce_check`) on the first train step's
    logits and labels (and its aux logits, where the model has the head;
    MaskFormer's on the first eval batch's scores);
    the first eval batch's confusion counts (equal but for near-tie
    pixels); the first-batch picture's mask (the top-2-gap rule); both
    passes of the first augmented batch's warp (bit-equal)."""
    steps = []
    for i, ((x, y, align), _) in enumerate(kept["softmax_ce"]):
        # an eval batch's tensors are inference tensors: their clones are
        # not, and take part in autograd
        _, _, loss_err, grad_err, top = ce_check(
            f"{name}_cli_step_logits_{i}", x.clone().requires_grad_(True),
            y.clone(), align)
        steps.append({"logits": list(x.shape), "dtype": str(x.dtype),
                      "out_hw": list(y.shape[1:]), "align_corners": align,
                      "loss_abs_err": loss_err,
                      "dlogits_max_abs_err": grad_err,
                      "dlogits_largest": top})
    (logits, labels, align), per_sample = kept["eval_confusion"][0]
    b = logits.shape[0]
    got = ec._finish(per_sample, b)
    want = ec.eval_confusion_reference(logits, labels, b, align)
    ties = 0
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        ties = near_ties(logits, tuple(labels.shape[1:]), align)
    close, l1 = counts_close(got, want, ties)
    if not close:
        raise AssertionError(f"{name} cli eval: counts differ by {l1} with "
                             f"{ties} near-tie pixels")
    (logits, out_hw, align), mask = kept["upsample_argmax"][0]
    up = resize_bilinear(logits.float(), out_hw, align_corners=align)
    agreement, argmax_err = mask_check(
        mask, ua.upsample_argmax_reference(logits, out_hw,
                                           align_corners=align), up)
    del up
    for (planes, coords, use_bil, out_dtype), out in kept["banded_resample"]:
        if not torch.equal(out, br.banded_resample_reference(
                planes, coords, use_bil, out_dtype)):
            raise AssertionError(f"{name} cli warp: the kernel's pass on "
                                 f"{tuple(planes.shape)} differs from the "
                                 f"plain version")
    return {"softmax_ce": steps,
            "eval_confusion": {"logits": list(logits.shape),
                               "counts_l1_diff_plain": l1,
                               "near_tie_pixels": ties},
            "upsample_argmax": {"logits": list(logits.shape),
                                "out_hw": list(out_hw),
                                "agreement": agreement,
                                "max_abs_err": argmax_err},
            "banded_resample": {"passes_bit_equal": [
                list(args[0].shape) for args, _ in
                kept["banded_resample"]]}}


# the command-line runs of the families phase: the train argv after the
# data directory (the root defaults but for these flags), the test argv's
# flags after the val file, the model class and the train-step heads
FAMILY_CLIS = {
    "unet": (["--epochs", "1"], ["--model", "unet"], "UNet", 1),
    # 321 = 8 x 40 + 1: stride-8 logits of 41 upsample 8x with taps of 1/8
    "pspnet": (["--model", "pspnet", "--aux-loss", str(AUX_WEIGHT), "-s",
                "321", "321", "--epochs", "1"],
               ["--model", "pspnet", "-s", "321", "321"], "PSPNet", 2),
    # the stride-8 logits of 41 upsample to 321 with align_corners=False;
    # the test CLI drops the nested aux_head.* entries
    "fcn": (["--model", "fcn", "--aux-loss", str(AUX_WEIGHT), "-s", "321",
             "321", "--epochs", "1"],
            ["--model", "fcn", "-s", "321", "321"], "FCN", 2),
    # stride-4 logits of 81 and aux logits of 21 (stride 16) upsample to 321
    # with align_corners=False; the test CLI drops aux_conv.* and aux_cls.*
    "upernet": (["--model", "upernet", "--aux-loss", str(AUX_WEIGHT), "-s",
                 "321", "321", "--epochs", "1"],
                ["--model", "upernet", "-s", "321", "321"], "UPerNet", 2),
    # ViT-B/16 at 320: a 20 x 20 patch grid, so the stored 14 x 14 position
    # grid is resized bicubically; f32 stride-16 logits of 20 upsample 16x
    # to 320 with align_corners=False (taps of 1/32)
    "segmenter": (["--model", "segmenter", "-s", "320", "320", "--epochs",
                   "1"], ["--model", "segmenter", "-s", "320", "320"],
                  "Segmenter", 1),
    # stride-8 logits of 40 and the four boosters, resized onto that grid,
    # upsample 8x to 320 with align_corners=False (taps of 1/16): five CE
    # forwards and backwards a step; the test CLI drops aux2_* ... aux5_*
    "bisenetv2": (["--model", "bisenetv2", "--aux-loss", str(AUX_WEIGHT),
                   "-s", "320", "320", "--epochs", "1"],
                  ["--model", "bisenetv2", "-s", "320", "320"],
                  "BiSeNetV2", 5),
    # the set criterion: no CE in the train step (0 heads); f32 stride-4
    # scores of 80 upsample to 320 with align_corners=False (taps of 1/8);
    # -bs 32 -a 1: three updates an epoch
    "maskformer": (["--model", "maskformer", "-s", "320", "320", "-bs",
                    "32", "-a", "1", "--epochs", "1"],
                   ["--model", "maskformer", "-s", "320", "320"],
                   "MaskFormer", 0),
}
# what the test command line must print of each dropped aux head
DROPPED_ENTRIES = {"fcn": ("'aux_head.aux_cls.bias'",),
                   "upernet": ("'aux_cls.bias'", "'aux_conv.conv.weight'"),
                   "bisenetv2": ("'aux2_cls.bias'", "'aux3_conv.conv.weight'",
                                 "'aux4_conv.bn.running_var'",
                                 "'aux5_cls.weight'")}


def family_cli(device, name):
    """The train command line with the root defaults (the cocoinstance
    dataset, -bs 32 -a 2, f32, 4 workers) and FAMILY_CLIS' flags on the cli
    phase's synthetic COCO set for one epoch; then the test command line on
    the best.pt it wrote. The CLI writes best.pt only when the epoch's val
    mIoU rises above 0, as the root CLI does, and one update of seeded
    weights may leave a model that predicts none of the val crops' classes
    (mIoU 0): then the test runs on last.pt. For PSPNet and FCN, trained
    with `--aux-loss`, the test builds the model without the head and must
    say that it dropped the head's entries (DROPPED_ENTRIES: FCN's nested
    `aux_head.*`, UPerNet's `aux_conv.*` and `aux_cls.*`, BiSeNetV2's
    `aux2_*` ... `aux5_*`).
    MaskFormer's train steps launch no CE kernel: its CE check runs on the
    first eval batch's scores. Returns the kernels' launches and the
    figures, with kernels 1-4 held against their plain versions on tensors
    the run handed them (`cli_kernel_checks`)."""
    import io
    from pytorch_segmentation_tpu_torch import test as test_cli
    from pytorch_segmentation_tpu_torch import train as train_cli

    train_argv, test_argv, cls_name, heads = FAMILY_CLIS[name]
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        data = make_synthetic_coco(os.path.join(tmp, "coco"), CLI_TRAIN,
                                   CLI_VAL, CLI_WH, seed=SEED,
                                   num_classes=CLI_CATEGORIES)
        for kernel in (ua, ce, br, ec, fm):
            kernel.reset_launch_count()
        t0 = time.perf_counter()
        with keeping_launches({"softmax_ce": (ce, "_launch_fwd",
                                              max(heads, 1)),
                               "eval_confusion": (ec, "_launch", 1),
                               "upsample_argmax": (ua, "_launch", 1),
                               "banded_resample": (br, "_launch", 2)}
                              ) as kept:
            trainer = train_cli.main([data] + train_argv)
        train_s = time.perf_counter() - t0
        wrote_best = os.path.exists("weights/best.pt")
        if wrote_best != (trainer.metrics > 0.0):
            raise AssertionError(f"train: best.pt written {wrote_best} at "
                                 f"val mIoU {trainer.metrics}")
        tested = "weights/best.pt" if wrote_best else "weights/last.pt"
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            miou = test_cli.main([os.path.join(data, "val.json"),
                                  "--weights", tested] + test_argv)
        test_s = time.perf_counter() - t0
        printed = printed.getvalue()
        print(printed, end="", flush=True)
        launches = {"upsample_argmax": ua.launch_count(),
                    "softmax_ce": ce.launch_count(),
                    "banded_resample": br.launch_count(),
                    "eval_confusion": ec.launch_count(),
                    "fused_matmul_bn": fm.launch_count()}
        with open("runs/log.jsonl") as f:
            records = [json.loads(line) for line in f]
    micro = CLI_TRAIN // ROOT_BATCH
    accumulate = (int(train_argv[train_argv.index("-a") + 1])
                  if "-a" in train_argv else ROOT_ACCUMULATE)
    if not (type(trainer.model).__name__ == cls_name
            and getattr(trainer.model, "aux", False) == (heads > 1)
            and trainer.epoch == 1
            and trainer.state.step == micro // accumulate
            and 0.0 <= trainer.metrics <= 1.0 and 0.0 <= miou <= 1.0):
        raise AssertionError(f"train --model {name}: epoch {trainer.epoch}, "
                             f"updates {trainer.state.step}, best "
                             f"{trainer.metrics}; test mIoU {miou}")
    dropped = ("dropping train-only entries not in the eval model" in printed
               and all(e in printed for e in DROPPED_ENTRIES.get(name, ())))
    if dropped != (heads > 1):
        raise AssertionError(f"test --model {name}: the train-only head's "
                             f"entries dropped: {dropped}")
    evals = 2 * -(-CLI_VAL // ROOT_BATCH)  # the epoch's eval, the test CLI's
    want = {"upsample_argmax": 2,   # each eval's first-batch picture
            "softmax_ce": {"fwd": heads * micro + evals,
                           "bwd": heads * micro},
            "banded_resample": 2 * micro, "eval_confusion": evals,
            "fused_matmul_bn": {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}}
    if launches != want:
        raise AssertionError(f"{name} cli launches {launches}, want {want}")
    epoch = [r for r in records if "steps" in r][0]
    checks = cli_kernel_checks(name, kept)
    return launches, {"train_argv": train_argv, "test_argv": test_argv,
                      "kernels_against_plain": checks,
                      "train_s": train_s, "test_s": test_s,
                      "epoch_loss": epoch["loss"],
                      "ms_per_step": 1e3 * epoch["seconds"] / epoch["steps"],
                      "val_miou": trainer.metrics, "tested": tested,
                      "test_dropped_train_only_head": dropped,
                      "test_miou": miou}


def families_phase(device):
    """UNet (MobileNetV2), HRNet-W32, FPN-R50, DANet, LR-ASPP
    (MobileNetV3-Large), SegFormer-B0, UPerNet-R50, Segmenter-B/16,
    UPerNet-Swin-T, BiSeNetV2, OCRNet-W32, SegNeXt-T and MaskFormer-R50 at
    512x512, PSPNet, FastFCN, FCN and DeepLabV3 at 513x513 (each with its
    aux heads in training but LR-ASPP, UNet, HRNet, FPN, SegFormer,
    Segmenter, SegNeXt and MaskFormer), 21 classes, bf16 compute over f32
    parameters (Segmenter's and SegNeXt's logits f32, MaskFormer's scores
    f32), seeded weights: served at batch 8 (kernel 1), trained at batch 32
    (kernel 2; once a step for each head: twice for PSPNet, FastFCN, FCN,
    DeepLabV3, both UPerNets and OCRNet, three times for DANet, five for
    BiSeNetV2, never for MaskFormer, whose set criterion runs the Sinkhorn
    matcher), evaluated over 64 images (kernels 2 and 3); UNet, PSPNet,
    DANet, UPerNet and MaskFormer trained again with the fused 1x1 switch on
    (kernel 5 on UNet's 16 expand and 16 project products and on
    ResNet-50's 16 conv1 and 16 conv3, each distinct (N, K, M, act) held
    against the plain versions); FPN-R34, FCN-R101, SegFormer-B2,
    UPerNet-MiT-B0, SegNeXt-B and OCRNet-W48 serve one batch,
    UPerNet-ConvNeXt-T and UPerNet-ViT-B/16 serve one batch and take one
    train step; SegFormer-B2 with scan_blocks=True serves one batch and
    takes one step (`scan_entry`); MaskFormer takes HUNGARIAN_STEPS steps
    with the Hungarian matcher; each kernel at each family's shape and
    dtype (and kernels 2 and 3 at each aux head's other stride) on random
    inputs for its times, once a shape; SegFormer's, Swin-T's and the ViT's
    blocks timed alone; then the train command line with the root defaults
    (UNet), with `--model pspnet --aux-loss 0.4 -s 321 321`, `--model fcn
    ...`, `--model upernet ...`, `--model segmenter -s 320 320`, `--model
    bisenetv2 --aux-loss 0.4 -s 320 320` and `--model maskformer -s 320
    320 -bs 32 -a 1`, and the test command line on the checkpoint each
    wrote, kernels 1-4 held against their plain versions on tensors those
    runs handed them.
    Returns each kernel's launches over the phase's main-path runs (in all
    and by model), each family's kernel figures and each fused shape's."""
    t_phase = time.perf_counter()
    eval_sets = {hw: MemoryDataset(FAMILY_EVAL_IMAGES,
                                   np.random.default_rng(SEED + 8), hw=hw)
                 for hw in sorted(set(FAMILY_IMGS.values()))}

    def zeros():
        return {"upsample_argmax": 0, "softmax_ce": {"fwd": 0, "bwd": 0},
                "eval_confusion": 0, "banded_resample": 0,
                "fused_matmul_bn": {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}}

    total, by_model = zeros(), {}

    def add(launches, model):
        for counts in (total, by_model.setdefault(model, zeros())):
            for key, value in launches.items():
                if isinstance(value, dict):
                    for k, v in value.items():
                        counts[key][k] += v
                else:
                    counts[key] += value

    cases, trained = {}, {}
    cased = {}   # (shape, dtype, align) -> the family whose cases ran it

    def kernel_cases(name, low, hw, dtype, align, aux=False):
        """Kernels 1-3 (2-3 for an aux head's shape) on random logits of a
        family's shapes, once for each (shape, dtype, align): a later
        family with the same ones reuses the figures."""
        key = (aux, low, hw, dtype, align)
        if key in cased:
            return cased[key]
        out_hw = (hw, hw)
        tag = f"{name}_aux" if aux else name
        shape = (BATCH, low, low, NUM_CLASSES)
        figures = {} if aux else {"upsample_argmax": kernel_case(
            f"{tag}_argmax", shape, out_hw, dtype, align, device)}
        shape = (TRAIN_BATCH, low, low, NUM_CLASSES)
        figures["softmax_ce"] = ce_case(f"{tag}_ce", shape, out_hw, dtype,
                                        align, device, nchw=True)
        figures["eval_confusion"] = eval_case(
            f"{tag}_eval", (EVAL_BATCH,) + shape[1:], out_hw, dtype, align,
            device, nchw=True,
            ties_allowed=not aux and name in NEAR_TIE_FAMILIES)
        cased[key] = figures
        return figures

    for name, hw in FAMILY_IMGS.items():
        t0 = time.perf_counter()
        serve_launches, serve = serve_phase(device, name, hw)
        add({"upsample_argmax": serve_launches}, name)
        train_launches, trained[name], model, _ = family_train(device, name)
        add(train_launches, name)
        eval_launches, evaluation = family_eval(device, name, model,
                                                eval_sets[hw])
        add(eval_launches, name)
        low = -(-hw // model.output_stride)
        align = model.up_align_corners
        if name == "danet":
            trained[name]["attention"] = danet_attention_ms(
                model, hw, min(trained[name]["ms_per_step_wall"]))
        blocks_ms = {"segformer": segformer_blocks_ms,
                     "upernet_swin": swin_blocks_ms,
                     "segmenter": vit_blocks_ms}.get(name)
        if blocks_ms:
            trained[name]["blocks"] = blocks_ms(
                model, hw, min(trained[name]["ms_per_step_wall"]))
        del model
        # the logits' own dtype: bf16, but f32 for Segmenter
        dtype = getattr(torch, serve["logits_dtype"])
        cases[name] = kernel_cases(name, low, hw, dtype, align)
        aux_shape = trained[name].get("aux_logits")
        if aux_shape and aux_shape[2] != low:
            # FastFCN's and UPerNet's 16x aux logits (align True and False)
            cases[f"{name}_aux"] = kernel_cases(name, aux_shape[2], hw,
                                                dtype, align, aux=True)
        log("family", model=name, img=hw, classes=NUM_CLASSES,
            train_kwargs=FAMILY_KWARGS.get(name, {}), serve=serve,
            train=trained[name], eval=evaluation,
            launches={"serve": serve_launches, "train": train_launches,
                      "eval": eval_launches},
            seconds=time.perf_counter() - t0)
    for name, variant in ONE_BATCH_VARIANTS:
        add({"upsample_argmax": serve_one_batch(
            device, name, variant, FAMILY_IMGS[name])}, f"{name}_{variant}")
    for key in ONE_STEP_FAMILIES:
        name, variant = FAMILY_VARIANTS[key]
        add({"upsample_argmax": serve_one_batch(device, name, variant,
                                                ONE_STEP_IMG),
             **train_one_step(device, key)}, key)
    for key in SCAN_ENTRIES:
        add(scan_entry(device, key), key)
    if "maskformer" in trained:
        add(hungarian_steps(device, min(
            trained["maskformer"]["ms_per_step_wall"])),
            "maskformer_hungarian")

    fused_shapes = {}
    for name, n_shapes in FUSED_FAMILIES.items():
        t0 = time.perf_counter()
        fused_launches, fused, _, shapes = family_train(
            device, name, plain=trained[name])
        add(fused_launches, name)
        if len(shapes) != n_shapes:
            raise AssertionError(f"{name}: {len(shapes)} distinct fused "
                                 f"shapes: {shapes}")
        for n, k, m, act in shapes:
            fused_shapes[f"{name}_{n}x{k}x{m}_{act}"] = fused_case(
                f"{name}_fused_{n}_{k}_{m}_{act}", n, k, m, torch.bfloat16,
                act, device, reps=3)
        off = trained[name]
        log("family_fused", model=name, switch_on=fused,
            switch_off={key: off[key] for key in (
                "first_loss", "ms_per_step_wall", "ms_per_step_cuda_events",
                "images_per_s", "peak_memory_mb")},
            launches=fused_launches, launches_per_step=FUSED_PER_STEP,
            distinct_shapes=[list(s) for s in shapes],
            seconds=time.perf_counter() - t0)

    for name in FAMILY_CLIS:
        t0 = time.perf_counter()
        cli_launches, cli = family_cli(device, name)
        add(cli_launches, name)
        log("family_cli", model=name, **cli, launches=cli_launches,
            seconds=time.perf_counter() - t0)
    log("families", seconds=time.perf_counter() - t_phase, launches=total,
        launches_by_model=by_model)
    return total, by_model, cases, fused_shapes


def only_families(keys):
    """Cut the families phase's tables down to the entries `keys` (a
    model's one-batch variants, fused run and command line go with it)."""
    global FAMILY_IMGS, ONE_BATCH_VARIANTS, ONE_STEP_FAMILIES
    global FUSED_FAMILIES, FAMILY_CLIS, SCAN_ENTRIES
    unknown = (set(keys) - set(FAMILY_IMGS) - set(ONE_STEP_FAMILIES)
               - set(SCAN_ENTRIES))
    if unknown:
        raise SystemExit(f"--families: unknown entries {sorted(unknown)}")
    FAMILY_IMGS = {k: v for k, v in FAMILY_IMGS.items() if k in keys}
    ONE_BATCH_VARIANTS = tuple(p for p in ONE_BATCH_VARIANTS
                               if p[0] in keys)
    ONE_STEP_FAMILIES = tuple(k for k in ONE_STEP_FAMILIES if k in keys)
    SCAN_ENTRIES = tuple(k for k in SCAN_ENTRIES if k in keys)
    FUSED_FAMILIES = {k: v for k, v in FUSED_FAMILIES.items() if k in keys}
    FAMILY_CLIS = {k: v for k, v in FAMILY_CLIS.items() if k in keys}


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
    parser.add_argument("--families", nargs="+", metavar="KEY",
                        help="after the builds, run only the families phase "
                             "for these FAMILY_IMGS entries (their one-batch "
                             "variants, fused runs and command lines too) "
                             "and stop: no kernels line, no last line")
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

    def build_native(load):  # the polygon fill and colour map; the codec
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    names = ("upsample_argmax", "softmax_ce", "banded_resample",
             "eval_confusion", "fused_matmul_bn")
    with ThreadPoolExecutor(len(names) + 2) as pool:
        native_seconds = pool.submit(build_native, native.lib)
        codec_seconds = pool.submit(build_native, native.jpeg_lib)
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
        log("build", kernel="pseg_native", compiler="g++",
            seconds=native_seconds.result(),
            flags=" ".join(native.CXX_FLAGS))
        log("build", kernel="jpeg_codec", compiler="g++",
            seconds=codec_seconds.result(),
            flags=" ".join(native.JPEG_CXX_FLAGS))
    if args.families:
        only_families(args.families)
        families_phase(device)
        return
    jpeg_phase()

    path = kernel_case("path_bf16", (BATCH, 129, 129, NUM_CLASSES),
                       (IMG, IMG), torch.bfloat16, True, device)
    kernel_case("path_f32", (BATCH, 129, 129, NUM_CLASSES), (IMG, IMG),
                torch.float32, True, device)
    kernel_case("path_bf16_nchw", (BATCH, 129, 129, NUM_CLASSES), (IMG, IMG),
                torch.bfloat16, True, device, nchw=True)
    kernel_case("ragged_c150", (2, 65, 97, 150), (257, 385), torch.bfloat16,
                False, device, tie=(3, 7))
    # bands of one row, column tiles and class chunks, each pixel's (best,
    # pred) carried from chunk to chunk
    chunked = (1, 4, 3000, 150)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ua.argmax_plan(*chunked, 6, 300, True, 4, sms)
    if not (len(plan.bands) > 1 and len(plan.tiles) > 1
            and plan.chunk < chunked[-1]):
        raise AssertionError(f"{chunked} -> (6, 300): argmax plan "
                             f"{len(plan.bands)} bands, {len(plan.tiles)} "
                             f"tiles, chunks of {plan.chunk}")
    kernel_case("chunks_c150", chunked, (6, 300), torch.float32, True, device,
                tie=(3, 7))

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
    # 45 rows in bands of 4 (the last of 1), 97 classes in chunks of
    # 25, 25, 25, 22
    ce_case("ce_ragged_bands_c97", (TRAIN_BATCH, 45, 37, 97), (177, 145),
            torch.float32, False, device)
    # 200 columns in two tiles of 100: the backward's halo columns and its
    # cut of each tile's output columns
    tiled = (2, 33, 200, NUM_CLASSES)
    if len(ce.bwd_plan(*tiled, 129, 797, True, 2).tiles) < 2:
        raise AssertionError(f"{tiled} -> 797 columns: one column tile")
    ce_case("ce_column_tiles_w200", tiled, (129, 797), torch.bfloat16, True,
            device)
    # the forward's bands of one row, 18 column tiles and 4 chunks of 36-38
    # classes, the state of each pixel carried from chunk to chunk
    plan = ce.fwd_plan(*chunked, 6, 300, True, 4, sms)
    if not (len(plan.bands) > 1 and len(plan.tiles) > 1
            and plan.chunk < chunked[-1]):
        raise AssertionError(f"{chunked} -> (6, 300): forward plan "
                             f"{len(plan.bands)} bands, {len(plan.tiles)} "
                             f"tiles, chunks of {plan.chunk}")
    ce_case("ce_fwd_chunks_c150", chunked, (6, 300), torch.float32, True,
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
    launches, _ = serve_phase(device, jpeg_bodies=True)
    eval_set = dataset.first(EVAL_IMAGES)
    ce_launches, ce_strides, train_figures, trained = train_phase(
        device, eval_set, profile=args.profile)
    eval_launches = eval_phase(device, trained, eval_set,
                               profile=args.profile)
    del trained
    resample_launches, e2e_ms_per_step = augment_phase(
        device, dataset, train_figures["images_per_s"],
        resample_path.pop("pass_ms"), profile=args.profile)
    cli_launches = cli_phase(device, e2e_ms_per_step)
    fused_launches = train_fused_phase(device, train_figures,
                                       profile=args.profile)
    family_launches, family_by_model, family_cases, family_fused = (
        families_phase(device))

    def by_model(kernel, part=None):
        """The kernel's launches in each family's main-path runs."""
        return {model: (v[kernel] if part is None else v[kernel][part])
                for model, v in family_by_model.items()}
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
        # ms: the wrapper call; device_ms: _launch with calls queued
        # behind a sleep kernel
        {"name": "upsample_argmax", "route": "cuda",
         "source": "pytorch_segmentation_tpu_torch/csrc/upsample_argmax.cu",
         "replaces":
             "pytorch_segmentation_tpu/ops/pallas/upsample_argmax.py:31",
         "design": "argmax_band_kernel: the eval kernel's layout (a band of "
                   "output rows and a tile of output columns a block, the "
                   "source rows staged by stage_band, each output row "
                   "interpolated along H once per staged column and class, "
                   "a thread per output column, the shared band_argmax "
                   "loop), one coalesced int32 store a pixel; the gather "
                   "kernel's arithmetic (mask bit-equal)",
         "launches": launches,
         "cli_launches": cli_launches["upsample_argmax"],
         "families_launches": family_launches["upsample_argmax"],
         "families_launches_by_model": by_model("upsample_argmax"),
         "families": {name: c["upsample_argmax"]
                      for name, c in family_cases.items() if "upsample_argmax" in c}, **path},
        # ms: the wrapper call; kernel_ms: _launch_fwd alone, with lse
        {"name": "softmax_ce_fwd", "route": "cuda", "source": ce_source,
         "replaces": ce_replaces,
         "design": "ce_fwd_band_kernel: a band of output rows and a tile "
                   "of output columns a block, the source rows they read "
                   "staged in shared memory, each output row interpolated "
                   "along H once per staged column and class, a thread per "
                   "output column, the gather kernel's arithmetic (lse "
                   "bit-equal), no atomics",
         "launches": ce_launches["fwd"],
         "cli_launches": cli_launches["softmax_ce"]["fwd"],
         "families_launches": family_launches["softmax_ce"]["fwd"],
         "families_launches_by_model": by_model("softmax_ce", "fwd"),
         "families": {name: c["softmax_ce"]["fwd"]
                      for name, c in family_cases.items()}, **ce_path["fwd"]},
        # ms: the backward through autograd; kernel_ms: the kernel alone on
        # the forward's saved tensors
        {"name": "softmax_ce_bwd", "route": "cuda", "source": ce_source,
         "replaces": ce_replaces,
         "design": "ce_bwd_band_kernel: a band of source rows staged in "
                   "shared memory (16-byte loads for channels-last logits), "
                   "each output pixel's softmax term computed once per band "
                   "and class, gathered in the matrix product's order, no "
                   "atomics",
         "launches": ce_launches["bwd"],
         "cli_launches": cli_launches["softmax_ce"]["bwd"],
         "families_launches": family_launches["softmax_ce"]["bwd"],
         "families_launches_by_model": by_model("softmax_ce", "bwd"),
         "families": {name: c["softmax_ce"]["bwd"]
                      for name, c in family_cases.items()}, **ce_path["bwd"]},
        # ms, device_ms, plain_ms and bound_ms: per launch, the mean of the
        # two passes
        {"name": "banded_resample", "route": "cuda",
         "source": "pytorch_segmentation_tpu_torch/csrc/banded_resample.cu",
         "replaces":
             "pytorch_segmentation_tpu/ops/pallas/banded_resample.py:60",
         "design": "the first port's gather, kept: a thread per output "
                   "position, a block of 32 output columns x 8 rows, both "
                   "passes (the second on the transposed view through its "
                   "strides); staged-tile and transposed-tile variants "
                   "measured no faster; bit-equal to the plain version",
         "launches": resample_launches,
         "cli_launches": cli_launches["banded_resample"],
         "families_launches": family_launches["banded_resample"],
         "families_launches_by_model": by_model("banded_resample"),
         **resample_path},
        # ms: the wrapper call; kernel_ms: _launch (the zeroed count buffer
        # and the kernel)
        {"name": "eval_confusion", "route": "cuda",
         "source": "pytorch_segmentation_tpu_torch/csrc/eval_confusion.cu",
         "replaces":
             "pytorch_segmentation_tpu/ops/pallas/eval_confusion.py:29",
         "design": "eval_band_kernel: a band of output rows and a tile of "
                   "output columns a block, the source rows they read "
                   "staged in shared memory (stage_band), each output row "
                   "interpolated along H once per staged column and class, "
                   "a thread per output column, the gather kernel's "
                   "arithmetic and select-form argmax (counts equal), "
                   "warp-grouped shared-memory counts",
         "launches": eval_launches["eval_confusion"],
         "cli_launches": cli_launches["eval_confusion"],
         "families_launches": family_launches["eval_confusion"],
         "families_launches_by_model": by_model("eval_confusion"),
         "families": {name: c["eval_confusion"]
                      for name, c in family_cases.items() if "eval_confusion" in c}, **eval_path},
        # ms, plain_ms, bound_ms, library_ms at (N, K, M) = `shape`, a
        # stage-1 shape of the step; `second_shape` has a stage-4 shape's
        {"name": "fused_matmul_bn_fwd", "route": "cuda",
         "source": fused_source, "replaces": fused_replaces + "91",
         "design": "hop::fwd_wgmma_kernel: TMA ring + wgmma, A = x K-major "
                   "through the prologue in shared memory",
         "launches": fused_launches["fwd"],
         "families_launches": family_launches["fused_matmul_bn"]["fwd"],
         "families_launches_by_model": by_model("fused_matmul_bn", "fwd"),
         "families_shapes": len(family_fused), **fused_path["fwd"]},
        {"name": "fused_matmul_bn_bwd_dx", "route": "cuda",
         "source": fused_source, "replaces": fused_replaces + "117",
         "design": "hop::dx_dy_tot_wgmma_kernel + hop::dx_dz_wgmma_kernel: "
                   "two full grids, K-major operands",
         "launches": fused_launches["bwd_dx"],
         "families_launches": family_launches["fused_matmul_bn"]["bwd_dx"],
         "families_launches_by_model": by_model("fused_matmul_bn", "bwd_dx"),
         "families_shapes": len(family_fused), **fused_path["bwd_dx"]},
        {"name": "fused_matmul_bn_bwd_dw", "route": "cuda",
         "source": fused_source, "replaces": fused_replaces + "156",
         "design": "hop::dw_wgmma_kernel: TMA ring + wgmma, A = z^T and "
                   "B = dy_tot MN-major, N split over blocks (dw_split), "
                   "f32 partials summed by partials.sum(0)",
         "launches": fused_launches["bwd_dw"],
         "families_launches": family_launches["fused_matmul_bn"]["bwd_dw"],
         "families_launches_by_model": by_model("fused_matmul_bn", "bwd_dw"),
         "families_shapes": len(family_fused), **fused_path["bwd_dw"]},
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
