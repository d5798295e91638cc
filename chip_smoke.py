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
`inference()` in the same process; the host's records/s beside), runs the
train CLI's losses and extras (`losses`: every `--loss` choice and the CE
with class weights, label smoothing and OHEM held against the CPU on the
same f32 logits and trained for 4 steps beside the default CE, CutMix and
Mosaic bit-equal to the CPU, end to end from u8 batches through
PostFetch(mix_fn=..., augment_fn=...), distillation from a seeded
SegFormer-B0 `.pt` teacher, the `train` command line with every loss, mix
and distillation flag on the cli phase's set, then `test`), runs the path on
non-square frames (`nonsquare`: H x W = 512 x 1024, the Cityscapes crop,
batch 16; the policy of every AugmentConfig option on the card against the
CPU, none launching the row resampler; the train step alone; `test()` over
32 images and one served batch of 8; end to end from u8 host batches
through the gather warp and the rectangular filter; kernels 1-3 at the
path's shapes; `train -s 1024 512 -bs 16` on the cli phase's set, then
`test`, and `train --fast-augment`), runs its int8 path (`int8`, quant.py:
the int8dyn forward at batch 8 with every distinct quantized layer shape
held bit for bit against the host, calibration, make_quant_mask_fn on the
card against the CPU, a MaskServer(int8=True) burst of PNG and JPEG bodies
and an int8 + flip-TTA request, `test(int8=True)` and `test(quant_stats=)`
over 80 images, Trainer(qat=True) beside the plain Trainer, two QAT steps
with the fused 1x1 switch on, `train --qat`, `test --int8 --calib-batches
2`, `inference --int8 --calib` and `serve --int8`'s server; the int8
products against cuDNN's bf16 convolutions at the same shapes), runs it
data-parallel (`dp`, parallel/: under `torch.distributed.run` with one
process and NCCL over loopback, the Trainer with the fused 1x1 switch off
and on, with ZeRO, `test()` and MaskServer through `make_mesh()`, bit-equal
to the same run without a mesh, each step's ms without and with the mesh,
and `train --zero` for 2 steps; then two gloo ranks on the one card at
batch 16 each against one process at batch 32, replicated, under ZeRO and
with remat, with each rank's peak memory), recomputes activations and takes
the train step's other options (`remat`, ROADMAP queue 1 item 5:
DeepLabV3+ with remat off and on, the fused 1x1 switch off and on, the
remat steps bit-equal to the plain ones under cuDNN's deterministic
algorithms and kernel 5's forward launched again in the recompute, QAT
with remat bit-equal to QAT, each run's ms a step and peak memory, BN
statistics from every second pixel and the debug-NaN switch beside the
plain step, a NaN image raising under the switch, Segmenter-B/16 with
remat off and on), and then
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
                                     # the train step (switch off and on,
                                     # and with remat), the eval step and
                                     # the augmentation
    python3 chip_smoke.py --families maskformer segformer_scan
                                     # the builds, then the families phase
                                     # for these entries alone
    python3 chip_smoke.py --losses   # the builds, then the losses phase
                                     # alone, on a set of its own
    python3 chip_smoke.py --nonsquare
                                     # the builds, then the nonsquare
                                     # phase alone, on a set of its own
    python3 chip_smoke.py --int8     # the builds, then the int8 phase
                                     # alone, on a set of its own
    python3 chip_smoke.py --dp       # the builds, then the dp phase alone
    python3 chip_smoke.py --remat    # the builds, then the remat phase
                                     # and the dp phase's two gloo ranks

Every phase prints one line; any failure raises, so the exit code is not 0.
The line before the last is a JSON object with each kernel's launches on its
main-path run (serving, training, evaluation, training end to end, training
with the fused 1x1 switch on, or the layout benchmark) and, for the four it
runs, on the command lines' run (`cli_launches`), on the losses phase's
runs (`losses_launches`), on the nonsquare phase's runs
(`nonsquare_launches`, every kernel; kernels 1-3's figures at its shapes
under `nonsquare`), on the int8 phase's runs (`int8_launches`, every
kernel), on the dp phase's world-1 mesh runs (`dp_launches`), on the remat
phase's remat steps with the fused switch on (`remat_launches`, kernels 2
and 5), on the
families phase's runs (`families_launches`, and by model in `families_launches_by_model`,
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
import dataclasses
import gc
import json
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
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
from pytorch_segmentation_tpu_torch.data.mix import make_mix_fn
from pytorch_segmentation_tpu_torch.data.pipeline import (PostFetch,
                                                          normalize_images)
from pytorch_segmentation_tpu_torch.data.rasterize import (
    rasterize_annotations)
from pytorch_segmentation_tpu_torch.data.resize_host import resize_u8
from pytorch_segmentation_tpu_torch.engine import test as run_eval
from pytorch_segmentation_tpu_torch.engine.checkpoint import (
    load_model_bundle, save_checkpoint)
from pytorch_segmentation_tpu_torch.engine.steps import (make_eval_step,
                                                         nhwc_forward,
                                                         require_eval_mode)
from pytorch_segmentation_tpu_torch.engine.trainer import Trainer
from pytorch_segmentation_tpu_torch.inference import (_tile_offsets,
                                                      make_infer_fn,
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
from pytorch_segmentation_tpu_torch.ops.int8 import (int8_conv2d,
                                                     int8_conv2d_plain)
from pytorch_segmentation_tpu_torch.ops.loss import (LOSSES, build_loss,
                                                    compute_loss)
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
from pytorch_segmentation_tpu_torch.parallel import (initialize_distributed,
                                                     make_mesh, shard_batch)
from pytorch_segmentation_tpu_torch.quant import (calibrate,
                                                  calibrate_from_u8,
                                                  make_quant_mask_fn,
                                                  quantized_forward)
from pytorch_segmentation_tpu_torch.serving import MaskServer
from pytorch_segmentation_tpu_torch.tools import bench_cmajor
# device ms of a call without the host's enqueue: calls queued behind a
# sleep kernel
from pytorch_segmentation_tpu_torch.tools.bench_eval_confusion import (
    queued_ms)
from pytorch_segmentation_tpu_torch.utils import imgcodecs, jpeg, png
from pytorch_segmentation_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
from pytorch_segmentation_tpu_torch.utils.png import decode_png, encode_png
from pytorch_segmentation_tpu_torch.utils.runtime import (debug_nans,
                                                          require_cuda)
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
    """The default policy on a small square batch: `augment_card_check`,
    the two-pass warp through the row resampler (2 launches)."""
    augment_card_check(device, "default_65x65", taug.AugmentConfig(), 8,
                       (65, 65), 2)


def augment_card_check(device, name, config, b, hw, resample_launches):
    """The policy `config` on a u8 batch [b, *hw], its parameters drawn once
    (on the CPU) and applied on the card (kernels) and on the CPU (plain
    versions): see AUG_* above for the bounds and their reason. The card's
    apply must launch the row resampler `resample_launches` times: 2 on the
    square two-pass warp, 0 on every path that bypasses it."""
    h, w = hw
    rng = np.random.default_rng(SEED + 5)
    imgs = torch.from_numpy(np.stack([smooth_image(rng, h, w)
                                      for _ in range(b)]))
    segs = resize_nearest(torch.from_numpy(rng.integers(
        1, NUM_CLASSES, (b, 5, 5)).astype(np.uint8)), (h, w))
    fn = taug.make_augment_fn(config)
    params = fn.draw(torch.Generator().manual_seed(SEED), b, h, w)
    t0 = time.perf_counter()
    cpu_img, cpu_seg = fn.apply(params, imgs, segs)
    cpu_s = time.perf_counter() - t0
    before = br.launch_count()
    gpu_img, gpu_seg = fn.apply(to_device(params, device), imgs.to(device),
                                segs.to(device))
    launches = br.launch_count() - before
    if launches != resample_launches:
        raise AssertionError(f"{name}: the policy on the card launched the "
                             f"resampler {launches} times, not "
                             f"{resample_launches}")
    gpu_img, gpu_seg = gpu_img.cpu(), gpu_seg.cpu()
    label_share = float((gpu_seg != cpu_seg).float().mean())
    diff = (gpu_img - cpu_img).abs()
    image_share, image_mean = float((diff > 0).float().mean()), float(
        diff.mean())
    if not (label_share <= AUG_LABEL_SHARE and image_share <= AUG_IMAGE_SHARE
            and image_mean <= AUG_IMAGE_MEAN):
        raise AssertionError(
            f"{name}: labels differ on {label_share}, image elements on "
            f"{image_share} (mean {image_mean}, max {float(diff.max())})")
    if torch.equal(cpu_img, imgs.float()) or len(cpu_seg.unique()) < 3:
        raise AssertionError(f"{name}: the drawn policy changed nothing")
    log("small_augment", case=name, shape=[b, h, w],
        config={f.name: getattr(config, f.name)
                for f in dataclasses.fields(config)
                if getattr(config, f.name) != f.default},
        warp=taug._warp(config, h, w), resample_launches=launches,
        labels_differing_share=label_share,
        image_elements_differing_share=image_share,
        image_mean_abs_diff=image_mean, image_max_abs_diff=float(diff.max()),
        cpu_apply_s=cpu_s, gates_per_sample=params["gates"].sum(1).tolist(),
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


def serve_phase(device, name="deeplabv3plus", img=IMG, jpeg_bodies=False,
                int8=False):
    """`name` (bf16, seeded weights, its stride-`output_stride` logits)
    behind MaskServer at batch 8 (with `int8`, MaskServer(int8=True): the
    int8 forward with dynamic scales, and make_quant_mask_fn where
    make_mask_fn stands below): a burst of 12 requests from threads (10 at
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
    server = MaskServer(model, img_size=hw, max_batch=BATCH, int8=int8)
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
    mask_fn = (make_quant_mask_fn(model, out_hw=hw) if int8
               else make_mask_fn(model, out_hw=hw))
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
    log("int8_serve" if int8 else "serve", model=name, img=img,
        requests=len(imgs), **figures,
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


def eval_report(model, dataset, device, tmp, batch=EVAL_BATCH, **options):
    """`test()` over `dataset` at `batch` (bf16 images, no augmentation, the
    last batch padded): the mIoU and the parsed report."""
    fetcher = Fetcher(DataLoader(dataset, batch),
                      PostFetch(dtype=torch.bfloat16, device=device))
    path = os.path.join(tmp, "report.json")
    miou = run_eval(model, fetcher, log=False, report_path=path,
                    device=device, **options)
    with open(path) as f:
        return miou, json.load(f)


def train_batch(device, hw=IMG, batch=TRAIN_BATCH):
    """The train phases' fixed batch: `batch` smooth u8 images at hw x hw
    (or an (h, w) pair) and, as labels, a 9x9 grid of classes per image,
    nearest-upsampled. Returns the u8 images (host) and the (images, segs,
    valid) batch on the card: loading is not part of the train-step
    slices."""
    h, w = (hw, hw) if isinstance(hw, int) else hw
    rng = np.random.default_rng(SEED + 4)
    imgs_u8 = np.stack([smooth_image(rng, h, w) for _ in range(batch)])
    grid = torch.from_numpy(rng.integers(0, NUM_CLASSES,
                                         (batch, 9, 9)).astype(np.int32))
    segs = resize_nearest(grid, (h, w))
    if len(torch.unique(segs)) < 3:
        raise AssertionError("labels have fewer than 3 classes")
    return imgs_u8, (normalize_images(torch.from_numpy(imgs_u8).to(device)),
                     segs.to(device), batch)


def family_model(key, **kwargs):
    """The model of a family entry (`FAMILY_VARIANTS`' model and
    `--variant` where the key names one, else the model `key` at its
    defaults) with NUM_CLASSES classes; `kwargs` to its constructor."""
    name, variant = FAMILY_VARIANTS.get(key, (key, ""))
    return build_model(name, NUM_CLASSES, **variant_kwargs(name, variant),
                       **kwargs)


def make_trainer(device, name, batch, tmp, loss_fn=compute_loss, weights="",
                 mesh=None, zero=False, qat=False, **model_kwargs):
    """`family_model(name)` (bf16 compute over f32 parameters,
    full_res_output=True, so the Trainer's deferred upsample routes the loss
    through the upsample+CE kernels; `model_kwargs` to its constructor) in a
    Trainer on one fixed batch, SGD 1e-3 with momentum 0.9, the aux head's
    loss at the Trainer's default weight, from the seeded start: the same
    weights on every call. `loss_fn` replaces the CE (MaskFormer's set
    criterion: no deferred upsample then); `weights` is a checkpoint to
    start from; `mesh`, `zero` and `qat` the Trainer's."""
    model = family_model(name, dtype=torch.bfloat16, full_res_output=True,
                         **model_kwargs)
    trainer = Trainer(model, RepeatFetcher(batch, 1), loss_fn=loss_fn,
                      weights=weights, workdir=os.path.join(tmp, "w"),
                      lr=1e-3, momentum=0.9, seed=SEED, log=False,
                      log_dir=os.path.join(tmp, "runs"), device=device,
                      mesh=mesh, zero=zero, qat=qat)
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
    as labels, a 9x9 grid of classes per image, nearest-upsampled. `hw` is
    a side or an (h, w) pair."""

    def __init__(self, n, rng, hw=IMG, num_classes=NUM_CLASSES):
        h, w = (hw, hw) if isinstance(hw, int) else hw
        self.classes = [f"class{i}" for i in range(num_classes)]
        self.images = np.stack([smooth_image(rng, h, w) for _ in range(n)])
        grid = torch.from_numpy(rng.integers(0, num_classes,
                                             (n, 9, 9)).astype(np.uint8))
        self.segs = resize_nearest(grid, (h, w)).numpy()

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


def add_launches(total, counts):
    """Add a run's launch counts (nested per kernel part) into `total`."""
    for k, v in counts.items():
        if isinstance(v, dict):
            for part, n in v.items():
                total[k][part] += n
        else:
            total[k] += v


def kernel_counts():
    return {"upsample_argmax": ua.launch_count(),
            "softmax_ce": ce.launch_count(),
            "banded_resample": br.launch_count(),
            "eval_confusion": ec.launch_count()}


def reset_kernel_counts():
    for kernel in (ua, ce, br, ec):
        kernel.reset_launch_count()


def augment_phase(device, dataset, train_images_per_s, resample_pass_ms,
                  profile=False, batch_size=TRAIN_BATCH,
                  phase="augment_train"):
    """The end-to-end train path at full width: u8 host batches from the
    in-memory dataset -> DataLoader(batch_size, shuffle, drop_last) ->
    Fetcher (a producer thread) -> PostFetch(default AugmentConfig, bf16) ->
    Trainer.step(). One warm-up epoch whose batches are checked, then timed
    epochs, each synchronised at its end. The row resampler must launch
    twice a batch on square frames (the two-pass warp) and never on others
    (the gather samplers). Returns the main path's launches of the
    resampler and the CE kernels, and its ms per step end to end."""
    n_batches = len(dataset) // batch_size
    h, w = dataset.images.shape[1:3]
    resample_per_step = 2 if h == w else 0
    fn = taug.make_augment_fn(taug.AugmentConfig())
    post = PostFetch(fn, dtype=torch.bfloat16, seed=SEED, device=device)

    # the augmentation alone on one host batch: device time (CUDA events,
    # the copy to the card included), host time to enqueue it, and both
    # together with a synchronise at the end
    batch = next(iter(DataLoader(dataset, batch_size)))
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
        profile_table("profile_" + phase, lambda: post(batch), 3)

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

    loader = DataLoader(dataset, batch_size, shuffle=True, drop_last=True,
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
    if (steps != 4 * n_batches
            or resample_launches != resample_per_step * steps):
        raise AssertionError(f"{steps} steps, {resample_launches} resampler "
                             f"launches: not {resample_per_step} per batch")
    if ce_launches != {"fwd": steps, "bwd": steps}:
        raise AssertionError(f"{steps} steps launched {ce_launches}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"end-to-end epoch losses {losses}")
    best = min(epoch_ms) / n_batches
    log(phase, batch=batch_size, image_hw=[h, w], steps=steps,
        epoch_mean_losses=losses,
        images_per_s_end_to_end=1e3 * batch_size / best,
        ms_per_step_end_to_end=[ms / n_batches for ms in epoch_ms],
        images_per_s_train_only=train_images_per_s,
        augment_ms_per_batch_cuda_events=statistics.median(event_ms),
        augment_ms_per_batch_host_enqueue=statistics.median(enqueue_ms),
        augment_ms_per_batch_wall=statistics.median(wall_ms),
        resample_kernel_ms_per_pass=resample_pass_ms,
        augment_peak_memory_mb=augment_peak_mb, peak_memory_gb=peak_gb,
        resample_launches=resample_launches, ce_launches=ce_launches)
    return ({"banded_resample": resample_launches,
             "softmax_ce": ce_launches},
            [ms / n_batches for ms in epoch_ms])


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


def cli_phase(device, e2e_ms_per_step, tmp):
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
    to `inference()`'s on the same batches. Kernels 1-4 must all launch.
    `tmp`: the directory the set (`tmp/coco`) and the CLIs' outputs go to,
    the caller's, so that the losses phase trains on the same set."""
    from pytorch_segmentation_tpu_torch import inference as infer_cli
    from pytorch_segmentation_tpu_torch import test as test_cli
    from pytorch_segmentation_tpu_torch import train as train_cli
    from pytorch_segmentation_tpu_torch.data import CocoDataset

    with working_dir(tmp):
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
        reset_kernel_counts()
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
        launches = kernel_counts()

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


# the losses phase (train --loss / --cutmix / --mosaic / --distill*): each
# loss and its gradient on the card against the CPU on the same f32 logits.
# The loss to LOSS_CARD_RTOL (sums of 10^7 terms in another order; Dice's
# per-class sums are atomic adds on the card), the gradient elementwise to
# LOSS_GRAD_SHARE of its largest entry on the CPU, except on at most
# LOSS_GRAD_MISMATCH of the elements: a pixel whose true-class probability
# rounds to the other side of the OHEM cutoff, or whose rectangle bound
# rounds apart, changes its gradient entirely. Lovász's gradient is a
# function of the order of the errors, and the two devices' softmaxes differ
# in the last bit, so a foreground and a background pixel whose errors are
# that close swap their (different) gradients: on random logits its terms
# may differ on LOVASZ_GRAD_MISMATCH of the elements; on `lovasz_exact`
# logits (0 or -200: every probability is 0 or 1/k on both devices, so the
# errors and their stable sort are the same) on none
LOSS_CHECK_SHAPE = (TRAIN_BATCH, 129, 129, NUM_CLASSES)
LOSS_CARD_RTOL = 1e-4
LOSS_GRAD_SHARE = 1e-3
LOSS_GRAD_MISMATCH = 1e-5
LOVASZ_GRAD_MISMATCH = 1e-4
LOSS_STEPS = 3        # timed Trainer steps a loss, after one warm-up step
# the CE knobs of the `ce_knobs` runs (ignore_index in the card check only:
# the train batch has no ignored label)
LOSS_KNOBS = dict(label_smoothing=0.1, ohem_frac=0.3, ohem_thresh=0.7)
MIX_P = 0.5           # CutMix's and Mosaic's probabilities
DISTILL = ("segformer", "b0", 1.0, 2.0)   # teacher, variant, weight, T


def class_weights():
    """NUM_CLASSES seeded weights in [0.5, 2)."""
    rng = np.random.default_rng(SEED + 8)
    return [round(float(v), 3) for v in rng.uniform(0.5, 2.0, NUM_CLASSES)]


def loss_functions():
    """name -> loss_fn(logits, labels) of every `build_loss` choice, the CE
    with every knob, and distill_loss against fixed teacher logits on
    another grid (65 x 65, resized to the student's)."""
    from pytorch_segmentation_tpu_torch.engine.steps import distill_loss
    fns = {name: build_loss(name) for name in LOSSES}
    fns["ce_knobs"] = build_loss("ce", class_weights=class_weights(),
                                 ignore_index=255, **LOSS_KNOBS)
    rng = np.random.default_rng(SEED + 10)
    teacher = torch.from_numpy((2.0 * rng.standard_normal(
        (TRAIN_BATCH, 65, 65, NUM_CLASSES))).astype(np.float32))
    on = {}   # the teacher's logits on each device, copied once

    def distill(logits, labels):
        if logits.device not in on:
            on[logits.device] = teacher.to(logits.device)
        return distill_loss(logits, on[logits.device], DISTILL[3])
    fns["distill"] = distill
    return fns


def loss_card_checks(device):
    """Each loss and its gradient on the card against the CPU on the same
    f32 logits [32, 129, 129, 21] (labels: a 9x9 grid of classes a sample,
    nearest-upsampled; 5% of the pixels 255 for ce_knobs; `lovasz_exact`
    on logits 0 or -200), and one forward and backward's ms on the card
    (CUDA events, the median of 3). Every case is checked, then any
    failure raises."""
    rng = np.random.default_rng(SEED + 9)
    x = (2.0 * rng.standard_normal(LOSS_CHECK_SHAPE)).astype(np.float32)
    exact = np.where(rng.random(LOSS_CHECK_SHAPE) < 0.2, 0.0,
                     -200.0).astype(np.float32)
    grid = torch.from_numpy(rng.integers(0, NUM_CLASSES, (
        TRAIN_BATCH, 9, 9)).astype(np.int32))
    labels = resize_nearest(grid, LOSS_CHECK_SHAPE[1:3])
    ignored = torch.where(torch.from_numpy(
        rng.random(labels.shape) < 0.05), 255, labels)
    fns = loss_functions()
    cases = {name: (fn, x, ignored if name == "ce_knobs" else labels)
             for name, fn in fns.items()}
    cases["lovasz_exact"] = (fns["lovasz"], exact, labels)
    figures, failed = {}, []
    for name, (fn, logits, y) in cases.items():
        results = []
        for dev in ("cpu", device):
            xt = torch.from_numpy(logits).to(dev).requires_grad_(True)
            value = fn(xt, y.to(dev))
            (grad,) = torch.autograd.grad(value, [xt])
            results.append((float(value.detach()), grad.cpu()))
        (want, want_g), (got, got_g) = results
        scale = float(want_g.abs().max())
        diff = (got_g - want_g).abs()
        mismatched = int((diff > LOSS_GRAD_SHARE * scale).sum())
        allowed = {"lovasz": LOVASZ_GRAD_MISMATCH, "ce+lovasz":
                   LOVASZ_GRAD_MISMATCH, "lovasz_exact": 0.0}.get(
                       name, LOSS_GRAD_MISMATCH)
        if not (abs(got - want) <= LOSS_CARD_RTOL * abs(want)
                and mismatched <= allowed * diff.numel()):
            failed.append(name)
        xt = torch.from_numpy(logits).to(device).requires_grad_(True)
        yt = y.to(device)
        ms = cuda_median_ms(lambda: torch.autograd.grad(fn(xt, yt), [xt]),
                            warmup=1, reps=3)
        figures[name] = {"card": got, "cpu": want,
                         "grad_max_abs_err": float(diff.max()),
                         "grad_max_abs": scale,
                         "grad_entries_beyond": mismatched,
                         "grad_entries_allowed": allowed * diff.numel(),
                         "fwd_bwd_ms": ms}
    log("losses_card_vs_cpu", shape=list(LOSS_CHECK_SHAPE),
        loss_rtol=LOSS_CARD_RTOL, grad_share=LOSS_GRAD_SHARE,
        losses=figures)
    if failed:
        raise AssertionError(f"losses on the card against the CPU: {failed} "
                             f"beyond their bounds (losses_card_vs_cpu "
                             f"line)")


def mix_card_check(device, dataset):
    """CutMix and Mosaic (make_mix_fn) on the card against the CPU on one
    u8 batch of 32 at 513^2, the draws made once on the CPU: bit-equal."""
    mix = make_mix_fn(cutmix_p=MIX_P, mosaic_p=MIX_P)
    draws = mix.draw(torch.Generator().manual_seed(SEED), TRAIN_BATCH)
    images = torch.from_numpy(dataset.images[:TRAIN_BATCH])
    segs = torch.from_numpy(dataset.segs[:TRAIN_BATCH])
    cpu = mix.apply(draws, images, segs)
    on_card = to_device(draws, device)
    images_d, segs_d = images.to(device), segs.to(device)
    card = mix.apply(on_card, images_d, segs_d)
    equal = [torch.equal(c.cpu(), w) for c, w in zip(card, cpu)]
    changed = float((cpu[1] != segs).float().mean())
    if equal != [True, True] or changed == 0.0:
        raise AssertionError(f"mix on the card: images and labels equal "
                             f"{equal}, {changed} of the labels changed")
    ms = cuda_median_ms(lambda: mix.apply(on_card, images_d, segs_d))
    log("losses_mix", batch=TRAIN_BATCH, bit_equal=True,
        gated={k: int(v["gate"].sum()) for k, v in draws.items()},
        labels_changed_share=changed, mix_ms_cuda_events=ms)


def write_teacher(path):
    """A seeded SegFormer-B0 `.pt` (21 classes), the distillation teacher."""
    name, variant = DISTILL[:2]
    teacher = build_model(name, NUM_CLASSES, **variant_kwargs(name, variant))
    torch.save({"model": seeded_state_dict(teacher, SEED + 1)}, path)


def loss_steps(device, model, batch, tmp, loss_fn, distill_fn=None):
    """One warm-up Trainer step and LOSS_STEPS timed ones of `model` on the
    fixed batch (SGD 1e-3, momentum 0.9, from the seeded start): the
    losses, wall and CUDA-event ms per step, the CE kernels' launches and
    the peak memory, GB."""
    trainer = Trainer(model, RepeatFetcher(batch, 1), loss_fn=loss_fn,
                      workdir=os.path.join(tmp, "w"), lr=1e-3, momentum=0.9,
                      seed=SEED, log=False, log_dir=os.path.join(tmp, "runs"),
                      distill_fn=distill_fn,
                      distill_weight=DISTILL[2] if distill_fn else 0.0,
                      distill_temp=DISTILL[3], device=device)
    if (trainer._train_module.full_res_output is False) != (
            loss_fn is compute_loss):
        raise AssertionError(f"the Trainer deferred the upsample "
                             f"{not trainer._train_module.full_res_output} "
                             f"for the loss {loss_fn}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce.reset_launch_count()
    losses = [trainer.step()]
    trainer.fetcher.n = LOSS_STEPS
    wall_ms, event_ms = step_windows(trainer, 1, losses)
    launches = ce.launch_count()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a loss is not finite: {losses}")
    steps = 1 + LOSS_STEPS
    fused = loss_fn is compute_loss
    want = {"fwd": steps, "bwd": steps} if fused else {"fwd": 0, "bwd": 0}
    if launches != want:
        raise AssertionError(f"{steps} steps launched {launches}, want "
                             f"{want}")
    return {"losses": losses, "ms_per_step_wall": wall_ms[0],
            "ms_per_step_cuda_events": event_ms[0],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "ce_launches": launches}


def losses_phase(device, dataset, cli_data):
    """The train CLI's losses and extras at full width (DeepLabV3+ R50,
    513^2, batch 32, bf16): each loss against the CPU; Trainer steps of
    every `--loss` choice and of the CE with class weights, smoothing and
    OHEM beside the default CE; CutMix and Mosaic on the card against the
    CPU; end to end from u8 batches through PostFetch(mix_fn=...,
    augment_fn=...); distillation from a seeded SegFormer-B0 `.pt`; and the
    `train` command line with the item-7 flags on the cli phase's synthetic
    set (`cli_data`), then `test`. Returns each kernel's launches in the
    phase's main-path runs (the Trainer steps, end to end, distillation and
    the command lines)."""
    from pytorch_segmentation_tpu_torch import test as test_cli
    from pytorch_segmentation_tpu_torch import train as train_cli
    t_phase = time.perf_counter()
    loss_card_checks(device)
    mix_card_check(device, dataset)
    launches = {"upsample_argmax": 0, "softmax_ce": {"fwd": 0, "bwd": 0},
                "banded_resample": 0, "eval_confusion": 0}

    def add(counts):
        add_launches(launches, counts)

    _, batch = train_batch(device)
    model = build_model("deeplabv3plus", NUM_CLASSES, dtype=torch.bfloat16,
                        full_res_output=True)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        configs = {name: build_loss(name) for name in LOSSES}
        configs["ce_knobs"] = build_loss("ce", class_weights=class_weights(),
                                         **LOSS_KNOBS)
        for name, loss_fn in configs.items():
            runs[name] = loss_steps(device, model, batch, tmp, loss_fn)
            add({"softmax_ce": runs[name]["ce_launches"]})
            log("losses_train", loss=name, batch=TRAIN_BATCH,
                **runs[name])

        # distillation: the default CE (deferred upsample, kernel 2) plus
        # the KL term against a seeded SegFormer-B0 teacher read from .pt
        teacher_path = os.path.join(tmp, "teacher.pt")
        write_teacher(teacher_path)
        name, variant = DISTILL[:2]
        teacher = load_model_bundle(
            build_model(name, NUM_CLASSES, dtype=torch.bfloat16,
                        full_res_output=False,
                        **variant_kwargs(name, variant)),
            teacher_path, device)
        teacher_fn = nhwc_forward(teacher)
        run = loss_steps(device, model, batch, tmp, compute_loss,
                         teacher_fn)
        add({"softmax_ce": run["ce_launches"]})
        with torch.no_grad():
            teacher_ms = cuda_median_ms(lambda: teacher_fn(batch[0]),
                                        warmup=1, reps=5)
            teacher_hw = list(teacher_fn(batch[0]).shape[1:3])
        run["teacher_ms"] = teacher_ms
        run["teacher_share_of_step"] = (teacher_ms
                                        / run["ms_per_step_cuda_events"])
        runs["distill"] = run
        log("losses_train", loss="ce+distill", teacher=f"{name}-{variant}",
            teacher_logits_hw=teacher_hw, distill_weight=DISTILL[2],
            distill_temp=DISTILL[3], batch=TRAIN_BATCH, **run)
        del teacher, teacher_fn

        # end to end: u8 batches -> PostFetch(mix, then augmentation) ->
        # Trainer, one warm-up epoch and one timed
        mix = make_mix_fn(cutmix_p=MIX_P, mosaic_p=MIX_P)
        mixes = []

        def counted_mix(gen, images, segs):
            mixes.append(images.shape[0])
            return mix(gen, images, segs)
        post = PostFetch(taug.make_augment_fn(), dtype=torch.bfloat16,
                         seed=SEED, mix_fn=counted_mix, device=device)
        loader = DataLoader(dataset, TRAIN_BATCH, shuffle=True,
                            drop_last=True, seed=SEED)
        trainer = Trainer(model, Fetcher(loader, post),
                          workdir=os.path.join(tmp, "w"), lr=1e-3,
                          momentum=0.9, seed=SEED, log=False,
                          log_dir=os.path.join(tmp, "runs"), device=device)
        br.reset_launch_count()
        ce.reset_launch_count()
        losses = [trainer.step()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.step())
        torch.cuda.synchronize()
        epoch_ms = 1e3 * (time.perf_counter() - t0)
        steps = trainer.state.step
        e2e = {"banded_resample": br.launch_count(),
               "softmax_ce": ce.launch_count()}
        if not (e2e == {"banded_resample": 2 * steps,
                        "softmax_ce": {"fwd": steps, "bwd": steps}}
                and mixes == [TRAIN_BATCH] * steps
                and all(np.isfinite(losses))):
            raise AssertionError(f"mix end to end: {steps} steps, "
                                 f"{len(mixes)} mixes, launches {e2e}, "
                                 f"losses {losses}")
        add(e2e)
        log("losses_mix_train", batch=TRAIN_BATCH, steps=steps,
            epoch_mean_losses=losses,
            ms_per_step_end_to_end=epoch_ms * TRAIN_BATCH / len(dataset),
            mixes=len(mixes), launches=e2e)
        del trainer, model

        # the train command line with the item-7 flags, then test
        work = os.path.join(tmp, "cli")
        os.makedirs(work)
        argv = [cli_data, "--model", "deeplabv3plus", "--dataset", "coco",
                "-s", str(IMG), str(IMG), "-bs", str(TRAIN_BATCH), "-a", "1",
                "-mp", "--num-workers", str(CLI_WORKERS), "--epochs", "1",
                "--loss", "ce+dice", "--class-weights",
                ",".join(map(str, class_weights())),
                "--label-smoothing", str(LOSS_KNOBS["label_smoothing"]),
                "--ohem", str(LOSS_KNOBS["ohem_frac"]), "--ohem-thresh",
                str(LOSS_KNOBS["ohem_thresh"]), "--cutmix", str(MIX_P),
                "--mosaic", str(MIX_P), "--distill", teacher_path,
                "--distill-model", name, "--distill-variant", variant,
                "--distill-weight", str(DISTILL[2]), "--distill-temp",
                str(DISTILL[3])]
        reset_kernel_counts()
        with working_dir(work):
            t0 = time.perf_counter()
            trainer = train_cli.main(argv)
            train_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            miou = test_cli.main([os.path.join(cli_data, "val.json"),
                                  "--model", "deeplabv3plus", "--weights",
                                  "weights/last.pt", "-s", str(IMG),
                                  str(IMG), "-bs", str(EVAL_BATCH),
                                  "--num-workers", str(CLI_WORKERS)])
            test_s = time.perf_counter() - t0
            with open("runs/log.jsonl") as f:
                records = [json.loads(line) for line in f]
        cli = kernel_counts()
        steps = CLI_TRAIN // TRAIN_BATCH
        evals = 2 * -(-CLI_VAL // EVAL_BATCH)   # the epoch's eval and test
        want = {"upsample_argmax": 2,
                "softmax_ce": {"fwd": evals, "bwd": 0},
                "banded_resample": 2 * steps, "eval_confusion": evals}
        epoch = [r for r in records if "steps" in r]
        if not (cli == want and trainer.state.step == steps
                and len(epoch) == 1 and np.isfinite(epoch[0]["loss"])
                and 0.0 <= miou <= 1.0):
            raise AssertionError(f"train CLI with the item-7 flags: launches "
                                 f"{cli} (want {want}), step "
                                 f"{trainer.state.step}, epochs {epoch}, "
                                 f"test mIoU {miou}")
        add(cli)
        del trainer
    log("losses_cli", flags=" ".join(argv[argv.index("--loss"):]),
        steps=steps, loss=epoch[0]["loss"],
        ms_per_step_cli=1e3 * epoch[0]["seconds"] / steps,
        test_miou=miou, seconds={"train": train_s, "test": test_s},
        launches=cli)
    log("losses", seconds=time.perf_counter() - t_phase,
        ms_per_step_cuda_events={k: v["ms_per_step_cuda_events"]
                                 for k, v in runs.items()},
        peak_memory_gb={k: v["peak_memory_gb"] for k, v in runs.items()},
        teacher_share_of_step=runs["distill"]["teacher_share_of_step"],
        launches=launches)
    return launches


# the int8 phase: quant.py on DeepLabV3+ R50 at 513^2, 21 classes, bf16
INT8_TENSOR_OPS = 1979e12   # int8 dense tensor-core peak, H100 SXM
INT8_CPU_HW = 129           # the card's int8 masks against the CPU's here
INT8_BAND_ROWS = 8          # output rows of a layer recomputed on the host
INT8_CALIB_BATCHES = 2
INT8_VAL_IMAGES = 8         # the inference CLI's images


def int8_product_check(device, model, images_u8):
    """Check 1: the int8dyn forward of `model` at batch 8 on the card, every
    quantized ConvNormAct's input, int8 operands, int32 product and
    rescaled output captured; for the first layer of each distinct (k,
    stride, dilation, Cin, Cout), the first image recomputed on the host
    (the quantize by `blocks.int8_operands`, the product by
    `int8_conv2d_plain` over a band of INT8_BAND_ROWS output rows and the
    input window they read): the int8 operands, the int32 product and the
    bf16 rescaled output bit-equal. Returns the quantized layers'
    (x_q shape, w_q shape, stride, padding, dilation) and the counts."""
    names = {m: n for n, m in model.named_modules()}
    current, eligible, layers, kept = [None], [0], [], {}
    real = blocks.int8_conv2d

    def pre_hook(mod, args):
        current[0] = mod
        if mod.conv.groups != 1:
            return
        eligible[0] += 1
        conv = mod.conv
        key = (conv.kernel_size[0], conv.stride[0], conv.dilation[0],
               conv.in_channels, conv.out_channels)
        if key not in kept:
            kept[key] = {"module": mod, "x": args[0][:1].cpu(),
                         "amax": args[0].abs().amax().float().cpu()}

    def bn_hook(mod, args):
        entry = kept.get(current[0].__dict__.get("_int8_key"))
        if entry is not None and "y" in entry and "pre_bn" not in entry:
            entry["pre_bn"] = args[0][:1].cpu()

    def record(x_q, w_q, stride, padding, dilation):
        y = real(x_q, w_q, stride, padding, dilation)
        mod = current[0]
        layers.append((tuple(x_q.shape), tuple(w_q.shape), stride, padding,
                       dilation))
        conv = mod.conv
        key = (conv.kernel_size[0], stride, dilation, conv.in_channels,
               conv.out_channels)
        entry = kept[key]
        if entry["module"] is mod and "y" not in entry:
            entry.update(x_q=x_q[:1].cpu(), w_q=w_q.cpu(), y=y[:1].cpu())
            mod._int8_key = key
        return y

    convs = [m for m in model.modules() if isinstance(m, blocks.ConvNormAct)]
    hooks = [m.register_forward_pre_hook(pre_hook) for m in convs]
    hooks += [m.bn.register_forward_pre_hook(bn_hook) for m in convs]
    blocks.int8_conv2d = record
    try:
        make_quant_mask_fn(model)(images_u8)
        torch.cuda.synchronize()
    finally:
        blocks.int8_conv2d = real
        for h in hooks:
            h.remove()
        for m in convs:
            m.__dict__.pop("_int8_key", None)
    checked = []
    for key, entry in sorted(kept.items()):
        if "y" not in entry:
            continue                                    # gated off
        mod = entry["module"]
        k, stride, dilation = key[:3]
        pad = mod.conv.padding[0]
        weight = mod.conv.weight.detach().cpu()
        x_q, w_q, rescale = blocks.int8_operands(entry["x"], weight,
                                                 entry["amax"])
        if not (torch.equal(x_q, entry["x_q"]) and torch.equal(
                w_q, entry["w_q"])):
            raise AssertionError(f"{names[mod]}: int8 operands differ from "
                                 f"the host's")
        ho = entry["y"].shape[2]
        o0 = max(0, ho // 2 - INT8_BAND_ROWS // 2)
        o1 = min(ho, o0 + INT8_BAND_ROWS)
        padded = torch.nn.functional.pad(x_q, (pad, pad, pad, pad))
        band = padded[:, :, o0 * stride:(o1 - 1) * stride
                      + dilation * (k - 1) + 1]
        want = int8_conv2d_plain(band, w_q, stride, 0, dilation)
        got = entry["y"][:, :, o0:o1]
        if not torch.equal(got, want):
            raise AssertionError(f"{names[mod]}: the card's int32 product "
                                 f"differs from int8_conv2d_plain's at "
                                 f"{int((got != want).sum())} entries")
        out = (want.float() * rescale).to(torch.bfloat16)
        if not torch.equal(entry["pre_bn"][:, :, o0:o1], out):
            raise AssertionError(f"{names[mod]}: the rescaled output "
                                 f"differs from the host's")
        checked.append({"layer": names[mod], "k": k, "stride": stride,
                        "dilation": dilation, "cin": key[3],
                        "cout": key[4], "rows": [o0, o1],
                        "int32_max": int(want.abs().max())})
    return layers, {"eligible": eligible[0], "quantized": len(layers),
                    "gated_off": eligible[0] - len(layers),
                    "distinct_shapes_checked": checked}


def int8_product_times(device, layers):
    """The quantized layers' int8 products (`int8_conv2d`: im2col and
    torch._int_mm) against cuDNN bf16 convolutions at the same shapes
    (channels_last), each distinct shape timed once and counted as often
    as the forward runs it, random operands; and the int8 ops' bound."""
    shapes = {}
    for shape in layers:
        shapes[shape] = shapes.get(shape, 0) + 1
    g = torch.Generator(device=device).manual_seed(SEED)
    int8_ms = bf16_ms = ops = 0.0
    for (xs, ws, stride, pad, dil), n in shapes.items():
        x = torch.randint(-127, 128, xs, generator=g, device=device,
                          dtype=torch.int8).contiguous(
            memory_format=torch.channels_last)
        w = torch.randint(-127, 128, ws, generator=g, device=device,
                          dtype=torch.int8)
        xb = x.to(torch.bfloat16)
        wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        int8_ms += n * cuda_median_ms(
            lambda: int8_conv2d(x, w, stride, pad, dil))
        bf16_ms += n * cuda_median_ms(
            lambda: torch.nn.functional.conv2d(xb, wb, None, stride, pad,
                                               dil))
        y = int8_conv2d(x, w, stride, pad, dil)
        ops += n * 2.0 * y.numel() * ws[1] * ws[2] * ws[3]
    return {"int8_products_ms": int8_ms, "cudnn_bf16_convs_ms": bf16_ms,
            "distinct_shapes": len(shapes), "layers": len(layers),
            "int8_ops_bound_ms": 1e3 * ops / INT8_TENSOR_OPS}


def int8_cpu_masks(device, model, stats):
    """make_quant_mask_fn on the card against the same function on the
    CPU (a copy of the model) for two images at INT8_CPU_HW^2, int8dyn and
    calibrated: equal wherever the top-2 gap of the card's upsampled
    logits is above twice the two devices' largest logit difference plus
    `tie_gap`. Returns the figures."""
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(SEED + 9)
    images = np.stack([smooth_image(rng, INT8_CPU_HW, INT8_CPU_HW)
                       for _ in range(2)])
    hw = (INT8_CPU_HW, INT8_CPU_HW)
    figures = {}
    for label, qs in (("int8dyn", None), ("int8", stats)):
        cpu_qs = None if qs is None else {n: v.cpu() for n, v in qs.items()}
        got = make_quant_mask_fn(model, quant_stats=qs)(images).cpu()
        want = make_quant_mask_fn(cpu_model, quant_stats=cpu_qs)(images)
        logits = []
        for m, s in ((model, qs), (cpu_model, cpu_qs)):
            x = normalize_images(torch.from_numpy(images).to(
                next(m.parameters()).device))
            with torch.inference_mode():
                logits.append(quantized_forward(nhwc_forward(m), m, s)(
                    x).float().cpu())
        diff = float((logits[0] - logits[1]).abs().max())
        up = resize_bilinear(logits[0], hw,
                             align_corners=model.up_align_corners)
        gap = 2.0 * diff + tie_gap(up)
        top2 = up.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > gap
        wrong = int(((got != want) & clear).sum())
        if wrong:
            raise AssertionError(f"{label}: {wrong} clear pixels differ "
                                 f"between the card and the CPU")
        figures[label] = {"agreement": float((got == want).float().mean()),
                          "clear_share": float(clear.float().mean()),
                          "max_logit_diff": diff,
                          "max_abs_logit": float(logits[1].abs().max())}
    return figures


def int8_phase(device, dataset, cli_data):
    """The int8 path (quant.py) of DeepLabV3+ R50 at 513^2, 21 classes,
    bf16, seeded weights: (1) the int8dyn forward at batch 8 with every
    distinct quantized layer shape held bit for bit against the host; (2)
    serving: calibrate_from_u8 on two batches, make_quant_mask_fn int8dyn
    and calibrated on the card against the CPU, a MaskServer(int8=True)
    burst of PNG and JPEG bodies (kernel 1 against its plain version on
    each served batch's int8 logits), one int8 + flip-TTA request, the int8
    masks' agreement with the bf16 ones (reported only: the weights are
    seeded); (3) test(int8=True) and test(quant_stats=) over 80 images at
    batch 32, kernel 3's counts against the plain tail's on each batch's
    int8 logits; (4) Trainer(qat=True) at batch 32 for the train phase's
    windows beside the plain Trainer, kernel 2 forward and backward on a
    QAT step's logits, two QAT steps with the fused 1x1 switch on, and
    the command lines: `train --qat` for one epoch on `cli_data` (its eval
    int8), `test --int8 --calib-batches 2`, `inference --int8 --calib` and
    `serve --int8`'s server on the checkpoint it wrote; (5) the times.
    Returns each kernel's launches in the phase's main-path runs."""
    from pytorch_segmentation_tpu_torch import inference as infer_cli
    from pytorch_segmentation_tpu_torch import serve as serve_cli
    from pytorch_segmentation_tpu_torch import test as test_cli
    from pytorch_segmentation_tpu_torch import train as train_cli
    t_phase = time.perf_counter()
    launches = {"upsample_argmax": 0, "softmax_ce": {"fwd": 0, "bwd": 0},
                "banded_resample": 0, "eval_confusion": 0,
                "fused_matmul_bn": {"fwd": 0, "bwd_dx": 0, "bwd_dw": 0}}
    cm.reset_launch_count()
    model = load_model_bundle(build_model(
        "deeplabv3plus", NUM_CLASSES, dtype=torch.bfloat16,
        full_res_output=False), None, device, seed=SEED)
    rng = np.random.default_rng(SEED + 8)
    batches = [np.stack([smooth_image(rng, IMG, IMG) for _ in range(BATCH)])
               for _ in range(INT8_CALIB_BATCHES)]

    # (1) the int8 product of every distinct layer shape
    layers, counts = int8_product_check(device, model, batches[0])
    log("int8_product", batch=BATCH, **counts)

    # (2) serving
    stats = calibrate_from_u8(model, batches)
    if len(stats) != counts["eligible"]:
        raise AssertionError(f"{len(stats)} statistics for "
                             f"{counts['eligible']} eligible convs")
    cpu_figures = int8_cpu_masks(device, model, stats)
    reset_kernel_counts()
    serve_launches, serve_figures = serve_phase(device, jpeg_bodies=True,
                                                int8=True)
    add_launches(launches, {"upsample_argmax": serve_launches})
    on_card = torch.from_numpy(batches[0]).to(device)
    fns = {"bf16": make_mask_fn(model),
           "int8dyn": make_quant_mask_fn(model),
           "int8": make_quant_mask_fn(model, quant_stats=stats)}
    masks = {k: f(on_card) for k, f in fns.items()}
    agreement = {k: float((masks[k] == masks["bf16"]).float().mean())
                 for k in ("int8dyn", "int8")}
    served_ms = {k: cuda_median_ms(lambda f=f: f(on_card))
                 for k, f in fns.items()}
    # one int8 + flip-TTA request: the host argmax of make_infer_fn's
    # probabilities (stride 4), resized to the request
    server = MaskServer(model, img_size=(IMG, IMG), max_batch=BATCH,
                        int8=True, tta_flip=True)
    host, port = server.start(port=0)[:2]
    try:
        status, _, body = post(f"http://{host}:{port}/predict?format=raw",
                               encode_png(batches[1][0]))
    finally:
        server.stop()
    padded = np.zeros_like(batches[1])
    padded[0] = batches[1][0]
    probs = make_infer_fn(model, int8=True, tta_flip=True)(padded)
    want = resize_nearest(probs[0].argmax(-1).to(torch.int32).cpu(),
                          (IMG, IMG)).numpy()
    if status != 200 or not np.array_equal(decode_png(body), want):
        raise AssertionError("the int8 + flip-TTA response differs from "
                             "make_infer_fn's host argmax")
    log("int8_serving", calibrated_layers=len(stats),
        card_vs_cpu_at=INT8_CPU_HW, card_vs_cpu=cpu_figures,
        agreement_with_bf16=agreement, served_batch8_ms=served_ms,
        burst=serve_figures, tta_flip_request_equal=True)

    # (3) evaluation: test(int8=True) and test(quant_stats=)
    evaluated = load_model_bundle(build_model(
        "deeplabv3plus", NUM_CLASSES, dtype=torch.bfloat16,
        full_res_output=True), None, device, seed=SEED)
    eval_set = dataset.first(EVAL_IMAGES)
    fetcher = Fetcher(DataLoader(eval_set, EVAL_BATCH),
                      PostFetch(dtype=torch.bfloat16, device=device))
    calib = []
    for i, (images, _, _) in enumerate(fetcher):
        if i >= INT8_CALIB_BATCHES:
            break
        calib.append(images)
    eval_stats = calibrate(evaluated, calib)
    steps = -(-EVAL_IMAGES // EVAL_BATCH)
    eval_figures = {}
    for label, options in (("int8dyn", {"int8": True}),
                           ("int8", {"quant_stats": eval_stats})):
        captured, seen = [], []
        hook = evaluated.register_forward_hook(
            lambda mod, args, out: captured.append(out))

        class Recording:
            loader = fetcher.loader

            def __len__(self):
                return len(fetcher)

            def __iter__(self):
                for batch in fetcher:
                    seen.append(batch)
                    yield batch

        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            reset_kernel_counts()
            torch.cuda.reset_peak_memory_stats()
            miou = run_eval(evaluated, Recording(), log=False,
                            report_path="report.json", device=device,
                            **options)
            run = kernel_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            hook.remove()
            with open("report.json") as f:
                report = json.load(f)
        if (run["eval_confusion"], run["softmax_ce"]["fwd"],
                run["upsample_argmax"]) != (steps, steps, 1):
            raise AssertionError(f"test({options}) launched {run}")
        add_launches(launches, run)
        # the first batch's picture is the plain forward's (captured[1])
        logits = captured[:1] + captured[2:]
        fused_step = make_eval_step(NUM_CLASSES)
        plain_step = make_eval_step(NUM_CLASSES, use_kernels=False)
        worst = 0.0
        for lg, (images, segs, valid) in zip(logits, seen):
            fixed = FixedLogits(lg).eval()
            fused = fused_step(fixed, images, segs, valid)
            plain = plain_step(fixed, images, segs, valid)
            nhwc = lg.permute(0, 2, 3, 1)
            ties = near_ties(nhwc, (IMG, IMG), True,
                             sample_valid_mask(valid, lg.shape[0], device))
            close, diff = counts_close(fused[1:], plain[1:], ties)
            loss_err = abs(float(fused[0]) - float(plain[0]))
            if not (close and loss_err <= LOSS_RTOL * abs(float(plain[0]))):
                raise AssertionError(f"{label}: kernel 3's counts differ "
                                     f"by {diff} ({ties} near ties), loss "
                                     f"by {loss_err}")
            worst = max(worst, diff)
        if not (0.0 <= miou <= 1.0 and np.isfinite(report["val_loss"])):
            raise AssertionError(f"{label} eval: {miou} {report}")
        eval_figures[label] = {"miou": miou, "val_loss": report["val_loss"],
                               "counts_max_l1_vs_plain": worst,
                               "peak_memory_gb": peak_gb}
    twin = copy.copy(evaluated)
    twin.full_res_output = False
    images, segs, _ = seen[0]
    quant_step = make_eval_step(NUM_CLASSES, quant=True)
    plain_step = make_eval_step(NUM_CLASSES)
    step_ms = {
        "bf16": cuda_median_ms(lambda: plain_step(twin, images, segs,
                                                  EVAL_BATCH), reps=10),
        "int8dyn": cuda_median_ms(lambda: quant_step(twin, images, segs,
                                                     EVAL_BATCH), reps=10),
        "int8": cuda_median_ms(lambda: quant_step(
            twin, images, segs, EVAL_BATCH, eval_stats), reps=10)}
    # the quantized forward's parts at batch 8: its int8 products against
    # cuDNN's bf16 convs at the same shapes, and what the rest costs
    with torch.inference_mode():
        x8 = normalize_images(on_card)
        fwd = nhwc_forward(model)
        forward_ms = {"bf16": cuda_median_ms(lambda: fwd(x8)),
                      "int8dyn": cuda_median_ms(
                          lambda: quantized_forward(fwd, model)(x8))}
    products = int8_product_times(device, layers)
    # int8 forward = products + quantize/rescale passes + the rest, where
    # the rest is the bf16 forward without the quantized layers' convs
    quantize_ms = (forward_ms["int8dyn"] - products["int8_products_ms"]
                   - (forward_ms["bf16"] - products["cudnn_bf16_convs_ms"]))
    log("int8_eval", images=EVAL_IMAGES, batch=EVAL_BATCH, steps=steps,
        results=eval_figures, eval_step_ms=step_ms,
        forward_batch8_ms=forward_ms, **products,
        quantize_rescale_ms_derived=quantize_ms,
        quantize_rescale_share_of_forward=quantize_ms
        / forward_ms["int8dyn"])
    del twin, evaluated, fetcher, seen, captured

    # (4) quantization-aware training
    _, batch = train_batch(device)
    fake = []
    real_fake = blocks.ConvNormAct._fake_quant_conv

    def counting(self, x):
        fake.append(self)
        return real_fake(self, x)

    def fake_names(module):
        seen = set(fake)
        return {n for n, m in module.named_modules() if m in seen}

    blocks.ConvNormAct._fake_quant_conv = counting
    qat_figures = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for label, qat, warm, windows in (("qat", True, 3, 3),
                                              ("plain", False, 1, 1)):
                logits = []
                trainer = Trainer(
                    build_model("deeplabv3plus", NUM_CLASSES,
                                dtype=torch.bfloat16, full_res_output=True),
                    RepeatFetcher(batch, 1), workdir=os.path.join(tmp, "w"),
                    lr=1e-3, momentum=0.9, seed=SEED, log=False,
                    log_dir=os.path.join(tmp, "runs"), qat=qat,
                    device=device)
                hook = trainer._train_module.register_forward_hook(
                    lambda mod, args, out: logits.append(out.detach()))
                fake.clear()
                reset_kernel_counts()
                losses, wall_ms, event_ms, run, peak_gb = timed_steps(
                    trainer, warm, windows)
                hook.remove()
                n = trainer.state.step
                if not (all(np.isfinite(losses)) and run["softmax_ce"] == {
                        "fwd": n, "bwd": n}):
                    raise AssertionError(f"{label}: losses {losses}, "
                                         f"launches {run}")
                if qat:
                    add_launches(launches, {"softmax_ce": run["softmax_ce"]})
                    qat_per_step = len(fake) // n
                    qat_names = fake_names(trainer.module)
                    x = logits[-1].permute(0, 2, 3, 1).detach(
                        ).requires_grad_(True)
                    _, loss_value, loss_err, grad_err, top = ce_check(
                        "int8_qat_logits", x, batch[1], True)
                elif fake:
                    raise AssertionError("the plain step fake-quantized")
                qat_figures[label] = {
                    "steps": n, "losses": losses,
                    "ms_per_step_wall": wall_ms,
                    "ms_per_step_cuda_events": event_ms,
                    "peak_memory_gb": peak_gb}
                del trainer, logits, hook
            # two QAT steps with the fused 1x1 switch on: each bottleneck's
            # conv1-3 leave the fake quant for the folded path (conv1 and
            # conv3 through the fused kernels), every other conv keeps it
            blocks.set_force_fused_1x1("on")
            try:
                fake.clear()
                trainer = Trainer(
                    build_model("deeplabv3plus", NUM_CLASSES,
                                dtype=torch.bfloat16, full_res_output=True),
                    RepeatFetcher(batch, 2), workdir=os.path.join(tmp, "f"),
                    lr=1e-3, momentum=0.9, seed=SEED, log=False,
                    log_dir=os.path.join(tmp, "runs"), qat=True,
                    device=device)
                reset_kernel_counts()
                fm.reset_launch_count()
                fused_loss = trainer.step()
                fused_run = {"fused_matmul_bn": fm.launch_count(),
                             "softmax_ce": ce.launch_count()}
                fused_names = fake_names(trainer.module)
                del trainer
            finally:
                blocks.set_force_fused_1x1(None)
            expected = {n for n in qat_names
                        if not ("_block" in n and n.endswith(
                            ("conv1", "conv2", "conv3")))}
            want_fm = 2 * FUSED_PER_STEP                 # two steps
            if not (np.isfinite(fused_loss)
                    and fused_run["fused_matmul_bn"] == {
                        "fwd": want_fm, "bwd_dx": want_fm,
                        "bwd_dw": want_fm}
                    and fused_names == expected
                    and len(fake) == 2 * len(expected)):
                raise AssertionError(f"QAT with the fused switch: loss "
                                     f"{fused_loss}, launches {fused_run}, "
                                     f"{len(fake)} fake quants of "
                                     f"{sorted(fused_names ^ expected)}")
            add_launches(launches, fused_run)
    finally:
        blocks.ConvNormAct._fake_quant_conv = real_fake
    log("int8_qat", batch=TRAIN_BATCH, fake_quantized_per_step=qat_per_step,
        kernel2_on_qat_logits={"loss": loss_value, "loss_err": loss_err,
                               "grad_err": grad_err, "grad_max": top},
        fused_switch={"loss": fused_loss, "launches": fused_run,
                      "fake_quantized_per_step": len(expected)},
        qat_vs_plain_step=qat_figures["qat"]["ms_per_step_cuda_events"][-1]
        / qat_figures["plain"]["ms_per_step_cuda_events"][-1],
        **qat_figures)

    # the command lines: train --qat (its eval int8), then test --int8
    # --calib-batches 2, inference --int8 --calib and serve --int8 on the
    # checkpoint it wrote
    evals = []
    real_test = train_cli.test

    def recording_test(*args, **kwargs):
        evals.append(kwargs.get("int8"))
        return real_test(*args, **kwargs)

    with tempfile.TemporaryDirectory() as work, working_dir(work):
        reset_kernel_counts()
        train_cli.test = recording_test
        try:
            t0 = time.perf_counter()
            trainer = train_cli.main([
                cli_data, "--model", "deeplabv3plus", "--dataset", "coco",
                "-s", str(IMG), str(IMG), "-bs", str(TRAIN_BATCH), "-a",
                "1", "-mp", "--num-workers", str(CLI_WORKERS), "--epochs",
                "1", "--qat"])
            train_s = time.perf_counter() - t0
        finally:
            train_cli.test = real_test
        val_json = os.path.join(cli_data, "val.json")
        t0 = time.perf_counter()
        miou = test_cli.main([val_json, "--model", "deeplabv3plus",
                              "--weights", "weights/last.pt", "-s", str(IMG),
                              str(IMG), "-bs", str(EVAL_BATCH),
                              "--num-workers", str(CLI_WORKERS), "--int8",
                              "--calib-batches", str(INT8_CALIB_BATCHES)])
        test_s = time.perf_counter() - t0
        os.makedirs("imgs")
        for info in json.load(open(val_json))["images"][:INT8_VAL_IMAGES]:
            os.symlink(os.path.join(cli_data, info["file_name"]),
                       os.path.join("imgs", info["file_name"]))
        t0 = time.perf_counter()
        written = infer_cli.main(["imgs", "out", "--weights",
                                  "weights/last.pt", "-s", str(IMG), str(IMG),
                                  "-nc", str(CLI_CATEGORIES + 1), "-bs",
                                  str(INT8_VAL_IMAGES), "--int8", "--calib"])
        infer_s = time.perf_counter() - t0
        server = serve_cli.build_server(serve_cli.parse_args(
            ["--weights", "weights/last.pt", "-nc", str(CLI_CATEGORIES + 1),
             "--int8"]), device)
        served = server._run_batch(batches[0])
        cli = kernel_counts()
        with open("runs/log.jsonl") as f:
            records = [json.loads(line) for line in f]
    steps = CLI_TRAIN // TRAIN_BATCH
    evals_run = 2 * -(-CLI_VAL // EVAL_BATCH)   # the epoch's eval and test
    want = {"upsample_argmax": 2 + 1,           # two pictures, one batch
            "softmax_ce": {"fwd": steps + evals_run, "bwd": steps},
            "banded_resample": 2 * steps, "eval_confusion": evals_run}
    epoch = [r for r in records if "steps" in r]
    if not (cli == want and trainer.qat and evals == [True]
            and trainer.state.step == steps and len(epoch) == 1
            and np.isfinite(epoch[0]["loss"]) and 0.0 <= miou <= 1.0
            and len(written) == INT8_VAL_IMAGES
            and served.shape == (BATCH, IMG, IMG)):
        raise AssertionError(f"int8 command lines: launches {cli} (want "
                             f"{want}), evals {evals}, step "
                             f"{trainer.state.step}, epochs {epoch}, test "
                             f"mIoU {miou}, {len(written)} masks")
    add_launches(launches, cli)
    log("int8_cli", train_qat_s=train_s, loss=epoch[0]["loss"],
        ms_per_step_cli=1e3 * epoch[0]["seconds"] / steps,
        test_int8_calib_miou=miou, test_s=test_s, inference_s=infer_s,
        launches=cli)
    launches["cmajor_matmul"] = cm.launch_count()
    log("int8", seconds=time.perf_counter() - t_phase, launches=launches)
    return launches


# the nonsquare phase: the path at the Cityscapes crop, H x W = 512 x 1024,
# batch 16 (8.39 M pixels a batch, as 513^2 at batch 32: 8.42 M)
NS_HW = (512, 1024)
NS_BATCH = 16
NS_EVAL_IMAGES = 32
# the policy on the card against the CPU, parameters drawn on the CPU:
# (case, config, batch, (h, w), the row resampler's launches). Every case
# bypasses the resampler: non-square frames take the gather samplers, and
# so do square ones with banded_warp=False; separable_warp=True takes the
# lane gathers; fast_geometric the matrix products
NS_AUGMENT_CASES = [
    ("default_65x97", taug.AugmentConfig(), 8, (65, 97), 0),
    ("default_512x1024", taug.AugmentConfig(), NS_BATCH, NS_HW, 0),
    ("order1_65x97", taug.AugmentConfig(image_warp_order=1), 4, (65, 97), 0),
    ("banded_off_65x65", taug.AugmentConfig(banded_warp=False), 4, (65, 65),
     0),
    ("separable_65x65", taug.AugmentConfig(banded_warp=False,
                                           separable_warp=True), 4, (65, 65),
     0),
    ("fast_65x65", taug.AugmentConfig(fast_geometric=True), 4, (65, 65), 0),
    ("fast_65x97", taug.AugmentConfig(fast_geometric=True), 4, (65, 97), 0),
    ("per_sample_order_65x97",
     taug.AugmentConfig(per_sample_photo_order=True), 8, (65, 97), 0),
]


def nonsquare_phase(device, cli_data, profile=False):
    """The path on non-square frames at full width: DeepLabV3+ R50, 21
    classes, bf16 over f32 parameters, H x W = 512 x 1024 (NS_HW), batch 16.
    The policy of every AugmentConfig option on the card against the CPU
    (NS_AUGMENT_CASES); the train step alone on one fixed batch; `test()`
    over 32 images at batch 16 and one `make_mask_fn` batch of 8 (kernels
    2-3, then 1); end to end from u8 host batches (the gather warp and the
    rectangular filter, no resampler launch); kernels 1-3 at the path's
    shapes against their plain versions; then `train -s 1024 512 -bs 16 -a
    1 -mp` for one epoch on the cli phase's set (`cli_data`) and `test` on
    its checkpoint, and the same train with `--fast-augment` (`--notest
    --nosave`). Returns each kernel's launches in the phase's main-path
    runs and the kernel cases' figures."""
    from pytorch_segmentation_tpu_torch import test as test_cli
    from pytorch_segmentation_tpu_torch import train as train_cli
    t_phase = time.perf_counter()
    fm.reset_launch_count()
    cm.reset_launch_count()
    for case in NS_AUGMENT_CASES:
        augment_card_check(device, *case)
    launches = {"upsample_argmax": 0, "softmax_ce": {"fwd": 0, "bwd": 0},
                "banded_resample": 0, "eval_confusion": 0}
    dataset = MemoryDataset(4 * NS_BATCH, np.random.default_rng(SEED + 8),
                            hw=NS_HW)
    imgs_u8, batch = train_batch(device, NS_HW, NS_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        # the train step alone on one fixed batch
        trainer = make_trainer(device, "deeplabv3plus", batch, tmp)
        losses, wall_ms, event_ms, counts, peak_gb = timed_steps(trainer, 2,
                                                                 2)
        steps = trainer.state.step
        if counts["softmax_ce"] != {"fwd": steps, "bwd": steps}:
            raise AssertionError(f"{steps} steps launched {counts}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"non-square train losses {losses}")
        add_launches(launches, {"softmax_ce": counts["softmax_ce"]})
        train_images_per_s = 1e3 * NS_BATCH / min(wall_ms)
        log("nonsquare_train", batch=NS_BATCH, image_hw=list(NS_HW),
            steps=steps, first_loss=losses[0], window_mean_losses=losses[2:],
            images_per_s=train_images_per_s, ms_per_step_wall=wall_ms,
            ms_per_step_cuda_events=event_ms, peak_memory_gb=peak_gb,
            launches=counts["softmax_ce"])

        # eval, then serving from the saved weights
        reset_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miou, report = eval_report(trainer.model,
                                   dataset.first(NS_EVAL_IMAGES), device,
                                   tmp, batch=NS_BATCH,
                                   show_first_batch=False)
        eval_s = time.perf_counter() - t0
        evals = NS_EVAL_IMAGES // NS_BATCH
        eval_counts = kernel_counts()
        if eval_counts != {"upsample_argmax": 0,
                           "softmax_ce": {"fwd": evals, "bwd": 0},
                           "banded_resample": 0, "eval_confusion": evals}:
            raise AssertionError(f"non-square eval launched {eval_counts}")
        if not (np.isfinite(report["val_loss"]) and 0.0 <= miou <= 1.0):
            raise AssertionError(f"non-square eval: {report}")
        trainer.save()
        served = load_model_bundle(
            build_model("deeplabv3plus", NUM_CLASSES, dtype=torch.bfloat16,
                        full_res_output=False),
            os.path.join(tmp, "w", "last.pt"), device)
        mask_fn = make_mask_fn(served, out_hw=NS_HW)
        masks = mask_fn(imgs_u8[:BATCH])
        torch.cuda.synchronize()
        eval_counts["upsample_argmax"] = ua.launch_count()
        if eval_counts["upsample_argmax"] != 1:
            raise AssertionError(f"one served batch launched kernel 1 "
                                 f"{eval_counts['upsample_argmax']} times")
        classes = len(torch.unique(masks))
        if (masks.shape != (BATCH, *NS_HW) or masks.dtype != torch.int32
                or classes < 2 or int(masks.max()) >= NUM_CLASSES):
            raise AssertionError(f"served masks {masks.dtype} "
                                 f"{tuple(masks.shape)}, {classes} classes")
        add_launches(launches, eval_counts)
        # timed after the checks: a second pass of the same eval, and the
        # served batch from host memory (as a server gets it) and from the
        # card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_report(trainer.model, dataset.first(NS_EVAL_IMAGES), device,
                    tmp, batch=NS_BATCH, show_first_batch=False)
        eval_again_s = time.perf_counter() - t0
        on_card = torch.from_numpy(imgs_u8[:BATCH]).to(device)
        serve_ms = cuda_median_ms(lambda: mask_fn(imgs_u8[:BATCH]), reps=10)
        serve_card_ms = cuda_median_ms(lambda: mask_fn(on_card), reps=10)
        log("nonsquare_eval_serve", eval_images=NS_EVAL_IMAGES,
            batch=NS_BATCH, miou=miou, val_loss=report["val_loss"],
            eval_images_per_s=[NS_EVAL_IMAGES / eval_s,
                               NS_EVAL_IMAGES / eval_again_s],
            serve_batch=BATCH, serve_ms_per_batch_from_host=serve_ms,
            serve_ms_per_batch_from_card=serve_card_ms,
            serve_images_per_s=1e3 * BATCH / serve_ms,
            served_classes=classes, launches=eval_counts)
        del trainer, served, mask_fn

    # end to end from u8 host batches
    e2e, _ = augment_phase(device, dataset, train_images_per_s, None,
                           profile=profile, batch_size=NS_BATCH,
                           phase="nonsquare_augment_train")
    add_launches(launches, e2e)

    # kernels 1-3 at the path's shapes against their plain versions
    logits = (128, 256, NUM_CLASSES)
    cases = {
        "upsample_argmax": kernel_case("nonsquare_argmax_bf16",
                                       (BATCH, *logits), NS_HW,
                                       torch.bfloat16, True, device),
        "softmax_ce": ce_case("ce_nonsquare_bf16", (NS_BATCH, *logits),
                              NS_HW, torch.bfloat16, True, device),
        "eval_confusion": eval_case("eval_nonsquare_bf16",
                                    (NS_BATCH, *logits), NS_HW,
                                    torch.bfloat16, True, device)}

    # the command lines: train -s W H on the cli set, then test; then
    # train --fast-augment
    argv = [cli_data, "--model", "deeplabv3plus", "--dataset", "coco",
            "-s", str(NS_HW[1]), str(NS_HW[0]), "-bs", str(NS_BATCH), "-a",
            "1", "-mp", "--num-workers", str(CLI_WORKERS), "--epochs", "1"]
    steps = CLI_TRAIN // NS_BATCH
    evals = -(-CLI_VAL // NS_BATCH)
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        reset_kernel_counts()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv)
        seconds["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        miou = test_cli.main([os.path.join(cli_data, "val.json"), "--model",
                              "deeplabv3plus", "--weights", "weights/last.pt",
                              "-s", str(NS_HW[1]), str(NS_HW[0]), "-bs",
                              str(NS_BATCH), "--num-workers",
                              str(CLI_WORKERS)])
        seconds["test"] = time.perf_counter() - t0
        with open("runs/log.jsonl") as f:
            epoch = [r for r in map(json.loads, f) if "steps" in r]
        cli = kernel_counts()
        want = {"upsample_argmax": 2,
                "softmax_ce": {"fwd": steps + 2 * evals, "bwd": steps},
                "banded_resample": 0, "eval_confusion": 2 * evals}
        if not (cli == want and trainer.state.step == steps
                and len(epoch) == 1 and np.isfinite(epoch[0]["loss"])
                and 0.0 <= miou <= 1.0):
            raise AssertionError(f"train -s {NS_HW[1]} {NS_HW[0]}: launches "
                                 f"{cli} (want {want}), step "
                                 f"{trainer.state.step}, epochs {epoch}, "
                                 f"test mIoU {miou}")
        add_launches(launches, cli)
        del trainer

        reset_kernel_counts()
        os.makedirs("fast")
        with working_dir("fast"):
            t0 = time.perf_counter()
            trainer = train_cli.main(argv + ["--fast-augment", "--notest",
                                             "--nosave"])
            seconds["train_fast_augment"] = time.perf_counter() - t0
            with open("runs/log.jsonl") as f:
                fast_epoch = [r for r in map(json.loads, f) if "steps" in r]
        fast = kernel_counts()
        want = {"upsample_argmax": 0,
                "softmax_ce": {"fwd": steps, "bwd": steps},
                "banded_resample": 0, "eval_confusion": 0}
        config = trainer.fetcher.post_fetch_fn.augment_fn.config
        if not (fast == want and trainer.state.step == steps
                and config.fast_geometric and len(fast_epoch) == 1
                and np.isfinite(fast_epoch[0]["loss"])):
            raise AssertionError(f"train --fast-augment: launches {fast} "
                                 f"(want {want}), step {trainer.state.step},"
                                 f" fast_geometric {config.fast_geometric}, "
                                 f"epochs {fast_epoch}")
        add_launches(launches, fast)
        del trainer
    log("nonsquare_cli", flags=" ".join(argv[argv.index("-s"):]),
        steps=steps, loss=epoch[0]["loss"],
        ms_per_step_cli=1e3 * epoch[0]["seconds"] / steps, test_miou=miou,
        fast_augment_loss=fast_epoch[0]["loss"],
        fast_augment_ms_per_step_cli=1e3 * fast_epoch[0]["seconds"] / steps,
        seconds=seconds, launches=cli, fast_augment_launches=fast)
    # the fused 1x1 switch stays off on this path
    launches["fused_matmul_bn"] = fm.launch_count()
    launches["cmajor_matmul"] = cm.launch_count()
    if any(launches["fused_matmul_bn"].values()) or launches["cmajor_matmul"]:
        raise AssertionError(f"the non-square path launched {launches}")
    log("nonsquare", seconds=time.perf_counter() - t_phase,
        launches=launches)
    return launches, cases


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


# ------------------------------------------------------------------ dp phase

DP_STEPS = 4
DP_EVAL_IMAGES = 64  # two eval batches of 32
DP_CLI_TRAIN, DP_CLI_VAL = 32, 8  # `train -bs 16`: 2 steps, one eval batch
# two ranks on the one card at batch 16 each against one process at batch
# 32, from the same start and global batch: the same arithmetic at other
# batch positions and sizes, and bf16 on the card depends on batch position
# (ROADMAP "Facts"). At seeded full width that alone moves the 4 steps'
# losses by ~1.3% and their parameter updates by ~90% in norm: the one
# process on the batch rolled by 16 rows (`rolled`, the same call) measures
# it. So each step's loss must stay within DP_PAIR_NOISE times the rolled
# run's largest loss difference, and the update's norm within DP_PAIR_NORM
# of one process's (a wrong mean of the gradients, their sum or one rank's
# half, scales it by 2 or 1/2); the two ranks end bit-equal.
DP_PAIR_NOISE = 2.0
DP_PAIR_NORM = (0.67, 1.5)


def torchrun(nproc, args, timeout):
    """This script under `python -m torch.distributed.run` with `nproc`
    processes over loopback, in a session of its own (killed whole at the
    timeout). Raises on a non-zero exit with the output's tail; returns
    the seconds it took."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(nproc), "--master_addr", "127.0.0.1", "--master_port",
           str(port), os.path.join(here, "chip_smoke.py"), *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=here,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {' '.join(args)}: exit "
                             f"{proc.returncode}\n{out[-3000:]}\n"
                             f"{err[-6000:]}")
    return time.perf_counter() - t0


def dp_steps(trainer, steps=DP_STEPS):
    """`steps` steps one by one: each step's loss, and the final state
    (copied to the host, so that it holds no device memory)."""
    trainer.fetcher.n = 1
    losses = [trainer.step() for _ in range(steps)]
    return losses, {k: v.detach().cpu()
                    for k, v in trainer.module.state_dict().items()}


def assert_same_run(name, got, want):
    """Bit-equal losses and state_dicts."""
    if got[0] != want[0]:
        raise AssertionError(f"{name}: losses {got[0]} != {want[0]}")
    bad = [k for k, v in want[1].items() if not torch.equal(got[1][k], v)]
    if bad:
        raise AssertionError(f"{name}: {len(bad)} tensors differ, e.g. "
                             f"{bad[:3]}")


def dp_step_ms(trainers, windows=3):
    """CUDA-event ms per step of each trainer, in turns: a window of 3
    steps each, `windows` times, after one step each (cuDNN's choice of
    algorithms)."""
    for trainer in trainers.values():
        trainer.fetcher.n = 1
        trainer.step()
    ms = {name: [] for name in trainers}
    for _ in range(windows):
        for name, trainer in trainers.items():
            trainer.fetcher.n = 3
            ms[name] += step_windows(trainer, 1, [])[1]
    return ms


def dp_worker(tmp):
    """The dp phase's world-1 run (launched by `dp_phase` under
    torch.distributed.run, one process). First, before the process group:
    DeepLabV3+ R50 at 513², batch 32, from `tmp/start.pt`, DP_STEPS steps
    through the Trainer (fused 1x1 switch off, then on), `test()` over 64
    images and a served batch of 8, without a mesh. Then
    `initialize_distributed()` (NCCL over loopback) and the same through
    `make_mesh()`: Trainer(mesh=) off and on, Trainer(mesh=, zero=True),
    test(mesh=), MaskServer(mesh=): losses and parameters bit-equal, counts
    and masks equal (cuDNN's deterministic algorithms for both sides: the
    all-reduces of one rank are copies, so nothing else may differ). Then
    each step's ms without and with the mesh in turns (cuDNN's defaults),
    and last the train CLI (`main`, under this torchrun) with --zero for 2
    steps and its epoch's eval, whose last.pt loads on one card. Writes
    `tmp/worker.json` and, for the two-rank run, `tmp/want.pt` and
    `tmp/rolled.pt` (one process on the batch rolled by 16 rows)."""
    device = require_cuda()
    start = os.path.join(tmp, "start.pt")
    _, batch = train_batch(device)
    eval_set = MemoryDataset(DP_EVAL_IMAGES, np.random.default_rng(SEED + 6))
    served = np.stack([smooth_image(np.random.default_rng(SEED + 8), IMG,
                                    IMG) for _ in range(BATCH - 2)])
    serve_model = load_model_bundle(family_model(
        "deeplabv3plus", dtype=torch.bfloat16, full_res_output=False),
        start, device)

    def trainer(tag, **kw):
        return make_trainer(device, "deeplabv3plus", batch,
                            os.path.join(tmp, tag), weights=start, **kw)

    def paths(tag, **kw):
        """Trainer off and on, test() of the first, a served batch."""
        off = trainer(tag + "_off", **kw)
        out = {"off": dp_steps(off)}
        blocks.set_force_fused_1x1("on")
        try:
            out["on"] = dp_steps(trainer(tag + "_on", **kw))
        finally:
            blocks.set_force_fused_1x1(None)
        out["counts"] = eval_report(off.model, eval_set, device, tmp,
                                    **kw)[1]["per_class"]
        server = MaskServer(serve_model, img_size=(IMG, IMG),
                            max_batch=BATCH, **kw)
        out["masks"] = server._run_batch(served)
        return off, out

    torch.backends.cudnn.deterministic = True
    plain, want = paths("plain")
    torch.save(want["off"], os.path.join(tmp, "want.pt"))
    # the same global batch in another order: what bf16 at other batch
    # positions alone moves (the two-rank run's bound)
    images, segs, n = batch
    rolled = (images.roll(TRAIN_BATCH // 2, 0), segs.roll(TRAIN_BATCH // 2, 0),
              n)
    torch.save(dp_steps(make_trainer(device, "deeplabv3plus", rolled,
                                     os.path.join(tmp, "rolled"),
                                     weights=start)),
               os.path.join(tmp, "rolled.pt"))
    rank_device = initialize_distributed()
    mesh = make_mesh()
    if (mesh.world, rank_device, torch.distributed.get_backend()) != (
            1, device, "nccl"):
        raise AssertionError(f"world {mesh.world} on {rank_device} "
                             f"{torch.distributed.get_backend()}")
    reset_kernel_counts()
    fm.reset_launch_count()
    meshed, got = paths("mesh", mesh=mesh)
    zero = trainer("zero", mesh=mesh, zero=True)
    zero_run = dp_steps(zero)
    launches = kernel_counts()
    launches["fused_matmul_bn"] = fm.launch_count()
    assert_same_run("mesh, switch off", got["off"], want["off"])
    assert_same_run("mesh, switch on", got["on"], want["on"])
    assert_same_run("mesh, zero", zero_run, want["off"])
    if got["counts"] != want["counts"]:
        raise AssertionError("test(mesh=) counts differ from test()'s")
    if not np.array_equal(got["masks"], want["masks"]):
        raise AssertionError("MaskServer(mesh=) masks differ")
    torch.backends.cudnn.deterministic = False
    ms = dp_step_ms({"without": plain, "mesh": meshed})

    reset_kernel_counts()
    fm.reset_launch_count()
    data = make_synthetic_coco(os.path.join(tmp, "coco"), DP_CLI_TRAIN,
                               DP_CLI_VAL, CLI_WH, seed=SEED,
                               num_classes=CLI_CATEGORIES)
    from pytorch_segmentation_tpu_torch import train as train_cli
    os.makedirs(os.path.join(tmp, "cli"))
    t0 = time.perf_counter()
    with working_dir(os.path.join(tmp, "cli")):
        cli = train_cli.main([data, "--model", "deeplabv3plus", "--dataset",
                              "coco", "-s", str(IMG), str(IMG), "-bs", "16",
                              "-a", "1", "-mp", "--epochs", "1", "--zero",
                              "--num-workers", str(CLI_WORKERS)])
        cli_seconds = time.perf_counter() - t0
        if cli.state.step != 2:
            raise AssertionError(f"train --zero took {cli.state.step} steps")
        load_model_bundle(family_model("deeplabv3plus", full_res_output=False),
                          os.path.join("weights", "last.pt"), device)
    cli_launches = kernel_counts()
    cli_launches["fused_matmul_bn"] = fm.launch_count()
    with open(os.path.join(tmp, "worker.json"), "w") as f:
        json.dump({"losses": got["off"][0], "fused_losses": got["on"][0],
                   "step_ms": ms, "launches": launches,
                   "cli_launches": cli_launches, "cli_seconds": cli_seconds,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}, f)


def dp_pair(tmp):
    """Two ranks on the one card (launched by `dp_phase`): a gloo group,
    both ranks bound to cuda:0, each on its 16 of the batch of 32 from
    `tmp/start.pt`: DP_STEPS steps replicated, then DP_STEPS under ZeRO and
    DP_STEPS with remat=True (each bit-equal to the replicated ones: the
    recompute runs on autograd's device thread, which must see the batch
    group), each with its peak memory. Rank r writes `tmp/pair<r>.pt`."""
    torch.cuda.set_device(0)
    device = require_cuda()
    torch.distributed.init_process_group("gloo", init_method="env://")
    try:
        mesh = make_mesh()
        _, (images, segs, _) = train_batch(device)
        batch = (*shard_batch(mesh, images, segs), TRAIN_BATCH // mesh.world)
        torch.backends.cudnn.deterministic = True
        out = {}
        for tag, zero, remat in (("replicated", False, False),
                                 ("zero", True, False),
                                 ("remat", False, True)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer = make_trainer(device, "deeplabv3plus", batch,
                                   os.path.join(tmp, f"pair_{tag}"),
                                   weights=os.path.join(tmp, "start.pt"),
                                   mesh=mesh, zero=zero, remat=remat)
            if trainer.zero != zero:
                raise AssertionError(f"{tag}: Trainer.zero {trainer.zero}")
            t0 = time.perf_counter()
            out[tag] = dp_steps(trainer)
            # each step ends in its loss's host read: the wall of 4 steps,
            # the first (cuDNN's choices) included
            out[tag + "_ms"] = 1e3 * (time.perf_counter() - t0) / DP_STEPS
            out[tag + "_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del trainer
        assert_same_run("two ranks, zero", out["zero"], out["replicated"])
        assert_same_run("two ranks, remat", out["remat"], out["replicated"])
        torch.save(out, os.path.join(tmp, f"pair{mesh.rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def dp_phase(device):
    """Data parallelism on the card (`parallel/`): the world-1 NCCL run
    (`dp_worker`) and two gloo ranks on the one card (`dp_pair`) against
    one process at batch 32, each a torch.distributed.run of this script.
    Returns each kernel's launches under the world-1 mesh: its Trainer,
    test() and MaskServer runs and `train --zero`."""
    start = seeded_state_dict(family_model("deeplabv3plus"), SEED,
                              init="train")
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(os.path.join(tmp, "start.pt"), start)
        worker_s = torchrun(1, ["--dp-worker", tmp], timeout=600)
        with open(os.path.join(tmp, "worker.json")) as f:
            res = json.load(f)
        pair_s = torchrun(2, ["--dp-pair", tmp], timeout=300)
        want, rolled, pair, pair1 = (
            torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=True)
            for name in ("want", "rolled", "pair0", "pair1"))
    assert_same_run("rank 1 against rank 0", pair1["replicated"],
                    pair["replicated"])
    got = pair["replicated"]

    def apart(run):
        """(largest relative loss difference, the update's difference in
        norm relative to one process's update, the update's norm ratio,
        the worst leaves) against one process at batch 32."""
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(run[0], want[0]))
        num = den = size = 0.0
        worst = []
        for k, v in want[1].items():
            if v.is_floating_point() and "running_" not in k:
                moved = v.cpu() - start[k]
                diff = float((run[1][k].cpu() - v.cpu()).square().sum())
                num += diff
                den += float(moved.square().sum())
                size += float((run[1][k].cpu() - start[k]).square().sum())
                worst.append((diff / max(float(moved.square().sum()),
                                         1e-30), k))
        return (loss_rel, (num / max(den, 1e-30)) ** 0.5,
                (size / max(den, 1e-30)) ** 0.5,
                [(k, r ** 0.5) for r, k in sorted(worst)[-4:]])

    pair_apart, rolled_apart = apart(got), apart(rolled)
    launches = res["launches"]
    total = copy.deepcopy(launches)
    add_launches(total, res["cli_launches"])
    for name, n in (("upsample_argmax", launches["upsample_argmax"]),
                    ("softmax_ce fwd", launches["softmax_ce"]["fwd"]),
                    ("softmax_ce bwd", launches["softmax_ce"]["bwd"]),
                    ("eval_confusion", launches["eval_confusion"]),
                    ("fused_matmul_bn", launches["fused_matmul_bn"]["fwd"])):
        if not n:
            raise AssertionError(f"{name}: no launch under the mesh")
    if not total["banded_resample"]:
        raise AssertionError("banded_resample: no launch in train --zero")
    step_ms = {k: statistics.median(v) for k, v in res["step_ms"].items()}
    log("dp", world1_nccl="bit-equal", step_ms_median=step_ms,
        step_ms=res["step_ms"],
        mesh_overhead_ms=step_ms["mesh"] - step_ms["without"],
        launches=launches, cli_zero_launches=res["cli_launches"],
        cli_zero_seconds=res["cli_seconds"], worker_seconds=worker_s,
        worker_peak_gb=res["peak_gb"], pair_seconds=pair_s,
        pair_losses=got[0], one_process_losses=want[0],
        rolled_losses=rolled[0], pair_apart=pair_apart,
        rolled_apart=rolled_apart,
        pair_peak_gb={"replicated": pair["replicated_peak_gb"],
                      "zero": pair["zero_peak_gb"],
                      "remat": pair["remat_peak_gb"]},
        pair_step_ms={"replicated": pair["replicated_ms"],
                      "zero": pair["zero_ms"], "remat": pair["remat_ms"]},
        pair_remat="bit-equal")
    if (pair_apart[0] > DP_PAIR_NOISE * rolled_apart[0]
            or not DP_PAIR_NORM[0] <= pair_apart[2] <= DP_PAIR_NORM[1]):
        raise AssertionError(f"two ranks against one process: {pair_apart}, "
                             f"the rolled batch {rolled_apart}")
    return total


# the remat phase: steps a bit-equality run takes, and Segmenter's size
REMAT_STEPS = 2
REMAT_SEGMENTER_IMG = 512


def release_memory():
    """Free what dropped trainers held (their cycles too) before the next
    run's peak is read."""
    gc.collect()
    torch.cuda.empty_cache()


def remat_figures(trainer):
    """1 + 5 steps at cuDNN's defaults (`timed_steps`): ms a step (wall and
    CUDA events, the window's), peak GB and the first timed loss."""
    torch.backends.cudnn.deterministic = False
    losses, wall_ms, event_ms, _, peak_gb = timed_steps(trainer, 1, 1)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"losses {losses}")
    return {"ms_per_step_wall": wall_ms[0], "ms_per_step_cuda_events":
            event_ms[0], "peak_memory_gb": peak_gb, "first_loss": losses[0]}


def remat_pair(device):
    """The dp phase's two gloo ranks alone (`dp_pair`: replicated, ZeRO and
    remat, each bit-equal to the replicated run): each rank's peak GB and ms
    a step of each run."""
    start = seeded_state_dict(family_model("deeplabv3plus"), SEED,
                              init="train")
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(os.path.join(tmp, "start.pt"), start)
        seconds = torchrun(2, ["--dp-pair", tmp], timeout=300)
        pair = torch.load(os.path.join(tmp, "pair0.pt"), weights_only=True)
    return {"seconds": seconds, **{f"{tag}_{k}": pair[f"{tag}_{k}"]
                                   for tag in ("replicated", "remat")
                                   for k in ("ms", "peak_gb")}}


def remat_phase(device, profile=False, pair=False):
    """Activation recompute, `--bn-subsample` and `--debug-nans` (ROADMAP
    queue 1 item 5). DeepLabV3+ R50 at 513², batch 32, bf16, remat off and
    on, with the fused 1x1 switch off and on: REMAT_STEPS steps each under
    cuDNN's deterministic algorithms, the remat run bit-equal to the plain
    one, kernel 5 launched 64 forward (the recompute's included) + 32 dx +
    32 dW a step under remat and kernel 2 one forward and one backward;
    then each run's ms a step and peak memory at cuDNN's defaults
    (`remat_figures`). `qat=True` with remat bit-equal to `qat=True`
    without. `--bn-subsample 2` and the debug-NaN switch, each beside the
    plain run's ms a step; under the switch a NaN in one image raises a
    FloatingPointError. Segmenter-B/16 at 512², batch 32, remat off and on:
    ms a step and peak memory. With `pair`, the dp phase's two gloo ranks
    (their remat run bit-equal to their replicated one; the whole script
    runs them in the dp phase). Returns kernels 2 and 5's launches on the
    remat steps with the switch on."""
    t0 = time.perf_counter()
    _, batch = train_batch(device)
    runs, figures, checked = {}, {}, {}
    remat_launches = None
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(tag, b=batch, name="deeplabv3plus", **kw):
            return make_trainer(device, name, b, os.path.join(tmp, tag),
                                **kw)

        for switch in ("off", "on"):
            blocks.set_force_fused_1x1(switch)
            try:
                for remat in (False, True):
                    tag = f"{'remat' if remat else 'plain'}_{switch}"
                    run = trainer(tag, remat=remat)
                    torch.backends.cudnn.deterministic = True
                    ce.reset_launch_count()
                    fm.reset_launch_count()
                    runs[tag] = dp_steps(run, REMAT_STEPS)
                    counts = {"softmax_ce": ce.launch_count(),
                              "fused_matmul_bn": fm.launch_count()}
                    n = REMAT_STEPS
                    # kernel 5: 32 of each a step with the switch on, the
                    # forward again in the recompute under remat
                    on = 32 * n if switch == "on" else 0
                    want = {"softmax_ce": {"fwd": n, "bwd": n},
                            "fused_matmul_bn": {
                                "fwd": (2 if remat else 1) * on,
                                "bwd_dx": on, "bwd_dw": on}}
                    if counts != want:
                        raise AssertionError(f"{tag}: {n} steps launched "
                                             f"{counts}, not {want}")
                    checked[tag] = counts
                    if remat and switch == "on":
                        remat_launches = counts
                    figures[tag] = remat_figures(run)
                    if profile and tag == "remat_off":
                        profile_steps(run, phase="profile_remat")
                    del run
                    release_memory()
            finally:
                blocks.set_force_fused_1x1(None)
                torch.backends.cudnn.deterministic = False
            assert_same_run(f"remat, switch {switch}", runs[f"remat_{switch}"],
                            runs[f"plain_{switch}"])

        torch.backends.cudnn.deterministic = True
        try:
            qat = {}
            for remat in (False, True):
                run = trainer(f"qat_{remat}", qat=True, remat=remat)
                qat[remat] = dp_steps(run, REMAT_STEPS)
                del run
                release_memory()
        finally:
            torch.backends.cudnn.deterministic = False
        assert_same_run("qat with remat", qat[True], qat[False])
        if qat[False][0] == runs["plain_off"][0]:
            raise AssertionError("the QAT steps' losses are the plain ones")

        with blocks.bn_stat_subsample(2):
            run = trainer("subsample")
            figures["bn_subsample_2"] = remat_figures(run)
            del run
            release_memory()
        if figures["bn_subsample_2"]["first_loss"] == \
                runs["plain_off"][0][0]:
            raise AssertionError("--bn-subsample 2 left the loss unchanged")

        with debug_nans():
            run = trainer("debug_nans")
            figures["debug_nans"] = remat_figures(run)
            images, segs, valid = batch
            poisoned = images.clone()
            poisoned[3, 100, 200, 1] = float("nan")
            run.fetcher.batch = (poisoned, segs, valid)
            run.fetcher.n = 1
            try:
                run.step()
            except FloatingPointError as e:
                raised = str(e)
            else:
                raise AssertionError("a NaN image raised nothing under "
                                     "the debug-NaN switch")
            del run
            release_memory()
        if "NaN in the loss" not in raised:
            raise AssertionError(f"the debug-NaN switch raised {raised!r}")

        _, seg_batch = train_batch(device, hw=REMAT_SEGMENTER_IMG)
        for remat in (False, True):
            run = trainer(f"segmenter_{remat}", b=seg_batch,
                          name="segmenter", remat=remat)
            figures[f"segmenter_{'remat' if remat else 'plain'}"] = (
                remat_figures(run))
            del run
            release_memory()
    phase_seconds = time.perf_counter() - t0
    pair_figures = remat_pair(device) if pair else None

    def ratio(key, base):
        return (figures[key]["ms_per_step_cuda_events"]
                / figures[base]["ms_per_step_cuda_events"])
    log("remat", seconds=phase_seconds, batch=TRAIN_BATCH, steps=REMAT_STEPS,
        bit_equal="remat against plain, switch off and on; qat with remat "
                  "against qat",
        launches=checked, figures=figures,
        remat_step_ratio={"switch_off": ratio("remat_off", "plain_off"),
                          "switch_on": ratio("remat_on", "plain_on"),
                          "segmenter": ratio("segmenter_remat",
                                             "segmenter_plain")},
        bn_subsample_2_ratio=ratio("bn_subsample_2", "plain_off"),
        debug_nans_added_ms_per_step={
            k: figures["debug_nans"][k] - figures["plain_off"][k]
            for k in ("ms_per_step_wall", "ms_per_step_cuda_events")},
        debug_nans_raised=raised, qat_losses=qat[True][0],
        pair=pair_figures)
    return remat_launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print torch.profiler tables, by op, of "
                             "the train step (fused 1x1 switch off and on, "
                             "and with remat), the eval step and the "
                             "augmentation")
    parser.add_argument("--families", nargs="+", metavar="KEY",
                        help="after the builds, run only the families phase "
                             "for these FAMILY_IMGS entries (their one-batch "
                             "variants, fused runs and command lines too) "
                             "and stop: no kernels line, no last line")
    parser.add_argument("--losses", action="store_true",
                        help="after the builds, run only the losses phase "
                             "(on a synthetic set of its own) and stop: no "
                             "kernels line, no last line")
    parser.add_argument("--nonsquare", action="store_true",
                        help="after the builds, run only the nonsquare "
                             "phase (on a synthetic set of its own) and "
                             "stop: no kernels line, no last line")
    parser.add_argument("--int8", action="store_true",
                        help="after the builds, run only the int8 phase "
                             "(on a synthetic set of its own) and stop: no "
                             "kernels line, no last line")
    parser.add_argument("--dp", action="store_true",
                        help="after the builds, run only the dp phase and "
                             "stop: no kernels line, no last line")
    parser.add_argument("--remat", action="store_true",
                        help="after the builds, run only the remat phase "
                             "(with the dp phase's two gloo ranks) and "
                             "stop: no kernels line, no last line")
    # the dp phase's own runs under torch.distributed.run
    parser.add_argument("--dp-worker", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--dp-pair", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.dp_worker or args.dp_pair:
        (dp_worker if args.dp_worker else dp_pair)(
            args.dp_worker or args.dp_pair)
        return
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
    if args.dp:
        dp_phase(device)
        return
    if args.remat:
        remat_phase(device, profile=args.profile, pair=True)
        return
    if args.losses or args.nonsquare or args.int8:
        with tempfile.TemporaryDirectory() as tmp:
            cli_data = make_synthetic_coco(
                os.path.join(tmp, "coco"), CLI_TRAIN, CLI_VAL, CLI_WH,
                seed=SEED, num_classes=CLI_CATEGORIES)
            dataset = MemoryDataset(4 * TRAIN_BATCH,
                                    np.random.default_rng(SEED + 6))
            if args.losses:
                losses_phase(device, dataset, cli_data)
            elif args.nonsquare:
                nonsquare_phase(device, cli_data, profile=args.profile)
            else:
                int8_phase(device, dataset, cli_data)
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
    e2e_launches, e2e_ms_per_step = augment_phase(
        device, dataset, train_figures["images_per_s"],
        resample_path.pop("pass_ms"), profile=args.profile)
    resample_launches = e2e_launches["banded_resample"]
    with tempfile.TemporaryDirectory() as cli_tmp:
        cli_launches = cli_phase(device, e2e_ms_per_step, cli_tmp)
        losses_launches = losses_phase(device, dataset,
                                       os.path.join(cli_tmp, "coco"))
        nonsquare_launches, nonsquare_cases = nonsquare_phase(
            device, os.path.join(cli_tmp, "coco"))
        int8_launches = int8_phase(device, dataset,
                                   os.path.join(cli_tmp, "coco"))
    dp_launches = dp_phase(device)
    remat_launches = remat_phase(device, profile=args.profile)
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
         "losses_launches": losses_launches["upsample_argmax"],
         "nonsquare_launches": nonsquare_launches["upsample_argmax"],
         "int8_launches": int8_launches["upsample_argmax"],
         "dp_launches": dp_launches["upsample_argmax"],
         "nonsquare": nonsquare_cases["upsample_argmax"],
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
         "losses_launches": losses_launches["softmax_ce"]["fwd"],
         "nonsquare_launches": nonsquare_launches["softmax_ce"]["fwd"],
         "int8_launches": int8_launches["softmax_ce"]["fwd"],
         "dp_launches": dp_launches["softmax_ce"]["fwd"],
         "remat_launches": remat_launches["softmax_ce"]["fwd"],
         "nonsquare": nonsquare_cases["softmax_ce"]["fwd"],
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
         "losses_launches": losses_launches["softmax_ce"]["bwd"],
         "nonsquare_launches": nonsquare_launches["softmax_ce"]["bwd"],
         "int8_launches": int8_launches["softmax_ce"]["bwd"],
         "dp_launches": dp_launches["softmax_ce"]["bwd"],
         "remat_launches": remat_launches["softmax_ce"]["bwd"],
         "nonsquare": nonsquare_cases["softmax_ce"]["bwd"],
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
         "losses_launches": losses_launches["banded_resample"],
         "nonsquare_launches": nonsquare_launches["banded_resample"],
         "int8_launches": int8_launches["banded_resample"],
         "dp_launches": dp_launches["banded_resample"],
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
         "losses_launches": losses_launches["eval_confusion"],
         "nonsquare_launches": nonsquare_launches["eval_confusion"],
         "int8_launches": int8_launches["eval_confusion"],
         "dp_launches": dp_launches["eval_confusion"],
         "nonsquare": nonsquare_cases["eval_confusion"],
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
         "nonsquare_launches": nonsquare_launches["fused_matmul_bn"]["fwd"],
         "int8_launches": int8_launches["fused_matmul_bn"]["fwd"],
         "dp_launches": dp_launches["fused_matmul_bn"]["fwd"],
         "remat_launches": remat_launches["fused_matmul_bn"]["fwd"],
         "families_launches": family_launches["fused_matmul_bn"]["fwd"],
         "families_launches_by_model": by_model("fused_matmul_bn", "fwd"),
         "families_shapes": len(family_fused), **fused_path["fwd"]},
        {"name": "fused_matmul_bn_bwd_dx", "route": "cuda",
         "source": fused_source, "replaces": fused_replaces + "117",
         "design": "hop::dx_dy_tot_wgmma_kernel + hop::dx_dz_wgmma_kernel: "
                   "two full grids, K-major operands",
         "launches": fused_launches["bwd_dx"],
         "nonsquare_launches":
             nonsquare_launches["fused_matmul_bn"]["bwd_dx"],
         "int8_launches": int8_launches["fused_matmul_bn"]["bwd_dx"],
         "dp_launches": dp_launches["fused_matmul_bn"]["bwd_dx"],
         "remat_launches": remat_launches["fused_matmul_bn"]["bwd_dx"],
         "families_launches": family_launches["fused_matmul_bn"]["bwd_dx"],
         "families_launches_by_model": by_model("fused_matmul_bn", "bwd_dx"),
         "families_shapes": len(family_fused), **fused_path["bwd_dx"]},
        {"name": "fused_matmul_bn_bwd_dw", "route": "cuda",
         "source": fused_source, "replaces": fused_replaces + "156",
         "design": "hop::dw_wgmma_kernel: TMA ring + wgmma, A = z^T and "
                   "B = dy_tot MN-major, N split over blocks (dw_split), "
                   "f32 partials summed by partials.sum(0)",
         "launches": fused_launches["bwd_dw"],
         "nonsquare_launches":
             nonsquare_launches["fused_matmul_bn"]["bwd_dw"],
         "int8_launches": int8_launches["fused_matmul_bn"]["bwd_dw"],
         "dp_launches": dp_launches["fused_matmul_bn"]["bwd_dw"],
         "remat_launches": remat_launches["fused_matmul_bn"]["bwd_dw"],
         "families_launches": family_launches["fused_matmul_bn"]["bwd_dw"],
         "families_launches_by_model": by_model("fused_matmul_bn", "bwd_dw"),
         "families_shapes": len(family_fused), **fused_path["bwd_dw"]},
        {"name": "cmajor_matmul", "route": "cuda", "source": fused_source,
         "replaces": "tools/bench_cmajor.py:64",
         "design": "hop::cmajor_wgmma_kernel: TMA ring + wgmma, W K-major, "
                   "X MN-major, 64-row tiles split over the pixels where "
                   "co <= 64, f32 epilogue of 16-byte stores",
         "launches": cmajor_launches,
         "nonsquare_launches": nonsquare_launches["cmajor_matmul"],
         "int8_launches": int8_launches["cmajor_matmul"],
         "dp_launches": 0,
         **cmajor_path}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
