#!/usr/bin/env python3
"""Channels-major against pixels-major for the small-channel 1x1
convolutions of ResNet's first stage, on the card (port of
tools/bench_cmajor.py).

  pixels-major:   Y[pix, co] = X[pix, ci] @ W[ci, co]
  channels-major: Y[co, pix] = W[co, ci] @ X[ci, pix]

Times the 1x1 convolution as the model runs it (`F.conv2d` on a
channels_last tensor), `torch.matmul` in both layouts (the three yardsticks:
nothing of the port's model path calls them) and the hand-written
channels-major kernel (`ops/kernels/cmajor_matmul.py`), at ci -> co of
256 -> 64, 64 -> 256 and 576 -> 64 (a 3x3 convolution's 9 x 64 taps as one
product) over 524,288 pixels (batch 32 of 128 x 128), bf16 operands. The
kernel writes f32, the yardsticks bf16. One line per measurement: ms (CUDA
events, median of 10 after 3 warm-ups) and TFLOP/s.

    python -m pytorch_segmentation_tpu_torch.tools.bench_cmajor
"""

from __future__ import annotations

import statistics

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels.cmajor_matmul import cmajor_matmul, cmajor_matmul_reference
from ..utils.runtime import require_cuda

SHAPES = ((256, 64), (64, 256), (576, 64))  # (ci, co)
BATCH, SIDE = 32, 128                       # pix = 524,288
# the kernel against its plain version: the same exact products summed in
# f32 in another order, relative to the output's largest entry
TOLERANCE = 1e-5


def timed_ms(fn, warmup: int = 3, reps: int = 10) -> float:
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


def bench_shape(ci: int, co: int, device, batch: int = BATCH,
                side: int = SIDE, seed: int = 0) -> dict:
    """One ci -> co shape: the kernel held against its plain version, then
    the four timings. Returns the numbers it printed."""
    pix = batch * side * side
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((ci, pix)).astype(np.float32)
                         ).to(device, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((co, ci)).astype(np.float32)
                         ).to(device, torch.bfloat16)
    got = cmajor_matmul(w, x)
    again = cmajor_matmul(w, x)
    want = cmajor_matmul_reference(w, x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    if got.dtype != torch.float32 or not err <= TOLERANCE * top:
        raise AssertionError(f"cmajor {ci}->{co}: kernel and plain version "
                             f"differ by {err} (largest entry {top})")
    if not torch.equal(got, again):
        raise AssertionError(f"cmajor {ci}->{co}: two launches differ")
    del got, again, want

    x_pm = x.t().contiguous()                      # [pix, ci]
    w_pm = w.t().contiguous()                      # [ci, co]
    x_img = x_pm.view(batch, side, side, ci).permute(0, 3, 1, 2)
    w_conv = w.view(co, ci, 1, 1)
    flops = 2.0 * ci * co * pix
    ms = {
        "conv2d_channels_last": timed_ms(lambda: F.conv2d(x_img, w_conv)),
        "matmul_pixels_major": timed_ms(lambda: torch.matmul(x_pm, w_pm)),
        "matmul_channels_major": timed_ms(lambda: torch.matmul(w, x)),
        "kernel_channels_major": timed_ms(lambda: cmajor_matmul(w, x)),
        "plain_channels_major": timed_ms(
            lambda: cmajor_matmul_reference(w, x)),
    }
    for name, t in ms.items():
        print(f"cmajor {ci}->{co} pix={pix} {name}: {t:7.3f} ms "
              f"{flops / t / 1e9:6.1f} TFLOP/s", flush=True)
    return {"ci": ci, "co": co, "pix": pix, "max_abs_err": err,
            "largest": top, "flops": flops,
            # every operand read once, the f32 output written once
            "bytes": 2 * (ci * pix + co * ci) + 4 * co * pix, **ms}


def main(device=None, shapes=SHAPES, batch: int = BATCH, side: int = SIDE):
    device = require_cuda() if device is None else torch.device(device)
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    return [bench_shape(ci, co, device, batch, side) for ci, co in shapes]


if __name__ == "__main__":
    main()
