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
events, median of 10 after 3 warm-ups) and TFLOP/s. First it holds the
kernel against its plain version at ragged shapes (co not a multiple of 64,
pixels not a multiple of 128), one line each.

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
# (ci, co, pix): both tile forms of the kernel (co <= 64: 64-row tiles whose
# warpgroups split the pixels), each with a ragged last tile in co, in pix
# and in the depth
RAGGED = ((200, 40, 10000), (72, 200, 9992))
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


def operands(ci: int, co: int, pix: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((ci, pix)).astype(np.float32)
                         ).to(device, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((co, ci)).astype(np.float32)
                         ).to(device, torch.bfloat16)
    return w, x


def check(w: torch.Tensor, x: torch.Tensor) -> tuple[float, float]:
    """The kernel against its plain version (to TOLERANCE of the largest
    entry) and two launches against each other (bit-equal): (largest
    difference, largest entry)."""
    (co, ci), pix = w.shape, x.shape[1]
    got = cmajor_matmul(w, x)
    again = cmajor_matmul(w, x)
    want = cmajor_matmul_reference(w, x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    if got.dtype != torch.float32 or not err <= TOLERANCE * top:
        raise AssertionError(f"cmajor {ci}->{co} pix={pix}: kernel and "
                             f"plain version differ by {err} (largest entry "
                             f"{top})")
    if not torch.equal(got, again):
        raise AssertionError(f"cmajor {ci}->{co} pix={pix}: two launches "
                             f"differ")
    return err, top


def check_ragged(ci: int, co: int, pix: int, device) -> dict:
    w, x = operands(ci, co, pix, device)
    err, top = check(w, x)
    print(f"cmajor {ci}->{co} pix={pix}: max abs err {err:.3g} (largest "
          f"{top:.3g}), two launches bit-equal", flush=True)
    return {"ci": ci, "co": co, "pix": pix, "max_abs_err": err,
            "largest": top}


def bench_shape(ci: int, co: int, device, batch: int = BATCH,
                side: int = SIDE, seed: int = 0) -> dict:
    """One ci -> co shape: the kernel held against its plain version, then
    the four timings. Returns the numbers it printed."""
    pix = batch * side * side
    w, x = operands(ci, co, pix, device, seed)
    err, top = check(w, x)

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


def main(device=None, shapes=SHAPES, batch: int = BATCH, side: int = SIDE,
         ragged=RAGGED):
    """-> (the timed shapes' rows, the ragged checks' rows)."""
    device = require_cuda() if device is None else torch.device(device)
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    checked = [check_ragged(ci, co, pix, device) for ci, co, pix in ragged]
    return ([bench_shape(ci, co, device, batch, side) for ci, co in shapes],
            checked)


if __name__ == "__main__":
    main()
