#!/usr/bin/env python3
"""The fused 1x1 kernels at every shape of the ResNet-50 train step, on the
card (port of tools/bench_fused_matmul.py).

DeepLabV3+ on a dilated ResNet-50 at batch 32, 513x513, routes conv1 and
conv3 of its 16 bottlenecks through `fused_bn_act_matmul` when
`nn.blocks.set_force_fused_1x1("on")`: 32 calls per forward at 12 distinct
shapes (N rows, K -> M channels). For each shape this prints the ms (CUDA
events, median of 10 after 3 warm-ups) of the forward, dx and dW kernels
and of one `torch.matmul` of the same product each (a yardstick: no
prologue, no statistics, no mask; the port never calls it), the share of dW
that sums its split partials (`partials.sum(0)`, included in dW's time),
then the sums over one train step, weighted by how often the step runs each
shape.

Last, the host's time per call of the forward and dx launchers
(`host_us`): bf16, whose Hopper kernels encode their TMA descriptors on the
host at every call, beside f32, whose older loop takes none, at one shape of
the step.

    python -m pytorch_segmentation_tpu_torch.tools.bench_fused_matmul
"""

from __future__ import annotations

import time

import torch

from ..ops.kernels import fused_matmul_bn as fm
from ..utils.runtime import require_cuda
from .bench_cmajor import timed_ms

# (N, K, M, calls per step): stage 1 at 129x129 per image, stage 2 at 65x65,
# stages 3 and 4 (dilated) at 33x33; a stage's first conv1 runs before its
# stride
N1, N2, N3 = 32 * 129 * 129, 32 * 65 * 65, 32 * 33 * 33
SHAPES = (
    (N1, 64, 64, 1), (N1, 64, 256, 3), (N1, 256, 64, 2), (N1, 256, 128, 1),
    (N2, 128, 512, 4), (N2, 512, 128, 3), (N2, 512, 256, 1),
    (N3, 256, 1024, 6), (N3, 1024, 256, 5), (N3, 1024, 512, 1),
    (N3, 512, 2048, 3), (N3, 2048, 512, 2),
)
HOST_SHAPE = (N3, 1024, 256)  # the step's most frequent stage-3 shape


def _operands(n, k, m, device, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, k, generator=gen, device=device).to(dtype)
    scale = torch.rand(k, generator=gen, device=device) + 0.5
    shift = torch.randn(k, generator=gen, device=device) * 0.2
    w = (torch.randn(k, m, generator=gen, device=device) * 0.1).to(dtype)
    dy = torch.randn(n, m, generator=gen, device=device).to(dtype)
    dsum = torch.randn(m, generator=gen, device=device) * 0.01
    dsumsq = torch.randn(m, generator=gen, device=device) * 0.001
    return x, scale, shift, w, w.t().contiguous(), dy, dsum, dsumsq


def bench_shape(n: int, k: int, m: int, device, dtype=torch.bfloat16,
                seed: int = 0) -> dict:
    x, scale, shift, w, wt, dy, dsum, dsumsq = _operands(n, k, m, device,
                                                         dtype, seed)
    with torch.no_grad():
        dy_tot = fm._launch_bwd_dx(x, scale, shift, w, dy, dsum, dsumsq,
                                   "relu", wt)[3]
        partials = torch.empty((fm.dw_split(n, k, m)[0], k, m),
                               dtype=torch.float32, device=device)
        return {
            "fwd": timed_ms(lambda: fm._launch_fwd(x, scale, shift, w,
                                                   "relu", wt)),
            "bwd_dx": timed_ms(lambda: fm._launch_bwd_dx(
                x, scale, shift, w, dy, dsum, dsumsq, "relu", wt)),
            "bwd_dw": timed_ms(lambda: fm._launch_bwd_dw(x, scale, shift,
                                                         dy_tot, "relu")),
            "matmul_fwd": timed_ms(lambda: torch.matmul(x, w)),
            "matmul_dx": timed_ms(lambda: torch.matmul(dy, wt)),
            "matmul_dw": timed_ms(lambda: torch.matmul(x.t(), dy)),
            "dw_partials_sum": timed_ms(lambda: partials.sum(0))}


def host_us(n: int, k: int, m: int, device, dtype=torch.bfloat16,
            calls: int = 64) -> dict:
    """Mean host microseconds per call of `_launch_fwd` and
    `_launch_bwd_dx`: `calls` calls issued back to back without a sync onto
    an idle stream (a few hundred kernels: the launch queue does not fill,
    so the host never waits for the card), after 3 warm-ups."""
    ops = _operands(n, k, m, device, dtype)
    x, scale, shift, w, wt, dy, dsum, dsumsq = ops
    launchers = {
        "fwd": lambda: fm._launch_fwd(x, scale, shift, w, "relu", wt),
        "bwd_dx": lambda: fm._launch_bwd_dx(x, scale, shift, w, dy, dsum,
                                            dsumsq, "relu", wt)}
    out = {}
    with torch.no_grad():
        for name, fn in launchers.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out[name] = 1e6 * (time.perf_counter() - t0) / calls
            torch.cuda.synchronize()
    return out


def main(device=None, shapes=SHAPES):
    device = require_cuda() if device is None else torch.device(device)
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    totals: dict = {}
    for n, k, m, calls in shapes:
        ms = bench_shape(n, k, m, device)
        flops = 2.0 * n * k * m
        print(f"fused N={n} {k}->{m} x{calls}: " + "  ".join(
            f"{name} {t:.4f} ms ({flops / t / 1e9:.0f} TFLOP/s)"
            for name, t in ms.items()), flush=True)
        for name, t in ms.items():
            totals[name] = totals.get(name, 0.0) + calls * t
    print("per train step (32 calls of each): " + "  ".join(
        f"{name} {t:.3f} ms" for name, t in totals.items()), flush=True)
    n, k, m = HOST_SHAPE
    host = {str(dtype).replace("torch.", ""): host_us(n, k, m, device, dtype)
            for dtype in (torch.bfloat16, torch.float32)}
    print(f"host us per launcher call, N={n} {k}->{m}: " + "  ".join(
        f"{dt} {name} {t:.1f}" for dt, row in host.items()
        for name, t in row.items()), flush=True)
    return totals, host


if __name__ == "__main__":
    main()
