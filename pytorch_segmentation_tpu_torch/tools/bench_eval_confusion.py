#!/usr/bin/env python3
"""The upsample+argmax+confusion kernel alone, on the card, at the eval
step's shape: logits [32, 129, 129, 21] -> labels 513 x 513,
align_corners, bf16 and f32 logits, int32 labels, inputs from a seed.

It prints the card's name and power limit, then for each dtype the ms of
`_launch` (the zeroed count buffer and the kernel) and of the wrapper
`fused_eval_confusion` (with its masked sum over the batch), CUDA events
around one call, median of 20 after 3 warm-ups. Such a time also holds the
host's enqueue of the call: the device waits for the launch. So it prints
`_launch`'s device time as well: 20 calls queued behind a sleep kernel run
back to back, their events' time over 20, median of 5.
`--save PATH` writes, for both dtypes, the per-sample counts `_launch`
returns (int32 [32, 3, 21]), so that two checkouts' kernels can be timed
and held against each other on the same inputs in one call: `--compare A B`
reads two such files and prints, per dtype, whether the counts are equal
and how many entries differ.

The script imports the package by its absolute name, so run as a file with
PYTHONPATH set to the root of a checkout it times that checkout's kernel
(the checkout needs `_launch(logits, labels, align_corners)`):

    PYTHONPATH=. python \
        pytorch_segmentation_tpu_torch/tools/bench_eval_confusion.py \
        --save new.pt
    PYTHONPATH=path/to/older python \
        pytorch_segmentation_tpu_torch/tools/bench_eval_confusion.py \
        --save old.pt
    python -m pytorch_segmentation_tpu_torch.tools.bench_eval_confusion \
        --compare old.pt new.pt
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from pytorch_segmentation_tpu_torch.ops.kernels import eval_confusion as ec

SHAPE, OUT_HW, SEED = (32, 129, 129, 21), (513, 513), 0
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def timed_ms(fn, warmup: int = 3, reps: int = 20) -> float:
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


def queued_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms per call of `fn`, without the host's: the device is held
    by a sleep kernel while the host enqueues `calls` calls, which then run
    back to back between the two events."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # ~0.1 s: longer than the enqueue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def seeded_inputs(dtype, device):
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)).to(
        device=device, dtype=dtype)
    y = torch.from_numpy(rng.integers(0, SHAPE[-1], (SHAPE[0],) + OUT_HW)).to(
        device=device, dtype=torch.int32)
    return x, y


def run(args):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool runs only on the GPU")
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    saved = {}
    for name, dtype in DTYPES.items():
        x, y = seeded_inputs(dtype, device)
        counts = ec._launch(x, y, True)
        torch.cuda.synchronize()
        saved[name] = counts.cpu()
        launch_ms = timed_ms(lambda: ec._launch(x, y, True))
        wrapper_ms = timed_ms(lambda: ec.fused_eval_confusion(x, y, SHAPE[0]))
        device_ms = queued_ms(lambda: ec._launch(x, y, True))
        print(json.dumps({"dtype": name, "launch_ms": launch_ms,
                          "wrapper_ms": wrapper_ms,
                          "launch_device_ms": device_ms}), flush=True)
    if args.save:
        torch.save(saved, args.save)


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    for name in DTYPES:
        print(json.dumps({"dtype": name,
                          "counts_equal": bool(torch.equal(a[name], b[name])),
                          "entries_differing": int((a[name] != b[name]).sum()),
                          "pixels_counted": int(a[name][:, 2].sum())}),
              flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--save", help="write the per-sample counts (.pt)")
    parser.add_argument("--compare", nargs=2, metavar=("A", "B"),
                        help="compare two files written by --save")
    args = parser.parse_args()
    if args.compare:
        compare(*args.compare)
    else:
        run(args)


if __name__ == "__main__":
    main()
