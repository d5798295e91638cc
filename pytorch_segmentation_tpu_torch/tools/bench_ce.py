#!/usr/bin/env python3
"""The upsample+cross-entropy kernels alone, on the card, at the train
step's shape: logits [32, 129, 129, 21] -> labels 513 x 513,
align_corners, bf16 and f32 logits, inputs from a seed.

It prints the card's name and power limit, then for each dtype the ms of
`_launch_fwd` with lse (as the train step calls it) and without (as the
eval step does) and of `_launch_bwd` on the forward's saved tensors (CUDA
events, median of 20 after 3 warm-ups).
`--save PATH` writes, for both dtypes, the forward's per-sample sums and
lse and the gradient through autograd, so that two checkouts' kernels can be
timed and held against each other bit for bit on the same inputs in one
call: `--compare A B` reads two such files and prints, per dtype and tensor,
whether they are equal and by how much they differ (lse also in f32 ulps).

The script imports the package by its absolute name, so run as a file with
PYTHONPATH set to the root of a checkout it times that checkout's kernels
(the checkout needs `_launch_fwd(logits, labels, align_corners, want_lse)`
and `_launch_bwd(logits, labels, lse, grad_out, align_corners)`):

    PYTHONPATH=. python pytorch_segmentation_tpu_torch/tools/bench_ce.py \
        --save new.pt
    PYTHONPATH=path/to/older python \
        pytorch_segmentation_tpu_torch/tools/bench_ce.py --save old.pt
    python -m pytorch_segmentation_tpu_torch.tools.bench_ce \
        --compare old.pt new.pt
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from pytorch_segmentation_tpu_torch.ops.kernels import softmax_ce as ce

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
        sums, lse, labels = ce._launch_fwd(x, y, True, want_lse=True)
        xg = x.clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(ce.fused_upsample_ce(xg, y, True), xg)
        torch.cuda.synchronize()
        saved[name] = {"sums": sums.cpu(), "lse": lse.cpu(),
                       "dlogits": grad.cpu()}
        del xg, grad
        fwd_ms = timed_ms(lambda: ce._launch_fwd(x, y, True, want_lse=True))
        # as the eval step calls it: the loss alone, no lse written
        loss_ms = timed_ms(lambda: ce._launch_fwd(x, y, True,
                                                  want_lse=False))
        one = torch.ones((), device=device)
        bwd_ms = timed_ms(lambda: ce._launch_bwd(x, labels, lse, one, True))
        print(json.dumps({"dtype": name, "fwd_kernel_ms": fwd_ms,
                          "fwd_no_lse_kernel_ms": loss_ms,
                          "bwd_kernel_ms": bwd_ms}), flush=True)
    if args.save:
        torch.save(saved, args.save)


def f32_ulps(a, b):
    """Largest distance of two f32 tensors in units in the last place
    (the number of representable floats between them)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    for name in DTYPES:
        for key in ("sums", "lse", "dlogits"):
            ta, tb = a[name][key], b[name][key]
            diff = (ta.float() - tb.float()).abs()
            row = {"dtype": name, "tensor": key,
                   "bit_equal": bool(torch.equal(ta, tb)),
                   "elements_differing": int((ta != tb).sum()),
                   "max_abs_diff": float(diff.max()),
                   "largest_entry": float(ta.float().abs().max())}
            if key == "sums":
                row["max_rel_diff"] = float((diff / tb.float().abs()).max())
            if key == "lse":
                row["max_ulps"] = f32_ulps(ta, tb)
            print(json.dumps(row), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--save", help="write sums, lse and gradients (.pt)")
    parser.add_argument("--compare", nargs=2, metavar=("A", "B"),
                        help="compare two files written by --save")
    args = parser.parse_args()
    if args.compare:
        compare(*args.compare)
    else:
        run(args)


if __name__ == "__main__":
    main()
