"""Channels-major 1x1 convolution as one matrix product: Y[co, pix] =
W[co, ci] @ X[ci, pix], with the pixels in the contiguous dimension of X and
Y (port of `pallas_cmajor` / `_mm_kernel` in tools/bench_cmajor.py). bf16
operands, f32 sums, f32 output.

On a CUDA tensor `cmajor_matmul` launches the hand-written kernel
`pseg_cmajor_matmul` of `csrc/fused_matmul_bn.cu`: the tile loop of the
fused 1x1 forward without prologue and epilogue, with the operands the other
way round. On a CPU tensor it runs `cmajor_matmul_reference`, the plain
PyTorch version. A CUDA tensor gets the kernel or an exception. Only
`tools/bench_cmajor.py` calls it: the question it answers is whether the
small-channel products of ResNet's first stage run better with the pixels,
not the channels, across a tile's columns.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_kernel_library

__all__ = ["cmajor_matmul", "cmajor_matmul_reference", "launch_count",
           "reset_launch_count"]

_launches = 0


def launch_count() -> int:
    """How many times the CUDA kernel has been launched in this process."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def cmajor_matmul_reference(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the f32 product of the bf16-rounded
    operands (their products are exact in f32)."""
    return (w.to(torch.bfloat16).float() @ x.to(torch.bfloat16).float())


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    fn = load_kernel_library("fused_matmul_bn").pseg_cmajor_matmul
    ptr = ctypes.c_void_p
    fn.restype = ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ptr]
    return fn


def cmajor_matmul(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w [co, ci] and x [ci, pix], both bf16 and contiguous, ci and pix
    multiples of 8 -> y [co, pix] f32."""
    global _launches
    if w.dim() != 2 or x.dim() != 2 or w.shape[1] != x.shape[0]:
        raise ValueError(f"w must be [co, ci] and x [ci, pix], got "
                         f"{tuple(w.shape)} and {tuple(x.shape)}")
    if w.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise TypeError(f"cmajor_matmul takes bfloat16 operands, not "
                        f"{w.dtype} and {x.dtype}")
    co, ci = w.shape
    pix = x.shape[1]
    if co < 1 or ci < 8 or pix < 8 or ci % 8 or pix % 8:
        raise ValueError(f"ci and pix must be multiples of 8, got {ci} and "
                         f"{pix} (co {co})")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if x.device.type == "cpu":
        return cmajor_matmul_reference(w, x)
    if x.device.type != "cuda":
        raise ValueError(f"cmajor_matmul: no path for device {x.device}")
    if not (w.is_contiguous() and x.is_contiguous()
            and w.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0):
        raise ValueError("cmajor_matmul needs contiguous, 16-byte aligned "
                         "operands")
    y = torch.empty((co, pix), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _kernel_fn()(w.data_ptr(), x.data_ptr(), y.data_ptr(), co, ci,
                           pix, stream)
    if err != 0:
        raise RuntimeError(f"cmajor_matmul kernel launch failed: CUDA error "
                           f"{err}")
    _launches += 1
    return y
