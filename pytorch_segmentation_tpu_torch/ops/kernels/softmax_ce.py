"""Fused bilinear upsample + softmax cross-entropy: logits [B, h, w, C] and
labels [B, H, W] -> mean over pixels of `logsumexp_c(up) - up[label]`, where
`up` is the bilinear upsampling of the logits to the labels' size, without
ever writing `up` (port of pytorch_segmentation_tpu/ops/pallas/softmax_ce.py).

On a CUDA tensor `fused_upsample_ce` goes through a `torch.autograd.Function`
whose forward and backward launch the hand-written kernels in
`csrc/softmax_ce.cu` (forward: one thread per output pixel, 2x2 tap gather,
online logsumexp; backward: gather form over a transposed tap table, no
atomics; see the note there for what bounds them). On a CPU tensor it runs
`upsample_ce_reference`, the plain PyTorch version that autograd
differentiates and that the tests hold against the JAX package. There is no
fallback from one to the other: a CUDA tensor gets the kernels or an
exception.

A label outside [0, C) matches no class: its true logit counts as 0 and its
one-hot row is empty, as in the TPU kernel's compare. `ignore_index` is not
part of the fused path (nor is it in the JAX package's).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..resize import _interp_weights, resize_bilinear
from .build import load_kernel_library
from .upsample_argmax import _device_taps

__all__ = ["fused_upsample_ce", "fused_upsample_ce_per_sample",
           "upsample_ce_reference", "interp_taps_transposed", "launch_count",
           "reset_launch_count"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_CODE = {torch.int32: 0, torch.int64: 1}
_FWD_THREADS = 256  # ce_fwd_kernel's block size: sizes the partials buffer
_launches = {"fwd": 0, "bwd": 0}


def launch_count() -> dict:
    """How many times each CUDA kernel has been launched in this process:
    {'fwd': n, 'bwd': n}."""
    return dict(_launches)


def reset_launch_count() -> None:
    _launches["fwd"] = 0
    _launches["bwd"] = 0


def _per_pixel_reference(logits, labels, align_corners):
    """f32 `lse - true_logit` per pixel [B, H, W], plain PyTorch."""
    up = resize_bilinear(logits.float(), labels.shape[1:3],
                         align_corners=align_corners)
    lse = torch.logsumexp(up, dim=-1)
    labels = labels.long()
    inside = (labels >= 0) & (labels < up.shape[-1])
    safe = torch.where(inside, labels, torch.zeros_like(labels))
    true_logit = up.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    return lse - true_logit * inside.to(up.dtype)


def upsample_ce_reference(logits: torch.Tensor, labels: torch.Tensor,
                          align_corners: bool = True) -> torch.Tensor:
    """The plain PyTorch version: f32 bilinear upsample, logsumexp minus the
    label's logit, mean over all pixels. Differentiable by autograd."""
    return _per_pixel_reference(logits, labels, align_corners).mean()


@functools.lru_cache(maxsize=64)
def interp_taps_transposed(in_size: int, out_size: int, align_corners: bool):
    """The columns of `_interp_weights(in_size, out_size)`, one per source
    index: (start int32 [in], count int32 [in], weight f32 [in, width]),
    numpy. Source index i is touched by the `count[i]` consecutive output
    indices from `start[i]`, with the matrix's own entries
    `weight[i, :count[i]]` (zero beyond). A source index that no output reads
    (downsampling) has count 0."""
    mat = _interp_weights(in_size, out_size, align_corners)
    touched = mat != 0
    any_touch = touched.any(axis=0)
    first = np.where(any_touch, touched.argmax(axis=0), 0)
    last = np.where(any_touch, out_size - 1 - touched[::-1].argmax(axis=0), -1)
    count = (last - first + 1).astype(np.int32)
    width = max(int(count.max()), 1)
    weight = np.zeros((in_size, width), np.float32)
    for i in range(in_size):
        weight[i, :count[i]] = mat[first[i]:first[i] + count[i], i]
    table = (first.astype(np.int32), count, weight)
    for a in table:
        a.flags.writeable = False
    return table


@functools.lru_cache(maxsize=64)
def _device_taps_transposed(in_size, out_size, align_corners, device):
    return [torch.tensor(a, device=device)
            for a in interp_taps_transposed(in_size, out_size, align_corners)]


@functools.lru_cache(maxsize=1)
def _kernel_fns():
    lib = load_kernel_library("softmax_ce")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fwd = lib.pseg_softmax_ce_fwd
    fwd.restype = ctypes.c_int
    fwd.argtypes = ([ptr, i32, i32, i32] + [i64] * 4 + [i32, i32, ptr, i32]
                    + [ptr] * 8 + [ptr] * 4)
    bwd = lib.pseg_softmax_ce_bwd
    bwd.restype = ctypes.c_int
    bwd.argtypes = ([ptr] + [i32] * 5 + [i64] * 4 + [ptr] + [i64] * 4
                    + [i32, i32, ptr, i32, ptr] + [ptr] * 8
                    + [ptr, ptr, ptr, i32] * 2 + [ptr, ctypes.c_float, ptr])
    return fwd, bwd


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 4:
        raise ValueError(f"logits must be [B, h, w, C], got "
                         f"{tuple(logits.shape)}")
    if labels.dim() != 3 or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"labels must be [B, H, W] with the logits' batch, "
                         f"got {tuple(labels.shape)} for logits "
                         f"{tuple(logits.shape)}")
    if (labels.dtype.is_floating_point or labels.dtype.is_complex
            or labels.dtype == torch.bool):
        raise TypeError(f"labels must be integers, not {labels.dtype}")
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"softmax_ce takes float32 or bfloat16 logits, not "
                        f"{logits.dtype}")
    if labels.device != logits.device:
        raise ValueError(f"logits on {logits.device}, labels on "
                         f"{labels.device}")


def _kernel_inputs(logits, labels):
    if any(s < 0 for s in logits.stride()):
        raise ValueError("softmax_ce kernels need non-negative strides")
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1], labels.shape[2]
    if min(b, h, w, c, out_h, out_w) < 1:
        raise ValueError(f"empty softmax_ce input {tuple(logits.shape)} -> "
                         f"{(out_h, out_w)}")
    if max(b, c, h, w, out_h, out_w) >= 2 ** 31:  # passed to C as int
        raise ValueError("softmax_ce shape out of range")
    if labels.dtype not in _LABEL_CODE:
        labels = labels.to(torch.int32)
    return labels.contiguous()


def _launch_fwd(logits, labels, align_corners, want_lse):
    """-> (per-sample sums of the pixel losses f32 [B], lse f32 [B, H, W] or
    None, the labels as the kernels read them)."""
    labels = _kernel_inputs(logits, labels)
    fwd, _ = _kernel_fns()
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1], labels.shape[2]
    dev = logits.device
    th = _device_taps(h, out_h, align_corners, dev)
    tw = _device_taps(w, out_w, align_corners, dev)
    blocks_per_sample = -(-(out_h * out_w) // _FWD_THREADS)
    partials = torch.empty((b, blocks_per_sample), dtype=torch.float32,
                           device=dev)
    sums = torch.empty((b,), dtype=torch.float32, device=dev)
    lse = (torch.empty((b, out_h, out_w), dtype=torch.float32, device=dev)
           if want_lse else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fwd(logits.data_ptr(), _DTYPE_CODE[logits.dtype], b, c,
                  *logits.stride(), out_h, out_w, labels.data_ptr(),
                  _LABEL_CODE[labels.dtype],
                  *(t.data_ptr() for t in th), *(t.data_ptr() for t in tw),
                  lse.data_ptr() if want_lse else None, partials.data_ptr(),
                  sums.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"softmax_ce forward kernel launch failed: CUDA "
                           f"error {err}")
    _launches["fwd"] += 1
    return sums, lse, labels


def _launch_bwd(logits, labels, lse, grad_out, align_corners):
    """dlogits, in the logits' dtype and layout, from what the forward kept
    (`labels` as `_launch_fwd` returned them) and the 0-d cotangent."""
    _, bwd = _kernel_fns()
    b, h, w, c = logits.shape
    out_h, out_w = labels.shape[1], labels.shape[2]
    dev = logits.device
    th = _device_taps(h, out_h, align_corners, dev)
    tw = _device_taps(w, out_w, align_corners, dev)
    tth = _device_taps_transposed(h, out_h, align_corners, dev)
    ttw = _device_taps_transposed(w, out_w, align_corners, dev)
    dlogits = torch.empty_like(logits)  # dense logits keep their strides
    grad_out = grad_out.to(torch.float32).reshape(1).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = bwd(logits.data_ptr(), _DTYPE_CODE[logits.dtype], b, h, w, c,
                  *logits.stride(), dlogits.data_ptr(), *dlogits.stride(),
                  out_h, out_w, labels.data_ptr(), _LABEL_CODE[labels.dtype],
                  lse.data_ptr(),
                  *(t.data_ptr() for t in th), *(t.data_ptr() for t in tw),
                  *(t.data_ptr() for t in tth), tth[2].shape[1],
                  *(t.data_ptr() for t in ttw), ttw[2].shape[1],
                  grad_out.data_ptr(), 1.0 / (b * out_h * out_w), stream)
    if err != 0:
        raise RuntimeError(f"softmax_ce backward kernel launch failed: CUDA "
                           f"error {err}")
    _launches["bwd"] += 1
    return dlogits


class _FusedUpsampleCE(torch.autograd.Function):
    """Mean upsample+CE through the CUDA kernels; the backward kernel reads
    the logits, the labels and the forward's per-pixel logsumexp."""

    @staticmethod
    def forward(ctx, logits, labels, align_corners):
        want_grad = ctx.needs_input_grad[0]
        sums, lse, labels = _launch_fwd(logits, labels, align_corners,
                                        want_lse=want_grad)
        if want_grad:
            ctx.save_for_backward(logits, labels, lse)
            ctx.align_corners = align_corners
        n = logits.shape[0] * labels.shape[1] * labels.shape[2]
        return sums.sum() / n

    @staticmethod
    def backward(ctx, grad_out):
        logits, labels, lse = ctx.saved_tensors
        return (_launch_bwd(logits, labels, lse, grad_out,
                            ctx.align_corners), None, None)


def fused_upsample_ce(logits: torch.Tensor, labels: torch.Tensor,
                      align_corners: bool = True) -> torch.Tensor:
    """logits [B, h, w, C] (f32 or bf16, any strides), labels [B, H, W]
    (integers) -> the mean softmax cross-entropy of the bilinearly upsampled
    logits, a 0-d f32 tensor. The gradient comes back in the logits' dtype.

    CUDA tensors go through the hand-written kernels, CPU tensors through
    `upsample_ce_reference`; any other device raises."""
    _check(logits, labels)
    if logits.device.type == "cuda":
        return _FusedUpsampleCE.apply(logits, labels, bool(align_corners))
    if logits.device.type == "cpu":
        return upsample_ce_reference(logits, labels, align_corners)
    raise ValueError(f"fused_upsample_ce: no path for device {logits.device}")


def fused_upsample_ce_per_sample(logits: torch.Tensor, labels: torch.Tensor,
                                 align_corners: bool = True) -> torch.Tensor:
    """Per-sample mean cross-entropy f32 [B], forward only (no gradient):
    lets an eval loop mask padded samples out of the loss."""
    _check(logits, labels)
    logits = logits.detach()
    if logits.device.type == "cuda":
        sums, _, _ = _launch_fwd(logits, labels, bool(align_corners),
                                 want_lse=False)
        return sums / (labels.shape[1] * labels.shape[2])
    if logits.device.type == "cpu":
        return _per_pixel_reference(logits, labels,
                                    align_corners).mean(dim=(1, 2))
    raise ValueError(f"fused_upsample_ce_per_sample: no path for device "
                     f"{logits.device}")
