"""Post-training int8 quantization for serving, evaluation and inference
(port of pytorch_segmentation_tpu/quant.py).

Scheme (the JAX package's):
  - weights: symmetric per-out-channel int8, scales from |w| max, folded
    into the conv's f32 rescale;
  - activations: symmetric per-tensor int8, one scale per ConvNormAct
    input: the abs-max over calibration batches ("int8") or the live
    batch's ("int8dyn", no calibration);
  - the product accumulates in int32 (`ops/int8.int8_conv2d`, exact), then
    one f32 multiply by s_x * s_w[out channel]; BatchNorm (running
    statistics) and the activation run unquantized;
  - grouped and depthwise convs, the folded 1x1 path and everything outside
    ConvNormAct (residual adds, resizes, the class conv, the upsample+argmax
    kernel) stay in the compute dtype.

The mode belongs to the calling thread (`nn.blocks.set_quant_mode`): the
helpers here set it around their own forwards only, so a bf16 forward of
the same model, on this thread or another, is never quantized.

Calibration statistics (`quant_stats`) are a plain mapping from a
ConvNormAct's qualified name to an f32 0-d tensor, one for each eligible
(groups == 1) ConvNormAct that the forward runs, outside the state_dict;
`utils/weights.quant_stats_from_jax` reads the JAX package's collection.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from .data.pipeline import normalize_images
from .nn import blocks

__all__ = ["quant_mode", "quant_min_k", "calibrate", "calibrate_from_u8",
           "make_quant_mask_fn", "stats_by_module", "quantized_forward"]


@contextmanager
def quant_mode(mode, stats=None):
    """The calling thread's quant mode (and statistics, by module: see
    `stats_by_module`) inside the block; the previous ones after it."""
    prev = blocks.get_quant_mode(), blocks.get_quant_stats()
    blocks.set_quant_mode(mode, stats)
    try:
        yield
    finally:
        blocks.set_quant_mode(*prev)


@contextmanager
def quant_min_k(min_k: int):
    """The int8 gate inside the block: only convs with contraction K =
    kh*kw*Cin >= min_k are quantized; 0 quantizes every eligible conv."""
    prev = blocks.get_quant_min_k()
    blocks.set_quant_min_k(min_k)
    try:
        yield
    finally:
        blocks.set_quant_min_k(prev)


def stats_by_module(model: torch.nn.Module, quant_stats) -> dict:
    """`quant_stats` (qualified name -> 0-d value) keyed by `model`'s
    ConvNormAct modules instead, as f32 tensors on the model's device. A
    name that is not a ConvNormAct of `model` raises a KeyError."""
    device = next(model.parameters()).device
    modules = dict(model.named_modules())
    out = {}
    for name, value in quant_stats.items():
        module = modules.get(name)
        if not isinstance(module, blocks.ConvNormAct):
            raise KeyError(f"quant_stats entry {name!r} is not a "
                           f"ConvNormAct of this model")
        out[module] = torch.as_tensor(value, dtype=torch.float32,
                                      device=device).reshape(())
    return out


def quantized_forward(fwd, model: torch.nn.Module, quant_stats=None):
    """`fwd` (any forward of `model`) run in "int8" mode with
    `quant_stats`, or in "int8dyn" when it is None."""
    if quant_stats is None:
        mode, stats = "int8dyn", None
    else:
        mode, stats = "int8", stats_by_module(model, quant_stats)

    def run(x):
        with quant_mode(mode, stats):
            return fwd(x)
    return run


def calibrate(model: torch.nn.Module, batches) -> dict:
    """Calibration forwards of the eval-mode `model` over `batches`, an
    iterable of NORMALIZED NHWC float batches [B, H, W, 3] (the serving
    path's preprocessing: the scales must see its values). Returns the
    running abs-max of each eligible ConvNormAct's input by qualified name
    ({} for a model without one, e.g. SegFormer)."""
    from .engine.steps import nhwc_forward, require_eval_mode
    require_eval_mode(model.modules(), "calibrate")
    fwd = nhwc_forward(model)
    device = next(model.parameters()).device
    stats = {}
    n = 0
    with torch.inference_mode(), quant_mode("calib", stats):
        for x in batches:
            fwd(torch.as_tensor(x).to(device))
            n += 1
    if not n:
        raise ValueError("calibrate() needs at least one batch")
    return {name: stats[m].clone() for name, m in model.named_modules()
            if m in stats}


def _normalize_u8(images_u8, legacy_preproc: bool, device) -> torch.Tensor:
    if not isinstance(images_u8, torch.Tensor):
        images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
    x = images_u8.to(device)
    if legacy_preproc:
        return x.to(torch.float32) / 255.0
    return normalize_images(x)


def calibrate_from_u8(model: torch.nn.Module, calib_images_u8,
                      legacy_preproc: bool = False) -> dict:
    """Calibrate from raw u8 RGB batches (the serving input contract): one
    [B, H, W, 3] array or tensor, or an iterable of them."""
    if hasattr(calib_images_u8, "shape"):
        calib_images_u8 = [calib_images_u8]
    device = next(model.parameters()).device
    return calibrate(model, (_normalize_u8(b, legacy_preproc, device)
                             for b in calib_images_u8))


def make_quant_mask_fn(model: torch.nn.Module, out_hw=None,
                       legacy_preproc: bool = False, quant_stats=None,
                       mesh=None):
    """The int8 twin of `inference.make_mask_fn`: fn(images_u8 [B, H, W, 3]
    RGB) -> int32 masks [B, *out_hw] on the model's device, every eligible
    conv on the exact int8 product, the low-resolution logits through
    `fused_upsample_argmax`. quant_stats: from `calibrate` /
    `calibrate_from_u8`; None takes dynamic scales ("int8dyn"). mesh: one
    process's local cards, as `inference.make_mask_fn` takes it."""
    from .inference import build_mask_fn
    return build_mask_fn(model, out_hw, legacy_preproc, "make_quant_mask_fn",
                         quant=True, quant_stats=quant_stats, mesh=mesh)
