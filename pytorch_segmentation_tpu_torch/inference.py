"""Inference and mask serving paths (port of pytorch_segmentation_tpu/
inference.py: `make_infer_fn`, `inference`, `make_mask_fn`, `_tile_offsets`,
`make_tiled_mask_fn`, and the root `inference.py` CLI as `main`).

`inference()` is the CLI's contract: each image resized to `img_size` (u8
bilinear, as cv2.resize), the model's softmax probabilities, each map
resized back to its image's own size (f32 bilinear with half-pixel centres)
and argmaxed. It resizes probabilities, not logits, so it does not go
through the upsample+argmax kernel.
Fixed size: normalize -> forward -> upsample+argmax, on the model's device.
The model's low-resolution logits (stride 2 for UNet, 4 for DeepLabV3+ and
HRNet, each with its own `up_align_corners`) go through
`fused_upsample_argmax`: the hand-written kernel
on a CUDA tensor, its plain PyTorch version on a CPU tensor. Softmax is
skipped: the per-pixel argmax of the logits equals that of the
probabilities. Sliding window: the same forward over a grid of tiles of the
training resolution, logits summed on a canvas, one argmax.

    python -m pytorch_segmentation_tpu_torch.inference IMG_DIR OUT_DIR \
        --weights weights/best.pt -s 513 513 -nc 21 -bs 8

writes `<name>.png`, the VOC-palette colour mask of each PNG or JPEG image
of IMG_DIR at the image's own size (CUDA only). `--model` takes
every family (unet, bisenetv2, danet, deeplabv3, deeplabv3plus, fastfcn,
fcn, fpn, hrnet, lraspp, maskformer, ocrnet, pspnet, segformer,
segmenter, segnext, upernet), deeplabv3plus the default; `--variant` a
family's size variant (fpn: r50, r34; fcn, deeplabv3, danet: r50, r101;
ocrnet: w18, w32, w48; segnext: tiny, t, s, b; segformer: b0..b5, tiny,
tiny-d4; segmenter: pico, b16, l16; maskformer: r50, tiny; upernet: r50,
r34, mit-b0..mit-b5, mit-tiny, cn-*, swin-*, vit-*); `--scan-blocks`
segformer's stacked block stages (another family exits with status 2).
`--int8` runs every eligible convolution on the exact int8 product with
dynamic activation scales (`quant.py`); `--int8 --calib` calibrates the
scales on the first batch and runs the calibrated program over the whole
directory.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil

import numpy as np
import torch
import torch.nn.functional as F

from .data.colormap import VOC_COLORMAP, colorize_mask
from .data.datasets import IMG_EXT
from .data.pipeline import normalize_images
from .data.resize_host import resize_probs, resize_u8
from .engine.checkpoint import load_model_bundle
from .engine.steps import nhwc_forward, require_eval_mode
from .models import (MODEL_REGISTRY, apply_scan_blocks, build_model,
                     variant_kwargs, without_default_init)
from .ops.kernels.upsample_argmax import fused_upsample_argmax
from .ops.resize import resize_bilinear
from .ops.tta import normalize_tta_scales, tta_logits
from .parallel.mesh import replicas, split_batch
from .quant import calibrate_from_u8, quantized_forward
from .utils.cli import refuse_unported
from .utils.imgcodecs import imread
from .utils.png import encode_png

__all__ = ["make_infer_fn", "inference", "make_mask_fn", "build_mask_fn",
           "make_tiled_mask_fn", "sum_tile_logits", "run", "build_parser",
           "parse_args", "main"]


def _serving_input(model, legacy_preproc: bool):
    """-> `prepare(images_u8)`: checks a u8 [B, H, W, 3] batch (numpy or
    tensor), moves it to the model's device and normalizes it to f32 NHWC."""
    device = next(model.parameters()).device

    def prepare(images_u8):
        if not isinstance(images_u8, torch.Tensor):
            images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
        x = images_u8.to(device)
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected uint8 [B, H, W, 3] images, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if legacy_preproc:
            return x.to(torch.float32) / 255.0
        return normalize_images(x)
    return prepare


def make_infer_fn(model: torch.nn.Module, legacy_preproc: bool = False,
                  int8: bool = False, quant_stats=None, tta_flip: bool = False,
                  tta_scales=()):
    """model: an eval-mode module (engine.checkpoint.load_model_bundle).
    Returns fn(images_u8 [B, H, W, 3] RGB, numpy or tensor) -> f32 softmax
    probabilities [B, h, w, C] on the model's device, of the logits that
    `tta_logits` averages (tta_flip / tta_scales as in `make_mask_fn`).
    int8=True runs every eligible conv on the exact int8 product (quant.py)
    with dynamic activation scales, or calibrated ones when `quant_stats`
    (from quant.calibrate / calibrate_from_u8) is passed."""
    prepare = _serving_input(model, legacy_preproc)
    tta_scales = normalize_tta_scales(tta_scales)
    fwd = nhwc_forward(model)
    if int8 or quant_stats is not None:
        fwd = quantized_forward(fwd, model, quant_stats)
    modules = tuple(model.modules())

    @torch.inference_mode()
    def fn(images_u8):
        require_eval_mode(modules, "make_infer_fn")
        logits = tta_logits(fwd, prepare(images_u8), scales=tta_scales,
                            flip=tta_flip)
        return torch.softmax(logits.float(), dim=-1)
    return fn


def inference(model: torch.nn.Module, imgs, img_size=(64, 64),
              legacy_preproc: bool = False, int8: bool = False,
              calib: bool = False, quant_stats=None, tta_flip: bool = False,
              tta_scales=()):
    """imgs: a list of BGR uint8 [H, W, 3] arrays (as cv2.imread gives
    them). Returns a list of int64 [H, W] argmax masks, one per image at
    its own size. img_size is (W, H).

    int8=True: the quantized forward with dynamic activation scales;
    calib=True also calibrates the scales on THIS batch first. To calibrate
    once and reuse the scales across calls, pass `quant_stats` from
    quant.calibrate_from_u8 instead (the CLI's --calib does that with the
    first batch)."""
    batch = np.stack([resize_u8(img, tuple(img_size), "linear")[:, :, ::-1]
                      for img in imgs])
    if int8 and calib and quant_stats is None:
        quant_stats = calibrate_from_u8(model, batch, legacy_preproc)
    probs = make_infer_fn(model, legacy_preproc, int8=int8,
                          quant_stats=quant_stats, tta_flip=tta_flip,
                          tta_scales=tta_scales)(batch)
    with torch.inference_mode():
        return [torch.argmax(resize_probs(p, img.shape[:2]), dim=-1)
                .cpu().numpy() for p, img in zip(probs, imgs)]


def make_mask_fn(model: torch.nn.Module, out_hw=None,
                 legacy_preproc: bool = False, tta_flip: bool = False,
                 tta_scales=(), mesh=None):
    """model: an eval-mode module (engine.checkpoint.load_model_bundle).
    Returns fn(images_u8 [B, H, W, 3] RGB, numpy or tensor) -> int32 masks
    [B, *out_hw] on the model's device. out_hw=None keeps the input size.
    legacy_preproc=True divides by 255 instead of the ImageNet
    normalization. tta_flip=True averages the logits with those of a second
    forward on the horizontally flipped batch before the upsample+argmax;
    tta_scales adds forwards at other input scales (ops/tta.py), composing
    with the flip. Each call raises a ValueError if any submodule of `model`
    is in train mode.

    mesh=make_mesh() (one process, without a process group) serves over
    every local card, as the JAX single-host mesh: the model is replicated
    on each card (`parallel.replicas`; `model` on the first), each call's
    batch must divide by the card count (a ValueError otherwise) and is
    split into one chunk a card, each chunk runs the whole path on its card
    (the upsample+argmax kernel there), and the masks are gathered on the
    first card: the masks of one card, on N cards."""
    return build_mask_fn(model, out_hw, legacy_preproc, "make_mask_fn",
                         tta_flip=tta_flip, tta_scales=tta_scales, mesh=mesh)


def build_mask_fn(model: torch.nn.Module, out_hw, legacy_preproc: bool,
                  what: str, quant: bool = False, quant_stats=None,
                  tta_flip: bool = False, tta_scales=(), mesh=None):
    """The body of `make_mask_fn` and `quant.make_quant_mask_fn` (`what`
    names the caller in the eval-mode error): with quant=True the forward
    runs in "int8" mode with `quant_stats`, or "int8dyn" without; `mesh`
    as `make_mask_fn` takes it."""
    if mesh is not None:
        if mesh.world > 1:
            raise ValueError(f"{what} serves in one process over its local "
                             f"cards; this mesh spans {mesh.world} "
                             f"processes")
        fns = [build_mask_fn(m, out_hw, legacy_preproc, what, quant,
                             quant_stats, tta_flip, tta_scales)
               for m in replicas(mesh, model)]

        def sharded(images_u8):
            masks = [fn(chunk) for fn, chunk in zip(
                fns, split_batch(mesh, images_u8))]
            return torch.cat([m.to(mesh.device) for m in masks])
        return sharded
    prepare = _serving_input(model, legacy_preproc)
    align = getattr(model, "up_align_corners", True)
    tta_scales = normalize_tta_scales(tta_scales)
    fwd = nhwc_forward(model)
    if quant:
        fwd = quantized_forward(fwd, model, quant_stats)
    modules = tuple(model.modules())  # each call checks their flags

    @torch.inference_mode()
    def fn(images_u8):
        require_eval_mode(modules, what)
        x = prepare(images_u8)
        hw = (tuple(int(s) for s in out_hw) if out_hw is not None
              else (x.shape[1], x.shape[2]))
        logits = tta_logits(fwd, x, scales=tta_scales, flip=tta_flip,
                            align_corners=align)
        if (logits.shape[1], logits.shape[2]) == hw:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return fused_upsample_argmax(logits, hw, align_corners=align)
    return fn


def _tile_offsets(size: int, tile: int, overlap: float):
    """Evenly spaced tile offsets covering [0, size) with ~overlap fraction
    of tile overlap; the last tile is flush with the end."""
    if size <= tile:
        return (0,)
    stride = max(1, int(round(tile * (1.0 - overlap))))
    n = -(-(size - tile) // stride) + 1  # ceil
    last = size - tile
    return tuple(int(round(i * last / (n - 1))) for i in range(n))


def sum_tile_logits(fwd_tile, x: torch.Tensor, tile_hw, overlap: float):
    """Run `fwd_tile` (tile [B, th, tw, 3] -> logits [B, th, tw, C]) over the
    grid of `_tile_offsets` windows of `x` [B, H, W, 3] (H >= th, W >= tw)
    and add the f32 logits up on a canvas. Returns the canvas [B, H, W, C]
    and how many tiles cover each pixel, f32 [1, H, W, 1]."""
    b, h, w = x.shape[:3]
    th, tw = tile_hw
    canvas = None
    count = torch.zeros((1, h, w, 1), dtype=torch.float32, device=x.device)
    for y0 in _tile_offsets(h, th, overlap):
        for x0 in _tile_offsets(w, tw, overlap):
            logits = fwd_tile(x[:, y0:y0 + th, x0:x0 + tw]).float()
            if canvas is None:
                canvas = torch.zeros((b, h, w, logits.shape[-1]),
                                     dtype=torch.float32, device=x.device)
            canvas[:, y0:y0 + th, x0:x0 + tw] += logits
            count[:, y0:y0 + th, x0:x0 + tw] += 1.0
    return canvas, count


def make_tiled_mask_fn(model: torch.nn.Module, tile_hw=(513, 513),
                       overlap: float = 0.25, legacy_preproc: bool = False,
                       tta_flip: bool = False, tta_scales=()):
    """Sliding-window serving for images LARGER than the training
    resolution: fn(images_u8 [B, H, W, 3] RGB) -> int32 masks [B, H, W] at
    the input's own resolution.

    The network runs at native resolution over a grid of tile_hw windows
    (~`overlap` fraction overlapping); per-tile logits, upsampled to the
    tile, are summed on a canvas and argmaxed once (the per-pixel argmax
    does not change under the positive per-pixel weight, so the sums are
    not divided by the cover count). An input smaller than a tile is padded
    with the ImageNet mean (zeros after normalize) and the mask cropped
    back. tta_flip / tta_scales compose per tile (ops/tta.py)."""
    prepare = _serving_input(model, legacy_preproc)
    align = getattr(model, "up_align_corners", True)
    th, tw = int(tile_hw[0]), int(tile_hw[1])
    tta_scales = normalize_tta_scales(tta_scales)
    fwd = nhwc_forward(model)
    modules = tuple(model.modules())  # each call checks their flags

    def fwd_tile(x):
        logits = tta_logits(fwd, x, scales=tta_scales, flip=tta_flip,
                            align_corners=align)
        return resize_bilinear(logits.float(), (th, tw), align_corners=align)

    @torch.inference_mode()
    def fn(images_u8):
        require_eval_mode(modules, "make_tiled_mask_fn")
        x = prepare(images_u8)
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, max(w, tw) - w, 0, max(h, th) - h))
        canvas, _ = sum_tile_logits(fwd_tile, x, (th, tw), overlap)
        return torch.argmax(canvas[:, :h, :w], dim=-1).to(torch.int32)
    return fn


def _write_mask(path: str, segmap) -> None:
    """The VOC-palette colour mask, as cv2.imwrite stores a BGR image."""
    seg = colorize_mask(np.asarray(segmap), VOC_COLORMAP)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(seg[:, :, ::-1])))


def run(img_dir, output_dir, img_size, num_classes, weights, model_name,
        legacy_preproc=False, batch_size=8, ema=False, tta=False, tile=None,
        tta_scales=(), variant="", scan_blocks=False, int8=False,
        calib=False, device=None):
    """The root inference CLI's `run` on `device` (None: the card): every
    image of `img_dir` whose suffix is in IMG_EXT (PNG and JPEG are read;
    another format raises) -> `<output_dir>/<name>.png`. int8=True takes
    the quantized forward; with calib=True its activation scales are
    calibrated once on the first batch and kept for the whole directory.
    As in the root CLI, `tile` takes the unquantized sliding-window path
    whatever `int8` says. Returns the masks by name."""
    from .utils.runtime import require_cuda
    device = require_cuda() if device is None else torch.device(device)
    shutil.rmtree(output_dir, ignore_errors=True)
    os.makedirs(output_dir, exist_ok=True)
    with without_default_init():
        model = build_model(model_name, num_classes=num_classes,
                            **apply_scan_blocks(
                                model_name, variant_kwargs(model_name,
                                                           variant),
                                scan_blocks))
    model = load_model_bundle(model, weights, device, use_ema=ema)
    names = sorted(n for n in os.listdir(img_dir)
                   if osp.splitext(n)[1] in IMG_EXT)
    masks = {}
    if tile is not None:
        # sliding windows at each image's own resolution, one at a time
        tiled = make_tiled_mask_fn(model, tile_hw=(tile[1], tile[0]),
                                   legacy_preproc=legacy_preproc,
                                   tta_flip=tta, tta_scales=tta_scales)
        for name in names:
            img = imread(osp.join(img_dir, name))
            masks[name] = tiled(img[None, :, :, ::-1])[0].cpu().numpy()
    else:
        quant_stats = None
        if int8 and calib and names:
            # calibrate once on the first batch, reuse for the whole run
            first = np.stack([resize_u8(imread(osp.join(img_dir, n)),
                                        tuple(img_size), "linear")[:, :, ::-1]
                              for n in names[:batch_size]])
            quant_stats = calibrate_from_u8(model, first, legacy_preproc)
        for start in range(0, len(names), batch_size):
            chunk = names[start:start + batch_size]
            imgs = [imread(osp.join(img_dir, n)) for n in chunk]
            masks.update(zip(chunk, inference(
                model, imgs, img_size, legacy_preproc=legacy_preproc,
                int8=int8, quant_stats=quant_stats, tta_flip=tta,
                tta_scales=tta_scales)))
    for name, segmap in masks.items():
        _write_mask(osp.join(output_dir, osp.splitext(name)[0] + ".png"),
                    segmap)
    return masks


# flags of the root CLI whose machinery is not ported: name -> (default,
# ROADMAP queue 1 item)
UNPORTED = {"show": (False, 11), "moe": (0, 10)}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("img_dir", type=str)
    parser.add_argument("output_dir", type=str)
    parser.add_argument("--model", type=str, default="deeplabv3plus",
                        choices=sorted(MODEL_REGISTRY))
    parser.add_argument("-s", "--img_size", type=int, nargs=2,
                        default=[320, 320])
    parser.add_argument("-nc", "--num-classes", type=int, default=2)
    parser.add_argument("--weights", type=str, default="weights/best.pt")
    parser.add_argument("-bs", "--batch-size", type=int, default=8)
    parser.add_argument("--variant", type=str, default="")
    parser.add_argument("--legacy-preproc", action="store_true",
                        help="divide by 255 instead of the training "
                             "normalization")
    parser.add_argument("--show", action="store_true")
    parser.add_argument("--int8", action="store_true",
                        help="int8 forward (dynamic activation scales)")
    parser.add_argument("--calib", action="store_true",
                        help="with --int8: calibrate the activation scales "
                             "on the first batch and keep them")
    parser.add_argument("--ema", action="store_true",
                        help="the EMA-averaged weights stored by train --ema")
    parser.add_argument("--tta", action="store_true",
                        help="flip test-time augmentation (~2x cost)")
    parser.add_argument("--tta-scales", type=float, nargs="+", default=[],
                        metavar="S", help="multi-scale TTA, e.g. 0.75 1.25")
    parser.add_argument("--scan-blocks", action="store_true")
    parser.add_argument("--moe", type=int, default=0, metavar="E")
    parser.add_argument("--moe-top-k", type=int, default=2, metavar="K")
    parser.add_argument("--tile", type=int, nargs=2, default=None,
                        metavar=("W", "H"),
                        help="sliding-window inference at each image's "
                             "native resolution with WxH tiles")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    opt = parser.parse_args(argv)
    refuse_unported(parser, opt, UNPORTED)
    return opt


def main(argv=None, device=None):
    """Parse `argv` and write the masks on `device` (None: the card);
    returns them by image name."""
    opt = parse_args(argv)
    print(opt)
    return run(opt.img_dir, opt.output_dir, opt.img_size, opt.num_classes,
               opt.weights, opt.model, opt.legacy_preproc, opt.batch_size,
               ema=opt.ema, tta=opt.tta, tile=opt.tile,
               tta_scales=tuple(opt.tta_scales), variant=opt.variant,
               scan_blocks=opt.scan_blocks, int8=opt.int8, calib=opt.calib,
               device=device)


if __name__ == "__main__":
    main()
