"""Batch-mixing augmentations on the device: CutMix and 4-image Mosaic
(port of pytorch_segmentation_tpu/data/mix.py).

They run in `PostFetch` on the uint8 batch BEFORE the per-image policy, so
the mixed canvas is then augmented as one image. Donors come from
`torch.roll` over the batch axis; the labels swap under the same masks.

CutMix (Yun et al., ICCV 2019): per sample, with probability `p`, a random
rectangle is replaced by the same rectangle of the next sample in the
batch. lam ~ U(0, 1); the box's sides are sqrt(1 - lam) of the canvas's,
around a uniform centre, clipped at the canvas.

Mosaic (the same-scale variant of the YOLO family's): per sample, with
probability `p`, the canvas is stitched from 4 consecutive batch samples
around a random centre in [0.25, 0.75]^2; quadrant q keeps the pixels of
donor q at their own positions.

Each mix is a draw (`draw_cutmix`, `draw_mosaic`: [B] tensors from a
`torch.Generator` of the images' device) and an apply that is pure in the
drawn values (`apply_cutmix`, `apply_mosaic`), so the tests can feed both
packages the same draws: the two frameworks' generators cannot be made to
agree.
"""

from __future__ import annotations

import torch

__all__ = ["draw_cutmix", "apply_cutmix", "cutmix", "draw_mosaic",
           "apply_mosaic", "mosaic", "MixFn", "make_mix_fn"]


def _grids(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    return ys, xs


def _uniform(gen: torch.Generator, b: int) -> torch.Tensor:
    return torch.rand((b,), generator=gen, device=gen.device)


def draw_cutmix(gen: torch.Generator, b: int, p: float) -> dict:
    """gate [B] bool (probability p), lam [B], and the box centre cy, cx [B]
    as fractions of the canvas, all uniform on [0, 1)."""
    return {"gate": _uniform(gen, b) < p, "lam": _uniform(gen, b),
            "cy": _uniform(gen, b), "cx": _uniform(gen, b)}


def apply_cutmix(draws: dict, images: torch.Tensor, segs: torch.Tensor):
    """images [B, H, W, C] (any dtype), segs [B, H, W]: the gated samples
    take the next sample's pixels and labels inside their box."""
    h, w = images.shape[1], images.shape[2]
    side = torch.sqrt(1.0 - draws["lam"])
    rh, rw = side * h, side * w
    cy, cx = draws["cy"] * h, draws["cx"] * w
    y0, y1 = (cy - rh / 2).clamp(0, h), (cy + rh / 2).clamp(0, h)
    x0, x1 = (cx - rw / 2).clamp(0, w), (cx + rw / 2).clamp(0, w)
    ys, xs = _grids(h, w, images.device)
    inbox = ((ys >= y0[:, None, None]) & (ys < y1[:, None, None])
             & (xs >= x0[:, None, None]) & (xs < x1[:, None, None]))
    take = inbox & draws["gate"][:, None, None]
    images = torch.where(take[..., None], torch.roll(images, -1, 0), images)
    segs = torch.where(take, torch.roll(segs, -1, 0), segs)
    return images, segs


def cutmix(gen: torch.Generator, images: torch.Tensor, segs: torch.Tensor,
           p: float):
    """Per-sample CutMix with the next batch element as the donor."""
    return apply_cutmix(draw_cutmix(gen, images.shape[0], p), images, segs)


def draw_mosaic(gen: torch.Generator, b: int, p: float) -> dict:
    """gate [B] bool (probability p) and the stitch centre cy, cx [B] as
    fractions of the canvas, uniform on [0.25, 0.75)."""
    gate = _uniform(gen, b) < p
    return {"gate": gate, "cy": _uniform(gen, b) * 0.5 + 0.25,
            "cx": _uniform(gen, b) * 0.5 + 0.25}


def apply_mosaic(draws: dict, images: torch.Tensor, segs: torch.Tensor):
    """images [B, H, W, C], segs [B, H, W]: the gated samples stitched from
    samples i (top left), i+1 (top right), i+2 (bottom left) and i+3
    (bottom right), wrapping around the batch."""
    h, w = images.shape[1], images.shape[2]
    ys, xs = _grids(h, w, images.device)
    bottom = ys >= h * draws["cy"][:, None, None]            # [B, H, 1]
    right = xs >= w * draws["cx"][:, None, None]             # [B, 1, W]
    gate = draws["gate"][:, None, None]

    def stitch(x, bm, rm, gm):
        r = [x] + [torch.roll(x, -k, 0) for k in (1, 2, 3)]
        top = torch.where(rm, r[1], r[0])
        bot = torch.where(rm, r[3], r[2])
        return torch.where(gm, torch.where(bm, bot, top), x)

    return (stitch(images, bottom[..., None], right[..., None],
                   gate[..., None]),
            stitch(segs, bottom, right, gate))


def mosaic(gen: torch.Generator, images: torch.Tensor, segs: torch.Tensor,
           p: float):
    """Per-sample 4-way same-scale mosaic around a random centre."""
    return apply_mosaic(draw_mosaic(gen, images.shape[0], p), images, segs)


class MixFn:
    """`fn(gen, images, segs) -> (images, segs)`: Mosaic, then CutMix, each
    gated per sample, the probabilities of `make_mix_fn`. `draw` and
    `apply` are the two halves: `apply(draw(gen, b), images, segs)`."""

    def __init__(self, cutmix_p: float, mosaic_p: float):
        self.cutmix_p = float(cutmix_p)
        self.mosaic_p = float(mosaic_p)

    def draw(self, gen: torch.Generator, b: int) -> dict:
        draws = {}
        if self.mosaic_p > 0:
            draws["mosaic"] = draw_mosaic(gen, b, self.mosaic_p)
        if self.cutmix_p > 0:
            draws["cutmix"] = draw_cutmix(gen, b, self.cutmix_p)
        return draws

    @torch.no_grad()
    def apply(self, draws: dict, images: torch.Tensor, segs: torch.Tensor):
        if "mosaic" in draws:
            images, segs = apply_mosaic(draws["mosaic"], images, segs)
        if "cutmix" in draws:
            images, segs = apply_cutmix(draws["cutmix"], images, segs)
        return images, segs

    def __call__(self, gen: torch.Generator, images: torch.Tensor,
                 segs: torch.Tensor):
        return self.apply(self.draw(gen, images.shape[0]), images, segs)


def make_mix_fn(cutmix_p: float = 0.0, mosaic_p: float = 0.0):
    """A `MixFn` applying Mosaic then CutMix, or None if both probabilities
    are zero (`train --cutmix P --mosaic P`)."""
    if cutmix_p <= 0 and mosaic_p <= 0:
        return None
    return MixFn(cutmix_p, mosaic_p)
