"""On-device batched augmentation (port of
pytorch_segmentation_tpu/data/augment.py): the imgaug TRAIN_AUGS policy as
tensor code over the whole uint8 batch.

  * The geometric members (flips, crop-and-pad, affine, perspective, elastic
    jitter, piecewise-affine) compose into one homography per sample plus a
    displacement field, applied to image and labels alike by a two-pass
    (Catmull-Smith) warp: rows, then columns, each pass one call of the
    hand-written row resampler (`ops/kernels/banded_resample.py`). Labels
    always take the nearest tap and 0 fill; the image's interpolation order
    is drawn per sample from {nearest, bilinear}.
  * The SomeOf(0..5) pool has 16 members: 13 photometric ops, applied after
    the warp in one random order per batch, plus elastic / piecewise /
    perspective, whose gates feed the warp.

Every function here is either a *draw* (`_draw_*`: takes a
`torch.Generator`, returns a dict of tensors with a leading batch axis) or
an *apply* that is pure in those tensors. The tests feed the JAX package and
this module the same drawn values, since the two frameworks' generators
cannot be made to agree. There is no `vmap`: every per-sample parameter is a
`[B, ...]` tensor. The full-grid fields (jitter, noise, dropout masks) are
drawn by the generator of the images' device; the pool's order, which the
host must know to dispatch the ops, comes from a host generator.

Cast points follow the JAX package: planes u8 -> bf16 (exact), the first
pass's output stays bf16, pool ops compute in `pool_compute` where the JAX
op does and in f32 elsewhere, and the pool's carry is requantised to u8
after every op (`photo_carry="u8"`).

Not ported (each raises NotImplementedError; ROADMAP "Augmentation, rest"):
`fast_geometric`, `separable_warp`, `banded_warp=False`, non-square images,
`per_sample_photo_order`, `legacy_ops`.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..ops.kernels.banded_resample import banded_resample_rows
from ..ops.resize import resize_bilinear
from ..utils.runtime import device_constant

__all__ = ["AugmentConfig", "AugmentFn", "make_augment_fn"]

# SomeOf pool layout, in order:
# 0 superpixels, 1 blur-OneOf, 2 sharpen, 3 emboss, 4 edge-blend,
# 5 additive noise, 6 dropout-OneOf, 7 invert, 8 add, 9 hue/sat,
# 10 multiply-OneOf, 11 contrast, 12 grayscale,
# 13 elastic, 14 piecewise-affine, 15 perspective
_N_POOL = 16
_N_PHOTO = 13


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Same fields and defaults as the JAX package's AugmentConfig."""
    # an axis-aligned warp by matrix products; not ported (raises)
    fast_geometric: bool = False
    # interpolation order of the image warp: None draws it per sample from
    # {0: nearest, 1: bilinear}; 0 or 1 force it. Labels are always nearest.
    image_warp_order: int | None = None
    # the two-pass warp through the row resampler kernel: the only warp the
    # port has (False raises). Square images only.
    banded_warp: bool = True
    # the two-pass warp by lane gathers; not ported (raises)
    separable_warp: bool = False
    # dtype the photometric pool carries between ops: "u8" rounds and clips
    # every op's output to 0..255 as imgaug does, "bf16" and "f32" do not
    photo_carry: str = "u8"
    # dtype inside the filter, noise, dropout and hue/saturation ops ("bf16"
    # or "f32"); scalar parameter math is f32 either way
    pool_compute: str = "bf16"
    # a benchmark mode of the JAX package; not ported (raises)
    legacy_ops: bool = False
    # the pool's order drawn per sample instead of per batch; not ported
    # (raises)
    per_sample_photo_order: bool = False
    # names a JAX generator; kept so that the configs read alike, ignored
    # here (torch.Generator has one implementation per device)
    rng_impl: str | None = "rbg"
    # geometric
    p_fliplr: float = 0.5
    p_flipud: float = 0.2
    p_crop_pad: float = 0.5
    crop_pad_percent: tuple = (-0.05, 0.1)
    p_affine: float = 0.5
    scale_range: tuple = (0.8, 1.2)
    translate_range: tuple = (-0.2, 0.2)
    rotate_range: tuple = (-90.0, 90.0)
    shear_range: tuple = (-16.0, 16.0)
    # SomeOf(0..5) pool
    someof_max: int = 5
    p_sometimes: float = 0.5  # inner Sometimes() wrappers
    elastic_alpha: tuple = (0.5, 3.5)
    piecewise_scale: tuple = (0.01, 0.05)
    perspective_scale: tuple = (0.01, 0.1)
    blur_sigma: tuple = (0.0, 3.0)
    noise_scale: tuple = (0.0, 0.05 * 255)
    dropout_p: tuple = (0.01, 0.1)
    coarse_dropout_p: tuple = (0.03, 0.15)
    add_range: tuple = (-10.0, 10.0)
    hue_sat_range: tuple = (-20.0, 20.0)
    multiply_range: tuple = (0.5, 1.5)
    contrast_range: tuple = (0.5, 2.0)
    invert_p: float = 0.05


_ROADMAP_QUEUE = "ROADMAP: Augmentation, rest"


def _check_config(cfg: AugmentConfig) -> None:
    unported = {
        "fast_geometric=True": cfg.fast_geometric,
        "separable_warp=True": cfg.separable_warp,
        "banded_warp=False": not cfg.banded_warp,
        "per_sample_photo_order=True": cfg.per_sample_photo_order,
        "legacy_ops=True": cfg.legacy_ops}
    for option, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"AugmentConfig({option}) is not ported yet "
                f"({_ROADMAP_QUEUE})")
    if cfg.photo_carry not in ("u8", "bf16", "f32"):
        raise ValueError(f"photo_carry {cfg.photo_carry!r}")
    if cfg.pool_compute not in ("bf16", "f32"):
        raise ValueError(f"pool_compute {cfg.pool_compute!r}")


def _require_square(h: int, w: int) -> None:
    if h != w:
        raise NotImplementedError(
            f"the two-pass warp and the pool's filters need square images, "
            f"got {(h, w)}: the gather samplers and the rectangular filter "
            f"are not ported yet ({_ROADMAP_QUEUE})")


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

def _uniform(gen, shape, lo=0.0, hi=1.0, dtype=torch.float32):
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
    if (lo, hi) == (0.0, 1.0):
        return u
    return u * (hi - lo) + lo


def _bernoulli(gen, p, shape):
    return torch.rand(shape, generator=gen, device=gen.device) < p


def _randint(gen, lo, hi, shape):
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def _normal(gen, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def _draw_gates(gen, cfg: AugmentConfig, b: int) -> torch.Tensor:
    return _someof_gates(_randint(gen, 0, cfg.someof_max + 1, (b,)),
                         _uniform(gen, (b, _N_POOL)))


def _draw_geometry(gen, cfg: AugmentConfig, b: int, h: int, w: int) -> dict:
    """Every random value of the warp, per sample. The two jitter fields are
    raw bf16 uniforms in [0, 1), one per pass."""
    u = functools.partial(_uniform, gen, (b,))
    return {
        "flip_lr": _bernoulli(gen, cfg.p_fliplr, (b,)),
        "flip_ud": _bernoulli(gen, cfg.p_flipud, (b,)),
        "do_cap": _bernoulli(gen, cfg.p_crop_pad, (b,)),
        "sides": _uniform(gen, (b, 4), *cfg.crop_pad_percent),
        "do_aff": _bernoulli(gen, cfg.p_affine, (b,)),
        "sxa": u(*cfg.scale_range), "sya": u(*cfg.scale_range),
        "tx": u(*cfg.translate_range), "ty": u(*cfg.translate_range),
        "theta": u(*cfg.rotate_range), "shear": u(*cfg.shear_range),
        "persp_scale": u(*cfg.perspective_scale),
        "persp_jitter": _normal(gen, (b, 4, 2)),
        "perm": torch.argsort(_uniform(gen, (b, 5)), dim=1),
        "sometimes": _bernoulli(gen, cfg.p_sometimes, (b, 3)),
        "alpha": u(*cfg.elastic_alpha),
        "pw_scale": u(*cfg.piecewise_scale),
        "pw_grid": _normal(gen, (b, 5, 5, 2)),
        "jitter_x": _uniform(gen, (b, h, w), dtype=torch.bfloat16),
        "jitter_v": _uniform(gen, (b, w, h), dtype=torch.bfloat16),
        "mode": _randint(gen, 0, 4, (b,)),
        "cval": u(0.0, 255.0),
        "order_bil": _bernoulli(gen, 0.5, (b,)),
    }


# ---------------------------------------------------------------------------
# SomeOf(0..5) selection over the 16-member pool
# ---------------------------------------------------------------------------

def _someof_gates(k_count: torch.Tensor, scores: torch.Tensor):
    """[B, _N_POOL] bool: per sample the k_count members with the highest
    scores (k ~ U{0..someof_max}, scores uniform: a uniform subset)."""
    desc = torch.sort(scores, dim=1, descending=True).values
    thresh = desc.gather(1, (k_count - 1).clamp(0, _N_POOL - 1)[:, None])
    return (scores >= thresh) & (k_count > 0)[:, None]


# ---------------------------------------------------------------------------
# geometric machinery
# ---------------------------------------------------------------------------

def _eye3(b: int, device) -> torch.Tensor:
    return torch.eye(3, device=device).repeat(b, 1, 1)


def _component_matrices(g: dict, cfg: AugmentConfig, h: int, w: int,
                        persp_gate: torch.Tensor) -> torch.Tensor:
    """[B, 5, 3, 3] forward homographies of the top-level members: fliplr,
    flipud, crop-and-pad, affine, perspective (whose gate comes from the
    SomeOf pool)."""
    b, dev = persp_gate.shape[0], persp_gate.device
    eye = _eye3(b, dev)
    zero, one = torch.zeros(b, device=dev), torch.ones(b, device=dev)

    # flips about the image centre
    m_fliplr = eye.clone()
    m_fliplr[:, 0, 0] = torch.where(g["flip_lr"], -one, one)
    m_fliplr[:, 0, 2] = torch.where(g["flip_lr"], one * (w - 1.0), zero)
    m_flipud = eye.clone()
    m_flipud[:, 1, 1] = torch.where(g["flip_ud"], -one, one)
    m_flipud[:, 1, 2] = torch.where(g["flip_ud"], one * (h - 1.0), zero)

    # CropAndPad: per-side percent, keep_size=True
    sides = g["sides"]
    l, r = sides[:, 0] * w, sides[:, 1] * w
    t, bt = sides[:, 2] * h, sides[:, 3] * h
    sx = w / (w - l - r).clamp_min(1.0)
    sy = h / (h - t - bt).clamp_min(1.0)
    cap = eye.clone()
    cap[:, 0, 0], cap[:, 0, 2] = sx, -l * sx
    cap[:, 1, 1], cap[:, 1, 2] = sy, -t * sy
    cap = torch.where(g["do_cap"][:, None, None], cap, eye)

    # Affine about the centre: scale per axis, rotate, shear, translate
    sxa, sya = g["sxa"], g["sya"]
    tx, ty = g["tx"] * w, g["ty"] * h
    theta, shear = torch.deg2rad(g["theta"]), torch.deg2rad(g["shear"])
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    rot = eye.clone()
    rot[:, 0, 0] = cos * sxa
    rot[:, 0, 1] = -sin * sya + cos * sxa * torch.tan(shear)
    rot[:, 1, 0] = sin * sxa
    rot[:, 1, 1] = cos * sya + sin * sxa * torch.tan(shear)
    center = device_constant(((1.0, 0.0, -cx), (0.0, 1.0, -cy),
                              (0.0, 0.0, 1.0)), dev)
    uncenter = eye.clone()
    uncenter[:, 0, 2] = cx + tx
    uncenter[:, 1, 2] = cy + ty
    aff = uncenter @ rot @ center
    aff = torch.where(g["do_aff"][:, None, None], aff, eye)

    # PerspectiveTransform: jitter the 4 corners, fit a homography
    jitter = (g["persp_jitter"] * g["persp_scale"][:, None, None]
              * device_constant((w, h), dev))
    src = device_constant(((0.0, 0.0), (w - 1.0, 0.0), (w - 1.0, h - 1.0),
                           (0.0, h - 1.0)), dev)
    persp = _fit_homography(src.expand(b, 4, 2), src + jitter)
    persp = torch.where(persp_gate[:, None, None], persp, eye)

    return torch.stack([m_fliplr, m_flipud, cap, aff, persp], 1)


def _compose_permuted(perm: torch.Tensor, mats: torch.Tensor):
    """Compose the [B, 5, 3, 3] member homographies in each sample's order
    `perm` [B, 5]. The member applied first multiplies rightmost."""
    b = mats.shape[0]
    rows = torch.arange(b, device=mats.device)
    m = _eye3(b, mats.device)
    for pos in range(mats.shape[1]):
        m = mats[rows, perm[:, pos]] @ m
    return m


def _fit_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """H [B, 3, 3] (h22 = 1) with dst ~ H @ src for 4 point pairs [B, 4, 2].
    `solve_ex` does not check for singularity, so it does not sync the
    host."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    o, z = torch.ones_like(x), torch.zeros_like(x)
    even = torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1)  # [B, 4, 8]
    odd = torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)
    a = torch.stack([even, odd], 2).reshape(-1, 8, 8)
    rhs = dst.reshape(-1, 8, 1)
    sol = torch.linalg.solve_ex(
        a + 1e-8 * torch.eye(8, device=a.device), rhs).result[..., 0]
    return torch.cat([sol, torch.ones_like(sol[:, :1])], 1).reshape(-1, 3, 3)


def _boundary(coord: torch.Tensor, n: int, mode: torch.Tensor):
    """Out-of-range coordinates per boundary mode id (0 = constant: clamp,
    masked later; 1 = edge; 2 = reflect; 3 = wrap). `remainder` takes the
    divisor's sign, as jnp.mod does. The result lies in [0, n-1]: the row
    resampler's precondition."""
    clamped = coord.clamp(0.0, n - 1.0)
    period = max(2.0 * (n - 1.0), 1.0)
    m = torch.remainder(coord, period)
    reflected = torch.minimum(m, period - m)
    wrapped = torch.remainder(coord, max(n * 1.0, 1.0))
    c = torch.where(mode == 2, reflected,
                    torch.where(mode == 3, wrapped, clamped))
    return c.clamp(0.0, n - 1.0)


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Keep |x| >= eps, with x's sign (positive at 0)."""
    return torch.where(x.abs() < eps,
                       torch.where(x < 0, -eps, eps).to(x.dtype), x)


def _twopass_fields(hinv: torch.Tensor, grid: torch.Tensor, h: int, w: int):
    """Coordinate fields of the separable two-pass warp.

    hinv: [B, 3, 3] inverse homographies (output pixel -> source);
    grid: [B, 5, 5, 2] piecewise-affine control grids (zeros when ungated).
    Returns (tf, sx, sy_msk, vt):
      tf     [B]: sample from the TRANSPOSED source (the 90 degree part of a
             rotation beyond 45 degrees is factored out, where the row map
             j -> x is ill-conditioned)
      sx     [B, h, w]: source column per output pixel (second pass)
      sy_msk [B, h, w]: source row per output pixel (boundary masks only)
      vt     [B, w, h]: first-pass field on the (source column x, output row
             i) grid: the source row that feeds intermediate column x at
             output row i, from the closed-form inverse of the homography's
             row map j*(i, x), plus the transported piecewise field.
    First pass t[i, x] = src[vt[x, i], x]; second pass out[i, j] =
    t[i, sx[i, j]]. Exact for homographies, first order for the smooth
    piecewise grid."""
    dev = hinv.device
    tf = hinv[:, 1, 0].abs() > hinv[:, 0, 0].abs()
    swapped = torch.stack([hinv[:, 1], hinv[:, 0], hinv[:, 2]], 1)
    hinv = torch.where(tf[:, None, None], swapped, hinv)
    grid = torch.where(tf[:, None, None, None], grid.flip(-1), grid)
    a, b, c, d, e, f, g, h2, w2 = (
        hinv.reshape(-1, 9)[:, k].reshape(-1, 1, 1) for k in range(9))

    # output-grid source coordinates (second pass + boundary masks)
    ig = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    jg = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    pz = _safe(g * jg + h2 * ig + w2, 1e-6)
    hx = (a * jg + b * ig + c) / pz
    hy = (d * jg + e * ig + f) / pz
    pw = resize_bilinear(grid, (h, w), align_corners=True)
    sx = hx + pw[..., 0]
    sy_msk = hy + pw[..., 1]

    # first-pass field on the transposed (x, i) grid: invert the row map
    # x = (a j + b i + c) / (g j + h2 i + w2) for j, then take the y map
    xg = torch.arange(w, dtype=torch.float32, device=dev)[:, None]
    ig2 = torch.arange(h, dtype=torch.float32, device=dev)[None, :]
    den = _safe(xg * g - a, 1e-4)
    jstar = (b * ig2 + c - xg * (h2 * ig2 + w2)) / den
    # columns no output pixel maps to can have a wild j* (behind the
    # perspective horizon); bound it so that what follows stays finite
    jstar = jstar.clamp(-1.0 * w, 2.0 * w)
    pzs = _safe(g * jstar + h2 * ig2 + w2, 1e-6)
    vh = (d * jstar + e * ig2 + f) / pzs
    # piecewise-y transported to (x, i): the bilinear 5x5 grid evaluated in
    # closed form at (row = i exactly, column = j*)
    rowg = resize_bilinear(grid[..., 1:2], (h, 5),
                           align_corners=True)[..., 0]          # [B, h, 5]
    u = (jstar / max(w - 1.0, 1.0) * 4.0).clamp(0.0, 4.0)
    c0 = u.floor().clamp(0.0, 3.0)
    t = u - c0
    pwy = torch.zeros_like(u)
    for k in range(4):
        seg_val = (rowg[:, None, :, k] * (1 - t)
                   + rowg[:, None, :, k + 1] * t)
        pwy = torch.where(c0 == k, seg_val, pwy)
    return tf, sx, sy_msk, vh + pwy


def _twopass_coords(g: dict, gates: torch.Tensor, cfg: AugmentConfig,
                    h: int, w: int):
    """The warp's fields and sampling parameters from the draws `g` and the
    pool's gates. `inv_ex` does not check for singularity (no host sync)."""
    some = g["sometimes"]
    elastic = gates[:, 13] & some[:, 0]
    piecewise = gates[:, 14] & some[:, 1]
    persp = gates[:, 15] & some[:, 2]

    mats = _component_matrices(g, cfg, h, w, persp)
    hmat = _compose_permuted(g["perm"], mats)
    hinv = torch.linalg.inv_ex(hmat).inverse

    alpha = torch.where(elastic, g["alpha"], torch.zeros_like(g["alpha"]))
    grid = (g["pw_grid"] * g["pw_scale"][:, None, None, None]
            * device_constant((w, h), gates.device))
    grid = torch.where(piecewise[:, None, None, None], grid,
                       torch.zeros_like(grid))

    tf, sx, sy_msk, vt = _twopass_fields(hinv, grid, h, w)
    # iid elastic jitter, one field per pass, drawn and scaled in bf16 and
    # added in f32
    a16 = alpha.to(torch.bfloat16)[:, None, None]
    sx = sx + ((g["jitter_x"] * 2.0 - 1.0) * a16).float()
    vt = vt + ((g["jitter_v"] * 2.0 - 1.0) * a16).float()

    if cfg.image_warp_order == 1:
        use_bil = torch.ones_like(elastic)
    elif cfg.image_warp_order == 0:
        use_bil = torch.zeros_like(elastic)
    else:
        use_bil = g["order_bil"]
    return vt, sx, sy_msk, g["mode"], g["cval"], use_bil, tf


def _sample_two_pass_banded(imgs_u8, segs_u8, vt, sx, sy_msk, mode, cval,
                            use_bil, tf, out_dtype=torch.bfloat16):
    """Two-pass warp through the row resampler: source rows first (in
    transposed layout, with `vt`), then columns (with `sx`). The first
    pass's output stays bf16 and is not requantised to u8. Both transposes
    are views: the resampler reads its planes through their strides."""
    n = segs_u8.shape[1]
    _require_square(n, segs_u8.shape[2])
    planes = torch.cat([imgs_u8.permute(0, 3, 1, 2).to(torch.bfloat16),
                        segs_u8[:, None].to(torch.bfloat16)], 1)  # [B,4,H,W]
    # first-pass input = (effective source)^T: src^T normally, src itself
    # when the sample reads the transposed source (tf)
    pt = torch.where(tf[:, None, None, None], planes,
                     planes.transpose(2, 3))
    m = mode[:, None, None]
    mid = banded_resample_rows(pt, _boundary(vt, n, m), use_bil,
                               out_dtype=out_dtype)
    mid = mid.transpose(2, 3).to(torch.bfloat16)    # [B, 4, out-row, x]
    out2 = banded_resample_rows(mid, _boundary(sx, n, m), use_bil,
                                out_dtype=out_dtype)
    rgb2 = out2[:, :3].permute(0, 2, 3, 1).float()
    seg2 = out2[:, 3].float().round().to(torch.int32)
    # constant-mode fill from the total source coordinates; sy_msk omits the
    # elastic jitter
    img_in = (sx >= 0) & (sx <= n - 1) & (sy_msk >= 0) & (sy_msk <= n - 1)
    seg_in = ((sx >= -0.5) & (sx <= n - 0.5)
              & (sy_msk >= -0.5) & (sy_msk <= n - 0.5))
    out_img = torch.where(((m == 0) & ~img_in)[..., None],
                          cval[:, None, None, None], rgb2)
    out_seg = torch.where(seg_in, seg2, torch.zeros_like(seg2))
    return out_img, out_seg


def _geometric_batch(g: dict, imgs_u8, segs_u8, gates, cfg: AugmentConfig):
    """The warp of the whole batch: fields from the draws, then the two
    resampling passes."""
    h, w = segs_u8.shape[1], segs_u8.shape[2]
    _require_square(h, w)
    vt, sx, sy_msk, mode, cval, use_bil, tf = _twopass_coords(
        g, gates, cfg, h, w)
    return _sample_two_pass_banded(imgs_u8, segs_u8, vt, sx, sy_msk, mode,
                                   cval, use_bil, tf)


# ---------------------------------------------------------------------------
# filters of the photometric pool ([B, H, W, 3], 0..255)
# ---------------------------------------------------------------------------

def _pool_dt(cfg: AugmentConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.pool_compute == "bf16" else torch.float32


def _bc(v: torch.Tensor) -> torch.Tensor:
    """A per-sample value [B] against [B, H, W, C]."""
    return v.reshape(-1, 1, 1, 1)


@functools.lru_cache(maxsize=16)
def _band_taps(k: int, n: int, device) -> torch.Tensor:
    """[k, n*n] f32: for tap t the 0/1 matrix 1{j == clip(i + t - k//2)}
    (edge-replicate boundary), flattened."""
    rows = torch.arange(n, device=device)[:, None]
    cols = torch.arange(n, device=device)[None, :]
    return torch.stack([
        (cols == (rows + (t - k // 2)).clamp(0, n - 1)).float()
        for t in range(k)]).reshape(k, n * n)


def _band_matrix(kernel: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """[B, n, n] banded filter matrices of the 1-D kernels [B, k]:
    K[i, j] = sum_t kernel[t] * 1{j == clip(i + t - k//2)}; taps that fall
    outside accumulate onto the edge column. Summed in f32, rounded once to
    `dtype`."""
    b, k = kernel.shape
    taps = _band_taps(k, n, kernel.device)
    return (kernel.to(dtype).float() @ taps).to(dtype).reshape(b, n, n)


def _sep_filter(img: torch.Tensor, kh: torch.Tensor, kw: torch.Tensor):
    """Separable filter on square [B, N, N, C] in the dtype of `img`: the
    1-D kernels kh [B, k] along H and kw along W, as two products with the
    banded matrices (edge boundary). Each product accumulates in f32 and
    rounds once to the compute dtype. The products run as f32 matmuls on
    values already rounded to that dtype (exact products for bf16), so an
    f32 pool needs TF32 off on the card, which `require_cuda` sees to."""
    n, dt = img.shape[1], img.dtype
    _require_square(n, img.shape[2])
    kmh = _band_matrix(kh, n, dt).float()
    kmw = kmh if kw is kh else _band_matrix(kw, n, dt).float()
    x = img.permute(0, 3, 1, 2).float()                     # [B, C, H, W]
    tmp = (kmh[:, None] @ x).to(dt).float()
    out = (tmp @ kmw.transpose(1, 2)[:, None]).to(dt)
    return out.permute(0, 2, 3, 1)


def _gaussian_kernel(sigma: torch.Tensor, size: int = 13) -> torch.Tensor:
    """[B, size] normalised Gaussian taps; sigma near 0 gives the identity."""
    half = size // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32,
                      device=sigma.device)
    sig = sigma.clamp_min(1e-3)[:, None]
    k = torch.exp(-0.5 * (xs / sig) ** 2)
    ident = (xs == 0).float().expand_as(k)
    k = torch.where(sigma[:, None] < 0.05, ident, k)
    return k / k.sum(1, keepdim=True)


def _box_kernel(ksize: torch.Tensor, size: int = 13) -> torch.Tensor:
    half = size // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32,
                      device=ksize.device)
    active = (xs.abs() <= (ksize[:, None] - 1) / 2.0).float()
    return active / active.sum(1, keepdim=True)


def _conv3x3(img: torch.Tensor, kernel3: torch.Tensor) -> torch.Tensor:
    """3x3 filter on [B, H, W, C] with edge padding, kernels [B, 3, 3], in
    the dtype of `img`: nine multiply-adds, each rounded to that dtype, in
    the JAX package's order."""
    h, w = img.shape[1], img.shape[2]
    ih = torch.arange(-1, h + 1, device=img.device).clamp(0, h - 1)
    iw = torch.arange(-1, w + 1, device=img.device).clamp(0, w - 1)
    x = img.index_select(1, ih).index_select(2, iw)
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            out = out + _bc(kernel3[:, dy, dx]) * x[:, dy:dy + h, dx:dx + w]
    return out


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(v)
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-9), zero)
    safe = delta.clamp_min(1e-9)
    rh = torch.remainder((g - b) / safe, 6.0)
    gh = (b - r) / safe + 2.0
    bh = (r - g) / safe + 4.0
    hh = torch.where(maxc == r, rh, torch.where(maxc == g, gh, bh))
    hh = torch.where(delta < 1e-9, zero, hh) * 60.0
    return torch.stack([hh, s, v], -1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    h = torch.remainder(h, 360.0) / 60.0
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.to(torch.int32)

    def select(choices, default):
        out = default
        for k in (4, 3, 2, 1, 0):   # the first true condition wins
            out = torch.where(i == k, choices[k], out)
        return out

    r = select([v, q, p, p, t], v)
    g = select([t, v, v, q, p], p)
    b = select([p, p, t, v, v], q)
    return torch.stack([r, g, b], -1)


def _smooth_noise(small: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Band-limited [B, H, W, 1] noise in [0, 1]: the coarse uniform field
    `small`, bilinearly upsampled (blobby blend masks)."""
    return resize_bilinear(small, (h, w))


def _noise_shape(b: int, h: int, w: int, cells: int):
    return (b, h // cells + 1, w // cells + 1, 1)


# ---------------------------------------------------------------------------
# the 13 photometric pool members: a draw and an apply each
# ---------------------------------------------------------------------------

def _draw_superpixels(gen, cfg, b, h, w):
    gh, gw = max(h // 8, 1), max(w // 8, 1)
    p_replace = _uniform(gen, (b,))
    return {"rep": _uniform(gen, (b, gh, gw, 1)) < _bc(p_replace),
            "inner": _bernoulli(gen, cfg.p_sometimes, (b,))}


def _op_superpixels(p, x, cfg):
    """Sometimes(0.5, Superpixels(p_replace 0-1)): a fixed 8x cell mosaic."""
    h, w = x.shape[1], x.shape[2]
    gh, gw = max(h // 8, 1), max(w // 8, 1)
    mosaic = resize_bilinear(resize_bilinear(x, (gh, gw)), (h, w))
    rep = resize_bilinear(p["rep"].float(), (h, w)) > 0.5
    sp = torch.where(rep, mosaic, x)
    return torch.where(_bc(p["inner"]), sp, x)


def _draw_blur(gen, cfg, b, h, w):
    return {"which": _randint(gen, 0, 3, (b,)),
            "sigma": _uniform(gen, (b,), *cfg.blur_sigma),
            "ksize": _randint(gen, 2, 8, (b,)),
            "median": _randint(gen, 1, 6, (b,))}


def _op_blur(p, x, cfg):
    """OneOf {Gaussian(0-3), Average(k 2-7), Median(k 3-11)}: the kernel is
    chosen first, then one separable blur runs. Median is a Gaussian of
    matched width."""
    gk = _gaussian_kernel(p["sigma"])
    bk = _box_kernel(p["ksize"].float())
    mk = _gaussian_kernel(0.25 * p["median"].float() * 2 + 0.25)
    which = p["which"][:, None]
    kernel = torch.where(which == 0, gk, torch.where(which == 1, bk, mk))
    dt = _pool_dt(cfg)
    kernel = kernel.to(dt)
    return _sep_filter(x.to(dt), kernel, kernel).float()


def _draw_sharpen(gen, cfg, b, h, w):
    return {"alpha": _uniform(gen, (b,)),
            "lightness": _uniform(gen, (b,), 0.75, 1.5)}


def _op_sharpen(p, x, cfg):
    # the imgaug sharpen kernel (all -1, centre 8 + lightness) is
    # (9 + lightness) * x - box3x3sum(x); the box sum is a separable filter,
    # rounded to the pool's compute dtype before the f32 combination
    dt = _pool_dt(cfg)
    alpha = _bc(p["alpha"])
    ones = torch.ones((x.shape[0], 3), dtype=dt, device=x.device)
    s3 = _sep_filter(x.to(dt), ones, ones)
    base = (9.0 + _bc(p["lightness"])) * x - s3.float()
    return (1 - alpha) * x + alpha * base


def _draw_emboss(gen, cfg, b, h, w):
    return {"strength": _uniform(gen, (b,), 0.0, 2.0),
            "alpha": _uniform(gen, (b,))}


def _op_emboss(p, x, cfg):
    dt = _pool_dt(cfg)
    s = p["strength"]
    o, z = torch.ones_like(s), torch.zeros_like(s)
    ek = torch.stack([-1.0 - s, -s, z, -s, o, s, z, s, 1.0 + s],
                     1).reshape(-1, 3, 3).to(dt)
    alpha = _bc(p["alpha"])
    return (1 - alpha) * x + alpha * _conv3x3(x.to(dt), ek).float()


def _draw_edge_blend(gen, cfg, b, h, w):
    return {"direction": _uniform(gen, (b,)),
            "which": _bernoulli(gen, 0.5, (b,)),
            "nmask": _uniform(gen, _noise_shape(b, h, w, 8)),
            "ea": _uniform(gen, (b,), 0.5, 1.0)}


def _op_edge_blend(p, x, cfg):
    """BlendAlphaSimplexNoise(OneOf(EdgeDetect, DirectedEdgeDetect)); the
    directed variant rectifies the gradient along a random direction. Sobel
    is separable ([1, 2, 1] smooth x [-1, 0, 1] difference)."""
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    dt = _pool_dt(cfg)
    xc = x.to(dt)
    smooth = device_constant((1.0, 2.0, 1.0), x.device, dt).expand(b, 3)
    diff = device_constant((-1.0, 0.0, 1.0), x.device, dt).expand(b, 3)
    gx = _sep_filter(xc, smooth, diff).float()
    gy = _sep_filter(xc, diff, smooth).float()
    mag = torch.sqrt(gx ** 2 + gy ** 2).clamp(0, 255)
    direction = _bc(p["direction"] * 2.0 * math.pi)
    directed = (torch.relu(gx * torch.cos(direction)
                           + gy * torch.sin(direction)) * 2.0).clamp(0, 255)
    edges = torch.where(_bc(p["which"]), mag, directed)
    nmask = _smooth_noise(p["nmask"], h, w)
    ea = _bc(p["ea"])
    return x * (1 - nmask * ea) + edges * (nmask * ea)


def _draw_noise(gen, cfg, b, h, w):
    return {"nscale": _uniform(gen, (b,), *cfg.noise_scale),
            "per_ch": _bernoulli(gen, 0.5, (b,)),
            "n": _normal(gen, (b, h, w, 3), dtype=_pool_dt(cfg))}


def _op_noise(p, x, cfg):
    dt = _pool_dt(cfg)
    n = p["n"] * _bc(p["nscale"].to(dt))
    return x + torch.where(_bc(p["per_ch"]), n, n[..., :1].expand_as(n))


def _draw_dropout(gen, cfg, b, h, w):
    ch, cw = max(h // 24, 1), max(w // 24, 1)
    return {"dp": _uniform(gen, (b,), *cfg.dropout_p),
            "u": _uniform(gen, (b, h, w, 3), dtype=_pool_dt(cfg)),
            "per_ch": _bernoulli(gen, 0.5, (b,)),
            "cdp": _uniform(gen, (b,), *cfg.coarse_dropout_p),
            "uc": _uniform(gen, (b, ch, cw, 3)),
            "coarse_per_ch": _bernoulli(gen, 0.2, (b,)),
            "which": _bernoulli(gen, 0.5, (b,))}


def _op_dropout(p, x, cfg):
    """OneOf {Dropout(per_channel .5), CoarseDropout(per_channel .2)}; the
    per-channel masks reuse the single-channel uniform fields."""
    h, w = x.shape[1], x.shape[2]
    dt = _pool_dt(cfg)
    u, dp = p["u"], _bc(p["dp"].to(dt))
    keep = torch.where(_bc(p["per_ch"]), u >= dp,
                       (u[..., :1] >= dp).expand_as(u))
    cdp = _bc(p["cdp"])
    ucf = resize_bilinear(p["uc"], (h, w))
    ckeep = torch.where(_bc(p["coarse_per_ch"]), ucf >= cdp,
                        (ucf[..., :1] >= cdp).expand_as(ucf))
    return x * torch.where(_bc(p["which"]), keep, ckeep)


def _draw_invert(gen, cfg, b, h, w):
    return {"inv": _bernoulli(gen, cfg.invert_p, (b, 1, 1, 3))}


def _op_invert(p, x, cfg):
    return torch.where(p["inv"], 255.0 - x, x)


def _draw_add(gen, cfg, b, h, w):
    return {"per_ch": _bernoulli(gen, 0.5, (b,)),
            "a3": _uniform(gen, (b, 1, 1, 3), *cfg.add_range),
            "a1": _uniform(gen, (b, 1, 1, 1), *cfg.add_range)}


def _op_add(p, x, cfg):
    return x + torch.where(_bc(p["per_ch"]), p["a3"], p["a1"])


def _draw_hue_sat(gen, cfg, b, h, w):
    return {"dh": _uniform(gen, (b,), *cfg.hue_sat_range),
            "dsat": _uniform(gen, (b,), *cfg.hue_sat_range)}


def _op_hue_sat(p, x, cfg):
    # the HSV round trip runs in the pool's compute dtype: a bf16 ulp at 360
    # degrees is about 2 degrees, the granularity of u8 HSV (H in 0..179)
    dt = _pool_dt(cfg)
    hsv = _rgb_to_hsv(x.to(dt).clamp(0, 255) / 255.0)
    dh = p["dh"] * 2.0              # 0..179 -> degrees
    dsat = p["dsat"] / 255.0
    hue = hsv[..., 0] + dh.to(dt)[:, None, None]
    sat = (hsv[..., 1] + dsat.to(dt)[:, None, None]).clamp(0.0, 1.0)
    rgb = _hsv_to_rgb(torch.stack([hue, sat, hsv[..., 2]], -1))
    return (rgb * 255.0).float()


def _draw_multiply(gen, cfg, b, h, w):
    lo, hi = cfg.multiply_range
    return {"per_ch": _bernoulli(gen, 0.5, (b,)),
            "m3": _uniform(gen, (b, 1, 1, 3), lo, hi),
            "m1": _uniform(gen, (b, 1, 1, 1), lo, hi),
            "e": _uniform(gen, (b,), -4.0, 0.0),
            "smooth": _uniform(gen, _noise_shape(b, h, w, 16)),
            "white": _uniform(gen, (b, h, w, 1)),
            "fg3": _uniform(gen, (b, 1, 1, 3), lo, hi),
            "cb": _uniform(gen, (b,), *cfg.contrast_range),
            "which": _bernoulli(gen, 0.5, (b,))}


def _op_multiply(p, x, cfg):
    """OneOf {Multiply(per_channel .5), BlendAlphaFrequencyNoise(
    fg=Multiply per-channel, bg=LinearContrast)}; the frequency mask mixes
    band-limited and white noise by the drawn exponent."""
    h, w = x.shape[1], x.shape[2]
    whole = x * torch.where(_bc(p["per_ch"]), p["m3"], p["m1"])
    # frequency-noise branch: exponent -4 (blobs) .. 0 (white)
    t = _bc(2.0 ** p["e"])
    mask = (1 - t) * _smooth_noise(p["smooth"], h, w) + t * p["white"]
    fg = x * p["fg3"]
    bg = 127.0 + _bc(p["cb"]) * (x - 127.0)
    freq = mask * fg + (1 - mask) * bg
    return torch.where(_bc(p["which"]), whole, freq)


def _draw_contrast(gen, cfg, b, h, w):
    return {"per_ch": _bernoulli(gen, 0.5, (b,)),
            "c3": _uniform(gen, (b, 1, 1, 3), *cfg.contrast_range),
            "c1": _uniform(gen, (b, 1, 1, 1), *cfg.contrast_range)}


def _op_contrast(p, x, cfg):
    return 127.0 + torch.where(_bc(p["per_ch"]), p["c3"],
                               p["c1"]) * (x - 127.0)


def _draw_grayscale(gen, cfg, b, h, w):
    return {"ga": _uniform(gen, (b,))}


def _op_grayscale(p, x, cfg):
    ga = _bc(p["ga"])
    gray = (0.299 * x[..., 0] + 0.587 * x[..., 1]
            + 0.114 * x[..., 2])[..., None]
    return (1 - ga) * x + ga * gray


# (draw, apply) per pool member, in the pool's order
_PHOTO_OPS = [(_draw_superpixels, _op_superpixels), (_draw_blur, _op_blur),
              (_draw_sharpen, _op_sharpen), (_draw_emboss, _op_emboss),
              (_draw_edge_blend, _op_edge_blend), (_draw_noise, _op_noise),
              (_draw_dropout, _op_dropout), (_draw_invert, _op_invert),
              (_draw_add, _op_add), (_draw_hue_sat, _op_hue_sat),
              (_draw_multiply, _op_multiply), (_draw_contrast, _op_contrast),
              (_draw_grayscale, _op_grayscale)]
assert len(_PHOTO_OPS) == _N_PHOTO


def _photometric_batch(order, photo: list, x: torch.Tensor,
                       gates: torch.Tensor, cfg: AugmentConfig):
    """Apply the 13 photometric members to the batch in the order `order`
    (13 host integers: one order per batch; the gates stay per sample).
    Every op runs on the whole batch and is kept per sample where its gate
    is set. With the u8 carry every op's output is rounded (half to even)
    and clipped to 0..255, as imgaug requantises after every augmenter; the
    carry itself is quantised once on entry."""
    carry_dt = {"u8": torch.uint8, "bf16": torch.bfloat16,
                "f32": torch.float32}[cfg.photo_carry]
    u8 = cfg.photo_carry == "u8"

    def quant(v):
        return v.round().clamp(0.0, 255.0) if u8 else v

    x = quant(x).to(carry_dt)
    for i in order:
        img = x.float()
        out = quant(_PHOTO_OPS[i][1](photo[i], img, cfg))
        x = torch.where(_bc(gates[:, i]), out, img).to(carry_dt)
    return x.float().clamp(0.0, 255.0)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

class AugmentFn:
    """`fn(gen, images u8 [B, H, W, 3], segs u8 [B, H, W]) -> (images f32
    0..255 [B, H, W, 3], segs int32 [B, H, W])` on the images' device.

    `gen` is a `torch.Generator` of that device. The pool's order is drawn
    from `host_gen`, a CPU generator; without one it comes from a CPU
    generator seeded with `gen.initial_seed()` (or from `gen` itself when
    that is a CPU generator), so a caller that keeps drawing from one device
    generator passes its own `host_gen` to vary the order.

    `draw` and `apply` are the two halves: `apply(draw(...), images, segs)`
    is pure in the drawn parameters."""

    def __init__(self, config: AugmentConfig | None = None):
        self.config = config or AugmentConfig()
        _check_config(self.config)

    def draw(self, gen: torch.Generator, b: int, h: int, w: int,
             host_gen: torch.Generator | None = None) -> dict:
        """Every random value of one batch: `gates` [B, 16], `geometry` (see
        `_draw_geometry`), `photo` (one dict per pool member) and `order`
        (13 host integers)."""
        cfg = self.config
        if host_gen is None:
            host_gen = gen if gen.device.type == "cpu" else (
                torch.Generator().manual_seed(gen.initial_seed()))
        return {
            "gates": _draw_gates(gen, cfg, b),
            "geometry": _draw_geometry(gen, cfg, b, h, w),
            "photo": [draw(gen, cfg, b, h, w) for draw, _ in _PHOTO_OPS],
            "order": torch.randperm(_N_PHOTO, generator=host_gen).tolist()}

    @torch.no_grad()
    def apply(self, params: dict, images: torch.Tensor, segs: torch.Tensor):
        imgs, out_segs = _geometric_batch(params["geometry"], images, segs,
                                          params["gates"], self.config)
        imgs = _photometric_batch(params["order"], params["photo"], imgs,
                                  params["gates"], self.config)
        return imgs, out_segs

    @torch.no_grad()
    def __call__(self, gen: torch.Generator, images: torch.Tensor,
                 segs: torch.Tensor,
                 host_gen: torch.Generator | None = None):
        b, h, w = segs.shape
        return self.apply(self.draw(gen, b, h, w, host_gen), images, segs)


def make_augment_fn(config: AugmentConfig | None = None) -> AugmentFn:
    """The augmentation policy as a callable (see `AugmentFn`)."""
    return AugmentFn(config)
