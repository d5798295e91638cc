"""PyTorch port: the augmentation policy (data/augment.py) against the JAX
package on the CPU. The two frameworks' generators cannot agree, so every
comparison feeds both sides the same drawn values: the geometry functions
take their parameters as arguments, and the JAX functions that draw inside
(`_twopass_coords`, the 13 photometric ops) run eagerly with `jax.random`'s
samplers wrapped so that a tape records every draw, which the port's apply
half then takes. The JAX package reaches the row resampler through its dense
plain reference here, the port through its two-tap plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.data import augment as jaug
from pytorch_segmentation_tpu.data import pipeline as jpipe
from pytorch_segmentation_tpu_torch.data import augment as taug
from pytorch_segmentation_tpu_torch.data.loader import Batch
from pytorch_segmentation_tpu_torch.data.pipeline import PostFetch

torch.set_num_threads(1)

N = 41          # image side of the geometry cases
IDENTITY = dict(p_fliplr=0.0, p_flipud=0.0, p_crop_pad=0.0, p_affine=0.0,
                p_sometimes=0.0, someof_max=0)


def _np(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    return np.asarray(a)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(_np(a)))  # a writable copy
    return t if dtype is None else t.to(dtype)


class Tape:
    """Records what `jax.random`'s samplers return, in call order."""
    NAMES = ("uniform", "normal", "bernoulli", "randint", "permutation")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            monkeypatch.setattr(jax.random, name,
                                self._wrap(getattr(jax.random, name)))

    def _wrap(self, sampler):
        def wrapped(*args, **kwargs):
            out = sampler(*args, **kwargs)
            self.calls.append(out)
            return out
        return wrapped

    def take(self):
        calls, self.calls = self.calls, []
        return calls


@pytest.fixture
def tape(monkeypatch):
    return Tape(monkeypatch)


def _stack(per_sample, names, dtypes=None):
    """Per-sample tapes (lists of draws, one list per sample) -> the port's
    parameter dict of [B, ...] tensors; a name of None drops the draw."""
    out = {}
    for k, name in enumerate(names):
        if name is not None:
            out[name] = torch.stack([_t(s[k]) for s in per_sample])
            if dtypes and name in dtypes:
                out[name] = out[name].to(dtypes[name])
    return out


# ---------------------------------------------------------------------------
# geometry with fixed parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_homography_matches_jax(seed):
    rng = np.random.default_rng(seed)
    src = np.array([[0, 0], [N - 1, 0], [N - 1, N - 1], [0, N - 1]],
                   np.float32)
    dst = (src + rng.normal(0, 0.08 * N, (3, 4, 2))).astype(np.float32)
    got = taug._fit_homography(_t(src).expand(3, 4, 2), _t(dst)).numpy()
    for b in range(3):
        want = _np(jaug._fit_homography(jnp.asarray(src),
                                        jnp.asarray(dst[b])))
        # entries of order 1 (and 1/N in the last row): 1e-4 relative keeps
        # the mapped corners within 1e-4 px of each other
        np.testing.assert_allclose(got[b], want, rtol=1e-4, atol=1e-6)
        pts = np.concatenate([src, np.ones((4, 1), np.float32)], 1)
        mapped = pts @ got[b].T
        np.testing.assert_allclose(mapped[:, :2] / mapped[:, 2:], dst[b],
                                   atol=2e-3)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_boundary_matches_jax(mode):
    rng = np.random.default_rng(mode)
    coord = rng.uniform(-3.0 * N, 4.0 * N, (2, 7, 9)).astype(np.float32)
    coord[0, 0, :4] = [-0.0, -1.0, N - 1.0, -(2.0 * N - 2)]
    got = taug._boundary(_t(coord), N, torch.full((2, 1, 1), mode)).numpy()
    want = _np(jaug._boundary(jnp.asarray(coord), N, mode))
    # 1e-4 px; the remainders are exact, so the two are equal in practice
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got.min() >= 0 and got.max() <= N - 1


def _rot(deg, scale=1.0, shift=(0.0, 0.0)):
    th = np.deg2rad(deg)
    c = (N - 1) / 2
    m = np.array([[np.cos(th) * scale, -np.sin(th) * scale, 0],
                  [np.sin(th) * scale, np.cos(th) * scale, 0], [0, 0, 1.0]])
    pre = np.array([[1, 0, -c], [0, 1, -c], [0, 0, 1.0]])
    post = np.array([[1, 0, c + shift[0]], [0, 1, c + shift[1]], [0, 0, 1.0]])
    return np.linalg.inv(post @ m @ pre).astype(np.float32)


def _persp():
    m = _rot(10.0, 0.95, (1.5, -2.0)).astype(np.float64)
    m[2, 0], m[2, 1] = 1.2e-3, -7e-4
    return m.astype(np.float32)


FIELD_CASES = {
    "identity": (np.eye(3, dtype=np.float32), 0.0),
    "translation": (np.array([[1, 0, 3.5], [0, 1, -2.25], [0, 0, 1]],
                             np.float32), 0.0),
    "rot30": (_rot(30.0, 1.1), 0.0),
    "rot60": (_rot(60.0, 0.9, (2.0, 1.0)), 0.0),      # beyond 45: tf
    "rot_minus80": (_rot(-80.0), 0.0),
    "perspective": (_persp(), 0.0),
    "piecewise": (_rot(20.0), 0.03),
    "piecewise_rot60": (_rot(60.0), 0.05),
}


def _fields_inputs(case):
    hinv, pscale = FIELD_CASES[case]
    grid = (np.random.default_rng(5).normal(0, 1, (5, 5, 2)) * pscale
            * N).astype(np.float32)
    return hinv, grid


@pytest.mark.parametrize("case", sorted(FIELD_CASES))
def test_twopass_fields_match_jax(case):
    hinv, grid = _fields_inputs(case)
    tf, sx, sy, vt = jaug._twopass_fields(jnp.asarray(hinv),
                                          jnp.asarray(grid), N, N)
    got = taug._twopass_fields(_t(hinv)[None], _t(grid)[None], N, N)
    assert bool(got[0][0]) == bool(tf) == (case in ("rot60", "rot_minus80",
                                                    "piecewise_rot60"))
    for g, want in zip(got[1:], (sx, sy, vt)):
        assert g.shape == (1,) + want.shape
        assert bool(torch.isfinite(g).all())
        # 1e-4 px (the fields reach a few N where j* is clipped: 1e-6 rel.)
        np.testing.assert_allclose(g[0].numpy(), _np(want), rtol=1e-6,
                                   atol=1e-4)


def _warp_inputs(seed=0, b=4):
    """A u8 batch and one field set per sample, from JAX's own
    `_twopass_fields` on four of the cases."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, N, N, 3), dtype=np.uint8)
    segs = rng.integers(0, 21, (b, N, N), dtype=np.uint8)
    cases = ["rot30", "rot60", "perspective", "piecewise"][:b]
    fields = [jaug._twopass_fields(*map(jnp.asarray, _fields_inputs(c)), N, N)
              for c in cases]
    tf, sx, sy, vt = (np.stack([_np(f[k]) for f in fields])
                      for k in range(4))
    jit = rng.uniform(-2, 2, (2, b, N, N)).astype(np.float32)
    return imgs, segs, vt + jit[0], sx + jit[1], sy, tf


@pytest.mark.parametrize("use_bil", ["mixed", "nearest"])
@pytest.mark.parametrize("modes", [(0, 1, 2, 3), (0, 0, 3, 2)])
def test_sample_two_pass_banded_matches_jax(modes, use_bil):
    imgs, segs, vt, sx, sy, tf = _warp_inputs()
    mode = np.array(modes, np.int32)
    cval = np.array([7.25, 200.5, 0.0, 99.0], np.float32)
    ub = (np.array([True, False, True, True]) if use_bil == "mixed"
          else np.zeros(4, bool))
    want_img, want_seg = jaug._sample_two_pass_banded(
        *map(jnp.asarray, (imgs, segs, vt, sx, sy, mode, cval, ub, tf)))
    got_img, got_seg = taug._sample_two_pass_banded(
        *map(_t, (imgs, segs, vt, sx, sy)), _t(mode).long(), _t(cval),
        _t(ub), _t(tf))
    assert got_img.dtype == torch.float32 and got_seg.dtype == torch.int32
    np.testing.assert_array_equal(got_seg.numpy(), _np(want_seg))
    # within one bf16 ulp (2^-7 relative); both sides take two exact
    # products and one f32 sum per pass, so they come out equal
    np.testing.assert_allclose(got_img.numpy(), _np(want_img),
                               rtol=2.0 ** -7, atol=0)
    assert float(np.abs(got_img.numpy() - _np(want_img)).max()) == 0.0


def test_sample_two_pass_banded_f32_output_and_nonsquare():
    imgs, segs, vt, sx, sy, tf = _warp_inputs(b=2)
    args = (np.array([1, 2], np.int32), np.array([0, 0], np.float32),
            np.array([True, True]))
    want_img, _ = jaug._sample_two_pass_banded(
        *map(jnp.asarray, (imgs, segs, vt, sx, sy, *args, tf)),
        out_dtype=jnp.float32)
    targs = (*map(_t, (imgs, segs, vt, sx, sy)), _t(args[0]).long(),
             _t(args[1]), _t(args[2]), _t(tf))
    got_img, _ = taug._sample_two_pass_banded(*targs,
                                              out_dtype=torch.float32)
    np.testing.assert_array_equal(got_img.numpy(), _np(want_img))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        taug._sample_two_pass_banded(targs[0][:, :, :30], targs[1][:, :, :30],
                                     *targs[2:])


# ---------------------------------------------------------------------------
# the geometry's draw -> fields chain under the same draws
# ---------------------------------------------------------------------------

GEO_NAMES = ["some0", "some1", "some2", "flip_lr", "flip_ud", "do_cap",
             "sides", "do_aff", "sxa", "sya", "tx", "ty", "theta", "shear",
             "persp_scale", "persp_jitter", "perm", "alpha", "pw_scale",
             "pw_grid", "jitter_x", "jitter_v", "mode", "cval", "order_bil"]


def _jax_coords(tape, cfg, keys, gates, n):
    """JAX `_twopass_coords` per sample, and the port's geometry dict from
    its draws."""
    outs, tapes = [], []
    for k, g in zip(keys, gates):
        outs.append(jaug._twopass_coords(k, n, n, jnp.asarray(g), cfg))
        tapes.append(tape.take())
    assert all(len(t) == len(GEO_NAMES) for t in tapes)
    geo = _stack(tapes, GEO_NAMES, {"jitter_x": torch.bfloat16,
                                    "jitter_v": torch.bfloat16,
                                    "perm": torch.int64,
                                    "mode": torch.int64})
    geo["sometimes"] = torch.stack([geo.pop(f"some{i}") for i in range(3)],
                                   1)
    stacked = [np.stack([_np(o[k]) for o in outs]) for k in range(7)]
    return stacked, geo


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twopass_coords_match_jax_under_the_same_draws(tape, seed):
    """`_component_matrices`, `_compose_permuted`, the inverse, the fields,
    the bf16 jitter and the sampling parameters, all from JAX's draws."""
    cfg = jaug.AugmentConfig(p_sometimes=0.9, p_affine=0.8)
    tcfg = taug.AugmentConfig(p_sometimes=0.9, p_affine=0.8)
    b = 4
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    gates = np.random.default_rng(seed).random((b, 16)) < 0.6
    (vt, sx, sy, mode, cval, ub, tf), geo = _jax_coords(tape, cfg, keys,
                                                        gates, N)
    got = taug._twopass_coords(geo, _t(gates), tcfg, N, N)
    np.testing.assert_array_equal(got[6].numpy(), tf)
    np.testing.assert_array_equal(got[3].numpy(), mode)
    np.testing.assert_array_equal(got[5].numpy(), ub)
    np.testing.assert_array_equal(got[4].numpy(), cval)
    # the fields go through an f32 3x3 inverse and an 8x8 solve whose
    # elimination orders differ between the frameworks: 1e-4 px (measured
    # 2e-5 on fields that reach 65)
    for g, want in zip(got[:3], (vt, sx, sy)):
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the 13 photometric ops under identical draws
# ---------------------------------------------------------------------------

# per op: the port's parameter name of each JAX draw, in JAX's call order
OP_DRAWS = [
    [None, "rep", "inner"],
    ["which", "sigma", "ksize", "median"],
    ["alpha", "lightness"],
    ["strength", "alpha"],
    ["direction", "which", "nmask", "ea"],
    ["nscale", "per_ch", "n"],
    ["dp", "u", "per_ch", "cdp", "uc", "coarse_per_ch", "which"],
    ["inv"],
    ["per_ch", "a3", "a1"],
    ["dh", "dsat"],
    ["per_ch", "m3", "m1", "e", "smooth", "white", "fg3", "cb", "which"],
    ["per_ch", "c3", "c1"],
    ["ga"],
]
OP_NAMES = ["superpixels", "blur", "sharpen", "emboss", "edge_blend", "noise",
            "dropout", "invert", "add", "hue_sat", "multiply", "contrast",
            "grayscale"]
BF16_FIELDS = {"n": torch.bfloat16, "u": torch.bfloat16}
H = 40          # image side of the pool cases: 8x and 24x cells, 16x ragged


def _pool_images(seed, b=3, n=H):
    """Integer-valued f32 images as the pool's u8 carry hands them on:
    smooth ramps plus texture, so that filters see edges and flat areas."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    base = np.stack([4 * xx + 2 * yy, 255 - 5 * yy, 128 + 100
                     * np.sin(xx / 5)], -1)
    x = base[None] + rng.normal(0, 25, (b, n, n, 3))
    return np.clip(np.round(x), 0, 255).astype(np.float32)


def _run_jax_op(tape, i, x, cfg, seed=0):
    """The JAX op `i` per sample; returns its f32 outputs and the port's
    parameter dict from the draws."""
    keys = jax.random.split(jax.random.PRNGKey(seed + 31 * i), x.shape[0])
    outs, tapes = [], []
    for k, img in zip(keys, x):
        tape.take()
        outs.append(_np(jaug._PHOTO_OPS[i](k, jnp.asarray(img), cfg)))
        tapes.append(tape.take())
    assert all(len(t) == len(OP_DRAWS[i]) for t in tapes), OP_NAMES[i]
    dtypes = BF16_FIELDS if cfg.pool_compute == "bf16" else None
    return np.stack(outs), _stack(tapes, OP_DRAWS[i], dtypes)


@pytest.mark.parametrize("i", range(13), ids=OP_NAMES)
def test_photo_op_matches_jax_f32_pool(tape, i):
    """pool_compute="f32": within 1e-3 on the 0..255 scale, before any
    requantisation (measured: 1e-4 in blur, whose matrix products sum in
    another order, 3e-5 in edge_blend, 0 elsewhere). Comparisons against a
    drawn field (dropout, superpixel cells) are exact on both sides, so no
    pixel flips."""
    x = _pool_images(i)
    want, params = _run_jax_op(
        tape, i, x, jaug.AugmentConfig(pool_compute="f32"))
    got = taug._PHOTO_OPS[i][1](params, _t(x),
                                taug.AugmentConfig(pool_compute="f32"))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("i", range(13), ids=OP_NAMES)
def test_photo_op_matches_jax_bf16_pool(tape, i):
    """The default pool (bf16 compute). The port rounds to bf16 where the
    JAX op does (after each product of a separable filter, after each of
    the nine multiply-adds of the 3x3 filter, in every step of the HSV round
    trip), so the f32 outputs agree to 1e-3 (measured 2e-5, in edge_blend's
    f32 combination; 0 elsewhere), far inside one ulp of any op's bf16
    intermediate. After the u8 requantisation at most 0.1% of the elements
    may differ, by one count (a value at a rounding tie); measured none."""
    x = _pool_images(100 + i)
    want, params = _run_jax_op(tape, i, x, jaug.AugmentConfig(), seed=7)
    got = taug._PHOTO_OPS[i][1](params, _t(x), taug.AugmentConfig()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    diff = np.abs(np.clip(np.round(got), 0, 255)
                  - np.clip(np.round(want), 0, 255))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.001, (
        OP_NAMES[i], diff.max(), (diff > 0).mean())


# ---------------------------------------------------------------------------
# the slice as a whole under one fixed set of parameters
# ---------------------------------------------------------------------------

def _jax_pool(tape, cfg, keys, x, gates, order):
    """The JAX pool composed op by op in `order` with the u8 carry
    (`_photometric_batch`'s per-batch-order branch, without its device-side
    switch), and the port's per-op parameter dicts from the draws."""
    b = x.shape[0]
    photo = [None] * 13
    x = np.clip(np.round(x), 0, 255).astype(np.uint8)
    for i in order:
        outs, tapes = [], []
        for s in range(b):
            img = jnp.asarray(x[s], jnp.float32)
            tape.take()
            out = jaug._PHOTO_OPS[i](jax.random.fold_in(keys[s], 100 + i),
                                     img, cfg)
            tapes.append(tape.take())
            out = jnp.clip(jnp.round(out), 0.0, 255.0)
            outs.append(_np(jnp.where(bool(gates[s, i]), out, img)
                            .astype(jnp.uint8)))
        photo[i] = _stack(tapes, OP_DRAWS[i], BF16_FIELDS)
        x = np.stack(outs)
    return np.clip(x.astype(np.float32), 0, 255), photo


def test_slice_matches_jax_under_fixed_parameters(tape):
    """u8 batch in, normalized bf16 images and int32 labels out. JAX side:
    `_twopass_coords` + `_sample_two_pass_banded` + the ops in one order
    with the u8 carry + `normalize_images`; the port: `AugmentFn.apply`
    inside `PostFetch`. The only difference between the two sides is in the
    coordinate fields (2e-5 px, from the 3x3 inverse and the 8x8 solve):
    it moves a bilinear sample by a fraction of a count, which the pool's
    u8 requantisation turns into a whole count on a few pixels and later
    ops amplify. Labels: equal but for a coordinate that straddles a
    rounding boundary (at most 0.1%; measured none). Normalized images: at
    most 1% of the elements differ at all (measured 0.16%), none by more
    than 0.15 (measured 0.07: four counts of 1/58 after bf16 rounding),
    mean absolute difference at most 1e-3 (measured 5e-5)."""
    b, seed = 3, 4
    rng = np.random.default_rng(seed)
    imgs = _pool_images(seed, b, N).astype(np.uint8)
    segs = np.zeros((b, N, N), np.uint8)
    segs[:, 8:30, 5:25] = 3
    segs[:, 20:38, 18:40] = 7
    cfg, tcfg = jaug.AugmentConfig(), taug.AugmentConfig()
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    gates = np.zeros((b, 16), bool)
    gates[0, [1, 5, 9, 13]] = True
    gates[1, [2, 4, 10, 14, 15]] = True
    gates[2, [0, 3, 6, 8, 11]] = True
    order = [int(v) for v in rng.permutation(13)]

    coords, geo = _jax_coords(tape, cfg, keys, gates, N)
    j_img, j_seg = jaug._sample_two_pass_banded(
        jnp.asarray(imgs), jnp.asarray(segs), *map(jnp.asarray, coords))
    j_img, photo = _jax_pool(tape, cfg, keys, _np(j_img), gates, order)
    want_img = _np(jpipe.normalize_images(jnp.asarray(j_img),
                                          dtype=jnp.bfloat16))

    fn = taug.make_augment_fn(tcfg)
    params = {"gates": _t(gates), "geometry": geo, "photo": photo,
              "order": order}
    post = PostFetch(
        augment_fn=lambda gen, i, s, host_gen=None: fn.apply(params, i, s),
        dtype=torch.bfloat16, device="cpu")
    got_img, got_seg, valid = post(Batch(imgs, segs, b))
    assert valid == b and got_img.dtype == torch.bfloat16
    assert got_seg.dtype == torch.int32 and got_img.shape == (b, N, N, 3)
    seg_diff = (got_seg.numpy() != _np(j_seg)).mean()
    assert seg_diff <= 0.001, seg_diff
    assert set(np.unique(got_seg.numpy())) <= {0, 3, 7}
    diff = np.abs(got_img.float().numpy() - want_img)
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    assert diff.max() <= 0.15 and diff.mean() <= 1e-3, (diff.max(),
                                                        diff.mean())


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------

def _batch(seed=0, b=4, n=48):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, n, n, 3), dtype=np.uint8)
    segs = np.zeros((b, n, n), np.uint8)
    segs[:, 10:30, 10:30] = 1
    return torch.from_numpy(imgs), torch.from_numpy(segs)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_someof_selects_at_most_max_uniformly():
    cfg = taug.AugmentConfig()
    gates = taug._draw_gates(_gen(), cfg, 6000)
    assert gates.shape == (6000, 16) and gates.dtype == torch.bool
    counts = gates.sum(1)
    assert int(counts.max()) == cfg.someof_max and int(counts.min()) == 0
    share = torch.bincount(counts, minlength=6).float() / 6000
    assert bool(((share - 1 / 6).abs() < 0.03).all()), share  # k ~ U{0..5}
    per_member = gates.float().mean(0)                        # 2.5 / 16
    assert bool(((per_member - 2.5 / 16).abs() < 0.03).all()), per_member
    none = taug._draw_gates(_gen(), dataclasses.replace(cfg, someof_max=0),
                            50)
    assert not bool(none.any())


def test_geometry_draw_rates_and_ranges():
    cfg = taug.AugmentConfig()
    g = taug._draw_geometry(_gen(1), cfg, 4000, 4, 4)
    for name, p in (("flip_lr", cfg.p_fliplr), ("flip_ud", cfg.p_flipud),
                    ("do_cap", cfg.p_crop_pad), ("do_aff", cfg.p_affine),
                    ("order_bil", 0.5)):
        assert abs(float(g[name].float().mean()) - p) < 0.04, name
    for name, (lo, hi) in (("sides", cfg.crop_pad_percent),
                           ("sxa", cfg.scale_range),
                           ("theta", cfg.rotate_range),
                           ("alpha", cfg.elastic_alpha), ("cval", (0, 255))):
        assert float(g[name].min()) >= lo and float(g[name].max()) <= hi
        assert float(g[name].max() - g[name].min()) > 0.9 * (hi - lo), name
    assert sorted(g["mode"].unique().tolist()) == [0, 1, 2, 3]
    assert bool((g["perm"].sort(1).values == torch.arange(5)).all())
    assert g["jitter_x"].dtype == torch.bfloat16
    assert g["jitter_x"].shape == g["jitter_v"].shape == (4000, 4, 4)


def test_shapes_ranges_and_labels():
    imgs, segs = _batch()
    out_i, out_s = taug.make_augment_fn()(_gen(), imgs, segs)
    assert out_i.shape == imgs.shape and out_s.shape == segs.shape
    assert out_i.dtype == torch.float32 and out_s.dtype == torch.int32
    assert float(out_i.min()) >= 0.0 and float(out_i.max()) <= 255.0
    assert set(out_s.unique().tolist()) <= {0, 1}
    # the u8 carry leaves whole numbers
    assert torch.equal(out_i, out_i.round())


def test_identity_config_passes_through():
    imgs, segs = _batch()
    for kw in (IDENTITY, {**IDENTITY, "p_sometimes": 1.0}):
        fn = taug.make_augment_fn(taug.AugmentConfig(**kw))
        for seed in range(3):
            out_i, out_s = fn(_gen(seed), imgs, segs)
            assert torch.equal(out_i, imgs.float())
            assert torch.equal(out_s, segs.int())


def test_image_and_labels_are_warped_alike():
    flip = taug.AugmentConfig(**{**IDENTITY, "p_fliplr": 1.0})
    segs = np.zeros((2, 32, 32), np.uint8)
    segs[:, 4:12, 2:20] = 1
    imgs = (segs * 255)[..., None].repeat(3, -1)
    out_i, out_s = taug.make_augment_fn(flip)(_gen(), torch.from_numpy(imgs),
                                              torch.from_numpy(segs))
    assert np.array_equal(out_s.numpy(), segs[:, :, ::-1])
    assert np.array_equal(out_i.numpy()[..., 0], segs[:, :, ::-1] * 255.0)
    # a general nearest warp: the label painted into the image moves with it
    warp = taug.AugmentConfig(**{**IDENTITY, "p_affine": 1.0,
                                 "p_crop_pad": 1.0, "image_warp_order": 0})
    fn = taug.make_augment_fn(warp)
    params = fn.draw(_gen(3), 2, 32, 32)
    params["geometry"]["mode"][:] = 1        # edge mode: no constant fill
    out_i, out_s = fn.apply(params, torch.from_numpy(imgs),
                            torch.from_numpy(segs))
    inside = out_s == 1
    assert bool(inside.any())
    assert not torch.equal(out_s, torch.from_numpy(segs).int())
    assert bool((out_i[..., 0][inside] == 255).all())


def test_same_seed_and_step_give_the_same_batch():
    imgs, segs = _batch()
    fn = taug.make_augment_fn()
    batch = Batch(imgs.numpy(), segs.numpy(), 4)

    def run(seed, steps):
        post = PostFetch(fn, seed=seed, device="cpu")
        return [post(batch) for _ in range(steps)]

    first, again, other = run(5, 2), run(5, 2), run(6, 1)
    for (a, sa, _), (b, sb, _) in zip(first, again):
        assert torch.equal(a, b) and torch.equal(sa, sb)
    assert not torch.equal(first[0][0], first[1][0])     # another step
    assert not torch.equal(first[0][0], other[0][0])     # another seed
    # per-sample randomness: identical inputs diverge across the batch
    same = imgs[:1].expand(4, -1, -1, -1).contiguous()
    out_i, _ = fn(_gen(3), same, segs)
    assert not torch.equal(out_i[0], out_i[1])


def test_draws_follow_the_config():
    fn = taug.make_augment_fn(taug.AugmentConfig(image_warp_order=1,
                                                 photo_carry="f32",
                                                 pool_compute="f32"))
    params = fn.draw(_gen(), 3, 16, 16)
    assert sorted(params["order"]) == list(range(13))
    assert params["photo"][5]["n"].dtype == torch.float32
    imgs, segs = _batch(b=3, n=16)
    out_i, _ = fn.apply(params, imgs, segs)
    assert not torch.equal(out_i, out_i.round())   # no u8 requantisation
    use_bil = taug._twopass_coords(params["geometry"], params["gates"],
                                   fn.config, 16, 16)[5]
    assert bool(use_bil.all())
    # another host generator gives another order
    orders = {tuple(fn.draw(_gen(), 1, 8, 8, host_gen=_gen(s))["order"])
              for s in range(4)}
    assert len(orders) > 1


@pytest.mark.parametrize("option", [
    dict(fast_geometric=True), dict(separable_warp=True),
    dict(banded_warp=False), dict(per_sample_photo_order=True),
    dict(legacy_ops=True)])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP: Augmentation"):
        taug.make_augment_fn(taug.AugmentConfig(**option))


def test_nonsquare_images_raise():
    fn = taug.make_augment_fn()
    with pytest.raises(NotImplementedError, match="ROADMAP: Augmentation"):
        fn(_gen(), torch.zeros(2, 24, 32, 3, dtype=torch.uint8),
           torch.zeros(2, 24, 32, dtype=torch.uint8))


def test_config_fields_equal_the_jax_package():
    ours = {f.name: f.default for f in dataclasses.fields(taug.AugmentConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jaug.AugmentConfig)}
    assert ours == theirs
