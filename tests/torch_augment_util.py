"""Shared pieces of the augmentation tests of the PyTorch port
(tests/test_torch_augment*.py): the tape that records the JAX package's
draws, the stacking of per-sample draws into the port's parameter dicts,
the pool's test images and the JAX pool composed op by op."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.data import augment as jaug

N = 41          # image side of the square geometry cases
H = 40          # image side of the pool cases: 8x and 24x cells, 16x ragged


def to_np(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    return np.asarray(a)


def to_t(a, dtype=None):
    t = torch.from_numpy(np.array(to_np(a)))  # a writable copy
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


def stack_draws(per_sample, names, dtypes=None):
    """Per-sample tapes (lists of draws, one list per sample) -> the port's
    parameter dict of [B, ...] tensors; a name of None drops the draw."""
    out = {}
    for k, name in enumerate(names):
        if name is not None:
            out[name] = torch.stack([to_t(s[k]) for s in per_sample])
            if dtypes and name in dtypes:
                out[name] = out[name].to(dtypes[name])
    return out


# ---------------------------------------------------------------------------
# the geometry's draws
# ---------------------------------------------------------------------------

# the port's name of each draw of the JAX geometry, in call order: the
# two-pass warps' (`_twopass_coords`) and the gather samplers'
# (`_geometric_coords`); with a fixed `image_warp_order` the last one
# (two-pass) or three (gather) are not drawn
_GEO_HEAD = ["some0", "some1", "some2", "flip_lr", "flip_ud", "do_cap",
             "sides", "do_aff", "sxa", "sya", "tx", "ty", "theta", "shear",
             "persp_scale", "persp_jitter", "perm", "alpha"]
TWOPASS_NAMES = _GEO_HEAD + ["pw_scale", "pw_grid", "jitter_x", "jitter_v",
                             "mode", "cval", "order_bil"]
PACKED_NAMES = _GEO_HEAD + ["elastic", "pw_scale", "pw_grid", "mode", "cval",
                            "order_bil", "dither_y", "dither_x"]
_GEO_DTYPES = {"jitter_x": torch.bfloat16, "jitter_v": torch.bfloat16,
               "perm": torch.int64, "mode": torch.int64}


def jax_geometry(tape, coords_fn, cfg, keys, gates, h, w, names):
    """The JAX coordinates function `coords_fn` (`_twopass_coords` or
    `_geometric_coords`) eagerly per sample: its outputs as numpy arrays
    stacked over the samples (None stays None), and the port's geometry
    dict from its draws."""
    outs, tapes = [], []
    tape.take()
    for k, g in zip(keys, gates):
        outs.append(coords_fn(k, h, w, jnp.asarray(g), cfg))
        tapes.append(tape.take())
    assert all(len(t) == len(names) for t in tapes)
    geo = stack_draws(tapes, names, _GEO_DTYPES)
    geo["sometimes"] = torch.stack([geo.pop(f"some{i}") for i in range(3)],
                                   1)
    stacked = [None if outs[0][k] is None
               else np.stack([to_np(o[k]) for o in outs])
               for k in range(len(outs[0]))]
    return stacked, geo


# ---------------------------------------------------------------------------
# warp fields of fixed homographies
# ---------------------------------------------------------------------------

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


# inverse homography and piecewise grid scale of each case
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


def fields_inputs(case):
    hinv, pscale = FIELD_CASES[case]
    grid = (np.random.default_rng(5).normal(0, 1, (5, 5, 2)) * pscale
            * N).astype(np.float32)
    return hinv, grid


def warp_inputs(seed=0, b=4):
    """A u8 batch and one field set per sample, from JAX's own
    `_twopass_fields` on four of the cases."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, N, N, 3), dtype=np.uint8)
    segs = rng.integers(0, 21, (b, N, N), dtype=np.uint8)
    cases = ["rot30", "rot60", "perspective", "piecewise"][:b]
    fields = [jaug._twopass_fields(*map(jnp.asarray, fields_inputs(c)), N, N)
              for c in cases]
    tf, sx, sy, vt = (np.stack([to_np(f[k]) for f in fields])
                      for k in range(4))
    jit = rng.uniform(-2, 2, (2, b, N, N)).astype(np.float32)
    return imgs, segs, vt + jit[0], sx + jit[1], sy, tf


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


def pool_images(seed, b=3, h=H, w=None):
    """Integer-valued f32 images [b, h, w, 3] (w defaults to h) as the
    pool's u8 carry hands them on: smooth ramps plus texture, so that
    filters see edges and flat areas."""
    w = h if w is None else w
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([4 * xx + 2 * yy, 255 - 5 * yy, 128 + 100
                     * np.sin(xx / 5)], -1)
    x = base[None] + rng.normal(0, 25, (b, h, w, 3))
    return np.clip(np.round(x), 0, 255).astype(np.float32)


def run_jax_op(tape, i, x, cfg, seed=0):
    """The JAX op `i` per sample; returns its f32 outputs and the port's
    parameter dict from the draws."""
    keys = jax.random.split(jax.random.PRNGKey(seed + 31 * i), x.shape[0])
    outs, tapes = [], []
    for k, img in zip(keys, x):
        tape.take()
        outs.append(to_np(jaug._PHOTO_OPS[i](k, jnp.asarray(img), cfg)))
        tapes.append(tape.take())
    assert all(len(t) == len(OP_DRAWS[i]) for t in tapes), OP_NAMES[i]
    dtypes = BF16_FIELDS if cfg.pool_compute == "bf16" else None
    return np.stack(outs), stack_draws(tapes, OP_DRAWS[i], dtypes)


def jax_pool(tape, cfg, keys, x, gates, order):
    """The JAX pool composed op by op with the u8 carry, and the port's
    per-op parameter dicts from the draws. `order` is one list of the 13
    ops for the batch (`_photometric_batch`'s per-batch branch, without its
    device-side switch) or one list per sample (its per-sample scan)."""
    b = x.shape[0]
    orders = order if isinstance(order[0], list) else [order] * b
    x = np.clip(np.round(x), 0, 255).astype(np.uint8)
    tapes = [[None] * b for _ in range(13)]
    for pos in range(13):
        outs = []
        for s in range(b):
            i = orders[s][pos]
            img = jnp.asarray(x[s], jnp.float32)
            tape.take()
            out = jaug._PHOTO_OPS[i](jax.random.fold_in(keys[s], 100 + i),
                                     img, cfg)
            tapes[i][s] = tape.take()
            out = jnp.clip(jnp.round(out), 0.0, 255.0)
            outs.append(to_np(jnp.where(bool(gates[s, i]), out, img)
                              .astype(jnp.uint8)))
        x = np.stack(outs)
    photo = [stack_draws(tapes[i], OP_DRAWS[i], BF16_FIELDS)
             for i in range(13)]
    return np.clip(x.astype(np.float32), 0, 255), photo
