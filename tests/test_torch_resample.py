"""PyTorch port: the row resampler of the augmentation warp against the JAX
package on the same numpy inputs (CPU). On the CPU the port's wrapper runs
its plain version; the JAX side is its dense `_reference` and the Pallas
kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.ops.pallas import banded_resample as jbr
from pytorch_segmentation_tpu_torch.ops.kernels import banded_resample as br

torch.set_num_threads(1)

# name -> (B, R, W, C, lo, hi): the shapes and coordinate ranges of the JAX
# package's own interpret-mode tests (tests/test_banded_resample.py)
CASES = {
    "exact_small_span": (2, 16, 128, 512, 10.0, 140.0),
    "exact_deep_start": (2, 16, 128, 512, 300.0, 430.0),
    "partial_tiles_low": (2, 18, 130, 513, 0.0, 120.0),
    "partial_tiles_near_c_minus_1": (2, 18, 130, 513, 392.0, 512.0),
    "wide_nonsquare": (1, 20, 160, 640, 489.0, 639.0),
    "seg_ids": (2, 16, 128, 512, 200.0, 330.0),
}


def _mk(b, r, w, c, lo, hi, seed=0):
    """Random planes and affine-like per-row coordinates spanning [lo, hi],
    as the JAX tests make them (exact .5 ties nudged away)."""
    rng = np.random.default_rng(seed)
    planes = rng.uniform(0, 255, size=(b, 4, r, c)).astype(np.float32)
    planes[:, 3] = rng.integers(0, 21, size=(b, r, c))
    a = (hi - lo) / max(w - 1, 1)
    base = lo + a * np.arange(w, dtype=np.float32)
    coords = base[None, None, :] + rng.uniform(
        -0.45, 0.45, size=(b, r, w)).astype(np.float32)
    coords = np.clip(coords, 0.0, c - 1.0).astype(np.float32)
    frac = coords - np.floor(coords)
    coords = np.where(np.abs(frac - 0.5) < 1e-3, coords + 2e-3,
                      coords).astype(np.float32)
    return planes, coords


def _torch_run(planes, coords, use_bil, out_dtype=torch.float32):
    before = br.launch_count()
    out = br.banded_resample_rows(
        torch.from_numpy(planes).bfloat16(), torch.from_numpy(coords),
        torch.from_numpy(use_bil), out_dtype=out_dtype)
    assert br.launch_count() == before  # CPU tensor: plain version
    assert out.dtype == out_dtype
    return out.float().numpy()


@pytest.mark.parametrize("use_bil", ["mixed", "all", "none"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_resample_equals_jax_reference(case, use_bil):
    """Two exact bf16 x bf16 products and one f32 sum on both sides: equal,
    atol 0, in f32 and after the cast to bf16."""
    b, r, w, c, lo, hi = CASES[case]
    planes, coords = _mk(b, r, w, c, lo, hi)
    ub = {"mixed": np.arange(b) % 2 == 0, "all": np.ones(b, bool),
          "none": np.zeros(b, bool)}[use_bil]
    want = jbr._reference(jnp.asarray(planes, jnp.bfloat16),
                          jnp.asarray(coords), jnp.asarray(ub))
    np.testing.assert_array_equal(_torch_run(planes, coords, ub),
                                  np.asarray(want))
    np.testing.assert_array_equal(
        _torch_run(planes, coords, ub, torch.bfloat16),
        np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))
    seg = _torch_run(planes, coords, ub)[:, 3]
    assert np.array_equal(seg, np.round(seg)) and seg.min() >= 0 \
        and seg.max() <= 20


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_resample_matches_interpreted_pallas_kernel(case):
    """Against the TPU kernel in interpret mode: atol 1e-3, the bound of the
    JAX package's own test of that kernel against its reference."""
    b, r, w, c, lo, hi = CASES[case]
    planes, coords = _mk(b, r, w, c, lo, hi)
    ub = np.arange(b) % 2 == 0
    for out_dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
        want = jbr.banded_resample_rows(
            jnp.asarray(planes, jnp.bfloat16), jnp.asarray(coords),
            jnp.asarray(ub), interpret=True, out_dtype=jdt)
        got = _torch_run(planes, coords, ub, out_dtype)
        if out_dtype == torch.float32:
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=1e-3)
        else:  # one bf16 ulp at 255 is 1: a value at a rounding tie may flip
            np.testing.assert_allclose(
                got, np.asarray(want.astype(jnp.float32)), rtol=2.0 ** -7,
                atol=1e-3)


def test_plain_resample_edges_and_ties():
    """Coordinates at 0 and C-1 (the tap at column C is never read), and the
    nearest tap at floor(c + 0.5) with the sum taken in f32: just under
    0.5 the f32 sum rounds up to 1, where `frac >= 0.5` would stay at 0."""
    c = 9
    planes = np.arange(4 * c, dtype=np.float32).reshape(1, 4, 1, c)
    under = np.nextafter(np.float32(0.5), np.float32(0))
    coords = np.array([[[0.0, c - 1.0, 2.5, 3.25, under]]], np.float32)
    assert np.float32(under + np.float32(0.5)) == 1.0 and under < 0.5
    for ub in (True, False):
        got = _torch_run(planes, coords, np.array([ub]))
        want = np.asarray(jbr._reference(
            jnp.asarray(planes, jnp.bfloat16), jnp.asarray(coords),
            jnp.asarray([ub])))
        np.testing.assert_array_equal(got, want)
    near = _torch_run(planes, coords, np.array([False]))
    np.testing.assert_array_equal(near[0, 0, 0], [0, 8, 3, 3, 1])
    np.testing.assert_array_equal(near[0, 3, 0], [27, 35, 30, 30, 28])
    # outside [0, C-1] a tap contributes nothing, as in the dense reference
    out = np.array([[[-0.25, c - 0.75, -3.0]]], np.float32)
    np.testing.assert_array_equal(
        _torch_run(planes, out, np.array([True])),
        np.asarray(jbr._reference(jnp.asarray(planes, jnp.bfloat16),
                                  jnp.asarray(out), jnp.asarray([True]))))


def test_resample_wrapper_checks_shapes():
    planes = torch.zeros(2, 4, 3, 5, dtype=torch.bfloat16)
    coords = torch.zeros(2, 3, 7)
    ub = torch.zeros(2, dtype=torch.bool)
    assert br.banded_resample_rows(planes, coords, ub).shape == (2, 4, 3, 7)
    with pytest.raises(ValueError):
        br.banded_resample_rows(planes[:, :3], coords, ub)
    with pytest.raises(ValueError):
        br.banded_resample_rows(planes, coords[:, :2], ub)
    with pytest.raises(ValueError):
        br.banded_resample_rows(planes, coords, ub[:1])
    # a transposed view gives what its contiguous copy gives
    rng = np.random.default_rng(1)
    sq = torch.from_numpy(rng.uniform(0, 255, (2, 4, 6, 6))).bfloat16()
    cs = torch.from_numpy(rng.uniform(0, 5, (2, 6, 6)).astype(np.float32))
    ub = torch.tensor([True, False])
    assert torch.equal(
        br.banded_resample_rows(sq.transpose(2, 3), cs, ub),
        br.banded_resample_rows(sq.transpose(2, 3).contiguous(), cs, ub))
