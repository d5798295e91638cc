"""PyTorch port: SegNeXt (the MSCAN encoder and the LightHam decoder with its
NMF) against the JAX package on the same seeded weights and inputs, on the
CPU: the GroupNorm against flax's in f32 and bf16, `nmf_bases`, `nmf2d`'s
forward and its one-step gradient against `jax.grad` of the JAX function,
the weights' mapping both ways and against the JAX `convert_named` (the
layer scales' `scale` leaves, the GroupNorm leaves, the (1, k) and (k, 1)
strip kernels), the f32 forwards (stride-8 f32 logits and the resize to
the input size), the bf16 forward (its logits f32; bit for bit against
the JAX module run eagerly, marked slow), `make_mask_fn`, one
`Trainer` step against the JAX train step and every variant on the meta
device. 5 classes, 64x64 inputs, batch 2, the JAX package's `tiny` MSCAN.
Each JAX program is compiled once."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import (
    MODEL_VARIANTS as JAX_MODEL_VARIANTS)
from pytorch_segmentation_tpu.models import SegNeXt as JaxSegNeXt
from pytorch_segmentation_tpu.models import segnext as jax_segnext
from pytorch_segmentation_tpu_torch import inference as tinference
from pytorch_segmentation_tpu_torch import serve as tserve
from pytorch_segmentation_tpu_torch import test as ttest
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.data.pipeline import normalize_images
from pytorch_segmentation_tpu_torch.models import (MODEL_VARIANTS,
                                                   build_model,
                                                   variant_kwargs)
from pytorch_segmentation_tpu_torch.models.segnext import (MSCAN_VARIANTS,
                                                           nmf2d, nmf_bases)
from pytorch_segmentation_tpu_torch.nn.blocks import GroupNorm
from pytorch_segmentation_tpu_torch.utils.weights import seeded_state_dict
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches,
                               assert_weights_match_convert_named,
                               jax_train_step, port_trainer_step,
                               train_batch)

torch.set_num_threads(1)

NC, HW = 5, 64
TINY = {"variant": "tiny"}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    # the bf16 mean bound at the logits is 1.0 of the bf16 error: the
    # port's bf16 logits equal the EAGER JAX module's bit for bit
    # (test_bf16_logits_equal_eager_jax: every cast where the JAX module
    # puts it, GELU's roundings too), and the compiled JAX program parts
    # from its own source by 0.84 of the bf16 error (XLA keeps sums of the
    # MSCA gate's strip convolutions and the GELUs' products unrounded).
    # The largest difference is held to the largest bf16 error of the JAX
    # module itself (measured: 0.036 against 0.055, the logits below 1.8)
    # instead of 2% of the largest logit
    return FamilyCase("segnext", JaxSegNeXt, NC, HW,
                      tmp_path_factory.mktemp("segnext"), f32_logits=True,
                      logits_mean_bound=1.0, logits_max_bound=1.0, **TINY)


@pytest.fixture(scope="module")
def f32(case):
    """The JAX SegNeXt's stride-8 f32 logits [2, 8, 8, NC]."""
    return case.jax_logits()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_group_norm_matches_flax(dtype):
    """GroupNorm(32) on a compute-dtype NCHW map against flax's on its NHWC
    view: the f32 result within 1e-5, the bf16 one equal but for a
    rounding step at an element (the f32 results before the cast differ
    by summation order)."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 64, 5, 6)) + 1.0).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = fnn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jdt,
                         param_dtype=jnp.float32).apply(
        {"params": {"scale": weight, "bias": bias}},
        jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jdt))
    norm = GroupNorm(32, 64, dtype=dtype)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(weight))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        step = np.abs(want) * 2.0 ** -7 + 1e-30
        assert (np.abs(got - want) <= step).all()
        assert (got != want).mean() < 0.01


def test_nmf_bases_equal_jax():
    for dim, rank in ((32, 8), (256, 64), (512, 64)):
        got = nmf_bases(dim, rank)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_segnext.nmf_bases(dim, rank))


@pytest.mark.parametrize("steps", [6, 7])
def test_nmf2d_and_its_one_step_gradient_match_jax(steps):
    """`nmf2d` of one small non-negative map (B=2, D=16, 6x5, rank 4) in f32
    against the JAX function within rtol 1e-4 / atol 1e-6, and the
    gradient of sum(out * w) to the input against `jax.grad` within rtol
    1e-3 / atol 1e-6: only the last coefficient update and the
    reconstruction carry it (the updates before run without a graph), so
    it differs from the gradient through all the updates (checked to part
    by more than 10%)."""
    rng = np.random.default_rng(steps)
    x = rng.uniform(0.0, 2.0, (2, 6, 5, 16)).astype(np.float32)
    w = rng.standard_normal((2, 6, 5, 16)).astype(np.float32)

    def jax_loss(xx):
        return jnp.sum(jax_segnext.nmf2d(xx, 4, steps) * w)

    # each JAX side one compiled program (eagerly, every op compiles)
    want = np.asarray(jax.jit(lambda xx: jax_segnext.nmf2d(xx, 4, steps))(
        jnp.asarray(x)))
    want_grad = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(x)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    out = nmf2d(xt, 4, steps)
    assert out.shape == xt.shape and out.dtype == torch.float32
    (out * torch.from_numpy(w.transpose(0, 3, 1, 2).copy())).sum().backward()
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1),
                               want, rtol=1e-4, atol=1e-6)
    got_grad = xt.grad.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-3, atol=1e-6)

    def full_loss(xx):   # the gradient through every update
        b_, h, w_, d = xx.shape
        xf = xx.reshape(b_, h * w_, d)
        bases = jnp.broadcast_to(jnp.asarray(jax_segnext.nmf_bases(d, 4)),
                                 (b_, d, 4))
        coef = jax.nn.softmax(jnp.einsum("bnd,bdr->bnr", xf, bases), -1)
        for _ in range(steps + 1):
            coef = coef * jnp.einsum("bnd,bdr->bnr", xf, bases) / (
                jnp.einsum("bns,bsr->bnr", coef, jnp.einsum(
                    "bds,bdr->bsr", bases, bases)) + 1e-6)
            if _ == steps:
                break
            bases = bases * jnp.einsum("bnd,bnr->bdr", xf, coef) / (
                jnp.einsum("bds,bsr->bdr", bases, jnp.einsum(
                    "bns,bnr->bsr", coef, coef)) + 1e-6)
        out = jnp.einsum("bdr,bnr->bnd", bases, coef)
        return jnp.sum(out.reshape(xx.shape) * w)

    full = np.asarray(jax.jit(jax.grad(full_loss))(jnp.asarray(x)))
    assert (np.linalg.norm(full - want_grad)
            > 0.1 * np.linalg.norm(want_grad))


def test_weights_match_convert_named(case):
    """The layer scales keep their `scale` leaf and name (no JAX export
    maps them), the GroupNorms' scale and bias map to weight and bias, a
    (1, 7) depthwise strip kernel HWIO (1, 7, 1, C) to (C, 1, 1, 7); the
    'train' start sets the layer scales to the JAX init, 1e-2."""
    params, stats = assert_weights_match_convert_named(case)
    block = params["backbone"]["stage0_block0"]
    assert block["layer_scale_1"] == {"scale": (16,)}
    msca = block["attn"]["spatial_gating_unit"]
    assert msca["conv0_1"]["kernel"] == (1, 7, 1, 16)
    assert msca["conv2_2"]["kernel"] == (21, 1, 1, 16)
    assert params["hamburger"]["ham_out_gn"] == {"scale": (32,),
                                                 "bias": (32,)}
    assert params["squeeze"]["gn"] == {"scale": (32,), "bias": (32,)}
    assert stats["backbone"]["stage0_block0"]["norm1"] == {"mean": (16,),
                                                           "var": (16,)}
    kernel = case.params["backbone"]["stage0_block0"]["attn"][
        "spatial_gating_unit"]["conv0_1"]["kernel"]
    np.testing.assert_array_equal(
        case.sd["backbone.stage0_block0.attn.spatial_gating_unit.conv0_1"
                ".weight"].numpy()[:, 0, 0], kernel[0, :, 0].T)
    model = case.port_module()
    assert (model.output_stride, model.up_align_corners) == (8, False)
    train = seeded_state_dict(model, seed=0, init="train")
    scales = [v for k, v in train.items() if k.endswith(".scale")]
    assert len(scales) == 8 and all(torch.all(s == 1e-2) for s in scales)
    assert float(train["hamburger.ham_out_gn.weight"].min()) == 1.0
    assert "hamburger.bases" not in model.state_dict()


@pytest.mark.parametrize("full_res_output,dtype", [
    pytest.param(False, torch.float32, id="False"),
    pytest.param(True, torch.float32, id="True"),
    pytest.param(False, torch.bfloat16, id="bf16")])
def test_forward_matches_jax(case, f32, full_res_output, dtype):
    bf16 = (case.jax_logits(jnp.bfloat16) if dtype == torch.bfloat16
            else None)
    assert_forward_matches_jax(case, full_res_output, dtype, f32, bf16)


@pytest.mark.slow
def test_bf16_logits_equal_eager_jax(case):
    """The bf16 forward (f32 parameters, f32 logits) equals the JAX module
    run op by op, uncompiled, bit for bit: the casts, GELU's roundings,
    the GroupNorms and the NMF in f32 are where the JAX module has them.
    (Eager JAX compiles every op and shape: ~18 s.)"""
    x = normalize_images(torch.from_numpy(case.images)).numpy()
    want = np.asarray(case.jax_module(False, jnp.bfloat16).apply(
        {"params": case.params, "batch_stats": case.stats}, x, train=False))
    got, _ = case.port_logits(False, torch.bfloat16)
    np.testing.assert_array_equal(got, want)


def test_make_mask_fn_matches_jax(case, f32):
    assert_mask_fn_matches_jax(case, f32, (80, 72))


def test_trainer_step_matches_jax(case, tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution SegNeXt, through the stride-8 twin (the f32 logits
    through the upsample+CE loss, align_corners=False; the NMF at its 6
    train steps with the one-step gradient), against the JAX train step;
    the layer scales move."""
    batch = train_batch(case)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")
    k = "backbone.stage1_block0.layer_scale_1.scale"
    assert not np.array_equal(got[k], case.sd[k].numpy())


@pytest.mark.parametrize("variant", ["tiny", "t", "s", "b"])
def test_variants(variant):
    """The JAX package's MSCAN sizes, each built on the meta device; the
    remat switch builds (tests/test_torch_remat.py steps it)."""
    assert MODEL_VARIANTS["segnext"] == JAX_MODEL_VARIANTS["segnext"]
    assert MSCAN_VARIANTS[variant] == jax_segnext.MSCAN_VARIANTS[variant]
    depths, dims, ratios, ham, rank = MSCAN_VARIANTS[variant]
    with torch.device("meta"):   # the structure only
        model = build_model("segnext", 21, **variant_kwargs("segnext",
                                                            variant))
    assert hasattr(model.backbone, f"stage2_block{depths[2] - 1}")
    assert model.backbone.stage3_block0.fc1.out_channels == dims[3] * ratios[3]
    assert model.squeeze.conv.in_channels == sum(dims[1:])
    assert tuple(model.hamburger.bases.shape) == (ham, rank)
    with torch.device("meta"):
        assert build_model("segnext", NC, remat=True, **TINY).backbone.remat


CLIS = {"train": ttrain, "test": ttest, "inference": tinference,
        "serve": tserve}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_command_lines_take_the_family(cli, tmp_path):
    """Every command line takes `--model segnext --variant b`."""
    weights = tmp_path / "w.pt"
    weights.touch()
    argv = {"train": ["data"], "test": ["val.json"],
            "inference": ["in", "out"],
            "serve": ["--weights", str(weights)]}[cli]
    argv += ["--model", "segnext", "--variant", "b"]
    opt = CLIS[cli].parse_args(argv)
    assert (opt.model, opt.variant) == ("segnext", "b")
