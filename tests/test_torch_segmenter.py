"""PyTorch port: Segmenter (the plain ViT and the Mask Transformer decoder)
against the JAX package on the same seeded weights and inputs, on the CPU:
`ops/resize.resize_bicubic` (the ViT's position-grid resize), the bare
parameters of the weights' mapping (ConvNeXt's `gamma`, Swin's `rpb`, the
ViT's `class_token` and `pos_embedding`, Segmenter's `cls_emb`, depthwise
kernels) both ways and their seeded starts, the mapping against the JAX
`convert_named`, the f32 forwards (stride-16 logits and the full-resolution
resize), the bf16 forward (its logits f32), `make_mask_fn`, one `Trainer`
step (the f32 stride-16 logits through the upsample+CE loss, 16x,
align_corners=False) and every variant on the meta device. 5 classes,
96x96 inputs (a 6x6 patch grid, so the stored 4x4 position grid is resized
bicubically), batch 2, the JAX package's `pico` ViT. Each JAX program is
compiled once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import (
    MODEL_VARIANTS as JAX_MODEL_VARIANTS)
from pytorch_segmentation_tpu.models import Segmenter as JaxSegmenter
from pytorch_segmentation_tpu.nn.backbones.vit import (
    VIT_VARIANTS as JAX_VIT_VARIANTS)
from pytorch_segmentation_tpu.ops.resize import (
    _bicubic_weights as jax_bicubic_weights)
from pytorch_segmentation_tpu.ops.resize import (
    resize_bicubic as jax_resize_bicubic)
from pytorch_segmentation_tpu_torch.models import build_model, variant_kwargs
from pytorch_segmentation_tpu_torch.nn.backbones.vit import VIT_VARIANTS
from pytorch_segmentation_tpu_torch.ops.resize import (_bicubic_weights,
                                                       resize_bicubic)
from pytorch_segmentation_tpu_torch.utils.weights import (
    BARE_PARAMS, jax_trees_from_state_dict, seeded_state_dict,
    state_dict_from_jax)
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches,
                               assert_weights_match_convert_named,
                               jax_train_step,
                               port_trainer_step, train_batch,
                               without_default_init)

torch.set_num_threads(1)

NC, HW = 5, 96
PICO = {"variant": "pico"}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    # the bf16 mean bound at the logits is 1.25 of the bf16 error, the
    # transformer families' (tests/test_torch_segformer.py: the compiled
    # JAX program keeps a convolution's output in f32 into the LayerNorm
    # after it, and GELU's erfc unrounded, where the source rounds to
    # bf16); the ViT block's cast points are held bit for bit against eager
    # flax in tests/test_torch_upernet.py. The largest difference is held
    # to 3 times the largest bf16 error instead of 2% of the largest logit:
    # `mask_norm` divides each pixel's K cosines by their spread over the
    # K classes, so a bf16 step in a cosine grows by its inverse there. The
    # JAX package's own bf16 logits part from its f32 ones by up to 2.4%
    # of the largest (measured: 0.061 of 2.6), the port's by up to 0.099,
    # and the two bf16 runs, which round at other points, by up to the sum
    # of the two (measured: 0.16, 2.6 times the JAX package's)
    return FamilyCase("segmenter", JaxSegmenter, NC, HW,
                      tmp_path_factory.mktemp("segmenter"),
                      logits_mean_bound=1.25, logits_max_bound=3.0,
                      f32_logits=True, **PICO)


@pytest.fixture(scope="module")
def f32(case):
    """The JAX Segmenter's stride-16 f32 logits [2, 6, 6, NC]."""
    return case.jax_logits()


@pytest.mark.parametrize("size,out", [(4, 6), (14, 32), (6, 4)],
                         ids=["4to6", "14to32", "6to4"])
def test_resize_bicubic_matches_jax(size, out):
    """The bicubic matrices equal the JAX package's bit for bit, and the f32
    resize of an f32 grid (the ViT's position embedding: [1, g, g, C]) its
    HIGHEST-precision einsums within rtol = atol = 1e-6 (two f32
    contractions summed in another order); the gradient reaches the
    input."""
    for align in (False, True):
        np.testing.assert_array_equal(_bicubic_weights(size, out, align),
                                      jax_bicubic_weights(size, out, align))
    x = np.random.default_rng(size).standard_normal(
        (1, size, size, 8)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = resize_bicubic(xt, (out, out), align_corners=False)
    want = np.asarray(jax_resize_bicubic(jnp.asarray(x), (out, out),
                                         align_corners=False))
    assert got.dtype == torch.float32 and got.shape == (1, out, out, 8)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    got.sum().backward()
    assert xt.grad is not None and float(xt.grad.abs().sum()) > 0


def test_bare_params_round_trip_both_ways():
    """ConvNeXt's `gamma` (C,), Swin's `rpb` ((2ws-1)^2, heads), the ViT's
    `class_token` (1, 1, C) and `pos_embedding` (1, 1+g^2, C), Segmenter's
    `cls_emb` (1, K, C) and MaskFormer's `query_embed` (Q, C) keep their
    names and layouts both ways, beside a depthwise kernel (7, 7, 1, C) <->
    (C, 1, 7, 7): `jax_trees_from_state_dict(state_dict_from_jax(p)) == p`;
    a 2-D `rpb` or `query_embed` is not transposed as a Dense kernel and a
    1-D `gamma` is not taken for a LayerNorm scale."""
    rng = np.random.default_rng(0)
    params = {"blk": {"gamma": rng.standard_normal(8),
                      "dwconv": {"kernel": rng.standard_normal((7, 7, 1, 8)),
                                 "bias": rng.standard_normal(8)},
                      "attn": {"rpb": rng.standard_normal((49, 3))}},
              "vit": {"class_token": rng.standard_normal((1, 1, 8)),
                      "pos_embedding": rng.standard_normal((1, 17, 8))},
              "decoder": {"cls_emb": rng.standard_normal((1, 5, 8))},
              "query_embed": rng.standard_normal((6, 8))}
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    sd = state_dict_from_jax(params, {})
    assert set(sd) == {"blk.gamma", "blk.dwconv.weight", "blk.dwconv.bias",
                       "blk.attn.rpb", "vit.class_token", "vit.pos_embedding",
                       "decoder.cls_emb", "query_embed"}
    assert sd["blk.dwconv.weight"].shape == (8, 1, 7, 7)
    np.testing.assert_array_equal(sd["blk.dwconv.weight"][:, 0],
                                  params["blk"]["dwconv"]["kernel"][:, :, 0]
                                  .transpose(2, 0, 1))
    for name in BARE_PARAMS:
        (path, value), = [(k, v) for k, v in sd.items()
                          if k.split(".")[-1] == name]
        *parts, leaf = path.split(".")
        node = params
        for part in parts:
            node = node[part]
        np.testing.assert_array_equal(value, node[leaf])   # as it is
    back, stats = jax_trees_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()})
    assert stats == {}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat]
    for (path, got), (_, want) in zip(flat_back, flat):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    assert "scale" not in back["blk"] and "kernel" not in back["blk"]["attn"]


@pytest.mark.parametrize("init", ["serve", "train"])
def test_seeded_bare_params(init):
    """'serve' (and 'uniform') seed the bare parameters at order 0.1-1
    (`gamma` 0.5..1.5, the others N(0, 0.25)), so a block body, the bias
    table and the grids count in every comparison; 'train' starts them as
    the JAX inits do (`gamma` 1e-6, `class_token` 0, the others 0.02 times
    a normal clipped to +-2)."""
    with without_default_init():
        model = build_model("upernet", NC, dtype=torch.float32,
                            encoder="convnext", convnext_variant="pico",
                            channels=64)
        segmenter = build_model("segmenter", NC, **PICO)
    sd = seeded_state_dict(model, seed=0, init=init)
    seg = seeded_state_dict(segmenter, seed=0, init=init)
    gamma = sd["backbone.stage0_block0.gamma"]
    others = [seg["backbone.pos_embedding"], seg["decoder.cls_emb"]]
    if init == "train":
        assert torch.equal(gamma, torch.full_like(gamma, 1e-6))
        assert torch.equal(seg["backbone.class_token"],
                           torch.zeros(1, 1, 32))
        assert all(float(t.abs().max()) <= 0.04 for t in others)
    else:
        assert 0.5 <= float(gamma.min()) and float(gamma.max()) <= 1.5
        assert all(0.3 < float(t.std()) < 0.7 for t in others)
    model.load_state_dict(sd, strict=True)


def test_weights_map_like_convert_named(case):
    """The JAX module's shape trees are those of the trees made from the
    port's state_dict, and `jax_trees_from_state_dict` equals the JAX
    package's `convert_named` on every leaf (Dense kernels transposed, the
    bare parameters as they are); `state_dict_from_jax` gives the
    state_dict back bit for bit and loads strictly."""
    params_shapes, stats_shapes = assert_weights_match_convert_named(case)
    assert stats_shapes == {}
    vit, dec = params_shapes["backbone"], params_shapes["decoder"]
    assert (vit["class_token"], vit["pos_embedding"]) == ((1, 1, 32),
                                                          (1, 17, 32))
    assert dec["cls_emb"] == (1, NC, 32)
    assert dec["proj_patch"] == {"kernel": (32, 32)}
    assert dec["mask_norm"] == {"scale": (NC,), "bias": (NC,)}
    model = case.port_module()
    assert (model.output_stride, model.up_align_corners) == (16, False)


@pytest.mark.parametrize("full_res_output,dtype", [
    pytest.param(False, torch.float32, id="False"),
    pytest.param(True, torch.float32, id="True"),
    pytest.param(False, torch.bfloat16, id="bf16")])
def test_forward_matches_jax(case, f32, full_res_output, dtype):
    """f32 within rtol = atol = 1e-4; in bf16 the logits stay f32 (the
    L2-normalized product and `mask_norm` run in f32)."""
    bf16 = (case.jax_logits(jnp.bfloat16) if dtype == torch.bfloat16
            else None)
    assert_forward_matches_jax(case, full_res_output, dtype, f32, bf16)


def test_make_mask_fn_matches_jax(case, f32):
    assert_mask_fn_matches_jax(case, f32, (80, 72))


@pytest.mark.slow   # the JAX train step's trace and compile: ~7 s
def test_trainer_step_matches_jax(case, tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution Segmenter, through its stride-16 twin (the f32 logits
    16x through the upsample+CE loss, align_corners=False), against the JAX
    train step; the position embedding (through the bicubic resize), the
    class token and the class embeddings move."""
    batch = train_batch(case)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert_step_matches(loss, got, want_loss, want, case.sd,
                        "decoder.mask_norm")
    for k in ("backbone.pos_embedding", "backbone.class_token",
              "decoder.cls_emb", "decoder.proj_classes.weight"):
        assert not np.array_equal(got[k], case.sd[k].numpy()), k


def test_variants_build_at_their_widths():
    """pico, b16 and l16 build (on the meta device: shapes only) at the JAX
    table's ViT sizes, with two decoder blocks of the encoder's width."""
    assert VIT_VARIANTS == JAX_VIT_VARIANTS
    assert JAX_MODEL_VARIANTS["segmenter"] == {
        v: variant_kwargs("segmenter", v) for v in ("pico", "b16", "l16")}
    for name, (layers, dim, heads, patch, grid, _) in VIT_VARIANTS.items():
        with without_default_init(), torch.device("meta"):
            model = build_model("segmenter", 21,
                                **variant_kwargs("segmenter", name))
        vit = model.backbone
        assert (vit.layers, vit.dim, vit.block0.heads) == (layers, dim, heads)
        assert vit.out_indices == (layers - 1,)
        assert vit.conv_proj.kernel_size == (patch, patch)
        assert vit.pos_embedding.shape == (1, 1 + grid ** 2, dim)
        assert hasattr(model.decoder, "block1")
        assert not hasattr(model.decoder, "block2")
        assert model.decoder.cls_emb.shape == (1, 21, dim)
    with without_default_init():
        assert build_model("segmenter", NC, remat=True, **PICO).backbone.remat
