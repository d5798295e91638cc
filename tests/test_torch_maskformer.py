"""PyTorch port: MaskFormer (the ResNet trunk, the FPN pixel decoder, the
post-norm transformer decoder over the C5 tokens, the shared class and mask
heads) and its set-prediction criterion against the JAX package on the same
seeded weights and inputs, on the CPU: DETR's sine position code, both
matchers on seeded costs, the weights' mapping (against the JAX
`convert_named`), the f32 eval scores (stride 4 and the x4 resize) and the
bf16 ones, the f32 train-mode dict with the deep-supervision layers, the
criterion and its gradient under both matchers with ignored labels (255),
`make_mask_fn`, one `Trainer` step with the Hungarian matcher, and the
registry's variants. 4 classes, 64x64 inputs, batch 2, the JAX package's
`tiny` variant (one bottleneck a stage, width 64, 8 queries, 4 heads, 2
decoder layers). Each JAX program is compiled once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import (
    MODEL_VARIANTS as JAX_MODEL_VARIANTS)
from pytorch_segmentation_tpu.models import MaskFormer as JaxMaskFormer
from pytorch_segmentation_tpu.models import maskformer as jax_maskformer
from pytorch_segmentation_tpu_torch.data.pipeline import normalize_images
from pytorch_segmentation_tpu_torch.engine.trainer import Trainer
from pytorch_segmentation_tpu_torch.models import (MODEL_VARIANTS,
                                                   build_model,
                                                   make_maskformer_loss,
                                                   variant_kwargs)
from pytorch_segmentation_tpu_torch.models import maskformer as port_maskformer
from torch_family_util import (FAST_COMPILE, LR, MOMENTUM, FamilyCase,
                               assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_weights_match_convert_named,
                               jax_train_step, numpy_tree)

torch.set_num_threads(1)

NC, HW = 4, 64
TINY = MODEL_VARIANTS["maskformer"]["tiny"]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    # the bf16 bound at the scores is the transformers' (1.25 of the bf16
    # error, tests/test_torch_segformer.py): the compiled JAX program keeps
    # values in f32 where its source rounds to bf16
    return FamilyCase("maskformer", JaxMaskFormer, NC, HW,
                      tmp_path_factory.mktemp("maskformer"),
                      logits_mean_bound=1.25, f32_logits=True, **TINY)


@pytest.fixture(scope="module")
def f32(case):
    """The JAX MaskFormer's stride-4 f32 scores [2, 16, 16, NC]."""
    return case.jax_logits()


@pytest.fixture(scope="module")
def images(case):
    return normalize_images(torch.from_numpy(case.images)).numpy()


@pytest.fixture(scope="module")
def jax_train_outputs(case, images):
    """The JAX module's train-mode dict (f32, batch statistics) on
    `images`, as numpy."""
    module = case.jax_module()

    def run(v, x):
        return module.apply(v, x, train=True, mutable=["batch_stats"])[0]

    args = ({"params": case.params, "batch_stats": case.stats}, images)
    out = jax.jit(run).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    return numpy_tree(out)


def _labels(seed=5):
    """[2, 64, 64] labels in 4x4 blocks: classes 0 and 2 everywhere, class
    1 only in sample 0, class 3 nowhere; 255 on a band of each sample."""
    rng = np.random.default_rng(seed)
    blocks = rng.choice([0, 2], (2, 16, 16))
    blocks[0, 4:8, 4:8] = 1
    segs = np.repeat(np.repeat(blocks, 4, 1), 4, 2).astype(np.int32)
    segs[:, 40:48] = 255
    return segs


def _rand_costs(rng, b=4, nq=12, nc=5):
    cost = rng.standard_normal((b, nq, nc)).astype(np.float32)
    present = rng.random((b, nc)) < 0.6
    present[:, 0] = True
    present[-1] = False   # a sample with no class present
    return cost, present


@pytest.mark.parametrize("h,w,dim", [(2, 2, 64), (16, 16, 256), (3, 5, 30)])
def test_sine_pos_embed_matches_jax(h, w, dim):
    want = np.asarray(jax_maskformer._sine_pos_embed(h, w, dim, jnp.float32))
    got = port_maskformer._sine_pos_embed(h, w, dim)
    assert got.dtype == np.float32 and got.shape == (h * w, dim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("matcher", ["sinkhorn", "hungarian"])
def test_matchers_match_jax(matcher):
    """Both matchers on seeded costs (absent classes, a sample with none
    present) give the JAX package's assignments, entry for entry: one query
    for each present class, none for an absent one, no query twice."""
    rng = np.random.default_rng(0)
    jax_fn = getattr(jax_maskformer, f"_{matcher}_assign")
    port_fn = getattr(port_maskformer, f"_{matcher}_assign")
    for _ in range(3):
        cost, present = _rand_costs(rng)
        want = np.asarray(jax_fn(jnp.asarray(cost), jnp.asarray(present)))
        got = port_fn(torch.from_numpy(cost), torch.from_numpy(present))
        assert got.dtype == torch.float32 and got.shape == (4, 5, 12)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not got[-1].any()
        np.testing.assert_array_equal(got.sum(-1).numpy(), present)
        assert (got.sum(1) <= 1).all()


def test_weights_map_like_convert_named(case):
    params, stats = assert_weights_match_convert_named(case)
    assert params["query_embed"] == (8, 64)
    assert params["dec0"]["self_attn"]["q"] == {"kernel": (64, 64),
                                                "bias": (64,)}
    assert params["dec1"]["ln3"] == {"scale": (64,), "bias": (64,)}
    assert params["cls_head"]["kernel"] == (64, NC + 1)
    assert params["pixel_proj"] == {"kernel": (3, 3, 64, 64), "bias": (64,)}
    assert stats["lat3"]["bn"]["mean"] == (64,)
    assert case.sd["query_embed"].shape == (8, 64)
    model = case.port_module()
    assert (model.output_stride, model.up_align_corners) == (4, False)


@pytest.mark.parametrize("full_res_output,dtype", [
    pytest.param(False, torch.float32, id="False"),
    pytest.param(True, torch.float32, id="True"),
    pytest.param(False, torch.bfloat16, id="bf16")])
def test_forward_matches_jax(case, f32, full_res_output, dtype):
    bf16 = (case.jax_logits(jnp.bfloat16) if dtype == torch.bfloat16
            else None)
    assert_forward_matches_jax(case, full_res_output, dtype, f32, bf16)


def test_train_dict_matches_jax(case, images, jax_train_outputs):
    """The train-mode forward (batch statistics) returns the JAX module's
    dict: the final layer's f32 class and mask logits and the stacked
    deep-supervision layer's, within rtol = atol = 1e-4."""
    model = case.port_module(full_res_output=True)
    model.load_state_dict(case.saved_state, strict=True)
    with torch.no_grad():
        got = model.train()(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert set(got) == set(jax_train_outputs) == {"cls", "mask", "aux_cls",
                                                  "aux_mask"}
    assert got["aux_mask"].shape == (1, 2, 8, 16, 16)
    for k, want in jax_train_outputs.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("matcher", ["sinkhorn", "hungarian"])
def test_criterion_and_gradient_match_jax(jax_train_outputs, matcher):
    """`make_maskformer_loss` on the JAX module's train outputs, labels of
    255 included: the loss within rtol 1e-4 of the JAX criterion's, its
    gradient to every class and mask logit (all layers) within rtol 1e-3 /
    atol 1e-3 of the largest entry of `jax.grad`'s."""
    segs = _labels()
    jax_loss = jax_maskformer.make_maskformer_loss(NC, matcher=matcher)
    want, want_grad = jax.jit(jax.value_and_grad(jax_loss))(
        jax.tree.map(jnp.asarray, jax_train_outputs), jnp.asarray(segs))
    outputs = {k: torch.tensor(v, requires_grad=True)
               for k, v in jax_train_outputs.items()}
    loss = make_maskformer_loss(NC, matcher=matcher)(
        outputs, torch.from_numpy(segs))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    grads = torch.autograd.grad(loss, list(outputs.values()))
    for (k, x), g in zip(outputs.items(), grads):
        w = np.asarray(want_grad[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)


def test_criterion_ignores_labels_past_the_classes(jax_train_outputs):
    """A label >= K (255) is in no target mask and in no pixel sum: the
    criterion on labels where the ignored band holds 255 equals its value
    on the same outputs and labels with that band set to any other label
    >= K, and differs from one where the band holds a class."""
    outputs = {k: torch.tensor(v) for k, v in jax_train_outputs.items()}
    loss = make_maskformer_loss(NC, matcher="hungarian")
    segs = _labels()
    other = np.where(segs == 255, NC, segs)
    labelled = np.where(segs == 255, 2, segs)
    values = [float(loss(outputs, torch.from_numpy(s)))
              for s in (segs, other, labelled)]
    assert values[0] == values[1] != values[2]


def test_make_mask_fn_matches_jax(case, f32):
    assert_mask_fn_matches_jax(case, f32, (80, 72))


def test_trainer_step_matches_jax(case, tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution MaskFormer with the Hungarian matcher's criterion (the
    dict through `make_train_step` as it is, no deferred upsample) against
    the JAX train step with the same criterion: the loss and every final
    tensor within 2e-3 (relative and absolute)."""
    rng = np.random.default_rng(4)
    batch = (rng.standard_normal((2, HW, HW, 3)).astype(np.float32),
             _labels(6))
    want_loss, want = jax_train_step(
        case, batch, loss_fn=jax_maskformer.make_maskformer_loss(
            NC, matcher="hungarian"))
    model = case.port_module(full_res_output=True)
    trainer = Trainer(model, [(*batch, 2)], lr=LR, momentum=MOMENTUM,
                      loss_fn=make_maskformer_loss(NC, matcher="hungarian"),
                      weights=case.path, log=False,
                      log_dir=str(tmp_path / "runs"), device="cpu")
    assert trainer._train_module is model
    loss = trainer.step()
    np.testing.assert_allclose(loss, want_loss, rtol=2e-3)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k
            continue
        np.testing.assert_allclose(got[k].numpy(), w, rtol=2e-3, atol=2e-3,
                                   err_msg=k)
    for k in ("query_embed", "cls_head.weight", "dec1.cross_attn.k.weight",
              "pixel_proj.weight"):
        assert not np.array_equal(got[k].numpy(), case.sd[k].numpy()), k


def test_variants_and_options():
    """`r50` and `tiny` are the JAX table's; R50 builds (on the meta
    device) at the paper's sizes; `remat` builds (tests/test_torch_remat.py
    steps it); an unknown matcher raises."""
    assert MODEL_VARIANTS["maskformer"] == JAX_MODEL_VARIANTS["maskformer"]
    with torch.device("meta"):
        model = build_model("maskformer", 21,
                            **variant_kwargs("maskformer", "r50"))
    assert model.query_embed.shape == (100, 256)
    assert hasattr(model, "dec5") and not hasattr(model, "dec6")
    assert model.lat0.conv.in_channels == 256
    assert model.input_proj.in_channels == 2048
    assert model.cls_head.out_features == 22
    with torch.device("meta"):
        assert build_model("maskformer", 21, remat=True).backbone.remat
    with pytest.raises(ValueError, match="matcher must be one of"):
        make_maskformer_loss(21, matcher="auction")
