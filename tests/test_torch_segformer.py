"""PyTorch port: SegFormer (the Mix Transformer encoder and the all-MLP
decoder) against the JAX package on the same seeded weights and inputs, on
the CPU: the port's `Linear` and `LayerNorm` alone against flax `Dense` and
`LayerNorm(epsilon=1e-6)` in bf16, the Dense and LayerNorm leaves of the
weights' mapping both ways (against the JAX package's `convert_named`,
since its `export_torch_state_dict` maps neither), the seeded starts, the
f32 forwards with the split and the literal fuse, the bf16 forward,
`make_mask_fn` (stride-4 logits, align_corners=False), one `Trainer` step
and the options that are not ported. 5 classes, 64x64 inputs, batch 2, the
JAX package's `tiny` variant (one block a stage, all four stages, sr ratios
and block types). Each JAX program is compiled once."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import (
    MODEL_VARIANTS as JAX_MODEL_VARIANTS)
from pytorch_segmentation_tpu.models import SegFormer as JaxSegFormer
from pytorch_segmentation_tpu.models.segformer import (
    SEGFORMER_VARIANTS as JAX_SEGFORMER_VARIANTS)
from pytorch_segmentation_tpu.models.segformer import (
    stack_block_params as jax_stack_block_params)
from pytorch_segmentation_tpu.utils.port_torch import convert_named
from pytorch_segmentation_tpu_torch.models import build_model, variant_kwargs
from pytorch_segmentation_tpu_torch.models.segformer import (
    SEGFORMER_VARIANTS, stack_block_params, unstack_block_params)
from pytorch_segmentation_tpu_torch.data.pipeline import normalize_images
from pytorch_segmentation_tpu_torch.nn.blocks import LayerNorm, Linear
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, seeded_state_dict, state_dict_from_jax)
from torch_family_util import (FAST_COMPILE, FamilyCase,
                               assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches, jax_train_step,
                               port_trainer_step, train_batch)

torch.set_num_threads(1)

NC, HW = 5, 64
TINY = {"variant": "tiny"}
LAYERNORMS = ("ln1", "ln2", "srln", "patch_embed1_ln", "norm1")
DENSES = ("q", "kv", "proj", "fc1", "fc2", "linear_c1")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    # the mean bound at the bf16 logits is 1.25 of the bf16 error (0.4 for
    # the ConvNet families): the compiled JAX program does not round where
    # its source does. XLA fuses each patch embedding's convolution and bias
    # into the LayerNorm after it and keeps that sum in f32, and computes
    # GELU's erfc in f32 on an unrounded argument, where the source (and
    # the port) round to bf16; from the first stage on the two bf16 runs
    # then part about as far as bf16 parts from f32 (measured 1.01 of it).
    # The cast points themselves are held bit for bit against the source's
    # op-by-op semantics (test_bf16_attention_matches_eager_jax,
    # test_linear_and_layernorm_match_flax_in_bf16)
    return FamilyCase("segformer", JaxSegFormer, NC, HW,
                      tmp_path_factory.mktemp("segformer"),
                      logits_mean_bound=1.25, **TINY)


@pytest.fixture(scope="module")
def f32(case):
    """The JAX SegFormer's stride-4 f32 logits [2, 16, 16, NC]."""
    return case.jax_logits()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


def test_linear_and_layernorm_match_flax_in_bf16():
    """`Linear` is flax `Dense` (bf16 product rounded, then the bf16 bias)
    and `LayerNorm` is flax `LayerNorm(epsilon=1e-6)` (f32 moments and
    affine, cast to bf16), on the same f32 parameters: equal but for a last
    bit where an f32 sum's order differs (at most one bf16 step of the
    larger value on a thousandth of the entries)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 37, 48)) * 3 + 1, jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    dense = fnn.Dense(24, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    norm = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16,
                         param_dtype=jnp.float32)
    for flax_mod, port_mod in ((dense, Linear(48, 24, torch.bfloat16)),
                               (norm, LayerNorm(48, torch.bfloat16))):
        sd = seeded_state_dict(port_mod, seed=2)
        port_mod.load_state_dict(sd)
        params, _ = jax_trees_from_state_dict(sd)
        want = np.asarray(flax_mod.apply({"params": params}, x)
                          .astype(jnp.float32))
        with torch.no_grad():
            got = port_mod(xt)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        step = 2.0 ** -7 * np.maximum(np.abs(want), np.abs(got))
        diff = np.abs(got - want)
        assert (diff <= step).all(), diff.max()
        assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()
    assert port_mod.eps == 1e-6


@pytest.mark.parametrize("sr", [2, 1])
def test_bf16_attention_matches_eager_jax(sr):
    """The efficient self-attention in bf16 (the `sr` reduction and `srln`
    where sr > 1, the bf16 scores scaled by hd**-0.5 AFTER the product, the
    f32 softmax, the bf16 product with v, `proj`) against the JAX
    `_Attention` run op by op: equal bit for bit."""
    from pytorch_segmentation_tpu.models.segformer import (
        _Attention as JaxAttention)
    from pytorch_segmentation_tpu_torch.models.segformer import _Attention
    port = _Attention(64, 2, sr, torch.bfloat16)   # hd = 32: 32**-0.5
    sd = seeded_state_dict(port, seed=4)
    port.load_state_dict(sd)
    params, _ = jax_trees_from_state_dict(sd)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, 8, 6, 64)),
                    jnp.bfloat16)
    want = JaxAttention(64, 2, sr, jnp.bfloat16).apply({"params": params}, x)
    with torch.no_grad():
        got = port(torch.from_numpy(np.asarray(x.astype(jnp.float32)))
                   .bfloat16().reshape(2, 48, 64), 8, 6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy().reshape(2, 8, 6, 64),
        np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("init", ["serve", "uniform", "train"])
def test_seeded_layernorm_linear_and_gate(init):
    """'train' starts each LayerNorm at weight 1 and bias 0 and DANet's
    residual gates at 0 (the JAX starts); 'serve' and 'uniform' draw the
    LayerNorm weights in 0.5..1.5. Linear weights are lecun-normal over
    their fan-in (flax `Dense`'s start), uniform in +-1/sqrt(fan_in) at
    'uniform'; their biases 0 at 'train'."""
    model = build_model("segformer", NC, dtype=torch.float32, **TINY)
    sd = seeded_state_dict(model, seed=0, init=init)
    model.load_state_dict(sd, strict=True)
    lns = [k[:-len(".weight")] for k, v in sd.items()
           if k.endswith(".weight") and v.dim() == 1 and ".bn." not in k]
    assert {k.split(".")[-1] for k in lns} >= set(LAYERNORMS[:2]) | {
        "srln", "patch_embed1_ln", "norm4"}
    for k in lns:
        w, b = sd[f"{k}.weight"], sd[f"{k}.bias"]
        if init == "train":
            assert torch.equal(w, torch.ones_like(w)), k
            assert torch.equal(b, torch.zeros_like(b)), k
        else:
            assert 0.5 <= float(w.min()) and float(w.max()) <= 1.5, k
            assert float(b.abs().max()) > 0, k
    w = sd["backbone.block2_0.ffn.fc1.weight"]   # (128, 32): fan-in 32
    assert w.shape == (128, 32)
    if init == "uniform":
        assert float(w.abs().max()) <= 32 ** -0.5
    else:
        assert 0.8 < float(w.std()) * 32 ** 0.5 < 1.2
    bias = sd["backbone.block2_0.ffn.fc1.bias"]
    assert (float(bias.abs().max()) == 0) == (init == "train")
    danet = build_model("danet", NC, dtype=torch.float32,
                        backbone_layers=(1, 1, 1, 1), channels=64)
    gates = seeded_state_dict(danet, seed=0, init=init)
    for g in ("pam_gamma.scale", "cam_gamma.scale"):
        assert (float(gates[g]) == 0.0) == (init == "train"), g


def test_weights_map_like_convert_named(case):
    """The JAX module's shape trees are those of the trees made from the
    port's state_dict; `jax_trees_from_state_dict` equals the JAX package's
    `convert_named` on every leaf (Dense kernels transposed, LayerNorm
    weights to `scale`); both directions round-trip bit for bit and
    `state_dict_from_jax` loads strictly."""
    params_shapes, stats_shapes = case.jax_shapes()
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    (case.params, case.stats))
    assert shapes == (params_shapes, stats_shapes)
    blk = params_shapes["backbone"]["block1_0"]
    assert blk["attn"]["q"] == {"kernel": (16, 16), "bias": (16,)}
    assert blk["attn"]["srln"] == {"scale": (16,), "bias": (16,)}
    assert params_shapes["fuse"]["conv"] == {"kernel": (1, 1, 256, 64)}
    want_p, want_s = convert_named({k: v.numpy() for k, v in
                                    case.sd.items()})
    got = dict(_leaves(case.params))
    want = dict(_leaves(want_p))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert np.array_equal(got[k], want[k]), k
    assert dict(_leaves(case.stats)).keys() == dict(_leaves(want_s)).keys()
    for k, v in _leaves(want_s):
        assert np.array_equal(dict(_leaves(case.stats))[k], v), k
    assert {p.rsplit("/", 1)[0].rsplit("/", 1)[-1] for p in got
            if p.endswith("/scale")} >= set(LAYERNORMS)
    assert {p.rsplit("/", 2)[-2] for p in got if p.endswith("/kernel")
            and got[p].ndim == 2} == set(DENSES) | {
                "linear_c2", "linear_c3", "linear_c4"}
    back = state_dict_from_jax(case.params, case.stats)
    assert set(back) == set(case.sd)
    for k, v in case.sd.items():
        assert np.array_equal(back[k], v.numpy()), k
    again_p, again_s = jax_trees_from_state_dict(back)
    assert dict(_leaves(again_p)).keys() == got.keys()
    for k, v in _leaves(again_p):
        assert np.array_equal(v, got[k]), k
    model = case.port_module()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()},
                          strict=True)
    assert (model.output_stride, model.up_align_corners) == (4, False)


@pytest.mark.parametrize("full_res_output,dtype", [
    pytest.param(False, torch.float32, id="False"),
    pytest.param(True, torch.float32, id="True"),
    pytest.param(False, torch.bfloat16, id="bf16")])
def test_forward_matches_jax(case, f32, full_res_output, dtype):
    bf16 = (case.jax_logits(jnp.bfloat16) if dtype == torch.bfloat16
            else None)
    assert_forward_matches_jax(case, full_res_output, dtype, f32, bf16)


def test_literal_fuse_matches_jax(tmp_path):
    """`split_fuse=False` (the concat and the 1x1 ConvNormAct) against the
    JAX module built the same way, in f32 within rtol = atol = 1e-4; the
    split fuse on the same weights gives the same logits."""
    case = FamilyCase("segformer", JaxSegFormer, NC, HW, tmp_path,
                      split_fuse=False, **TINY)
    assert_forward_matches_jax(case, False, torch.float32,
                               case.jax_logits())
    split = build_model("segformer", NC, dtype=torch.float32,
                        full_res_output=False, **TINY)
    split.load_state_dict(case.sd, strict=True)
    x = torch.from_numpy(case.images).permute(0, 3, 1, 2).float() / 255
    with torch.no_grad():
        np.testing.assert_allclose(split.eval()(x).numpy(),
                                   case.loaded()(x).numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_full_res_output_is_the_input_size(case):
    """`full_res_output=True` resizes to the INPUT size: at 62x62 the
    stride-4 logits are 16x16 (4h = 64), and the output is 62x62, their
    bilinear resize (align_corners=False)."""
    from pytorch_segmentation_tpu_torch.ops.resize import (
        resize_bilinear_nchw)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 3, 62, 62)).astype(np.float32))
    with torch.no_grad():
        low = case.loaded()(x)
        full = case.loaded(full_res_output=True)(x)
    assert low.shape == (1, NC, 16, 16) and full.shape == (1, NC, 62, 62)
    torch.testing.assert_close(full, resize_bilinear_nchw(
        low, (62, 62), align_corners=False), rtol=0, atol=0)


def test_make_mask_fn_matches_jax(case, f32):
    assert_mask_fn_matches_jax(case, f32, (80, 72))


def test_trainer_step_matches_jax(case, tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution SegFormer, through its stride-4 twin and the
    upsample+CE loss with align_corners=False, against the JAX train step;
    every LayerNorm and Dense leaf moves as the JAX one does."""
    batch = train_batch(case)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")
    for k in ("backbone.block1_0.attn.srln.weight",
              "backbone.block4_0.attn.kv.weight", "linear_c4.weight"):
        assert not np.array_equal(got[k], case.sd[k].numpy()), k


@pytest.mark.parametrize("kwargs,item", [
    ({"scan_blocks": True, "moe_experts": 4}, "item 10,"),
    ({"moe_experts": 4}, "item 10,"),
    ({"pp_mesh": object()}, "item 10,"), ({"remat": True}, "item 5,")],
    ids=["scan_blocks", "moe_experts", "pp_mesh", "remat"])
def test_unported_options_raise(kwargs, item):
    """MoE (with scan blocks too), pipeline parallelism and remat raise,
    naming their ROADMAP item."""
    with pytest.raises(NotImplementedError,
                       match=f"not ported yet \\(ROADMAP queue 1 {item}"):
        build_model("segformer", NC, **TINY, **kwargs)


def test_variants_build_at_their_widths():
    """Every variant of the JAX table builds (on the meta device: shapes
    only), with its stage widths, depths and decoder width."""
    assert SEGFORMER_VARIANTS == JAX_SEGFORMER_VARIANTS
    assert (set(JAX_MODEL_VARIANTS["segformer"])
            == {"b0", "b1", "b2", "b3", "b4", "b5", "tiny", "tiny-d4"})
    for name, (dims, depths, _, dec) in SEGFORMER_VARIANTS.items():
        with torch.device("meta"):
            model = build_model("segformer", 21,
                                **variant_kwargs("segformer", name))
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            assert hasattr(model.backbone, f"block{i + 1}_{depth - 1}")
            assert not hasattr(model.backbone, f"block{i + 1}_{depth}")
            assert getattr(model.backbone, f"norm{i + 1}").weight.shape \
                == (dim,)
        assert model.fuse.conv.weight.shape == (dec, 4 * dec, 1, 1)
        assert model.cls_conv.out_channels == 21



@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """The tiny-d4 variant (stage 3 four blocks deep), unrolled, on the
    harness's seeded weights."""
    return FamilyCase("segformer", JaxSegFormer, NC, HW,
                      tmp_path_factory.mktemp("segformer_d4"),
                      variant="tiny-d4")


def _scan_model(deep, sd=None):
    model = build_model("segformer", NC, dtype=torch.float32,
                        full_res_output=False, variant="tiny-d4",
                        scan_blocks=True)
    model.load_state_dict(sd or stack_block_params(deep.sd, "tiny-d4"),
                          strict=True)
    # as the Trainer and load_model_bundle move it: the stacked 5-D
    # kernels layer by layer
    return model.to(memory_format=torch.channels_last).eval()


def test_stacked_layout_maps_like_jax(deep):
    """`stack_block_params` / `unstack_block_params` are inverses on a
    state_dict (tensors or numpy arrays): stage 3's four blocks become
    `backbone.blocks3.stack.<leaf>` [4, ...], the depth-1 stages keep
    `block{i}_0`; the stacked state_dict maps to the JAX package's
    `stack_block_params` of the unrolled trees and back, bit for bit, and
    loads strictly into the scan_blocks model, whose own seeded start has
    the same entries and shapes."""
    stacked = stack_block_params(deep.sd, "tiny-d4")
    assert stacked["backbone.blocks3.stack.attn.q.weight"].shape == (
        4, 64, 64)
    assert "backbone.block1_0.attn.q.weight" in stacked
    assert not any(k.startswith("backbone.block3_") for k in stacked)
    back = unstack_block_params(stacked, "tiny-d4")
    assert set(back) == set(deep.sd)
    for k, v in deep.sd.items():
        assert torch.equal(back[k], v), k
    numpy_sd = {k: v.numpy() for k, v in deep.sd.items()}
    for k, v in unstack_block_params(stack_block_params(
            numpy_sd, "tiny-d4"), "tiny-d4").items():
        assert np.array_equal(v, numpy_sd[k]), k
    want = jax_stack_block_params(deep.params, "tiny-d4")
    params, stats = jax_trees_from_state_dict(stacked)
    assert stats.keys() == deep.stats.keys()
    got, want = dict(_leaves(params)), dict(_leaves(want))
    assert got.keys() == want.keys()
    assert "/backbone/blocks3/stack/attn/q/kernel" in got
    for k, v in want.items():
        assert np.array_equal(got[k], np.asarray(v)), k
    again = state_dict_from_jax(params, stats)
    assert set(again) == set(stacked)
    for k, v in stacked.items():
        assert np.array_equal(again[k], v.numpy()), k
    model = _scan_model(deep)
    seeded = seeded_state_dict(model, seed=0, init="train")
    assert {k: v.shape for k, v in seeded.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    w = seeded["backbone.blocks3.stack.ffn.fc1.weight"]   # (4, 256, 64)
    assert all(0.8 < float(w[j].std()) * 8 < 1.2 for j in range(4))
    assert torch.equal(seeded["backbone.blocks3.stack.ln1.weight"],
                       torch.ones(4, 64))


def test_scan_blocks_matches_jax(deep):
    """The scan_blocks model on the stacked weights against the JAX
    `scan_blocks=True` module (`lax.scan` over the stacked tree) on the
    JAX `stack_block_params` of the same weights: f32 stride-4 logits
    within rtol = atol = 1e-4."""
    module = JaxSegFormer(num_classes=NC, dtype=jnp.float32,
                          full_res_output=False, variant="tiny-d4",
                          scan_blocks=True)
    x = normalize_images(torch.from_numpy(deep.images))
    args = ({"params": jax_stack_block_params(deep.params, "tiny-d4"),
             "batch_stats": deep.stats}, x.numpy())
    want = jax.jit(module.apply).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
    with torch.no_grad():
        got = _scan_model(deep)(x.permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_scan_blocks_equal_the_unrolled_model(deep):
    """On the same weights the scan_blocks model's f32 logits equal the
    unrolled model's, and the gradient of a loss on them to each stacked
    parameter equals the unrolled blocks' gradients stacked."""
    unrolled = deep.loaded().to(memory_format=torch.channels_last)
    scan = _scan_model(deep)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 3, HW, HW)).astype(np.float32))
    want, got = unrolled(x), scan(x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    weights = torch.from_numpy(np.random.default_rng(8).standard_normal(
        tuple(want.shape)).astype(np.float32))
    want_grads = dict(zip(
        [n for n, _ in unrolled.named_parameters()],
        torch.autograd.grad((want * weights).sum(),
                            list(unrolled.parameters()))))
    got_grads = dict(zip(
        [n for n, _ in scan.named_parameters()],
        torch.autograd.grad((got * weights).sum(), list(scan.parameters()))))
    want_grads = stack_block_params(want_grads, "tiny-d4")
    assert set(got_grads) == set(want_grads)
    for k, g in want_grads.items():
        torch.testing.assert_close(got_grads[k], g, rtol=1e-5, atol=1e-6,
                                   msg=k)
