"""PyTorch port: UPerNet (the PPM-capped FPN head) on its ResNet encoders
(bottleneck and basic blocks), SegFormer's Mix Transformer, ConvNeXt, Swin
and the plain ViT (with the MultiLevelNeck), against the JAX package on the
same seeded weights and inputs, on the CPU: the weights' mapping, the f32
and bf16 forwards, `make_mask_fn` (stride-4 logits, align_corners=False),
the auxiliary head (train mode only, one aux `Trainer` step against the JAX
train step with aux_weight 0.4, the train-only entries that
`load_model_bundle` drops), the adaptive pools of a C5 smaller than the
pool scales, Swin's shift set to 0 where the window covers the axis, the
Swin window attention and the ViT block's attention bit for bit against
eager flax in bf16, and every variant of the JAX table on the meta device.
The ConvNeXt, Swin and ViT cases' bf16 forwards and the eager comparisons
are marked slow (each JAX compile or eager op compile of its own). 5 classes,
batch 2, one block a ResNet stage (`backbone_layers=(1, 1, 1, 1)`), a head
of `channels=64`, the JAX package's `tiny` MiT and `pico` ConvNeXt, Swin
and ViT; 64x64 inputs (C5 is 2x2, so the 3x3 and 6x6 pools pool UP) but for
Swin and ViT at 96x96: Swin-pico's third stage (6x6, window 4) then shifts
on a padded 8x8 canvas, and the ViT's 6x6 patch grid differs from its
stored 4x4 one, so the bicubic resize runs. Each JAX program is compiled
once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import (
    MODEL_VARIANTS as JAX_MODEL_VARIANTS)
from pytorch_segmentation_tpu.models import UPerNet as JaxUPerNet
from pytorch_segmentation_tpu.nn.backbones.convnext import (
    CONVNEXT_VARIANTS as JAX_CONVNEXT_VARIANTS)
from pytorch_segmentation_tpu.nn.backbones.swin import (
    SWIN_VARIANTS as JAX_SWIN_VARIANTS)
from pytorch_segmentation_tpu.nn.backbones.vit import (
    VIT_VARIANTS as JAX_VIT_VARIANTS)
from pytorch_segmentation_tpu.ops.pool import (
    adaptive_avg_pool2d as jax_adaptive_avg_pool2d)
from pytorch_segmentation_tpu.utils.port_torch import convert_named
from pytorch_segmentation_tpu_torch import inference as tinference
from pytorch_segmentation_tpu_torch import serve as tserve
from pytorch_segmentation_tpu_torch import test as ttest
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.engine.checkpoint import (
    load_model_bundle, save_checkpoint)
from pytorch_segmentation_tpu_torch.models import (UNPORTED_ENCODERS,
                                                   build_model,
                                                   variant_kwargs)
from pytorch_segmentation_tpu_torch.ops.loss import compute_loss
from pytorch_segmentation_tpu_torch.ops.pool import adaptive_avg_pool2d
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, seeded_state_dict, state_dict_from_jax)
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches, assert_weights_match_jax,
                               jax_train_step, port_trainer_step,
                               train_batch, without_default_init)

torch.set_num_threads(1)

NC, HW = 5, 64
RESNET = {"backbone_layers": (1, 1, 1, 1), "channels": 64}
AUX_WEIGHT = 0.4   # the JAX make_train_step's default, the train CLI's

# name -> (input size, constructor arguments)
CASES = {"r50_aux": (HW, dict(RESNET, aux=True)),
         "r34": (HW, dict(RESNET, block="basic")),
         "mit_aux": (HW, {"encoder": "mit", "mit_variant": "tiny",
                          "channels": 64, "aux": True}),
         "cn": (HW, {"encoder": "convnext", "convnext_variant": "pico",
                     "channels": 64}),
         "swin": (96, {"encoder": "swin", "swin_variant": "pico",
                       "channels": 64}),
         "vit": (96, {"encoder": "vit", "vit_variant": "pico",
                      "channels": 64})}


@pytest.fixture(scope="module")
def built():
    """Each case's FamilyCase and JAX f32 logits, made at first use and kept
    for the module: `case` takes its name from its own params and, in
    test_forward_matches_jax, from the test's, so pytest may set it up more
    than once for a name."""
    return {}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, built, tmp_path_factory):
    # the transformer encoders' bf16 logits part from the compiled JAX
    # program's as far as SegFormer's do (tests/test_torch_segformer.py: XLA
    # keeps a convolution's output in f32 into the LayerNorm after it, and
    # GELU's erfc unrounded, where the source rounds to bf16): the mean
    # bound is 1.25 of the bf16 error there (ConvNeXt's depthwise conv and
    # its LayerNorm, its GELU, likewise), 0.4 on the ResNet encoders; the
    # cast points are held bit for bit against eager flax instead
    # (test_bf16_swin_window_attention_matches_eager_jax and the ViT's)
    name = request.param
    if name not in built:
        hw, kwargs = CASES[name]
        bound = 0.4 if name.startswith("r") else 1.25
        built[name] = FamilyCase("upernet", JaxUPerNet, NC, hw,
                                 tmp_path_factory.mktemp(name),
                                 logits_mean_bound=bound, **kwargs)
    return built[name]


@pytest.fixture(scope="module")
def f32(case, built):
    """The JAX UPerNet's stride-4 f32 logits [2, hw/4, hw/4, NC] (an
    eval-mode forward: the aux head's output is dropped there)."""
    key = ("f32", id(case))
    if key not in built:
        built[key] = case.jax_logits()
    return built[key]


# a leaf of each encoder's tree that its mapping must carry as it is
WIDEST = {
    "mit": lambda b: b["norm4"] == {"scale": (128,), "bias": (128,)},
    "convnext": lambda b: b["stage3_block0"]["gamma"] == (128,)
    and b["stage3_block0"]["dwconv"]["kernel"] == (7, 7, 1, 128),
    "swin": lambda b: b["stage2_block1"]["attn"]["rpb"] == (49, 4)
    and b["merge3"]["reduction"] == {"kernel": (256, 128)},
    "vit": lambda b: b["pos_embedding"] == (1, 17, 32)
    and b["class_token"] == (1, 1, 32)}


def test_weights_map_to_jax(case):
    """The shape trees, and the mapping: the JAX export's where it maps
    every leaf (the ResNet encoders), `convert_named` on every leaf where it
    does not (the MiT's Dense and LayerNorm leaves), with a strict load."""
    model = case.port_module()
    assert (model.output_stride, model.up_align_corners) == (4, False)
    names = set(model.state_dict())
    aux = case.kwargs.get("aux", False)
    assert ("aux_conv.conv.weight" in names) == aux
    assert ("aux_cls.bias" in names) == aux
    assert {f"ppm_conv{s}.conv.weight" for s in (1, 2, 3, 6)} <= names
    assert model.fpn_bottleneck.conv.in_channels == 4 * 64
    if case.kwargs.get("encoder") is None:
        assert_weights_match_jax(case)
        widths = 512 if case.kwargs.get("block") == "basic" else 2048
        assert model.ppm_bottleneck.conv.in_channels == widths + 4 * 64
        return
    params_shapes, stats_shapes = case.jax_shapes()
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  (case.params, case.stats)) == (
        params_shapes, stats_shapes)
    assert WIDEST[case.kwargs["encoder"]](params_shapes["backbone"])
    want_p, want_s = convert_named({k: v.numpy() for k, v in
                                    case.sd.items()})
    for got, want in ((case.params, want_p), (case.stats, want_s)):
        flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, g), (_, w) in zip(flat_got, flat_want):
            assert np.array_equal(g, w), path
    back = state_dict_from_jax(case.params, case.stats)
    assert set(back) == names
    model.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()},
                          strict=True)
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), case.sd[k].numpy()), k


# the ConvNeXt, Swin and ViT cases' bf16 forwards are marked slow: each is
# a JAX compile of its own (a `-m 'not slow'` run holds their f32 forwards;
# the attention blocks' bf16 cast points, held bit for bit, are slow too)
NEW_ENCODERS = ("cn", "swin", "vit")


@pytest.mark.parametrize("case,full_res_output,dtype", [
    pytest.param(name, full_res, dtype, id=f"{name}-{tag}",
                 marks=(pytest.mark.slow if name in NEW_ENCODERS
                        and dtype == torch.bfloat16 else ()))
    for name in sorted(CASES)
    for full_res, dtype, tag in ((False, torch.float32, "False"),
                                 (True, torch.float32, "True"),
                                 (False, torch.bfloat16, "bf16"))],
    indirect=["case"])
def test_forward_matches_jax(case, f32, full_res_output, dtype):
    bf16 = (case.jax_logits(jnp.bfloat16) if dtype == torch.bfloat16
            else None)
    assert_forward_matches_jax(case, full_res_output, dtype, f32, bf16)


def test_make_mask_fn_matches_jax(case, f32):
    assert_mask_fn_matches_jax(case, f32, (80, 72))


def test_aux_head_runs_in_train_mode_only(case):
    """An eval-mode forward returns the logits alone; a train-mode one of
    an aux model returns (logits, aux logits at C4's stride, 16)."""
    model = case.loaded()
    hw = case.hw
    x = torch.zeros(2, 3, hw, hw)
    with torch.no_grad():
        assert model(x).shape == (2, NC, hw // 4, hw // 4)
        out = model.train()(x)
    if not case.kwargs.get("aux"):
        assert isinstance(out, torch.Tensor)
        return
    assert [tuple(o.shape) for o in out] == [(2, NC, hw // 4, hw // 4),
                                             (2, NC, hw // 16, hw // 16)]


def test_aux_trainer_step_matches_jax(tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution UPerNet-R34 with its aux head, through the stride-4
    twin (the main logits 4x and the aux logits 16x through the
    upsample+CE loss, align_corners=False), against the JAX train step with
    aux_weight 0.4: the loss equals the plain compute_loss of the main
    logits plus 0.4 times that of the aux logits (1e-6 relative)."""
    case = FamilyCase("upernet", JaxUPerNet, NC, HW, tmp_path,
                      **dict(CASES["r34"][1], aux=True))
    batch = train_batch(case)
    model = case.loaded(full_res_output=True).train()
    with torch.no_grad():
        main, aux = model(torch.from_numpy(batch[0]).permute(0, 3, 1, 2))
    segs = torch.from_numpy(batch[1])
    plain = (compute_loss(main.permute(0, 2, 3, 1), segs)
             + AUX_WEIGHT * compute_loss(aux.permute(0, 2, 3, 1), segs,
                                         align_corners=False))
    assert main.shape[2:] == (HW, HW) and aux.shape[2:] == (HW // 16,
                                                            HW // 16)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    np.testing.assert_allclose(loss, float(plain), rtol=1e-6)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")
    for k in ("aux_cls.weight", "aux_conv.conv.weight", "ppm_conv6.conv.weight"):
        assert not np.array_equal(got[k], case.sd[k].numpy()), k


def test_load_model_bundle_drops_the_aux_head(tmp_path, capsys):
    """A checkpoint of an aux model loads into UPerNet built without the
    head: `aux_conv.*` and `aux_cls.*` are dropped and named."""
    aux_model = build_model("upernet", NC, dtype=torch.float32, aux=True,
                            **dict(RESNET, block="basic"))
    sd = seeded_state_dict(aux_model, seed=5)
    path = str(tmp_path / "aux.pt")
    save_checkpoint(path, sd)
    head = sorted(k for k in sd if k.startswith(("aux_conv.", "aux_cls.")))
    assert len(head) == 8
    model = load_model_bundle(build_model("upernet", NC, dtype=torch.float32,
                                          **dict(RESNET, block="basic")),
                              path, "cpu")
    out = capsys.readouterr().out
    assert f"dropping train-only entries not in the eval model: {head}" in out
    got = model.state_dict()
    assert set(got) == set(sd) - set(head)
    assert all(torch.equal(v, sd[k]) for k, v in got.items())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_adaptive_pool_of_a_small_c5_matches_jax(dtype):
    """A 2x2 C5 (64x64 inputs) pooled to 1, 2, 3 and 6: torch's adaptive
    windows repeat rows and columns where the output is larger, as the JAX
    package's slices do; f32 to 1e-6, bf16 bit for bit."""
    x = np.random.default_rng(0).standard_normal((2, 2, 2, 8)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(x).astype(jnp.float32 if dtype == torch.float32
                               else jnp.bfloat16)
    for s in (1, 2, 3, 6):
        got = adaptive_avg_pool2d(xt.permute(0, 3, 1, 2), (s, s))
        assert got.shape == (2, 8, s, s) and got.dtype == dtype
        got = got.permute(0, 2, 3, 1).float().numpy()
        want = np.asarray(jax_adaptive_avg_pool2d(xj, (s, s)).astype(
            jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0:3, 0:3], np.broadcast_to(
        got[:, 0:1, 0:1], got[:, 0:3, 0:3].shape))   # 6 from 2: 3 repeats


def _bf16_input(shape, seed=5):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                    jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()


def _seeded_pair(port, zero=()):
    """Seeded weights loaded into `port` and as the flax params; the
    entries named in `zero` set to 0."""
    sd = seeded_state_dict(port, seed=4)
    for k in zero:
        sd[k] = torch.zeros_like(sd[k])
    port.load_state_dict(sd)
    return jax_trees_from_state_dict(sd)[0]


@pytest.mark.slow   # one eager compile a JAX op and shape: ~4 s a case
@pytest.mark.parametrize("hw,shift", [(6, 2), (4, 0)],
                         ids=["padded_shifted", "shift_set_to_0"])
def test_bf16_swin_window_attention_matches_eager_jax(hw, shift):
    """Swin-pico's third-stage window attention (64 wide, 4 heads, window
    4, nominal shift 2) in bf16 against the JAX `_WindowAttention` run op
    by op, equal bit for bit: at 6x6 the map pads to 8x8 and shifts by 2
    under the mask of the padded canvas; at 4x4 the window covers the axis
    and the shift is set to 0 (no roll, no mask). The relative-position
    bias `rpb` is seeded N(0, 0.25), so a wrong index would show."""
    from pytorch_segmentation_tpu.nn.backbones.swin import (
        _WindowAttention as JaxWindowAttention)
    from pytorch_segmentation_tpu_torch.nn.backbones.swin import (
        _WindowAttention, _shift_mask)
    port = _WindowAttention(64, 4, 4, 2, torch.bfloat16)
    params = _seeded_pair(port)
    assert float(np.abs(params["rpb"]).max()) > 0.5
    x, xt = _bf16_input((2, hw, hw, 64))
    want = JaxWindowAttention(64, 4, 4, 2, jnp.bfloat16).apply(
        {"params": params}, x)
    with torch.no_grad():
        got = port(xt)
    assert got.dtype == torch.bfloat16 and got.shape == (2, hw, hw, 64)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if shift:   # 4 windows of the 8x8 canvas; all but the first straddle
        mask = _shift_mask(8, 8, 4, shift, shift)     # two of 9 regions
        assert (mask == -100).any(axis=(1, 2)).tolist() == [False, True,
                                                            True, True]


def test_swin_shift_is_set_to_0_where_the_window_covers_the_axis():
    """Swin-pico's window attention (window 4, nominal shift 2) on the
    same weights: on a 4x4 map the window covers the axis, so the shifted
    block computes what the unshifted one does; on a 6x6 map (padded to
    8x8) the shift and its mask change the output."""
    from pytorch_segmentation_tpu_torch.nn.backbones.swin import (
        _WindowAttention)
    shifted = _WindowAttention(64, 4, 4, 2, torch.float32)
    plain = _WindowAttention(64, 4, 4, 0, torch.float32)
    sd = seeded_state_dict(shifted, seed=4)
    shifted.load_state_dict(sd)
    plain.load_state_dict(sd)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for hw, same in ((4, True), (6, False)):
            x = torch.from_numpy(rng.standard_normal(
                (2, hw, hw, 64)).astype(np.float32))
            assert torch.equal(shifted(x), plain(x)) == same, hw


@pytest.mark.slow   # one eager compile a JAX op and shape: ~6 s
def test_bf16_vit_block_attention_matches_eager_jax():
    """The ViT block's attention half in bf16 (`ln1`, the fused `qkv`, q
    scaled by hd**-0.5 in bf16 before the product, the f32 softmax, the
    bf16 product with v, `proj`, the residual) against the JAX `_ViTBlock`
    run op by op with its `fc2` zeroed (its MLP then adds exactly 0): equal
    bit for bit, on 1 + 36 tokens (a class token and a 6x6 grid). The full
    block differs only by the GELU: `F.gelu` rounds once, where the eager
    JAX GELU rounds each of its bf16 steps (x/2, -x times sqrt(1/2) in
    bf16, erfc, the product); the full blocks differ by at most 2^-7 of the
    largest output (measured: 2^-6 where the largest is 4.8)."""
    from pytorch_segmentation_tpu.nn.backbones.vit import (
        _ViTBlock as JaxViTBlock)
    from pytorch_segmentation_tpu_torch.nn.backbones.vit import _ViTBlock
    x, xt = _bf16_input((2, 37, 64))
    port = _ViTBlock(64, 2, torch.bfloat16)
    params = _seeded_pair(port, zero=("fc2.weight", "fc2.bias"))
    want = JaxViTBlock(64, 2, jnp.bfloat16).apply({"params": params}, x)
    with torch.no_grad():
        got = port.attention(xt)
        assert torch.equal(port(xt), got)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    params = _seeded_pair(port)
    want = np.asarray(JaxViTBlock(64, 2, jnp.bfloat16).apply(
        {"params": params}, x).astype(jnp.float32))
    with torch.no_grad():
        got = port(xt).float().numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 ** -7 * np.abs(want).max()


def _cli_argv(cli, tmp_path, *extra):
    weights = tmp_path / "w.pt"
    weights.touch()
    return {"train": ["data"], "test": ["val.json"],
            "inference": ["in", "out"],
            "serve": ["--weights", str(weights)]}[cli] + list(extra)


CLIS = {"train": ttrain, "test": ttest, "inference": tinference,
        "serve": tserve}


def _encoder_sizes(backbone, encoder):
    """The encoder's table row, read back from the built trunk's shapes."""
    if encoder == "convnext":
        depths = tuple(sum(n.startswith(f"stage{s}_block")
                           for n, _ in backbone.named_children())
                       for s in range(4))
        dims = tuple(getattr(backbone, f"stage{s}_block0").gamma.shape[0]
                     for s in range(4))
        return depths, dims
    if encoder == "swin":
        depths = tuple(sum(n.startswith(f"stage{s}_block")
                           for n, _ in backbone.named_children())
                       for s in range(4))
        blocks = [getattr(backbone, f"stage{s}_block0").attn
                  for s in range(4)]
        return (depths, backbone.patch_conv.out_channels,
                tuple(a.heads for a in blocks), blocks[0].window)
    block = backbone.block0
    return (backbone.layers, backbone.dim, block.heads,
            backbone.conv_proj.kernel_size[0], backbone.base_grid,
            backbone.out_indices)


@pytest.mark.parametrize("variant", ["cn-t", "swin-t", "vit-b16"])
def test_unported_encoders_are_refused(variant, tmp_path):
    """The encoders once refused are ported: `variant_kwargs` returns the
    JAX table's entry, the model builds (on the meta device) at the JAX
    table's sizes and every command line parses the variant, as it parses
    maskformer's r50, the last family ported."""
    kwargs = variant_kwargs("upernet", variant)
    assert kwargs == JAX_MODEL_VARIANTS["upernet"][variant]
    encoder = kwargs["encoder"]
    assert encoder not in UNPORTED_ENCODERS == ()
    with without_default_init(), torch.device("meta"):
        model = build_model("upernet", 21, **kwargs)
    table, key = {"convnext": (JAX_CONVNEXT_VARIANTS, "convnext_variant"),
                  "swin": (JAX_SWIN_VARIANTS, "swin_variant"),
                  "vit": (JAX_VIT_VARIANTS, "vit_variant")}[encoder]
    assert _encoder_sizes(model.backbone, encoder) == table[kwargs[key]]
    assert model.cls_conv.out_channels == 21
    for cli, module in CLIS.items():
        opt = module.parse_args(_cli_argv(cli, tmp_path, "--model", "upernet",
                                          "--variant", variant))
        assert (opt.model, opt.variant) == ("upernet", variant), cli
        opt = module.parse_args(_cli_argv(cli, tmp_path, "--model",
                                          "maskformer", "--variant", "r50"))
        assert (opt.model, opt.variant) == ("maskformer", "r50"), cli


def test_ported_variants_and_aux_loss_parse(tmp_path):
    """Every variant of the JAX table builds (on the meta device: shapes
    only) with its encoder; `train --model upernet --aux-loss 0.4` parses,
    and every command line takes a SegFormer and a UPerNet `--variant`."""
    encoders = {"r": "resnet", "mit": "mit", "cn": "convnext",
                "swin": "swin", "vit": "vit"}
    for variant in JAX_MODEL_VARIANTS["upernet"]:
        with without_default_init(), torch.device("meta"):
            model = build_model("upernet", 21,
                                **variant_kwargs("upernet", variant))
        assert model.channels == 512 and model.cls_conv.out_channels == 21
        assert model.encoder == encoders[variant.split("-")[0].rstrip(
            "0123456789")], variant
        if variant == "mit-tiny":
            assert hasattr(model.backbone, "block1_0")
    opt = ttrain.parse_args(["data", "--model", "upernet", "--variant",
                             "r34", "--aux-loss", "0.4"])
    assert (opt.model, opt.variant, opt.aux_loss) == ("upernet", "r34", 0.4)
    for cli, module in CLIS.items():   # --variant on every command line
        for model, variant in (("upernet", "mit-b2"), ("segformer", "b2")):
            opt = module.parse_args(_cli_argv(cli, tmp_path, "--model", model,
                                              "--variant", variant))
            assert (opt.model, opt.variant) == (model, variant), cli
    assert variant_kwargs("upernet", "r34") == {
        "block": "basic", "backbone_layers": (3, 4, 6, 3)}
