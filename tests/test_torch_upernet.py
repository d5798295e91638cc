"""PyTorch port: UPerNet (the PPM-capped FPN head) on its ResNet encoders
(bottleneck and basic blocks) and on SegFormer's Mix Transformer, against
the JAX package on the same seeded weights and inputs, on the CPU: the
weights' mapping, the f32 and bf16 forwards, `make_mask_fn` (stride-4
logits, align_corners=False), the auxiliary head (train mode only, one aux
`Trainer` step against the JAX train step with aux_weight 0.4, the
train-only entries that `load_model_bundle` drops), the adaptive pools of a
C5 smaller than the pool scales, and the encoders that are not ported. 5
classes, 64x64 inputs (C5 is 2x2, so the 3x3 and 6x6 pools pool UP),
batch 2, one block a ResNet stage (`backbone_layers=(1, 1, 1, 1)`), a head
of `channels=64`, the JAX package's `tiny` MiT. Each JAX program is
compiled once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.models import UPerNet as JaxUPerNet
from pytorch_segmentation_tpu.ops.pool import (
    adaptive_avg_pool2d as jax_adaptive_avg_pool2d)
from pytorch_segmentation_tpu.utils.port_torch import convert_named
from pytorch_segmentation_tpu_torch import inference as tinference
from pytorch_segmentation_tpu_torch import serve as tserve
from pytorch_segmentation_tpu_torch import test as ttest
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.engine.checkpoint import (
    load_model_bundle, save_checkpoint)
from pytorch_segmentation_tpu_torch.models import build_model, variant_kwargs
from pytorch_segmentation_tpu_torch.ops.loss import compute_loss
from pytorch_segmentation_tpu_torch.ops.pool import adaptive_avg_pool2d
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, seeded_state_dict, state_dict_from_jax)
from torch_family_util import (FamilyCase, assert_forward_matches_jax,
                               assert_mask_fn_matches_jax,
                               assert_step_matches, assert_weights_match_jax,
                               jax_train_step, port_trainer_step,
                               train_batch)

torch.set_num_threads(1)

NC, HW = 5, 64
RESNET = {"backbone_layers": (1, 1, 1, 1), "channels": 64}
AUX_WEIGHT = 0.4   # the JAX make_train_step's default, the train CLI's

# name -> constructor arguments
CASES = {"r50_aux": dict(RESNET, aux=True),
         "r34": dict(RESNET, block="basic"),
         "mit_aux": {"encoder": "mit", "mit_variant": "tiny", "channels": 64,
                     "aux": True}}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    # the MiT encoder's bf16 logits part from the compiled JAX program's as
    # far as SegFormer's do (tests/test_torch_segformer.py: XLA keeps the
    # patch embeddings' convolution outputs in f32 into their LayerNorms
    # where the source rounds to bf16): the mean bound is 1.25 of the bf16
    # error there, 0.4 on the ResNet encoders
    bound = 1.25 if request.param.startswith("mit") else 0.4
    return FamilyCase("upernet", JaxUPerNet, NC, HW,
                      tmp_path_factory.mktemp(request.param),
                      logits_mean_bound=bound, **CASES[request.param])


@pytest.fixture(scope="module")
def f32(case):
    """The JAX UPerNet's stride-4 f32 logits [2, 16, 16, NC] (an eval-mode
    forward: the aux head's output is dropped there)."""
    return case.jax_logits()


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
    if case.kwargs.get("encoder") != "mit":
        assert_weights_match_jax(case)
        widths = 512 if case.kwargs.get("block") == "basic" else 2048
        assert model.ppm_bottleneck.conv.in_channels == widths + 4 * 64
        return
    params_shapes, stats_shapes = case.jax_shapes()
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  (case.params, case.stats)) == (
        params_shapes, stats_shapes)
    assert params_shapes["backbone"]["norm4"] == {"scale": (128,),
                                                  "bias": (128,)}
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


@pytest.mark.parametrize("full_res_output,dtype", [
    pytest.param(False, torch.float32, id="False"),
    pytest.param(True, torch.float32, id="True"),
    pytest.param(False, torch.bfloat16, id="bf16")])
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
    x = torch.zeros(2, 3, HW, HW)
    with torch.no_grad():
        assert model(x).shape == (2, NC, HW // 4, HW // 4)
        out = model.train()(x)
    if not case.kwargs.get("aux"):
        assert isinstance(out, torch.Tensor)
        return
    assert [tuple(o.shape) for o in out] == [(2, NC, HW // 4, HW // 4),
                                             (2, NC, HW // 16, HW // 16)]


def test_aux_trainer_step_matches_jax(tmp_path):
    """One SGD step (lr 1e-3, momentum 0.9) of `Trainer` on the
    full-resolution UPerNet-R34 with its aux head, through the stride-4
    twin (the main logits 4x and the aux logits 16x through the
    upsample+CE loss, align_corners=False), against the JAX train step with
    aux_weight 0.4: the loss equals the plain compute_loss of the main
    logits plus 0.4 times that of the aux logits (1e-6 relative)."""
    case = FamilyCase("upernet", JaxUPerNet, NC, HW, tmp_path,
                      **dict(CASES["r34"], aux=True))
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


def _cli_argv(cli, tmp_path, *extra):
    weights = tmp_path / "w.pt"
    weights.touch()
    return {"train": ["data"], "test": ["val.json"],
            "inference": ["in", "out"],
            "serve": ["--weights", str(weights)]}[cli] + list(extra)


CLIS = {"train": ttrain, "test": ttest, "inference": tinference,
        "serve": tserve}


@pytest.mark.parametrize("variant", ["cn-t", "swin-t", "vit-b16"])
def test_unported_encoders_are_refused(variant, tmp_path, capsys):
    """`variant_kwargs` returns the JAX table's entry; the constructor
    refuses the encoder, and each command line exits 2 naming the item."""
    kwargs = variant_kwargs("upernet", variant)
    assert kwargs["encoder"] in ("convnext", "swin", "vit")
    with pytest.raises(NotImplementedError, match=r"not ported yet \(ROADMAP "
                       r"queue 1 item 6, other model families\)"):
        build_model("upernet", NC, **kwargs)
    for cli, module in CLIS.items():
        with pytest.raises(SystemExit) as err:
            module.parse_args(_cli_argv(cli, tmp_path, "--model", "upernet",
                                        "--variant", variant))
        assert err.value.code == 2, cli
        assert (f"--variant {variant} is not ported yet (ROADMAP queue 1 "
                "item 6" in capsys.readouterr().err), cli


def test_ported_variants_and_aux_loss_parse(tmp_path):
    """r50, r34 and mit-b0...mit-b5 build (on the meta device: shapes
    only); `train --model upernet --aux-loss 0.4` parses, and every command
    line takes a SegFormer and a UPerNet `--variant`."""
    for variant in ("r50", "r34", "mit-b0", "mit-b5", "mit-tiny"):
        with torch.device("meta"):
            model = build_model("upernet", 21,
                                **variant_kwargs("upernet", variant))
        assert model.channels == 512 and model.cls_conv.out_channels == 21
        assert model.encoder == ("mit" if variant.startswith("mit")
                                 else "resnet")
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
