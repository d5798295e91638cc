"""PyTorch port: the rest of the train step (ROADMAP queue 1 item 5) on the
CPU: activation recompute (`remat`), BatchNorm statistics from every s-th
pixel (`--bn-subsample`) and the debug-NaN switch (`--debug-nans`).

- remat: each family that takes it (the JAX CLI's twelve, MaskFormer,
  SegFormer's stacked layout and every UPerNet encoder), built at its family
  test's size from the FamilyCase's memoised seeded weights, takes one SGD
  step with `remat=True` that equals the plain step bit for bit: the loss,
  every parameter, buffer and momentum (the first step's momentum is the
  gradient), `num_batches_tracked` at 1. DeepLabV3+ with `remat=True`
  against the JAX module with `remat=True` at the family tests' step
  tolerances, with the fused 1x1 switch off and on (JAX: 'interpret').
  The recompute keeps the forward's batch group and quant mode when the
  backward runs on another thread (as autograd's device thread does on the
  card): under a one-rank gloo group and under QAT.
- `BatchNorm2d(stat_subsample=2)` against the JAX module's, above and below
  the 32 s guard; a folded BatchNorm keeps full statistics, as JAX's.
- The debug-NaN switch raises a `FloatingPointError` where JAX's
  `jax.debug_nans` does (scoped on both sides), and a finite step is the
  same with the switch on and off.
- `train --remat` on a family outside the JAX CLI's list exits with its
  message."""

import functools
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from pytorch_segmentation_tpu.engine import steps as jsteps
from pytorch_segmentation_tpu.models import MODEL_REGISTRY as JAX_MODELS
from pytorch_segmentation_tpu.nn import blocks as jblocks
from pytorch_segmentation_tpu.ops.loss import compute_loss as jax_compute_loss
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.engine.steps import (create_train_state,
                                                         make_eval_step,
                                                         make_train_step)
from pytorch_segmentation_tpu_torch.engine.trainer import make_optimizer
from pytorch_segmentation_tpu_torch.models import (MODEL_VARIANTS,
                                                   build_model,
                                                   make_maskformer_loss,
                                                   without_default_init)
from pytorch_segmentation_tpu_torch.nn import blocks
from pytorch_segmentation_tpu_torch.ops.loss import make_loss_fn
from pytorch_segmentation_tpu_torch.parallel import make_mesh, mesh
from pytorch_segmentation_tpu_torch.quant import quant_min_k, quant_mode
from pytorch_segmentation_tpu_torch.utils.runtime import debug_nans
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, seeded_state_dict)
from torch_family_util import (LR, MOMENTUM, FamilyCase,
                               assert_step_matches, jax_train_step,
                               port_trainer_step, train_batch)

torch.set_num_threads(1)

NC = 5
LAYERS = (1, 1, 1, 1)
# key -> (registry name, input size, constructor arguments): each family
# test file's model; the ResNet families at 32 (the 2048-wide stages are
# most of the time), the others at their test file's size
CASES = {
    "deeplabv3plus": ("deeplabv3plus", 32, {"backbone_layers": LAYERS}),
    "pspnet_aux": ("pspnet", 32, {"backbone_layers": LAYERS, "aux": True}),
    "fastfcn": ("fastfcn", 32, {"backbone_layers": LAYERS}),
    "fpn_r34": ("fpn", 32, {"backbone_layers": LAYERS, "block": "basic"}),
    "fcn_aux": ("fcn", 32, {"backbone_layers": LAYERS, "aux": True}),
    "deeplabv3": ("deeplabv3", 32, {"backbone_layers": LAYERS}),
    "danet_aux": ("danet", 32, {"backbone_layers": LAYERS, "channels": 64,
                                "aux": True}),
    "segformer": ("segformer", 64, {"variant": "tiny-d4"}),
    "segformer_scan": ("segformer", 64, {"variant": "tiny-d4",
                                         "scan_blocks": True}),
    "segmenter": ("segmenter", 96, {"variant": "pico"}),
    "upernet_r50_aux": ("upernet", 32, {"backbone_layers": LAYERS,
                                        "channels": 64, "aux": True}),
    "upernet_mit": ("upernet", 64, {"encoder": "mit", "mit_variant": "tiny",
                                    "channels": 64}),
    "upernet_cn": ("upernet", 64, {"encoder": "convnext",
                                   "convnext_variant": "pico",
                                   "channels": 64}),
    "upernet_swin": ("upernet", 96, {"encoder": "swin",
                                     "swin_variant": "pico",
                                     "channels": 64}),
    "upernet_vit": ("upernet", 96, {"encoder": "vit", "vit_variant": "pico",
                                    "channels": 64}),
    "bisenetv2_aux": ("bisenetv2", 64, {
        "detail_channels": (8, 8, 16), "semantic_channels": (4, 8, 12, 16),
        "head_channels": 32, "aux_channels": (8, 8, 16, 32), "aux": True}),
    "segnext": ("segnext", 64, {"variant": "tiny"}),
    "maskformer": ("maskformer", 32, MODEL_VARIANTS["maskformer"]["tiny"]),
}


@pytest.fixture(autouse=True)
def _restore_switches():
    yield
    blocks.set_force_fused_1x1(None)
    jblocks.set_force_fused_1x1(None)
    jblocks.set_bn_stat_subsample(1)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    made = {}

    def get(key):
        if key not in made:
            name, hw, kwargs = CASES[key]
            made[key] = FamilyCase(name, JAX_MODELS[name], NC, hw,
                                   tmp_path_factory.mktemp(key), **kwargs)
        return made[key]
    return get


def _model(case, remat):
    """The case's model at low resolution, on its seeded weights, in train
    mode."""
    with without_default_init():
        model = build_model(case.name, case.nc, dtype=torch.float32,
                            full_res_output=False, remat=remat, **case.kwargs)
    model.load_state_dict(case.sd, strict=True)
    return model.train()


def _loss_fn(case, model):
    if case.name == "maskformer":
        return make_maskformer_loss(case.nc)
    return make_loss_fn(align_corners=model.up_align_corners)


def _batch(case):
    images, segs = train_batch(case)
    return torch.from_numpy(images), torch.from_numpy(segs).long()


def _sgd_step(case, remat, **step_kwargs):
    """One SGD-momentum step -> (loss, state_dict, momentum buffers)."""
    model = _model(case, remat)
    state = create_train_state(model, make_optimizer(
        model.parameters(), lr=LR, momentum=MOMENTUM))
    step = make_train_step(loss_fn=_loss_fn(case, model), **step_kwargs)
    _, loss = step(state, *_batch(case))
    momentum = [v for _, _, v in state.optimizer.state_tensors()]
    return loss, model.state_dict(), momentum


@pytest.mark.parametrize("key", sorted(CASES))
def test_remat_step_equals_the_plain_step(cases, key):
    case = cases(key)
    loss, got, momentum = _sgd_step(case, True)
    want_loss, want, want_momentum = _sgd_step(case, False)
    assert torch.equal(loss, want_loss) and torch.isfinite(loss)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k
    assert len(momentum) == len(want_momentum)
    assert all(torch.equal(a, b) for a, b in zip(momentum, want_momentum))


@pytest.mark.parametrize("switch", [
    "off",
    # the JAX step through the interpreted Pallas kernels: ~15 s of compile
    pytest.param("on", marks=pytest.mark.slow)])
def test_deeplab_remat_step_matches_jax_remat(tmp_path, switch):
    """DeepLabV3+ with remat=True: one Trainer step against the JAX
    module's remat step, switch off and on ('interpret' on the JAX side,
    the folded chain's plain versions on the port's)."""
    case = FamilyCase("deeplabv3plus", JAX_MODELS["deeplabv3plus"], NC, 64,
                      tmp_path, backbone_layers=LAYERS, remat=True)
    assert case.port_module().backbone.remat
    if switch == "on":
        blocks.set_force_fused_1x1("on")
        jblocks.set_force_fused_1x1("interpret")
    batch = train_batch(case)
    want_loss, want = jax_train_step(case, batch)
    loss, got = port_trainer_step(case, batch, tmp_path)
    assert_step_matches(loss, got, want_loss, want, case.sd, "cls_conv")


def _threaded_grads(case, remat, group, mode):
    """The gradients of one forward under `group` and quant `mode`, the
    backward run on a thread of its own (as autograd's device thread runs
    it on the card), and the batch groups that every BatchNorm statistic
    saw, by thread."""
    model = _model(case, remat)
    images, segs = _batch(case)
    with mesh.batch_statistics_over(group), quant_mode(mode):
        loss = _loss_fn(case, model)(
            model(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1), segs)
    params = [p for p in model.parameters() if p.requires_grad]
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(loss, params)
        except Exception as e:   # re-raised on the test's thread
            out["error"] = e

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    if "error" in out:
        raise out["error"]
    assert len(out["grads"]) == len(params)
    return loss, out["grads"], worker.ident


@pytest.mark.parametrize("scope", ["group", "qat"])
def test_recompute_on_another_thread_keeps_group_and_quant_mode(
        cases, tmp_path, monkeypatch, scope):
    """The backward (and so the recompute) on another thread: under a
    one-rank gloo group every BatchNorm statistic of the recompute spans
    the group, and under QAT (every conv quantized) the gradients equal
    the plain forward's."""
    case = cases("deeplabv3plus")
    seen = []
    batch_mean = blocks.batch_mean

    def spy(*values):
        seen.append((threading.get_ident(), mesh.batch_group()))
        return batch_mean(*values)

    monkeypatch.setattr(blocks, "batch_mean", spy)
    if scope == "group":
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            group, mode = make_mesh(("cpu",)).group, None
            want = _threaded_grads(case, False, group, mode)
            seen.clear()
            got = _threaded_grads(case, True, group, mode)
        finally:
            dist.destroy_process_group()
        recomputed = [g for ident, g in seen if ident == got[2]]
        assert recomputed and all(g is group for _, g in seen)
    else:
        with quant_min_k(0):
            want = _threaded_grads(case, False, None, "qat")
            got = _threaded_grads(case, True, None, "qat")
        assert any(ident == got[2] for ident, _ in seen)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def _jax_bn(x, subsample):
    """JAX BatchNorm2d(stat_subsample) on NHWC x, train mode: (output,
    running mean, running var), eager."""
    module = jblocks.BatchNorm2d(dtype=jnp.float32, stat_subsample=subsample)
    c = x.shape[-1]
    variables = {"params": {"scale": jnp.linspace(0.5, 1.5, c),
                            "bias": jnp.linspace(-0.2, 0.2, c)},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
    y, upd = module.apply(variables, jnp.asarray(x),
                          use_running_average=False, mutable=["batch_stats"])
    return (np.asarray(y), np.asarray(upd["batch_stats"]["mean"]),
            np.asarray(upd["batch_stats"]["var"]))


def _port_bn(x, subsample=None):
    c = x.shape[-1]
    bn = blocks.BatchNorm2d(c, dtype=torch.float32, stat_subsample=subsample)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, c))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
    y = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    return (y.permute(0, 2, 3, 1).detach().numpy(), bn.running_mean.numpy(),
            bn.running_var.numpy(), int(bn.num_batches_tracked))


@pytest.mark.parametrize("hw", [64, 48], ids=["subsampled", "under_guard"])
def test_bn_stat_subsample_matches_jax(hw):
    """s = 2 at 64 (statistics from 32 x 32 of the pixels) and at 48 (under
    the 32 s guard: every pixel), per module and through the process-wide
    default; the output normalizes the whole map."""
    x = (np.random.default_rng(3).standard_normal((2, hw, hw, 6))
         + 0.1 * np.arange(6)).astype(np.float32)
    want = _jax_bn(x, 2)
    full = _port_bn(x, 1)
    for got in (_port_bn(x, 2), _port_bn_default(x, 2)):
        assert got[3] == 1
        # tests/test_torch_train.py's BatchNorm tolerances, and an absolute
        # 1e-7 for running means near zero (f32 sums in another order)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        for g, w in zip(got[1:3], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        assert np.array_equal(got[1], full[1]) == (hw < 64)


def _port_bn_default(x, s):
    with blocks.bn_stat_subsample(s):
        assert blocks.get_bn_stat_subsample() == s
        got = _port_bn(x)
    assert blocks.get_bn_stat_subsample() == 1
    return got


def test_folded_batchnorm_keeps_full_statistics():
    """Under subsampling 2 (both packages' process-wide setting) the folded
    BatchNorm of column sums over every pixel gives JAX BatchNormFolded's
    fold and running statistics, which are those of the unsubsampled
    forward."""
    x = (np.random.default_rng(4).standard_normal((2, 64, 64, 6)) * 2
         + np.arange(6)).astype(np.float32)
    xt = torch.from_numpy(x)
    n = 2 * 64 * 64
    col_sum, col_sumsq = xt.sum(dim=(0, 1, 2)), (xt * xt).sum(dim=(0, 1, 2))
    jblocks.set_bn_stat_subsample(2)
    variables = {"params": {"scale": jnp.linspace(0.5, 1.5, 6),
                            "bias": jnp.linspace(-0.2, 0.2, 6)},
                 "batch_stats": {"mean": jnp.zeros(6), "var": jnp.ones(6)}}
    (jscale, jshift), upd = jblocks.BatchNormFolded().apply(
        variables, jnp.asarray(col_sum.numpy()),
        jnp.asarray(col_sumsq.numpy()), n, use_running_average=False,
        mutable=["batch_stats"])
    bn = blocks.BatchNorm2d(6, dtype=torch.float32).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 6))
    with blocks.bn_stat_subsample(2):
        scale, shift = bn.fold(col_sum, col_sumsq, n)
    for got, want in ((scale, jscale), (shift, jshift),
                      (bn.running_mean, upd["batch_stats"]["mean"]),
                      (bn.running_var, upd["batch_stats"]["var"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    full = _port_bn(x, 1)
    np.testing.assert_allclose(bn.running_var.numpy(), full[2], rtol=1e-5)
    assert not np.allclose(_port_bn(x, 2)[2], full[2], rtol=1e-5)


class _JaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = jblocks.ConvNormAct(4, kernel_size=3, dtype=jnp.float32,
                                name="stem")(x, train=train)
        return fnn.Conv(NC, (1, 1), dtype=jnp.float32, name="cls_conv")(x)


class _Tiny(torch.nn.Module):
    up_align_corners = True

    def __init__(self):
        super().__init__()
        self.stem = blocks.ConvNormAct(3, 4, 3, dtype=torch.float32)
        self.cls_conv = torch.nn.Conv2d(4, NC, 1, bias=True)

    def forward(self, x):
        return blocks.conv2d(self.cls_conv, self.stem(x), torch.float32)


def _nan_batch(finite):
    rng = np.random.default_rng(5)
    images = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    if not finite:
        images[1, 3, 4, 0] = np.nan
    return images, rng.integers(0, NC, (2, 16, 16)).astype(np.int32)


def _jax_nan_step(kind, sd, images, segs):
    """The JAX package's step on `_JaxTiny` under `jax.debug_nans(True)`."""
    params, stats = jax_trees_from_state_dict(sd)
    module = _JaxTiny()
    with jax.debug_nans(True):
        if kind == "eval":
            step = jsteps.make_eval_step(NC, use_pallas=False)
            state = jsteps.TrainState(
                step=jnp.zeros((), jnp.int32), params=params,
                batch_stats=stats, opt_state=None, tx=None,
                apply_fn=module.apply)
            return step(state, jnp.asarray(images), jnp.asarray(segs), 2)
        tx = optax.sgd(LR, momentum=MOMENTUM)
        state = jsteps.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jax.jit(tx.init)(params), tx=tx, apply_fn=module.apply,
            grad_acc=None, micro_step=jnp.zeros((), jnp.int32),
            ema_params=None)
        step = jsteps.make_train_step(loss_fn=functools.partial(
            jax_compute_loss, align_corners=True), donate=False)
        return step(state, jnp.asarray(images), jnp.asarray(segs))


def _port_nan_step(kind, sd, images, segs, switch):
    model = _Tiny()
    model.load_state_dict(sd)
    images, segs = torch.from_numpy(images), torch.from_numpy(segs).long()
    with debug_nans(switch):
        if kind == "eval":
            return make_eval_step(NC, use_kernels=False)(
                model.eval(), images, segs, 2)
        state = create_train_state(model, make_optimizer(
            model.parameters(), lr=LR, momentum=MOMENTUM))
        _, loss = make_train_step()(state, images, segs)
        return loss, model.state_dict()


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_debug_nans_raises_where_jax_does(kind):
    """A NaN in one image: JAX under `jax.debug_nans(True)` and the port
    under `debug_nans()` raise FloatingPointError (the port naming the loss
    first); finite batches raise on neither side, and the port's results
    are the same with the switch on and off."""
    sd = seeded_state_dict(_Tiny(), 0, init="uniform")
    bad = _nan_batch(finite=False)
    with pytest.raises(FloatingPointError):
        _jax_nan_step(kind, sd, *bad)
    with pytest.raises(FloatingPointError, match="NaN in the loss"):
        _port_nan_step(kind, sd, *bad, switch=True)
    assert not blocks.recomputing()
    good = _nan_batch(finite=True)
    _jax_nan_step(kind, sd, *good)
    on = _port_nan_step(kind, sd, *good, switch=True)
    off = _port_nan_step(kind, sd, *good, switch=False)
    if kind == "train":
        assert torch.equal(on[0], off[0])
        assert all(torch.equal(v, off[1][k]) for k, v in on[1].items())
    else:
        assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_debug_nans_names_an_updated_tensor():
    """A NaN that reaches the state but not the loss: a running variance
    poisoned before the step stays NaN, and the check names it."""
    model = _Tiny()
    model.load_state_dict(seeded_state_dict(model, 0, init="uniform"))
    model.stem.bn.running_var[2] = float("nan")
    state = create_train_state(model, make_optimizer(model.parameters()))
    images, segs = _nan_batch(finite=True)
    with debug_nans(), pytest.raises(
            FloatingPointError, match="NaN in buffer stem.bn.running_var"):
        make_train_step()(state, torch.from_numpy(images),
                          torch.from_numpy(segs).long())


@pytest.mark.parametrize("model", ["unet", "hrnet", "ocrnet", "lraspp",
                                   "maskformer"])
def test_train_remat_outside_the_list_exits(model):
    with pytest.raises(SystemExit, match=f"--remat is not supported for "
                                         f"{model} \\(no remat-capable"):
        ttrain.train("data", model, 1, (64, 64), 2, 1, 1e-3, False, False,
                     "", 1, False, False, False, False, False, remat=True,
                     device="cpu")
    assert model not in ttrain.REMAT_FAMILIES
