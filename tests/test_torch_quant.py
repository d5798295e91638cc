"""PyTorch port: int8 quantization (quant.py, ops/int8.py and the int8,
calibration and QAT branches of nn/blocks.ConvNormAct) against the JAX
package on the CPU.

- One ConvNormAct (bf16) in int8 and int8dyn: the int32 product and the
  pre-BN output bit-equal to the compiled JAX program's, the output after
  BN within one bf16 ulp of the largest value.
- `int8_conv2d` against `int8_conv2d_plain` and XLA's int32 convolution at
  shapes that need its padding (rows <= 16, K and N not multiples of 8).
- Calibration, the gate, depthwise convs, the per-thread mode, QAT (the
  forward, the STE gradients and one Trainer step) on a small ConvNormAct
  net with the JAX twin's names, and SegFormer (no eligible conv).
- A shallow DeepLabV3+ (one block a stage, 33x33, f32) under quant_min_k(0):
  the mask, probability and eval functions against the JAX package's, int8
  dynamic and calibrated. The two packages' f32 convolutions sum in other
  orders, so an activation on the int8 grid's rounding boundary may land a
  step apart: masks and counts are held exact where the top-2 gap exceeds
  a bound that the two packages' log-probabilities give.
"""

import copy
import json
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_segmentation_tpu import quant as jquant
from pytorch_segmentation_tpu.data import DataLoader as JaxDataLoader
from pytorch_segmentation_tpu.data import Fetcher as JaxFetcher
from pytorch_segmentation_tpu.data import PostFetch as JaxPostFetch
from pytorch_segmentation_tpu.engine import steps as jsteps
from pytorch_segmentation_tpu.engine import test as jax_test
from pytorch_segmentation_tpu.engine.trainer import ModelBundle
from pytorch_segmentation_tpu.inference import make_infer_fn as jax_infer_fn
from pytorch_segmentation_tpu.models import DeepLabV3Plus as JaxDeepLabV3Plus
from pytorch_segmentation_tpu.nn import blocks as jblocks
from pytorch_segmentation_tpu.ops.loss import compute_loss as jax_loss
from pytorch_segmentation_tpu.ops.resize import resize_bilinear as jax_resize
from pytorch_segmentation_tpu_torch import quant as tquant
from pytorch_segmentation_tpu_torch.data import DataLoader, Fetcher, PostFetch
from pytorch_segmentation_tpu_torch.data.pipeline import normalize_images
from pytorch_segmentation_tpu_torch.engine import Trainer
from pytorch_segmentation_tpu_torch.engine import steps as tsteps
from pytorch_segmentation_tpu_torch.engine import test as port_test
from pytorch_segmentation_tpu_torch.inference import (make_infer_fn,
                                                      make_mask_fn)
from pytorch_segmentation_tpu_torch.models import (build_model,
                                                   without_default_init)
from pytorch_segmentation_tpu_torch.nn import blocks as tblocks
from pytorch_segmentation_tpu_torch.ops.int8 import (int8_conv2d,
                                                     int8_conv2d_plain)
from pytorch_segmentation_tpu_torch.ops.resize import resize_bilinear
from pytorch_segmentation_tpu_torch.serving import MaskServer
from pytorch_segmentation_tpu_torch.utils.weights import (
    jax_trees_from_state_dict, quant_stats_from_jax, quant_stats_to_jax,
    seeded_state_dict, state_dict_from_jax)

torch.set_num_threads(1)

NC, HW = 5, 33
LAYERS = (1, 1, 1, 1)
BF16_ULP = 2.0 ** -7
LR, MOMENTUM = 1e-3, 0.9


@pytest.fixture()
def all_layers_quantized():
    """The gate at 0 in both packages, so the small convs (K = k*k*Cin
    below 576) take the int8 path, as the JAX package's own tests do."""
    with jquant.quant_min_k(0), tquant.quant_min_k(0):
        yield


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------- one ConvNormAct

def _conv_case(k, cin, cout, seed):
    """(JAX params, batch_stats, the port's eval-mode ConvNormAct kwargs'
    state_dict) of one ConvNormAct with non-trivial BN."""
    rng = np.random.default_rng(seed)
    params = {"conv": {"kernel": (rng.standard_normal((k, k, cin, cout))
                                  * 0.2).astype(np.float32)},
              "bn": {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                     "bias": (0.1 * rng.standard_normal(cout)).astype(
                         np.float32)}}
    stats = {"bn": {"mean": (0.1 * rng.standard_normal(cout)).astype(
        np.float32), "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}}
    return params, stats


@pytest.mark.parametrize("mode", ["int8", "int8dyn"])
@pytest.mark.parametrize("k,stride,dilation", [(1, 2, 1), (3, 1, 1),
                                               (3, 1, 2)],
                         ids=["1x1_s2", "3x3", "3x3_d2"])
def test_convnormact_int8_bit_equal_jax(mode, k, stride, dilation,
                                        all_layers_quantized, monkeypatch):
    cin, cout = 12, 10
    params, stats = _conv_case(k, cin, cout, seed=k + dilation)
    x = np.random.default_rng(3).standard_normal((2, 9, 11, cin)).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    module = jblocks.ConvNormAct(cout, kernel_size=k, stride=stride,
                                 dilation=dilation, dtype=jnp.bfloat16)
    amax = jnp.max(jnp.abs(xb)).astype(jnp.float32) * 1.25  # calibrated
    variables = {"params": params, "batch_stats": stats}
    if mode == "int8":
        variables["quant_stats"] = {"in_absmax": amax}

    # JAX's int32 product and pre-BN output, out of the compiled program
    conv = jax.lax.conv_general_dilated
    seen = {}

    def recording_conv(*args, **kwargs):
        y = conv(*args, **kwargs)
        if kwargs.get("preferred_element_type") == jnp.int32:
            seen["int32"] = y
        return y

    def intercept(next_fun, args, kwargs, context):
        if context.module.name == "bn":
            seen["pre_bn"] = args[0]
        return next_fun(*args, **kwargs)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", recording_conv)

    @jax.jit
    def jax_run(v, x):
        with jquant.quant_mode(mode), fnn.intercept_methods(intercept):
            y = module.apply(v, x, train=False)
        return y, seen["int32"], seen["pre_bn"]

    want, want_int32, want_pre = jax_run(variables, xb)
    monkeypatch.undo()

    port = tblocks.ConvNormAct(cin, cout, k, stride=stride,
                               dilation=dilation).eval()
    port.load_state_dict({n: torch.from_numpy(a) for n, a in
                          state_dict_from_jax(params, stats).items()})
    got_seen = {}
    real = tblocks.int8_conv2d

    def recording_int8(*args):
        got_seen["int32"] = real(*args)
        return got_seen["int32"]

    monkeypatch.setattr(tblocks, "int8_conv2d", recording_int8)
    port.bn.register_forward_pre_hook(
        lambda mod, args: got_seen.update(pre_bn=args[0]))
    stat = {port: torch.tensor(float(amax))} if mode == "int8" else None
    with torch.inference_mode(), tquant.quant_mode(mode, stat):
        got = port(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))

    nhwc = (lambda t: t.permute(0, 2, 3, 1).float().numpy())
    assert got_seen["int32"].dtype == torch.int32
    assert np.array_equal(nhwc(got_seen["int32"]), np.asarray(want_int32))
    assert got_seen["pre_bn"].dtype == torch.bfloat16
    assert np.array_equal(nhwc(got_seen["pre_bn"]), _np(want_pre))
    want = _np(want)
    assert np.abs(nhwc(got) - want).max() <= BF16_ULP * np.abs(want).max()
    # the int8 path, not the plain one
    with torch.inference_mode():
        plain = port(torch.from_numpy(x).to(torch.bfloat16).permute(
            0, 3, 1, 2))
    assert not torch.equal(plain, got)


@pytest.mark.parametrize("b,cin,h,w,cout,k,stride,padding,dilation", [
    (1, 5, 3, 4, 7, 3, 1, 1, 1),     # 12 rows, K = 45, N = 7: all padded
    (2, 13, 7, 6, 11, 1, 2, 0, 1),   # 1x1 stride 2: 24 rows, K = 13
    (1, 6, 9, 9, 9, 3, 1, 2, 2),     # dilated, K = 54, N = 9
    (2, 16, 8, 8, 24, 3, 2, 1, 1),   # aligned: K = 144, N = 24
], ids=["pad_all", "1x1_s2", "3x3_d2", "3x3_s2"])
def test_int8_conv2d_is_exact(b, cin, h, w, cout, k, stride, padding,
                              dilation):
    rng = np.random.default_rng(cin)
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    wk = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, wk, (stride, stride), [(padding, padding)] * 2,
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
    w_t = torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))
    got = int8_conv2d(x_t, w_t, stride, padding, dilation)
    plain = int8_conv2d_plain(x_t, w_t, stride, padding, dilation)
    assert got.dtype == plain.dtype == torch.int32
    assert torch.equal(got, plain)
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert np.abs(want).max() > 2 ** 15   # sums beyond an int16
    with pytest.raises(TypeError, match="int8"):
        int8_conv2d(x_t.float(), w_t)


# ------------------------------------------------- a small net of ConvNormAct

class JaxQNet(fnn.Module):
    """ConvNormActs of each geometry (3x3 stride 2, depthwise-separable,
    dilated, 1x1 stride 2), a biased class conv at stride 4 and, behind
    `full_res_output`, a 4x upsample (align_corners=True)."""
    num_classes: int = NC
    full_res_output: bool = False
    up_align_corners: bool = True
    dtype: jnp.dtype = jnp.float32

    @fnn.compact
    def __call__(self, x, train=False):
        dt = self.dtype
        y = jblocks.ConvNormAct(16, 3, stride=2, dtype=dt, name="stem")(
            x, train)
        y = jblocks.SeparableConvNormAct(16, 3, dtype=dt, name="sep")(y, train)
        y = jblocks.ConvNormAct(16, 3, dilation=2, dtype=dt, name="dil")(
            y, train)
        y = jblocks.ConvNormAct(24, 1, stride=2, dtype=dt, name="down")(
            y, train)
        y = fnn.Conv(self.num_classes, (1, 1), dtype=dt, name="cls_conv")(y)
        if self.full_res_output:
            y = jax_resize(y, (4 * y.shape[1], 4 * y.shape[2]),
                           align_corners=True)
        return y


class TorchQNet(torch.nn.Module):
    def __init__(self, full_res_output=False, dtype=torch.float32):
        super().__init__()
        self.full_res_output, self.up_align_corners = full_res_output, True
        self.dtype = dtype
        self.stem = tblocks.ConvNormAct(3, 16, 3, stride=2, dtype=dtype)
        self.sep = tblocks.SeparableConvNormAct(16, 16, 3, dtype=dtype)
        self.dil = tblocks.ConvNormAct(16, 16, 3, dilation=2, dtype=dtype)
        self.down = tblocks.ConvNormAct(16, 24, 1, stride=2, dtype=dtype)
        self.cls_conv = torch.nn.Conv2d(24, NC, 1)

    def forward(self, x):
        y = self.down(self.dil(self.sep(self.stem(x))))
        y = tblocks.conv2d(self.cls_conv, y, self.dtype)
        if self.full_res_output:
            y = resize_bilinear(y.permute(0, 2, 3, 1),
                                (4 * y.shape[2], 4 * y.shape[3]),
                                align_corners=True).permute(0, 3, 1, 2)
        return y


# the eligible (groups == 1) ConvNormActs of the net, by name
QNET_ELIGIBLE = ["stem", "sep.pointwise", "dil", "down"]


@pytest.fixture(scope="module")
def qnet():
    """The port's net (eval mode) and the JAX variables on its weights."""
    model = TorchQNet()
    sd = seeded_state_dict(model, 0, init="uniform")
    model.load_state_dict(sd)
    params, stats = jax_trees_from_state_dict(sd)
    return model.eval(), {"params": params, "batch_stats": stats}, sd


def _qnet_images(seed, scale=1.0, b=2, hw=16):
    return (scale * np.random.default_rng(seed).standard_normal(
        (b, hw, hw, 3))).astype(np.float32)


def test_calibration_is_a_running_max_equal_to_jax(qnet):
    """Every eligible conv gets a statistic, the depthwise half none; the
    running max does not depend on the batch order and equals JAX
    calibrate's through quant_stats_from_jax; the round trip is exact."""
    model, variables, _ = qnet
    x1 = _qnet_images(5)
    x2 = 3.0 * x1
    got12 = tquant.calibrate(model, [torch.from_numpy(x1),
                                     torch.from_numpy(x2)])
    got21 = tquant.calibrate(model, [x2, x1])
    assert list(got12) == QNET_ELIGIBLE
    for name in got12:
        assert got12[name].dtype == torch.float32 and got12[name].dim() == 0
        assert torch.equal(got12[name], got21[name]), name
    assert float(got12["stem"]) == float(np.abs(x2).max())
    want = quant_stats_from_jax(jquant.calibrate(JaxQNet(), variables,
                                                 [x1, x2]))
    assert sorted(want) == sorted(got12)
    for name, value in want.items():
        np.testing.assert_allclose(float(got12[name]), float(value),
                                   rtol=1e-5, err_msg=name)
    back = quant_stats_from_jax(quant_stats_to_jax(got12))
    assert list(back) == list(got12)
    assert all(torch.equal(back[n], got12[n]) for n in got12)
    with pytest.raises(ValueError, match="at least one batch"):
        tquant.calibrate(model, [])
    with pytest.raises(KeyError, match="not a ConvNormAct"):
        tquant.stats_by_module(model, {"cls_conv": 1.0})


def test_depthwise_and_the_gate(qnet, monkeypatch):
    """Grouped convs never quantize; the default gate (576) quantizes a
    conv with K = 9 * 64 = 576 and leaves one with K = 9 * 63 = 567 on the
    plain path, in int8dyn and in qat alike."""
    model, _, _ = qnet
    calls = []
    real = tblocks.int8_conv2d
    monkeypatch.setattr(tblocks, "int8_conv2d",
                        lambda x, w, *a: calls.append(tuple(w.shape))
                        or real(x, w, *a))
    with tquant.quant_min_k(0), tquant.quant_mode("int8dyn"), \
            torch.inference_mode():
        model(torch.from_numpy(_qnet_images(6)).permute(0, 3, 1, 2))
    assert [s[:2] for s in calls] == [(16, 3), (16, 16), (16, 16), (24, 16)]
    assert tblocks.get_quant_min_k() == 576
    x = torch.from_numpy(_qnet_images(7, hw=8)[..., :1]).repeat(1, 1, 1, 64)
    for cin, quantized in ((64, True), (63, False)):
        conv = tblocks.ConvNormAct(cin, 8, 3, dtype=torch.float32)
        conv.load_state_dict(seeded_state_dict(conv, cin, init="uniform"))
        xc = x[..., :cin].permute(0, 3, 1, 2)
        for mode, training in (("int8dyn", False), ("qat", True)):
            conv.train(training)
            with torch.no_grad():
                plain = conv(xc)
                calls.clear()
                with tquant.quant_mode(mode):
                    got = conv(xc)
            assert (not torch.equal(got, plain)) == quantized, (cin, mode)
            assert bool(calls) == (quantized and mode == "int8dyn")


def test_the_mode_belongs_to_the_thread_and_to_its_phase(qnet):
    """Serving modes act in eval mode only and qat in train mode only;
    make_quant_mask_fn and make_mask_fn on one model give int8 and plain
    masks in either order, and a plain forward on a second thread while a
    quantized one is inside the model stays plain."""
    model = copy.deepcopy(qnet[0])  # its train-mode forwards move BN stats
    images = np.random.default_rng(8).integers(0, 256, (2, 16, 16, 3),
                                               dtype=np.uint8)
    x = normalize_images(torch.from_numpy(images)).permute(0, 3, 1, 2)
    with torch.no_grad():
        plain = model(x)
        with tquant.quant_min_k(0):
            with tquant.quant_mode("qat"):
                assert torch.equal(model(x), plain)      # eval: no qat
            with tquant.quant_mode("int8dyn"):
                int8 = model(x)
            model.train()
            try:
                with tquant.quant_mode("int8dyn"):
                    train_int8 = model(x)
                train_plain = model(x)
            finally:
                model.eval()
    assert not torch.equal(int8, plain)
    assert torch.equal(train_int8, train_plain)      # train: no int8
    with tquant.quant_min_k(0):
        quant_fn = tquant.make_quant_mask_fn(model)
        plain_fn = make_mask_fn(model)
        first = [plain_fn(images), quant_fn(images)]
        second = [quant_fn(images), plain_fn(images)]
    assert tblocks.get_quant_mode() is None
    assert torch.equal(first[0], second[1]) and torch.equal(first[1],
                                                            second[0])
    assert not torch.equal(first[0], first[1])

    # a plain forward on this thread while another thread's int8 forward
    # waits inside the model
    inside, release = threading.Event(), threading.Event()
    result = {}

    def hold(mod, args):
        if threading.current_thread().name == "int8":
            inside.set()
            assert release.wait(30)

    handle = model.dil.register_forward_pre_hook(hold)
    try:
        with tquant.quant_min_k(0):
            worker = threading.Thread(
                name="int8", target=lambda: result.update(
                    mask=quant_fn(images)))
            worker.start()
            assert inside.wait(30)
            result["plain"] = plain_fn(images)
            release.set()
            worker.join(30)
    finally:
        handle.remove()
        release.set()
    assert torch.equal(result["plain"], first[0])
    assert torch.equal(result["mask"], first[1])


def test_qat_forward_equals_explicit_fake_quant(qnet, all_layers_quantized):
    """A train-mode ConvNormAct under qat equals the plain train forward of
    fake-quantized input and kernel (the JAX test's scale formulas)."""
    conv = tblocks.ConvNormAct(8, 16, 3, dtype=torch.float32).train()
    conv.load_state_dict(seeded_state_dict(conv, 1, init="uniform"))
    x = torch.from_numpy(_qnet_images(9, hw=10)).repeat(1, 1, 1, 3)[..., :8]
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        with tquant.quant_mode("qat"):
            got = conv(x)
        s = x.abs().max().clamp(min=1e-6) / 127.0
        x_fq = torch.clamp(torch.round(x / s), -127, 127) * s
        w = conv.conv.weight.clone()
        s_w = (w.abs().amax(dim=(1, 2, 3)).clamp(min=1e-8) / 127.0).view(
            -1, 1, 1, 1)
        conv.conv.weight.copy_(torch.clamp(torch.round(w / s_w), -127,
                                           127) * s_w)
        want = conv(x_fq)
        conv.conv.weight.copy_(w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_qat_gradients_equal_jax(all_layers_quantized):
    """The straight-through gradients of sum(y^2) in train mode under qat,
    against jax.grad of the JAX ConvNormAct's: the kernel's and the
    input's, rtol 1e-4; they differ from the plain gradients."""
    params, stats = _conv_case(3, 6, 8, seed=11)
    x = np.random.default_rng(12).standard_normal((2, 7, 7, 6)).astype(
        np.float32)
    module = jblocks.ConvNormAct(8, 3, dtype=jnp.float32)

    def loss(p, x):
        with jquant.quant_mode("qat"):
            y, _ = module.apply({"params": p, "batch_stats": stats}, x,
                                train=True, mutable=["batch_stats"])
        return jnp.sum(y ** 2)

    want_w, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    port = tblocks.ConvNormAct(6, 8, 3, dtype=torch.float32).train()
    port.load_state_dict({n: torch.from_numpy(a) for n, a in
                          state_dict_from_jax(params, stats).items()})

    def grads(mode):
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        with tquant.quant_mode(mode):
            y = port(xt)
        return torch.autograd.grad((y ** 2).sum(), (port.conv.weight, xt))

    g_w, g_x = grads("qat")
    np.testing.assert_allclose(g_w.permute(2, 3, 1, 0).numpy(),
                               np.asarray(want_w["conv"]["kernel"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_x.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_x), rtol=1e-4, atol=1e-4)
    plain_w, _ = grads(None)
    assert not torch.allclose(plain_w, g_w, rtol=1e-4, atol=1e-4)


def test_qat_trainer_step_matches_jax(qnet, tmp_path, all_layers_quantized):
    """One SGD-momentum step of Trainer(qat=True) (the deferred upsample)
    against the JAX make_train_step(qat=True) on the full-resolution net,
    from the same uniform start: the loss to 5e-4, parameters and running
    statistics as tests/torch_family_util.assert_step_matches holds them."""
    from torch_family_util import assert_step_matches
    _, variables, sd = qnet
    rng = np.random.default_rng(13)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    segs = rng.integers(0, NC, (2, 32, 32)).astype(np.int32)
    module = JaxQNet(full_res_output=True)
    tx = optax.sgd(LR, momentum=MOMENTUM)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jax.jit(tx.init)(params), tx=tx, apply_fn=module.apply,
        grad_acc=None, micro_step=jnp.zeros((), jnp.int32), ema_params=None)
    step = jsteps.make_train_step(
        loss_fn=lambda lg, y: jax_loss(lg, y, align_corners=True),
        qat=True, donate=False)
    state, want_loss = step(state, jnp.asarray(images), jnp.asarray(segs))
    want = state_dict_from_jax(jax.tree.map(np.asarray, state.params),
                               jax.tree.map(np.asarray, state.batch_stats))
    path = str(tmp_path / "qnet.pt")
    torch.save({"model": sd}, path)
    model = TorchQNet(full_res_output=True)
    trainer = Trainer(model, [(images, segs, 2)], lr=LR, momentum=MOMENTUM,
                      weights=path, qat=True, log=False,
                      log_dir=str(tmp_path / "runs"), device="cpu")
    assert trainer._train_module.full_res_output is False
    loss = trainer.step()
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert_step_matches(loss, got, float(want_loss), want,
                        {k: torch.as_tensor(v) for k, v in sd.items()},
                        head="cls_conv")
    plain = Trainer(TorchQNet(full_res_output=True), [(images, segs, 2)],
                    lr=LR, momentum=MOMENTUM, weights=path, log=False,
                    log_dir=str(tmp_path / "runs"), device="cpu")
    assert abs(plain.step() - loss) > 1e-6                 # fake quant on


def test_qat_with_the_fused_switch(monkeypatch, all_layers_quantized):
    """With the fused 1x1 switch on, a shallow DeepLabV3+'s QAT step runs
    each bottleneck's conv1 and conv3 through the fused product and conv2
    on the folded path, all three unquantized, and fake-quantizes every
    other eligible conv: 12 fewer fake-quantized convs than with the
    switch off."""
    with without_default_init():   # every entry seeded next
        model = build_model("deeplabv3plus", NC, backbone_layers=LAYERS,
                            dtype=torch.float32, full_res_output=False)
    model.load_state_dict(seeded_state_dict(model, 0, init="uniform"))
    fake, fused = [], []
    real_fake = tblocks.ConvNormAct._fake_quant_conv
    real_fused = tblocks.fused_bn_act_matmul
    monkeypatch.setattr(
        tblocks.ConvNormAct, "_fake_quant_conv",
        lambda self, x: fake.append(self) or real_fake(self, x))
    monkeypatch.setattr(tblocks, "fused_bn_act_matmul",
                        lambda *a, **k: fused.append(1) or real_fused(*a, **k))
    rng = np.random.default_rng(14)
    images = torch.from_numpy(rng.standard_normal((2, HW, HW, 3)).astype(
        np.float32))
    segs = torch.from_numpy(rng.integers(0, NC, (2, 9, 9)).astype(np.int32))
    losses = {}
    for switch in ("off", "on"):
        fake.clear()
        fused.clear()
        tblocks.set_force_fused_1x1(switch)
        try:
            state = tsteps.create_train_state(model, _NoUpdate())
            _, loss = tsteps.make_train_step(qat=True)(state, images, segs)
        finally:
            tblocks.set_force_fused_1x1(None)
        losses[switch] = float(loss)
        assert np.isfinite(losses[switch])
        if switch == "off":
            n_off = len(fake)
            assert not fused
        else:
            assert len(fused) == 2 * len(LAYERS)
            assert len(fake) == n_off - 3 * len(LAYERS)
            assert not any(m in fake for name, m in model.named_modules()
                           if name.endswith(("conv1", "conv2", "conv3")))
    np.testing.assert_allclose(losses["on"], losses["off"], rtol=1e-2)


class _NoUpdate:
    """An optimizer that leaves the parameters alone."""

    def apply(self, count):
        pass


def test_segformer_has_no_eligible_conv():
    """SegFormer: calibrate gives {} and its int8 forwards equal the plain
    one bit for bit."""
    model = build_model("segformer", 3, variant="tiny", dtype=torch.float32,
                        full_res_output=False)
    model.load_state_dict(seeded_state_dict(model, 0, init="uniform"))
    model.eval()
    images = np.random.default_rng(15).integers(0, 256, (1, 64, 64, 3),
                                                dtype=np.uint8)
    assert tquant.calibrate_from_u8(model, images) == {}
    plain = make_mask_fn(model)(images)
    for stats in (None, {}):
        assert torch.equal(tquant.make_quant_mask_fn(
            model, quant_stats=stats)(images), plain)


# --------------------------------------------------- shallow DeepLabV3+ vs JAX

@pytest.fixture(scope="module")
def dlv3p():
    """(the port's eval-mode model, the JAX bundle, u8 images [2, 33, 33,
    3], the JAX calibration statistics on them by name)."""
    with without_default_init():   # every entry seeded next
        model = build_model("deeplabv3plus", NC, backbone_layers=LAYERS,
                            dtype=torch.float32, full_res_output=False)
    sd = seeded_state_dict(model, 0, init="uniform")
    model.load_state_dict(sd)
    params, stats = jax_trees_from_state_dict(sd)
    bundle = ModelBundle(JaxDeepLabV3Plus(
        num_classes=NC, backbone_layers=LAYERS, dtype=jnp.float32,
        full_res_output=False), params, stats)
    images = np.random.default_rng(1).integers(0, 256, (2, HW, HW, 3),
                                               dtype=np.uint8)
    x = normalize_images(torch.from_numpy(images)).numpy()
    jax_stats = jquant.calibrate(bundle.module, {"params": params,
                                                 "batch_stats": stats}, [x])
    return model.eval(), bundle, images, jax_stats


def _bound(got_probs, want_probs):
    """How far a top-2 gap of (upsampled) logits can move between the two
    packages: a logit difference is a log-probability difference, and the
    upsample is a convex combination."""
    d = np.abs(np.log(np.asarray(got_probs, np.float64))
               - np.log(np.asarray(want_probs, np.float64))).max()
    return 4.0 * d + 1e-5


def _clear(logits_nhwc, hw, bound):
    """f32 upsampled logits [B, *hw, C] and which pixels have a top-2 gap
    above `bound`."""
    up = resize_bilinear(torch.as_tensor(logits_nhwc).float(), hw,
                         align_corners=True).numpy()
    top2 = -np.sort(-up, axis=-1)[..., :2]
    return up, top2[..., 0] - top2[..., 1] > bound


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["int8dyn", "int8"])
def test_dlv3p_calibration_and_infer_match_jax(dlv3p, calibrated,
                                               all_layers_quantized):
    """calibrate's statistics (each within 1e-5 of JAX's, the same names);
    make_infer_fn(int8=True) / (quant_stats=) probabilities within 1e-5 of
    JAX's and apart from the plain ones; MaskServer(int8=True) /
    (quant_stats=) serves make_quant_mask_fn's masks, the argmax of the
    upsampled int8 logits; with flip TTA it serves the host argmax of
    make_infer_fn's probabilities."""
    model, bundle, images, jax_stats = dlv3p
    stats = quant_stats_from_jax(jax_stats) if calibrated else None
    if calibrated:
        got = tquant.calibrate_from_u8(model, images)
        assert list(got) == [n for n, m in model.named_modules()
                             if isinstance(m, tblocks.ConvNormAct)
                             and m.conv.groups == 1]
        assert sorted(got) == sorted(stats)
        for name in got:
            np.testing.assert_allclose(float(got[name]), float(stats[name]),
                                       rtol=1e-5, err_msg=name)
    want_probs = np.asarray(jax_infer_fn(bundle, int8=True,
                                         quant_stats=jax_stats
                                         if calibrated else None)(images))
    probs = make_infer_fn(model, int8=True, quant_stats=stats)(images)
    np.testing.assert_allclose(probs.numpy(), want_probs, rtol=1e-5,
                               atol=1e-6)
    plain = make_infer_fn(model)(images)
    assert float((plain - probs).abs().max()) > 1e-4

    masks = tquant.make_quant_mask_fn(model, quant_stats=stats)(images)
    with torch.inference_mode():
        logits = tquant.quantized_forward(tsteps.nhwc_forward(model), model,
                                          stats)(normalize_images(
                                              torch.from_numpy(images)))
    up, _ = _clear(logits, (HW, HW), 0.0)
    assert masks.dtype == torch.int32
    assert np.array_equal(masks.numpy(), up.argmax(-1))
    server = MaskServer(model, img_size=(HW, HW), max_batch=2,
                        int8=not calibrated, quant_stats=stats)
    assert np.array_equal(server._run_batch(images), masks.numpy())
    flip = MaskServer(model, img_size=(HW, HW), max_batch=2, int8=True,
                      quant_stats=stats, tta_flip=True)
    assert flip._mask_fn is None
    want = make_infer_fn(model, int8=True, quant_stats=stats,
                         tta_flip=True)(images).argmax(-1)
    assert np.array_equal(flip._run_batch(images), want.numpy())


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["int8dyn", "int8"])
def test_quant_mask_fn_matches_jax(qnet, calibrated, all_layers_quantized):
    """make_quant_mask_fn against JAX make_quant_mask_fn (off the TPU its
    f32 upsample and argmax) on the small net at 32x32 -> (40, 36): equal
    wherever the top-2 gap of the upsampled logits is above twice the two
    packages' largest logit difference. (The JAX function closes over the
    weights, so XLA constant-folds their quantize pass: on DeepLabV3+'s
    ResNet-50 widths that is ~20 s a compile, hence the small net.)"""
    model, variables, _ = qnet
    images = np.random.default_rng(16).integers(0, 256, (2, 32, 32, 3),
                                                dtype=np.uint8)
    x = normalize_images(torch.from_numpy(images))
    mode = "int8" if calibrated else "int8dyn"
    if calibrated:
        jax_stats = jquant.calibrate(JaxQNet(), variables, [x.numpy()])
        variables = {**variables, "quant_stats": jax_stats}
        stats = quant_stats_from_jax(jax_stats)
    else:
        jax_stats = stats = None

    @jax.jit
    def jax_logits(v, x):
        with jquant.quant_mode(mode):
            return JaxQNet().apply(v, x, train=False)

    want_logits = np.asarray(jax_logits(variables, x.numpy()))
    bundle = ModelBundle(JaxQNet(), variables["params"],
                         variables["batch_stats"])
    out_hw = (40, 36)
    want = np.asarray(jquant.make_quant_mask_fn(
        bundle, out_hw=out_hw, quant_stats=jax_stats)(images))
    got = tquant.make_quant_mask_fn(model, out_hw=out_hw,
                                    quant_stats=stats)(images)
    with torch.inference_mode():
        logits = tquant.quantized_forward(tsteps.nhwc_forward(model), model,
                                          stats)(x)
    diff = float(np.abs(logits.numpy() - want_logits).max())
    up, clear = _clear(logits, out_hw, 2.0 * diff + 1e-5)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert clear.mean() > 0.99
    assert np.array_equal(got.numpy()[clear], want[clear])
    with torch.inference_mode():
        plain = tsteps.nhwc_forward(model)(x)
    assert float((plain - logits).abs().max()) > 1e-4


def test_dlv3p_eval_step_and_test_match_jax(dlv3p, tmp_path, monkeypatch,
                                            all_layers_quantized):
    """make_eval_step(quant=True) against the JAX step on two images: the
    loss to 1e-5, the counts equal (no pixel of these images has a top-2
    gap near the two packages' logit difference); the calibrated fifth
    argument through test(quant_stats=) against JAX test(quant_stats=) over
    12 images at batch 8 (the last batch padded): the mIoU to 1e-6, the
    val loss to 1e-5 and each class's counts equal."""
    from test_torch_eval import MemoryDataset
    model, bundle, images, jax_stats = dlv3p
    segs = np.random.default_rng(2).integers(0, NC, (2, HW, HW)).astype(
        np.int32)
    x = normalize_images(torch.from_numpy(images))
    state = jsteps.TrainState(step=0, params=bundle.params,
                              batch_stats=bundle.batch_stats, opt_state=None,
                              tx=None, apply_fn=bundle.module.apply)
    want = jsteps.make_eval_step(NC, quant=True)(
        state, jnp.asarray(x.numpy()), jnp.asarray(segs), jnp.asarray(2))
    got = tsteps.make_eval_step(NC, quant=True)(model, x,
                                                torch.from_numpy(segs), 2)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    plain = tsteps.make_eval_step(NC)(model, x, torch.from_numpy(segs), 2)
    assert float(plain[0]) != float(got[0])

    monkeypatch.chdir(tmp_path)
    dataset = MemoryDataset(12, (HW, HW), [f"c{i}" for i in range(NC)])
    want_miou = jax_test(bundle, JaxFetcher(JaxDataLoader(
        dataset, 8, num_workers=1), JaxPostFetch()), show_first_batch=False,
        log=False, quant_stats=jax_stats,
        report_path=str(tmp_path / "jax.json"))
    got_miou = port_test(model, Fetcher(DataLoader(dataset, 8, num_workers=1),
                                        PostFetch(device="cpu")),
                         show_first_batch=False, log=False,
                         quant_stats=quant_stats_from_jax(jax_stats),
                         report_path=str(tmp_path / "port.json"),
                         device="cpu")
    assert abs(got_miou - want_miou) <= 1e-6
    got_report = json.loads((tmp_path / "port.json").read_text())
    want_report = json.loads((tmp_path / "jax.json").read_text())
    np.testing.assert_allclose(got_report["val_loss"],
                               want_report["val_loss"], rtol=1e-5)
    for g, w in zip(got_report["per_class"], want_report["per_class"]):
        assert [g[k] for k in ("tp", "fn", "fp")] == [w[k] for k in
                                                      ("tp", "fn", "fp")]
