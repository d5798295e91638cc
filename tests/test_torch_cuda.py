"""PyTorch port on the card: the hand-written kernels (upsample+argmax, its
mask counted to the eval kernel's counts;
upsample+cross-entropy forward, its loss and lse, and backward; the
augmentation warp's row resampler on both passes' layouts;
upsample+argmax+confusion counts; the
fused 1x1 forward, dx and dW; the channels-major product; the Hopper loop's
product with each operand K-major or MN-major) against their plain PyTorch
versions at edge shapes, and the small model (served, trained, evaluated)
against the CPU, and the train, test and inference command lines from
PNG files. Skips without a CUDA device. On the card (no jax there, so
without the JAX-side conftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu_torch.data.pipeline import normalize_images
from pytorch_segmentation_tpu_torch.engine.checkpoint import load_model_bundle
from pytorch_segmentation_tpu_torch.inference import make_mask_fn
from pytorch_segmentation_tpu_torch.models import build_model
from pytorch_segmentation_tpu_torch.nn import blocks
from pytorch_segmentation_tpu_torch.nn.backbones.resnet import Bottleneck
from pytorch_segmentation_tpu_torch.ops.kernels import banded_resample as br
from pytorch_segmentation_tpu_torch.ops.kernels import cmajor_matmul as cm
from pytorch_segmentation_tpu_torch.ops.kernels import eval_confusion as ec
from pytorch_segmentation_tpu_torch.ops.kernels import fused_matmul_bn as fm
from pytorch_segmentation_tpu_torch.ops.kernels import softmax_ce as ce
from pytorch_segmentation_tpu_torch.ops.kernels import upsample_argmax as ua
from pytorch_segmentation_tpu_torch.ops.resize import resize_bilinear
from pytorch_segmentation_tpu_torch.utils.runtime import require_cuda
from torch_port_util import assert_masks_agree

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return require_cuda()


def _check(logits, out_hw, align):
    before = ua.launch_count()
    got = ua.fused_upsample_argmax(logits, out_hw, align_corners=align)
    assert ua.launch_count() == before + 1
    ref = ua.upsample_argmax_reference(logits, out_hw, align_corners=align)
    up = resize_bilinear(logits.float(), out_hw, align_corners=align)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert_masks_agree(got.cpu().numpy(), ref.cpu().numpy(),
                       up.cpu().numpy())


@pytest.mark.parametrize("shape,out_hw,align,dtype", [
    ((1, 1, 1, 1), (1, 1), True, torch.float32),      # one class, one pixel
    ((1, 1, 1, 3), (5, 7), False, torch.bfloat16),    # one source pixel
    ((3, 4, 5, 2), (4, 5), True, torch.float32),      # identity size
    ((1, 20, 30, 21), (7, 9), True, torch.float32),   # downsample
    ((2, 9, 11, 130), (33, 41), False, torch.bfloat16),  # > 128 classes
    ((8, 129, 129, 21), (513, 513), True, torch.bfloat16),  # serving path
    ((8, 65, 65, 21), (513, 513), True, torch.bfloat16),    # PSPNet: 8x
    ((8, 128, 128, 21), (512, 512), False, torch.bfloat16),  # FPN: 4x
    ((8, 32, 32, 21), (512, 512), False, torch.float32),  # Segmenter: 16x
])
def test_kernel_matches_plain(device, shape, out_hw, align, dtype):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _check(torch.from_numpy(x).to(device=device, dtype=dtype), out_hw, align)


def test_kernel_reads_strides_and_ties(device):
    x = torch.randn(2, 6, 17, 19, device=device)   # NCHW memory
    x[:, 5] = x[:, 2]                              # class 2 must beat 5
    nhwc = x.permute(0, 2, 3, 1)                   # strided NHWC view
    got = ua.fused_upsample_argmax(nhwc, (40, 50))
    assert torch.equal(got, ua.fused_upsample_argmax(nhwc.contiguous(),
                                                     (40, 50)))
    assert not bool((got == 5).any())
    _check(nhwc[:, ::2, 1:], (31, 37), False)      # sliced, offset view


def test_kernel_rejects_other_dtypes(device):
    with pytest.raises(TypeError):
        ua.fused_upsample_argmax(torch.zeros(1, 4, 4, 3, device=device,
                                             dtype=torch.float16), (8, 8))


def test_small_model_on_card_matches_cpu(device):
    def build(dev):
        m = build_model("deeplabv3plus", 21, backbone_layers=(1, 1, 1, 1),
                        dtype=torch.float32, full_res_output=False)
        return load_model_bundle(m, None, dev, seed=0)

    imgs = np.random.default_rng(1).integers(0, 256, (2, 65, 65, 3),
                                             dtype=np.uint8)
    cpu_model, gpu_model = build("cpu"), build(device)
    want = make_mask_fn(cpu_model)(imgs)
    got = make_mask_fn(gpu_model)(imgs).cpu()
    with torch.inference_mode():
        x = normalize_images(torch.from_numpy(imgs)).permute(0, 3, 1, 2)
        lc = cpu_model(x).permute(0, 2, 3, 1)
        lg = gpu_model(x.to(device)).permute(0, 2, 3, 1).cpu()
    diff = float((lc - lg).abs().max())
    # f32 with TF32 off on the card; a pixel can flip only where its top-2
    # gap is below twice the largest logit difference
    assert diff < 1e-3 * float(lc.abs().max())
    up = resize_bilinear(lc, (65, 65), align_corners=True)
    assert_masks_agree(got.numpy(), want.numpy(), up.numpy(),
                       gap=max(1e-4, 2 * diff))


def _ce_inputs(shape, out_hw, dtype, device, label_dtype=torch.int32, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, shape[-1], (shape[0],) + out_hw))
    return (x.to(device=device, dtype=dtype).requires_grad_(True),
            y.to(device=device, dtype=label_dtype))


def _ce_check(x, y, align):
    """Kernel loss and dlogits against the plain version and autograd on an
    f32 copy of the same values: loss to 1e-6 relative (f32, another
    summation order); f32 dlogits to 1e-5 of the gradient's largest entry;
    bf16 dlogits to two bf16 ulps of the f32 gradient rounded to bf16 (with
    the f32 bound as the floor for entries near zero)."""
    before = ce.launch_count()
    loss = ce.fused_upsample_ce(x, y, align_corners=align)
    (grad,) = torch.autograd.grad(loss, x)
    after = ce.launch_count()
    assert (after["fwd"], after["bwd"]) == (before["fwd"] + 1,
                                            before["bwd"] + 1)
    xr = x.detach().float().requires_grad_(True)
    ref = ce.upsample_ce_reference(xr, y, align)
    (ref_grad,) = torch.autograd.grad(ref, xr)
    torch.cuda.synchronize()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert grad.dtype == x.dtype and grad.shape == x.shape
    assert grad.stride() == x.detach().contiguous().stride() or (
        grad.stride() == x.stride())
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=0)
    top = float(ref_grad.abs().max())
    if x.dtype == torch.float32:
        assert float((grad - ref_grad).abs().max()) <= 1e-5 * top
    else:
        want = ref_grad.to(torch.bfloat16).float()
        assert bool(((grad.float() - want).abs()
                     <= 2 ** -7 * want.abs() + 1e-5 * top).all())
    return grad


# lse from the forward kernel against the plain f32 logsumexp of the
# upsampled logits: both f32 with |lse| < 12, they differ by the online
# recurrence against torch's, and another interpolation order: a few ulps
LSE_TOL = 1e-5


def _lse_check(x, y, align):
    """The forward kernel alone: lse against the plain per-pixel
    logsumexp, the per-sample sums against the plain per-pixel losses (1e-5
    relative: f32 sums of up to 263,169 pixels in another order). ->
    (sums, lse)."""
    before = ce.launch_count()["fwd"]
    sums, lse, _ = ce._launch_fwd(x.detach(), y, align, want_lse=True)
    assert ce.launch_count()["fwd"] == before + 1
    up = resize_bilinear(x.detach().float(), tuple(y.shape[1:]),
                         align_corners=align)
    want = torch.logsumexp(up, dim=-1)
    del up
    assert lse.shape == want.shape and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) <= LSE_TOL
    per_pixel = ce._per_pixel_reference(x.detach(), y, align)
    torch.testing.assert_close(sums, per_pixel.sum(dim=(1, 2)), rtol=1e-5,
                               atol=0)
    return sums, lse


@pytest.mark.parametrize("shape,out_hw,align,dtype,label_dtype", [
    ((32, 129, 129, 21), (513, 513), True, torch.bfloat16, torch.int32),
    ((32, 129, 129, 21), (513, 513), True, torch.float32, torch.int64),
    ((2, 65, 97, 150), (257, 385), False, torch.bfloat16, torch.int64),
    ((2, 33, 33, 81), (129, 129), True, torch.float32, torch.int32),
    ((1, 1, 1, 1), (1, 1), True, torch.float32, torch.int32),
    ((1, 1, 1, 3), (5, 7), False, torch.bfloat16, torch.uint8),
    ((3, 4, 5, 2), (4, 5), True, torch.float32, torch.int64),   # same size
    ((1, 20, 30, 21), (7, 9), True, torch.float32, torch.int32),  # downsample
    # the backward's tiling: 45 rows in bands of 4 (the last of 1), 97
    # classes in chunks of 25, 25, 25, 22
    ((32, 45, 37, 97), (177, 145), False, torch.float32, torch.int32),
    # rows and columns downsampled, 33 classes in chunks of 17 and 16
    ((2, 40, 50, 33), (13, 17), True, torch.bfloat16, torch.int64),
    # 150 classes at in_w 97 in f32 (58 KB a source row): chunks of 30
    ((2, 33, 97, 150), (129, 385), True, torch.float32, torch.int32),
    # PSPNet's and FastFCN's logits (8x) and FastFCN's aux logits (16x)
    ((32, 65, 65, 21), (513, 513), True, torch.bfloat16, torch.int32),
    ((32, 33, 33, 21), (513, 513), True, torch.bfloat16, torch.int32),
    # SegFormer's and UPerNet's logits (4x) and UPerNet's aux logits (16x),
    # align_corners=False
    ((32, 128, 128, 21), (512, 512), False, torch.bfloat16, torch.int32),
    ((32, 32, 32, 21), (512, 512), False, torch.bfloat16, torch.int32),
    # Segmenter's f32 logits (16x, align_corners=False)
    ((32, 32, 32, 21), (512, 512), False, torch.float32, torch.int32),
])
def test_ce_kernels_match_plain(device, shape, out_hw, align, dtype,
                                label_dtype):
    x, y = _ce_inputs(shape, out_hw, dtype, device, label_dtype)
    _ce_check(x, y, align)
    per = ce.fused_upsample_ce_per_sample(x, y, align_corners=align)
    assert per.shape == (shape[0],) and not per.requires_grad
    torch.testing.assert_close(
        per.mean(), ce.upsample_ce_reference(x.detach().float(), y, align),
        rtol=1e-5, atol=0)
    sums, _ = _lse_check(x, y, align)
    assert torch.equal(per, sums / (out_hw[0] * out_hw[1]))


@pytest.mark.parametrize("shape,out_hw,dtype,chunks", [
    # 6 bands of one row, 300 columns in 18 tiles of 17 (each reading ~170
    # source columns), 150 classes in chunks of 38, 38, 38, 36
    ((1, 4, 3000, 150), (6, 300), torch.float32, 4),
    # bf16, 2 samples: 2 chunks of 75
    ((2, 4, 1500, 150), (6, 300), torch.bfloat16, 2),
    # every class in one chunk, staged in 16-byte loads: at batch 2 the
    # grid fills the card with bands of 4 rows, 3 tiles of 171 columns
    ((2, 129, 129, 21), (513, 513), torch.bfloat16, 1),
])
def test_ce_forward_bands_tiles_and_chunks_match_plain(device, shape, out_hw,
                                                       dtype, chunks):
    x, y = _ce_inputs(shape, out_hw, dtype, device)
    y[0, 0, :3] = shape[-1]  # labels outside the classes
    y[-1, -1, -2:] = -1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = ce.fwd_plan(*shape, *out_hw, True, x.element_size(), sms)
    assert len(plan.bands) > 1 and len(plan.tiles) > 1
    assert -(-shape[-1] // plan.chunk) == chunks
    _ce_check(x, y, True)
    _lse_check(x, y, True)


def test_ce_forward_is_bit_reproducible_and_reads_strides(device):
    """Two launches give the same lse and per-sample sums, and the NCHW
    memory seen through strides (staged element by element) gives the bits
    of the contiguous logits (staged in 16-byte loads)."""
    for shape, out_hw, dtype in (
            ((4, 33, 33, 21), (129, 129), torch.bfloat16),
            ((1, 4, 3000, 150), (6, 300), torch.float32)):
        x, y = _ce_inputs(shape, out_hw, dtype, device)
        x = x.detach()
        sums, lse, _ = ce._launch_fwd(x, y, True, want_lse=True)
        again, lse_again, _ = ce._launch_fwd(x, y, True, want_lse=True)
        assert torch.equal(again, sums) and torch.equal(lse_again, lse)
        view = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        sums_v, lse_v, _ = ce._launch_fwd(view, y, True, want_lse=True)
        assert torch.equal(sums_v, sums) and torch.equal(lse_v, lse)


@pytest.mark.parametrize("shape,out_hw,dtype,tiled", [
    # 200 columns in two tiles of 100: halo columns, each tile's outputs
    ((2, 33, 200, 21), (129, 797), torch.bfloat16, "several_tiles"),
    # 2000 columns down to 16 in 22 tiles of 92, 6 of them read by no
    # output column (their gradient is 0, nothing staged)
    ((1, 3, 2000, 32), (5, 16), torch.float32, "tiles_no_output_reads"),
])
def test_ce_backward_column_tiles_match_plain(device, shape, out_hw, dtype,
                                              tiled):
    x, y = _ce_inputs(shape, out_hw, dtype, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = ce.bwd_plan(*shape, *out_hw, True, x.element_size(), sms)
    assert len(plan.tiles) > 1
    unread = np.flatnonzero(plan.tiles[:, 3] < plan.tiles[:, 2])
    assert (len(unread) > 0) == (tiled == "tiles_no_output_reads")
    grad = _ce_check(x, y, True)
    for t in unread:
        cols = slice(t * plan.tile_cols, (t + 1) * plan.tile_cols)
        assert not bool(grad[:, :, cols].any())


def test_ce_labels_outside_the_classes(device):
    x, y = _ce_inputs((2, 9, 11, 5), (33, 41), torch.float32, device)
    y[0, :4] = 9
    y[1, 5:7] = -1
    _ce_check(x, y, True)


def test_ce_backward_is_bit_reproducible_and_reads_strides(device):
    x, y = _ce_inputs((4, 33, 33, 21), (129, 129), torch.bfloat16, device)
    first = _ce_check(x, y, True)
    for _ in range(3):
        loss = ce.fused_upsample_ce(x, y)
        assert torch.equal(torch.autograd.grad(loss, x)[0], first)
    assert torch.equal(ce.fused_upsample_ce(x, y), loss)
    # NCHW memory seen as NHWC through strides: same values, and the
    # gradient comes back in that layout
    nchw = x.detach().permute(0, 3, 1, 2).contiguous()
    view = nchw.permute(0, 2, 3, 1).requires_grad_(True)
    assert not view.is_contiguous()
    loss_v = ce.fused_upsample_ce(view, y)
    (grad_v,) = torch.autograd.grad(loss_v, view)
    assert torch.equal(loss_v, loss) and torch.equal(grad_v, first)
    assert grad_v.stride() == view.stride()


def test_ce_gradient_by_finite_differences(device):
    """The backward kernel against central differences of the forward
    kernel on a tiny f32 case (f32 differences: 2e-2 relative to the
    largest entry)."""
    x, y = _ce_inputs((1, 3, 4, 3), (7, 9), torch.float32, device, seed=3)
    (grad,) = torch.autograd.grad(ce.fused_upsample_ce(x, y, False), x)
    flat = x.detach().clone().reshape(-1)
    fd = torch.zeros_like(flat)
    eps = 1e-2
    for i in range(flat.numel()):
        for sign in (1.0, -1.0):
            bumped = flat.clone()
            bumped[i] += sign * eps
            fd[i] += sign * ce.fused_upsample_ce(bumped.view(x.shape), y,
                                                 False) / (2 * eps)
    assert float((fd.view(x.shape) - grad).abs().max()) <= 2e-2 * float(
        grad.abs().max())


def test_ce_wrapper_rejects_what_the_kernels_do_not_take(device):
    x, y = _ce_inputs((1, 4, 4, 3), (8, 8), torch.float32, device)
    with pytest.raises(TypeError):
        ce.fused_upsample_ce(x.half(), y)
    with pytest.raises(TypeError):
        ce.fused_upsample_ce(x, y.float())
    with pytest.raises(ValueError):
        ce.fused_upsample_ce(x, y.cpu())


def test_small_train_steps_on_card_match_cpu(device, tmp_path):
    """3 SGD steps of the small f32 model through the Trainer's deferred
    upsample: the kernels on the card against the plain version on the CPU.
    Seeded weights with uniform conv kernels: under the He kernels the f32
    gradient at this size is badly conditioned (see `seeded_state_dict`).
    Tensors to 2e-3 of their largest entry (measured 3e-4): the small
    updates of convolutions that feed a BatchNorm over 50 values per channel
    are sums that cancel, and differ by up to a third between two f32
    runs."""
    from pytorch_segmentation_tpu_torch.engine.trainer import Trainer
    from pytorch_segmentation_tpu_torch.utils.weights import seeded_state_dict
    rng = np.random.default_rng(2)
    batch = (rng.standard_normal((2, 65, 65, 3)).astype(np.float32),
             rng.integers(0, 5, (2, 65, 65)).astype(np.int32), 2)

    def build():
        return build_model("deeplabv3plus", 5, backbone_layers=(1, 1, 1, 1),
                           dtype=torch.float32, full_res_output=True)

    start = str(tmp_path / "start.pt")
    torch.save({"model": seeded_state_dict(build(), 0,
                                           init="uniform")}, start)

    def run(dev):
        model = build()
        trainer = Trainer(model, [batch], lr=1e-3, weights=start, log=False,
                          log_dir=str(tmp_path / str(dev)), device=dev)
        return [trainer.step() for _ in range(3)], model.state_dict()

    cpu_losses, cpu_sd = run("cpu")
    before = ce.launch_count()
    gpu_losses, gpu_sd = run(device)
    after = ce.launch_count()
    assert (after["fwd"] - before["fwd"], after["bwd"] - before["bwd"]) == (
        3, 3)
    np.testing.assert_allclose(gpu_losses, cpu_losses, rtol=1e-4)
    for k, v in cpu_sd.items():
        if v.dtype.is_floating_point:
            assert float((gpu_sd[k].cpu() - v).abs().max()) <= 2e-3 * float(
                v.abs().max()), k


def _resample_inputs(b, r, w, c, device, seed=0):
    """bf16 planes (label ids in plane 3), f32 coordinates over the whole of
    [0, C-1] with both ends present, and a mixed use_bil."""
    rng = np.random.default_rng(seed)
    planes = rng.uniform(0, 255, (b, 4, r, c)).astype(np.float32)
    planes[:, 3] = rng.integers(0, 21, (b, r, c))
    coords = rng.uniform(0, c - 1, (b, r, w)).astype(np.float32)
    coords[:, :, 0] = 0.0
    coords[:, :, -1] = c - 1.0
    return (torch.from_numpy(planes).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(coords).to(device),
            torch.from_numpy(np.arange(b) % 2 == 0).to(device))


def _resample_check(planes, coords, use_bil, out_dtype):
    """The kernel equals the plain version bit for bit: two exact products
    and one f32 sum on both sides."""
    before = br.launch_count()
    got = br.banded_resample_rows(planes, coords, use_bil,
                                  out_dtype=out_dtype)
    assert br.launch_count() == before + 1
    want = br.banded_resample_reference(planes, coords, use_bil, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == want.shape
    assert got.is_contiguous()
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("shape,w,out_dtype", [
    ((32, 4, 513, 513), 513, torch.bfloat16),   # the augmentation's shape
    ((2, 4, 37, 211), 150, torch.float32),      # ragged, non-square
    ((1, 4, 1, 1), 1, torch.float32),           # one source column
    ((3, 4, 5, 2), 300, torch.bfloat16),        # upsampling a pair
])
def test_resample_kernel_equals_plain(device, shape, w, out_dtype):
    b, _, r, c = shape
    _resample_check(*_resample_inputs(b, r, w, c, device), out_dtype)


def test_resample_kernel_reads_strides_and_is_reproducible(device):
    planes, coords, use_bil = _resample_inputs(4, 65, 65, 65, device, seed=1)
    view = planes.transpose(2, 3)                  # strided, no copy
    assert not view.is_contiguous()
    first = _resample_check(view, coords, use_bil, torch.bfloat16)
    assert torch.equal(first, br.banded_resample_rows(
        view.contiguous(), coords, use_bil, out_dtype=torch.bfloat16))
    for _ in range(3):
        assert torch.equal(first, br.banded_resample_rows(
            view, coords, use_bil, out_dtype=torch.bfloat16))
    _resample_check(planes[:, :, ::2, 3:], coords[:, ::2], use_bil,
                    torch.float32)                 # sliced, offset view


def _smooth_coords(rng, b, r, w, c, wrap_sample=None):
    """Per-row coordinates as the warp makes them: advancing by 0.8 (C-1) /
    (W-1) a column, shifting 0.4 a row, jittered, clamped into [0, C-1] with
    both ends present; sample `wrap_sample` wraps from C-1 to 0 mid-row, as
    the wrap mode does."""
    x = np.arange(w, dtype=np.float32)
    rows = np.arange(r, dtype=np.float32)[:, None]
    coords = (3.0 + 0.8 * (c - 1) / max(w - 1, 1) * x[None] + 0.4 * rows
              + rng.uniform(-1.5, 1.5, (b, r, w)))
    coords = np.clip(coords, 0.0, c - 1.0).astype(np.float32)
    coords[:, 0, 0], coords[:, -1, -1] = 0.0, c - 1.0
    if wrap_sample is not None:
        coords[wrap_sample] = np.mod(coords[wrap_sample] + c / 2, c - 1.0)
    return coords


# name -> (B, R, C, W, planes as a transposed view, coordinates, out dtype)
RESAMPLE_CASES = {
    "contiguous_513_bf16": (2, 513, 513, 513, False, "smooth",
                            torch.bfloat16),
    "transposed_513_bf16": (2, 513, 513, 513, True, "smooth",
                            torch.bfloat16),
    "contiguous_513_f32": (2, 513, 513, 513, False, "smooth", torch.float32),
    "transposed_211_f32": (3, 37, 211, 150, True, "smooth", torch.float32),
    "wide_span_211_to_150": (2, 37, 211, 150, False, "random",
                             torch.float32),
    "transposed_513_wrap": (2, 513, 513, 513, True, "wrap", torch.bfloat16),
}


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_kernel_equals_plain_on_both_passes_layouts(device, case):
    """The kernel equals the plain version bit for bit on a contiguous
    source (the first pass) and a transposed view (the second pass's), at
    odd widths whose rows are misaligned, with coordinates at exactly 0 and
    C-1, random ones, a sample in wrap mode and mixed use_bil; a repeat
    gives the same bits."""
    b, r, c, w, transposed, kind, out_dtype = RESAMPLE_CASES[case]
    rng = np.random.default_rng(3)
    planes = rng.uniform(0, 255, (b, 4, c, r) if transposed
                         else (b, 4, r, c)).astype(np.float32)
    planes = torch.from_numpy(planes).to(device=device, dtype=torch.bfloat16)
    if transposed:
        planes = planes.transpose(2, 3)
    planes[:, 3] = torch.from_numpy(rng.integers(0, 21, (b, r, c))).to(
        device=device, dtype=torch.bfloat16)
    if kind == "random":
        coords = rng.uniform(0, c - 1, (b, r, w)).astype(np.float32)
        coords[:, :, 0], coords[:, :, -1] = 0.0, c - 1.0
    else:
        coords = _smooth_coords(rng, b, r, w, c,
                                wrap_sample=1 if kind == "wrap" else None)
    coords = torch.from_numpy(coords).to(device)
    use_bil = torch.from_numpy(np.arange(b) % 2 == 0).to(device)
    first = _resample_check(planes, coords, use_bil, out_dtype)
    assert torch.equal(first, br.banded_resample_rows(
        planes, coords, use_bil, out_dtype=out_dtype))


@pytest.mark.parametrize("shape,out_hw,align,dtype,nchw", [
    ((8, 129, 129, 21), (513, 513), True, torch.bfloat16, False),  # path
    ((8, 129, 129, 21), (513, 513), True, torch.bfloat16, True),   # NCHW
    ((2, 65, 97, 150), (257, 385), False, torch.bfloat16, False),
    ((1, 4, 3000, 150), (6, 300), True, torch.float32, False),  # chunks
])
def test_argmax_mask_counts_to_the_eval_kernels_counts(device, shape, out_hw,
                                                       align, dtype, nchw):
    """Kernel 1's mask, counted against seeded labels with plain torch,
    gives kernel 3's counts on the same logits and labels (the two run the
    same staged argmax), and a planted tie keeps the lower class."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 7] = x[..., 3]  # class 3 must win every tie with class 7
    logits = torch.from_numpy(x).to(device=device, dtype=dtype)
    if nchw:
        logits = logits.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    labels = torch.from_numpy(rng.integers(0, shape[-1], (shape[0],)
                                           + out_hw)).to(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = ua.argmax_plan(*shape, *out_hw, align, logits.element_size(), sms)
    if shape[-1] == 150 and shape[1] == 4:
        assert plan.chunk < shape[-1] and plan.band_rows == 1
    _check(logits, out_hw, align)
    mask = ua.fused_upsample_argmax(logits, out_hw, align_corners=align)
    from pytorch_segmentation_tpu_torch.ops.metrics import confusion_update
    want = ec.fused_eval_confusion(logits, labels, shape[0],
                                   align_corners=align)
    for a, b in zip(confusion_update(mask, labels, shape[-1]), want):
        assert torch.equal(a, b)
    assert not bool((mask == 7).any())


def test_resample_wrapper_rejects_what_the_kernel_does_not_take(device):
    planes, coords, use_bil = _resample_inputs(2, 8, 8, 8, device)
    with pytest.raises(TypeError):
        br.banded_resample_rows(planes.float(), coords, use_bil)
    with pytest.raises(TypeError):
        br.banded_resample_rows(planes, coords.double(), use_bil)
    with pytest.raises(TypeError):
        br.banded_resample_rows(planes, coords, use_bil.int())
    with pytest.raises(TypeError):
        br.banded_resample_rows(planes, coords, use_bil,
                                out_dtype=torch.float16)
    with pytest.raises(ValueError):
        br.banded_resample_rows(planes, coords.cpu(), use_bil)
    before = br.launch_count()
    with pytest.raises(ValueError):
        br.banded_resample_rows(planes[:, :3], coords, use_bil)
    assert br.launch_count() == before


def _eval_inputs(shape, out_hw, dtype, device, label_dtype=torch.int32,
                 seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, shape[-1], (shape[0],) + out_hw))
    return (x.to(device=device, dtype=dtype),
            y.to(device=device, dtype=label_dtype))


def _eval_check(x, y, valid, align):
    """The kernel's counts equal the plain version's exactly (integers; the
    two interpolate in the same f32 order, H then W), a second launch gives
    the same bits, and every counted pixel is counted once."""
    before = ec.launch_count()
    got = ec.fused_eval_confusion(x, y, valid, align_corners=align)
    assert ec.launch_count() == before + 1
    want = ec.eval_confusion_reference(x, y, valid, align)
    again = ec.fused_eval_confusion(x, y, valid, align_corners=align)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, again):
        assert g.dtype == torch.float32 and g.shape == (x.shape[-1],)
        assert torch.equal(g, w) and torch.equal(g, a)
    return got


# lse from the forward kernel against the plain f32 logsumexp of the
# upsampled logits: both f32 with |lse| < 12, they differ by the online
# recurrence against torch's, and another interpolation order: a few ulps
LSE_TOL = 1e-5


def _lse_check(x, y, align):
    """The forward kernel alone: lse against the plain per-pixel
    logsumexp, the per-sample sums against the plain per-pixel losses (1e-5
    relative: f32 sums of up to 263,169 pixels in another order). ->
    (sums, lse)."""
    before = ce.launch_count()["fwd"]
    sums, lse, _ = ce._launch_fwd(x.detach(), y, align, want_lse=True)
    assert ce.launch_count()["fwd"] == before + 1
    up = resize_bilinear(x.detach().float(), tuple(y.shape[1:]),
                         align_corners=align)
    want = torch.logsumexp(up, dim=-1)
    del up
    assert lse.shape == want.shape and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) <= LSE_TOL
    per_pixel = ce._per_pixel_reference(x.detach(), y, align)
    torch.testing.assert_close(sums, per_pixel.sum(dim=(1, 2)), rtol=1e-5,
                               atol=0)
    return sums, lse


@pytest.mark.parametrize("shape,out_hw,align,dtype,label_dtype", [
    ((32, 129, 129, 21), (513, 513), True, torch.bfloat16, torch.int32),
    ((4, 129, 129, 21), (513, 513), True, torch.float32, torch.int64),
    ((2, 65, 97, 150), (257, 385), False, torch.bfloat16, torch.int64),
    ((2, 33, 33, 81), (129, 129), True, torch.float32, torch.int32),
    ((1, 1, 1, 1), (1, 1), True, torch.float32, torch.int32),
    ((1, 1, 1, 3), (5, 7), False, torch.bfloat16, torch.uint8),
    ((3, 4, 5, 2), (4, 5), True, torch.float32, torch.int64),   # same size
    ((1, 20, 30, 21), (7, 9), True, torch.float32, torch.int32),  # downsample
    ((1, 5, 5, 4096), (9, 9), True, torch.bfloat16, torch.int32),  # the limit
    # bands of one row, 18 column tiles and class chunks: each pixel's
    # argmax carried from chunk to chunk
    ((1, 4, 3000, 150), (6, 300), True, torch.float32, torch.int32),
    # the limit at the path's output size: a 48 KB table, above 48 KB of
    # shared memory
    ((1, 129, 129, 4096), (513, 513), True, torch.bfloat16, torch.int32),
    # PSPNet's and FastFCN's eval logits: 8x with taps of 1/8
    ((32, 65, 65, 21), (513, 513), True, torch.bfloat16, torch.int32),
    # UPerNet's aux logits' shape: 16x, align_corners=False, taps of 1/32
    ((32, 32, 32, 21), (512, 512), False, torch.bfloat16, torch.int32),
])
def test_eval_kernel_equals_plain(device, shape, out_hw, align, dtype,
                                  label_dtype):
    x, y = _eval_inputs(shape, out_hw, dtype, device, label_dtype)
    b = shape[0]
    tp, fn, fp = _eval_check(x, y, b, align)
    pixels = b * out_hw[0] * out_hw[1]
    assert float((tp + fn).sum()) == pixels == float((tp + fp).sum())


def test_eval_kernel_masks_samples_and_labels_outside(device):
    x, y = _eval_inputs((6, 17, 19, 5), (65, 73), torch.bfloat16, device)
    y[0, :4] = 255
    y[1, 5:7] = -1
    y[5, 0, 0] = 5
    full = _eval_check(x, y, 6, True)
    outside = 4 * 73 + 2 * 73 + 1
    assert float((full[0] + full[1]).sum()) == 6 * 65 * 73 - outside
    assert float((full[0] + full[2]).sum()) == 6 * 65 * 73
    first4 = _eval_check(x, y, 4, True)
    mask = torch.tensor([True, True, False, True, True, False], device=device)
    holes = _eval_check(x, y, mask, True)
    assert float((holes[0] + holes[2]).sum()) == 4 * 65 * 73
    direct = ec.fused_eval_confusion(x[mask], y[mask], 4)
    for a, b in zip(holes, direct):
        assert torch.equal(a, b)
    assert not torch.equal(first4[0], holes[0])
    none = _eval_check(x, y, 0, True)
    assert all(float(v.sum()) == 0 for v in none)


def test_eval_kernel_reads_strides_and_ties(device):
    x = torch.randn(2, 6, 17, 19, device=device)   # NCHW memory
    x[:, 5] = x[:, 2]                              # class 2 must beat 5
    nhwc = x.permute(0, 2, 3, 1)                   # strided NHWC view
    y = torch.randint(0, 6, (2, 40, 50), device=device)
    got = _eval_check(nhwc, y, 2, True)
    for a, b in zip(got, ec.fused_eval_confusion(nhwc.contiguous(), y, 2)):
        assert torch.equal(a, b)
    assert float(got[0][5]) == 0 and float(got[2][5]) == 0
    _eval_check(nhwc[:, ::2, 1:], y[:, :31, :37], 2, False)  # sliced view
    # the counts are those of the argmax kernel's mask
    mask = ua.fused_upsample_argmax(nhwc, (40, 50))
    from pytorch_segmentation_tpu_torch.ops.metrics import confusion_update
    for a, b in zip(got, confusion_update(mask, y, 6)):
        assert torch.equal(a, b)


def test_eval_wrapper_rejects_what_the_kernel_does_not_take(device):
    x, y = _eval_inputs((1, 4, 4, 3), (8, 8), torch.float32, device)
    with pytest.raises(TypeError):
        ec.fused_eval_confusion(x.half(), y, 1)
    with pytest.raises(TypeError):
        ec.fused_eval_confusion(x, y.float(), 1)
    with pytest.raises(ValueError):
        ec.fused_eval_confusion(x, y.cpu(), 1)
    before = ec.launch_count()
    wide = torch.zeros((1, 2, 2, ec.MAX_CLASSES + 1), device=device)
    with pytest.raises(ValueError, match="at most 4096"):
        ec.fused_eval_confusion(wide, y, 1)
    assert ec.launch_count() == before


def test_small_eval_on_card_matches_cpu(device, tmp_path, monkeypatch):
    """`test()` over an in-memory dataset with a padded last batch: the
    fused route on the card (both kernels) against the CPU (their plain
    versions), small f32 model, TF32 off. Counts may differ only by pixels
    whose top-2 gap is below twice the logit difference between the
    devices: none at this seed."""
    import json

    from pytorch_segmentation_tpu_torch.data import (DataLoader, Fetcher,
                                                     PostFetch)
    from pytorch_segmentation_tpu_torch.engine import test as run_test
    monkeypatch.chdir(tmp_path)

    class Dataset:
        classes = [f"c{i}" for i in range(5)]

        def __init__(self):
            rng = np.random.default_rng(3)
            self.x = rng.integers(0, 256, (6, 65, 65, 3), dtype=np.uint8)
            self.y = rng.integers(0, 5, (6, 65, 65)).astype(np.uint8)

        def __len__(self):
            return 6

        def __getitem__(self, i):
            return self.x[i], self.y[i]

    def run(dev):
        m = build_model("deeplabv3plus", 5, backbone_layers=(1, 1, 1, 1),
                        dtype=torch.float32, full_res_output=True)
        m = load_model_bundle(m, None, dev, seed=0)
        fetcher = Fetcher(DataLoader(Dataset(), 4, num_workers=1),
                          PostFetch(device=dev))
        path = str(tmp_path / f"{torch.device(dev).type}.json")
        miou = run_test(m, fetcher, log=False, report_path=path, device=dev)
        return miou, json.load(open(path))

    cpu_miou, cpu = run("cpu")
    before = (ec.launch_count(), ce.launch_count()["fwd"], ua.launch_count())
    gpu_miou, gpu = run(device)
    after = (ec.launch_count(), ce.launch_count()["fwd"], ua.launch_count())
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 1)
    assert abs(gpu_miou - cpu_miou) <= 1e-6
    assert abs(gpu["val_loss"] - cpu["val_loss"]) <= 1e-5 * cpu["val_loss"]
    for g, c in zip(gpu["per_class"], cpu["per_class"]):
        assert (g["tp"], g["fn"], g["fp"]) == (c["tp"], c["fn"], c["fp"])


# ---------------------------------------------------------------- fused 1x1

def _fused_check(n, k, m, dtype, act, device, seed=0):
    """Kernels against the plain forward and backward on the same tensors,
    cotangents on all three outputs. bf16: y within one ulp, dx within two
    plus what one flipped dy_tot entry moves; vectors and dW to 1e-3 of
    their largest entry (chip_smoke.fused_case has the reasons)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = rand(n, k).to(dtype).requires_grad_(True)
    scale = (0.5 + torch.rand(k, generator=gen, device=device)
             ).requires_grad_(True)
    shift = (0.2 * rand(k)).requires_grad_(True)
    w = (0.1 * rand(k, m)).requires_grad_(True)
    cts = (rand(n, m).to(dtype), 0.01 * rand(m), 0.001 * rand(m))
    before = fm.launch_count()
    out = fm.fused_bn_act_matmul(x, scale, shift, w, act=act)
    grads = torch.autograd.grad(out, (x, scale, shift, w), cts)
    assert fm.launch_count() == {key: v + 1 for key, v in before.items()}
    with torch.no_grad():
        ref = fm.bn_act_matmul_reference(x, scale, shift, w, act)
        ref_grads = fm.bn_act_matmul_backward_reference(x, scale, shift, w,
                                                        *cts, act)
        mask = fm._act_grad_mask(x.float() * scale + shift, act)
    torch.cuda.synchronize()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for got, want, ulps, extra in (
            (out[0], ref[0], 1, 0.0),
            (grads[0], ref_grads[0], 2,
             ulp * float(cts[0].abs().max() + 1) * float(w.abs().max())
             * float(scale.abs().max()))):
        assert got.dtype == dtype and got.shape == want.shape
        got, want = got.float(), want.float()
        allowed = (ulps * ulp * want.abs() + 1e-5 * float(want.abs().max())
                   + extra)
        assert bool(((got - want).abs() <= allowed).all())
    for got, want in zip((*out[1:], *grads[1:]), (*ref[1:], *ref_grads[1:])):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-3 * float(
            want.abs().max())
    assert not bool((grads[0][~mask] != 0).any())


@pytest.mark.parametrize("n,k,m,dtype,act", [
    (1, 8, 8, torch.float32, "relu"),           # one row, the narrowest
    (127, 8, 8, torch.bfloat16, "none"),        # one short of a row tile
    (129, 24, 144, torch.bfloat16, "relu6"),    # one over; ragged K, M tiles
    (300, 144, 24, torch.float32, "relu6"),
    (1000, 136, 72, torch.bfloat16, "relu"),    # K, M one vector over a tile
    (4161, 64, 256, torch.bfloat16, "relu"),
    (513, 256, 64, torch.float32, "none"),
    (700, 2048, 512, torch.bfloat16, "relu"),   # the path's deepest product
    # PSPNet's dilated stages at batch 32, 513x513: 135,200 rows
    (135200, 1024, 256, torch.bfloat16, "relu"),
    (135200, 512, 2048, torch.bfloat16, "relu"),
    # UPerNet-R50's smallest stage at batch 32, 512x512 (not dilated): 8192
    (8192, 2048, 512, torch.bfloat16, "relu"),
    (8192, 512, 2048, torch.bfloat16, "relu"),
])
def test_fused_kernels_match_plain(device, n, k, m, dtype, act):
    _fused_check(n, k, m, dtype, act, device)


@pytest.mark.parametrize("n,k,m,act", [
    (4097, 1024, 256, "relu"),    # a wide shape, rows ending inside a tile
    (2000, 64, 256, "relu6"),     # a narrow stage-1 shape, 64-wide tiles
    (77, 24, 144, "none"),        # fewer rows than a tile, ragged K and M
    # both tile widths of the Hopper kernels (`wgmma_tiles`: 64 for a
    # matrix 64 wide or less, else 128) at widths that are multiples of
    # neither, in each of the three kernels
    (1000, 328, 264, "relu"), (1000, 328, 56, "relu"),
    (1000, 56, 264, "relu"),
])
def test_hopper_launchers_match_plain(device, n, k, m, act):
    """The bf16 forward and dx launchers (the Hopper kernels; dx as its two
    grids) against the plain versions: y and dy_tot within one bf16 ulp, dx
    within two plus the inherited floor, the sums to 1e-3 of their largest
    entry, no gradient where the mask is off; two launches bit-equal."""
    gen = torch.Generator(device=device).manual_seed(3)
    rand = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = rand(n, k).bfloat16()
    scale = 0.5 + torch.rand(k, generator=gen, device=device)
    shift = 0.2 * rand(k)
    wc = (0.1 * rand(k, m)).bfloat16()
    wt = wc.t().contiguous()
    dy, dsum, dsumsq = rand(n, m).bfloat16(), 0.01 * rand(m), 0.001 * rand(m)
    with torch.no_grad():
        ry, rs, rss = fm.bn_act_matmul_reference(x, scale, shift, wc, act)
        rdx, rdsc, rdsh, rdy_tot = fm.bn_act_matmul_dx_reference(
            x, scale, shift, wc, dy, dsum, dsumsq, act)
        mask = fm._act_grad_mask(x.float() * scale + shift, act)
        runs = [(fm._launch_fwd(x, scale, shift, wc, act, wt),
                 fm._launch_bwd_dx(x, scale, shift, wc, dy, dsum, dsumsq,
                                   act, wt))
                for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip((*runs[0][0], *runs[0][1]), (*runs[1][0], *runs[1][1])):
        assert torch.equal(a, b)
    (y, s, ss), (g, dsc, dsh, dy_tot) = runs[0]
    ulp = 2.0 ** -7
    floor = ulp * float(rdy_tot.abs().max()) * float(wc.abs().max()) * float(
        scale.abs().max())

    def close(got, want, ulps, extra=0.0):
        got, want = got.float(), want.float()
        allowed = (ulps * ulp * want.abs() + 1e-5 * float(want.abs().max())
                   + extra)
        return bool(((got - want).abs() <= allowed).all())

    def sums_close(got, want):
        return float((got - want).abs().max()) <= 1e-3 * float(
            want.abs().max())

    assert y.dtype == torch.bfloat16 and close(y, ry, 1)
    assert sums_close(s, rs) and sums_close(ss, rss)
    assert close(dy_tot, rdy_tot, 1) and close(g, rdx, 2, floor)
    assert sums_close(dsc, rdsc) and sums_close(dsh, rdsh)
    assert not bool((g[~mask] != 0).any())


def test_fused_kernels_are_reproducible_and_count_copies(device):
    gen = torch.Generator(device=device).manual_seed(1)
    nchw = torch.randn(2, 64, 9, 11, generator=gen, device=device
                       ).bfloat16()
    x = nchw.permute(0, 2, 3, 1)                  # rows not contiguous
    scale = torch.rand(64, generator=gen, device=device) + 0.5
    shift = torch.randn(64, generator=gen, device=device) * 0.2
    w = (torch.randn(64, 128, generator=gen, device=device) * 0.1
         ).requires_grad_(True)
    fm.reset_layout_copy_count()
    runs = []
    for _ in range(2):
        xr = x.detach().requires_grad_(True)
        out = fm.fused_bn_act_matmul(xr, scale, shift, w)
        cts = (torch.ones_like(out[0]), torch.ones_like(out[1]),
               torch.ones_like(out[2]))
        runs.append((*out, *torch.autograd.grad(out, (xr, w), cts)))
    assert fm.layout_copy_count() == 2
    assert runs[0][0].shape == (2, 9, 11, 128)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # the same values from channels_last memory, without a copy
    cl = nchw.contiguous(memory_format=torch.channels_last)
    y, s, ss = fm.fused_bn_act_matmul(cl.permute(0, 2, 3, 1), scale, shift, w)
    assert fm.layout_copy_count() == 2
    assert torch.equal(y, runs[0][0]) and torch.equal(s, runs[0][1])


def test_fused_wrapper_rejects_what_the_kernels_do_not_take(device):
    ok = (torch.ones(16, device=device), torch.zeros(16, device=device),
          torch.zeros(16, 8, device=device))
    before = fm.launch_count()
    with pytest.raises(TypeError):
        fm.fused_bn_act_matmul(torch.zeros(4, 16, device=device).half(), *ok)
    with pytest.raises(TypeError):   # f64 only on the CPU (gradient checks)
        fm.fused_bn_act_matmul(torch.zeros(4, 16, device=device).double(),
                               *ok)
    with pytest.raises(ValueError):
        fm.fused_bn_act_matmul(torch.zeros(4, 16, device=device), ok[0].cpu(),
                               *ok[1:])
    with pytest.raises(ValueError):
        fm.fused_bn_act_matmul(torch.zeros(4, 20, device=device),
                               torch.ones(20, device=device),
                               torch.zeros(20, device=device),
                               torch.zeros(20, 8, device=device))
    assert fm.launch_count() == before


def test_fused_bottleneck_on_card_matches_cpu(device):
    """The folded Bottleneck, f32, on the card (kernels) against the CPU
    (plain versions) from the same weights: output, gradients, buffers."""
    import copy
    torch.manual_seed(0)
    block = Bottleneck(32, 16, downsample=True, dtype=torch.float32)
    x = torch.relu(torch.randn(2, 32, 9, 9))
    blocks.set_force_fused_1x1("on")
    try:
        results = []
        for dev in ("cpu", device):
            m = copy.deepcopy(block).to(dev,
                                        memory_format=torch.channels_last)
            before = fm.launch_count()
            y = m.train()(x.to(dev).contiguous(
                memory_format=torch.channels_last))
            grads = torch.autograd.grad((y ** 2).sum(), list(m.parameters()))
            used = {k: v - before[k] for k, v in fm.launch_count().items()}
            assert set(used.values()) == {0 if dev == "cpu" else 2}
            results.append(([y.detach().cpu()] + [g.cpu() for g in grads],
                            {k: v.cpu() for k, v in m.state_dict().items()}))
    finally:
        blocks.set_force_fused_1x1(None)
    for a, b in zip(*(r[0] for r in results)):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max()) + 1e-5
    for name, v in results[0][1].items():
        assert torch.allclose(results[1][1][name].float(), v.float(),
                              rtol=1e-4, atol=1e-5), name


@pytest.mark.parametrize("n,k,m,act", [
    (1237, 24, 144, "relu6"),   # K < 64; the last split 213 of 256 rows
    (2000, 136, 64, "relu"),    # 64-wide M tile; the second K tile's
                                # second box lies past K (not loaded)
    (4133, 200, 264, "none"),   # ragged K and M tiles; a box of dy_tot past M
    (34849, 512, 200, "relu"),  # wide; the last split 33 of 1088 rows
    (5000, 1024, 512, "relu"),  # 32 tiles of 128 x 128, 8 splits
])
def test_dw_kernel_matches_plain(device, n, k, m, act):
    """The bf16 dW launcher (the Hopper kernel over its split of N, the
    partials summed) against the plain version on the same dy_tot: to 1e-3
    of the largest entry; two launches bit-equal. Every shape here has a
    last split shorter than the others, which ends inside a stage."""
    gen = torch.Generator(device=device).manual_seed(5)
    rand = lambda *s: torch.randn(*s, generator=gen, device=device)
    x = rand(n, k).bfloat16()
    scale = 0.5 + torch.rand(k, generator=gen, device=device)
    shift = 0.2 * rand(k)
    dy_tot = rand(n, m).bfloat16()
    splits, rows = fm.dw_split(n, k, m)
    last = n - (splits - 1) * rows
    assert splits > 1 and last < rows and last % 64
    before = fm.launch_count()["bwd_dw"]
    with torch.no_grad():
        got = fm._launch_bwd_dw(x, scale, shift, dy_tot, act)
        again = fm._launch_bwd_dw(x, scale, shift, dy_tot, act)
        want = fm.bn_act_matmul_dw_reference(x, scale, shift, dy_tot, act)
    torch.cuda.synchronize()
    assert fm.launch_count()["bwd_dw"] == before + 2
    assert got.dtype == torch.float32 and got.shape == (k, m)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    assert torch.equal(got, again)


# ----------------------------------------------------------- channels-major

def _small_ints(rows, cols, seed):
    """Integers in [-4, 4]: exact in bf16, and their products' sums over a
    few hundred terms exact in f32."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-4, 5, (rows, cols), generator=gen).float()


@pytest.mark.parametrize("rows,cols,depth", [(128, 128, 128),
                                             (200, 136, 72)])
@pytest.mark.parametrize("a_mn,b_mn", [(False, False), (False, True),
                                       (True, False), (True, True)])
def test_wgmma_majorness_products(device, rows, cols, depth, a_mn, b_mn):
    """The Hopper loop's product C = A @ B with A and B each K-major (the
    depth contiguous) or MN-major (the rows of A, the columns of B
    contiguous): the forward and dx read (K, K), the channels-major product
    (K, MN), dW (MN, MN). Small integers, so the product is exact: a wrong
    shared-memory descriptor shows here as a wrong entry. 200 x 136 x 72
    leaves ragged tiles in all three extents and a box of B wholly past its
    columns."""
    a, b = _small_ints(rows, depth, 0), _small_ints(depth, cols, 1)
    want = (a.double() @ b.double()).float()
    a_in = (a.t() if a_mn else a).contiguous().to(device, torch.bfloat16)
    b_in = (b if b_mn else b.t()).contiguous().to(device, torch.bfloat16)
    got = cm.wgmma_product(a_in, b_in, a_mn, b_mn)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rows, cols)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("co,ci,pix", [
    (64, 256, 4096), (256, 64, 4104), (24, 8, 8), (130, 40, 1000),
    # both tile forms (co <= 64: the warpgroups split the pixels) with
    # ragged co, pixels and depth
    (40, 200, 1000), (200, 72, 1000),
])
def test_cmajor_kernel_matches_plain(device, co, ci, pix):
    gen = torch.Generator(device=device).manual_seed(0)
    w = torch.randn(co, ci, generator=gen, device=device).bfloat16()
    x = torch.randn(ci, pix, generator=gen, device=device).bfloat16()
    before = cm.launch_count()
    got = cm.cmajor_matmul(w, x)
    assert cm.launch_count() == before + 1
    want = cm.cmajor_matmul_reference(w, x)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (co, pix)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, cm.cmajor_matmul(w, x))
    with pytest.raises(ValueError):
        cm.cmajor_matmul(w, x.t().contiguous().t())   # pixels not contiguous


def test_cli_train_resume_test_inference_on_card(device, tmp_path,
                                                 monkeypatch):
    """The command lines on the card at a small size, from PNG files: train
    (one epoch), train --resume (to two), test on best.pt and inference,
    each through its module's `main` with no device given. The augmented
    train steps, the per-epoch eval and the test run kernels 1-4; the test
    CLI's mIoU is engine.test's, the inference CLI's masks inference()'s."""
    import json
    import os

    from pytorch_segmentation_tpu_torch import inference as infer_cli
    from pytorch_segmentation_tpu_torch import test as test_cli
    from pytorch_segmentation_tpu_torch import train as train_cli
    from pytorch_segmentation_tpu_torch.data import (CocoDataset, DataLoader,
                                                     Fetcher, PostFetch)
    from pytorch_segmentation_tpu_torch.engine import test as engine_test
    from pytorch_segmentation_tpu_torch.utils.imgcodecs import imread
    from pytorch_segmentation_tpu_torch.utils.synthetic import (
        make_synthetic_coco)

    monkeypatch.chdir(tmp_path)
    data = make_synthetic_coco(str(tmp_path / "coco"), 8, 4, (96, 72),
                               seed=2, num_classes=4)
    argv = [data, "--model", "deeplabv3plus", "--dataset", "coco", "-s",
            "64", "64", "-bs", "4", "-a", "1", "-mp", "--num-workers", "2"]
    kernels = (ua, ce, br, ec)
    for kernel in kernels:
        kernel.reset_launch_count()
    first = train_cli.main(argv + ["--epochs", "1"])
    resumed = train_cli.main(argv + ["--epochs", "2", "--resume"])
    assert (first.epoch, resumed.epoch, resumed.state.step) == (1, 2, 4)
    miou = test_cli.main([os.path.join(data, "val.json"), "--weights",
                          "weights/best.pt", "-s", "64", "64", "-bs", "4"])
    os.makedirs("imgs")
    for name in ("val_0000.jpg", "val_0001.jpg", "val_0002.jpg"):
        os.symlink(os.path.join(data, name), os.path.join("imgs", name))
    masks = infer_cli.main(["imgs", "out", "-s", "64", "64", "-nc", "5",
                            "--weights", "weights/best.pt", "-bs", "3"])
    assert ua.launch_count() == 3          # a picture per test() call
    assert ce.launch_count() == {"fwd": 4 + 3, "bwd": 4}
    assert br.launch_count() == 8 and ec.launch_count() == 3
    with open("runs/log.jsonl") as f:
        val = [json.loads(line) for line in f if "val_miou" in line]
    assert [r["epoch"] for r in val] == [0, 1]

    model = load_model_bundle(build_model("deeplabv3plus", 5),
                              "weights/best.pt", device)
    val_set = CocoDataset(os.path.join(data, "val.json"), img_size=(64, 64),
                          augments=False)
    assert miou == engine_test(model, Fetcher(DataLoader(val_set, 4),
                                              PostFetch(device=device)),
                               device=device, show_first_batch=False)
    imgs = [imread(os.path.join("imgs", n)) for n in sorted(masks)]
    want = infer_cli.inference(model, imgs, (64, 64))
    for (name, mask), img, w in zip(sorted(masks.items()), imgs, want):
        assert mask.shape == img.shape[:2] == (72, 96)
        assert np.array_equal(mask, w), name
