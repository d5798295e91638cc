"""PyTorch port on the card: the hand-written upsample+argmax kernel against
its plain PyTorch version at edge shapes, and the small model against the
CPU. Skips without a CUDA device. On the card (no jax there, so without the
JAX-side conftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu_torch.data.pipeline import normalize_images
from pytorch_segmentation_tpu_torch.engine.checkpoint import load_model_bundle
from pytorch_segmentation_tpu_torch.inference import make_mask_fn
from pytorch_segmentation_tpu_torch.models import build_model
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
