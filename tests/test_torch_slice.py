"""PyTorch port: the serving slice (DeepLabV3+ forward, weights, make_mask_fn,
MaskServer) against the JAX package on the same seeded weights and inputs,
on the CPU. Sizes are cut for the test budget: ResNet layers (1,1,1,1),
5 classes, 65x65 images, f32 (and bf16 for the forward)."""

import json
import re
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.engine.trainer import ModelBundle
from pytorch_segmentation_tpu.inference import make_mask_fn as jax_make_mask_fn
from pytorch_segmentation_tpu.models import DeepLabV3Plus as JaxDeepLabV3Plus
from pytorch_segmentation_tpu.ops.resize import resize_bilinear as jax_resize
from pytorch_segmentation_tpu.utils.port_torch import (
    export_torch_state_dict, save_torch_checkpoint)
from pytorch_segmentation_tpu_torch.data.colormap import VOC_COLORMAP
from pytorch_segmentation_tpu_torch.data.pipeline import normalize_images
from pytorch_segmentation_tpu_torch.engine.checkpoint import load_model_bundle
from pytorch_segmentation_tpu_torch.inference import make_mask_fn
from pytorch_segmentation_tpu_torch.models import MODEL_REGISTRY, build_model
from pytorch_segmentation_tpu_torch.parallel import make_mesh
from pytorch_segmentation_tpu_torch.serving import MaskServer
from pytorch_segmentation_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
from pytorch_segmentation_tpu_torch.utils.png import decode_png, encode_png
from pytorch_segmentation_tpu_torch.utils.weights import (load_state,
                                                          state_dict_from_jax)
from torch_port_util import assert_masks_agree

torch.set_num_threads(1)

NC = 5
HW = 65
LAYERS = (1, 1, 1, 1)


JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_module(full_res_output, dtype=jnp.float32):
    return JaxDeepLabV3Plus(num_classes=NC, backbone_layers=LAYERS,
                            dtype=dtype, full_res_output=full_res_output)


def _seeded(tree, rng):
    """Numpy values for a flax shape tree: He-normal (fan-out) kernels,
    small biases, non-trivial BN affines and running statistics."""
    def leaf(path, s):
        names = [p.key for p in path]
        name, parent = names[-1], names[-2]
        if name == "kernel":
            fan_out = int(np.prod(s.shape[:2])) * s.shape[3]
            v = rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_out)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "mean" or (name == "bias" and parent == "bn"):
            v = 0.1 * rng.standard_normal(s.shape)
        else:  # the class conv's bias
            v = 0.01 * rng.standard_normal(s.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(params, batch_stats) numpy trees and the `.pt` the JAX package's
    save_torch_checkpoint writes from them."""
    shapes = jax.eval_shape(
        lambda k, x: _jax_module(False).init({"params": k}, x, train=False),
        jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 3), jnp.float32))
    rng = np.random.default_rng(0)
    params = _seeded(shapes["params"], rng)
    stats = _seeded(shapes["batch_stats"], rng)
    path = str(tmp_path_factory.mktemp("port") / "dlv3p.pt")
    save_torch_checkpoint(path, params, stats)
    return params, stats, path


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).integers(0, 256, (2, HW, HW, 3),
                                             dtype=np.uint8)


def _jax_logits(params, stats, images, full_res_output, dtype=jnp.float32):
    x = normalize_images(torch.from_numpy(images)).numpy()
    module = _jax_module(full_res_output, dtype)
    logits = jax.jit(lambda v, x: module.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x)
    assert logits.dtype == dtype
    return np.asarray(logits.astype(jnp.float32))


@pytest.fixture(scope="module")
def stride4_logits(weights, images):
    """The JAX model's stride-4 f32 logits [2, 17, 17, NC] on `images`."""
    return _jax_logits(weights[0], weights[1], images, False)


def _port_model(path, full_res_output=False, dtype=torch.float32):
    model = build_model("deeplabv3plus", NC, backbone_layers=LAYERS,
                        dtype=dtype, full_res_output=full_res_output)
    return load_model_bundle(model, path, "cpu")


def test_state_dict_equals_jax_export(weights):
    params, stats, _ = weights
    got = state_dict_from_jax(params, stats)
    want = export_torch_state_dict(params, stats)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_checkpoint_loads_strict(weights):
    params, stats, path = weights
    sd = load_state(path)
    model = build_model("deeplabv3plus", NC, backbone_layers=LAYERS,
                        dtype=torch.float32)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    want = state_dict_from_jax(params, stats)
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), want[k]), k
    # every model name of the JAX package builds, maskformer the last
    with torch.device("meta"):
        for name in MODEL_REGISTRY:
            assert build_model(name, NC).num_classes == NC, name
    assert len(MODEL_REGISTRY) == 17


@pytest.mark.parametrize("full_res_output,dtype", [
    pytest.param(False, torch.float32, id="False"),
    pytest.param(True, torch.float32, id="True"),
    pytest.param(False, torch.bfloat16, id="bf16")])
def test_forward_matches_jax(weights, images, stride4_logits,
                             full_res_output, dtype):
    """f32, and the served configuration: bf16 compute with f32 params and
    statistics on both sides."""
    params, stats, path = weights
    want = (stride4_logits if (full_res_output, dtype) == (False, torch.float32)
            else _jax_logits(params, stats, images, full_res_output,
                             JAX_DTYPES[dtype]))
    model = _port_model(path, full_res_output, dtype)
    with torch.inference_mode():
        got = model(normalize_images(torch.from_numpy(images))
                    .permute(0, 3, 1, 2))
    assert got.dtype == dtype
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape == ((2, 68, 68, NC) if full_res_output
                                       else (2, 17, 17, NC))
    assert np.isfinite(got).all()
    if dtype == torch.float32:
        # f32 on both sides; convolutions sum in another order
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    # bf16 forwards differ by a few ulps wherever a summation order tips a
    # rounding: at most 2% of the largest logit (~2.5 bf16 ulps there)
    # anywhere. A cast moved from where the JAX module puts it (BN applied
    # in f32, an f32 kernel) makes the two differ about as much as bf16
    # differs from f32; the mean bound, 40% of that, catches it.
    diff = np.abs(got - want)
    assert diff.max() <= 0.02 * np.abs(want).max(), diff.max()
    bf16_error = np.abs(want - stride4_logits).mean()
    assert diff.mean() <= 0.4 * bf16_error, (diff.mean(), bf16_error)
    # masks: off the TPU, JAX make_mask_fn is this f32 upsample and argmax.
    # The upsample is a convex combination in f32 on both sides, so a pixel
    # can only flip where its top-2 gap is below twice the logit difference
    up = np.asarray(jax_resize(jnp.asarray(want), (HW, HW),
                               align_corners=True))
    got_mask = make_mask_fn(model)(images)
    assert_masks_agree(got_mask.numpy(), up.argmax(-1), up,
                       gap=2 * float(diff.max()) + 1e-4, agreement=0.99)


@pytest.mark.parametrize("out_hw", [None, (80, 72)])
def test_make_mask_fn_matches_jax(weights, images, stride4_logits, out_hw):
    params, stats, path = weights
    bundle = ModelBundle(_jax_module(False), params, stats)
    want = np.asarray(jax_make_mask_fn(bundle, out_hw=out_hw)(images))
    got = make_mask_fn(_port_model(path), out_hw=out_hw)(images)
    assert got.dtype == torch.int32
    up = np.asarray(jax_resize(jnp.asarray(stride4_logits),
                               out_hw or (HW, HW), align_corners=True))
    assert_masks_agree(got.numpy(), want, up)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def test_mask_server_round_trip(weights, images):
    model = _port_model(weights[2])
    srv = MaskServer(model, img_size=(HW, HW), max_batch=2,
                     batch_window_ms=20.0)
    host, port = srv.start(port=0)[:2]
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            info = json.loads(r.read())
        assert info["status"] == "ok" and info["model"] == "DeepLabV3Plus"
        assert info["img_size"] == [HW, HW] and info["max_batch"] == 2

        # model-size request: the server's padded batch, run directly
        padded = np.zeros((2, HW, HW, 3), np.uint8)
        padded[0] = images[0]
        want = make_mask_fn(model, out_hw=(HW, HW))(padded)[0].numpy()
        raw = decode_png(_post(base + "/predict?format=raw",
                               encode_png(images[0])))
        assert raw.shape == (HW, HW)
        assert np.array_equal(raw.astype(np.int32), want)
        color = decode_png(_post(base + "/predict", encode_png(images[0])))
        assert np.array_equal(color, VOC_COLORMAP[want][:, :, ::-1])

        # another size: resized for the model, mask returned at its own
        other = np.random.default_rng(2).integers(0, 256, (40, 50),
                                                  dtype=np.uint8)  # gray
        mask = decode_png(_post(base + "/predict?format=raw",
                                encode_png(other)))
        assert mask.shape == (40, 50) and mask.max() < NC

        # a JPEG body: the mask of a PNG body holding its decoded pixels
        jpg = encode_jpeg(np.ascontiguousarray(images[1][:, :, ::-1]))
        pixels = np.ascontiguousarray(decode_jpeg(jpg)[:, :, ::-1])
        from_jpeg = decode_png(_post(base + "/predict?format=raw", jpg))
        from_png = decode_png(_post(base + "/predict?format=raw",
                                    encode_png(pixels)))
        assert from_jpeg.shape == (HW, HW)
        assert np.array_equal(from_jpeg, from_png)

        # a corrupt JPEG body and bytes of no image: 400
        for body in (b"not an image", b"\xff\xd8\xff\xe0 jpeg body",
                     jpg[:len(jpg) // 2]):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(base + "/predict", body)
            assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/other", encode_png(images[0]))
        assert err.value.code == 404

        def broken(_):
            raise ValueError("device fault")
        srv._mask_fn = broken  # a device error is a 500, never a 200
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/predict", encode_png(images[0]))
        assert err.value.code == 500
    finally:
        srv.stop()
    assert not srv._dispatcher.is_alive()


def test_unported_options_raise(weights, images):
    model = _port_model(weights[2])
    # test-time augmentation is ported: both options give masks
    plain = make_mask_fn(model)(images)
    for kw in (dict(tta_flip=True), dict(tta_scales=(0.75, 1.25))):
        mask = make_mask_fn(model, **kw)(images)
        assert mask.dtype == torch.int32 and mask.shape == plain.shape
        assert 0.5 < float((mask == plain).float().mean()) < 1.0
    # a one-device mesh serves the same masks
    assert torch.equal(
        make_mask_fn(model, mesh=make_mesh(devices=["cpu"]))(images), plain)
    # int8 serving is ported: the server's batches go through the int8
    # forward (the default gate quantizes the ResNet's deep convs)
    masks = MaskServer(model, int8=True, img_size=(HW, HW),
                       max_batch=2)._run_batch(images)
    assert masks.dtype == np.int32 and masks.shape == (2, HW, HW)
    assert 0.5 < float((masks == plain.numpy()).mean()) < 1.0


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pytorch_segmentation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'cv2', 'pytorch_segmentation_tpu'))\n"
        "assert not bad, bad\n"
        "new = ['ops.loss', 'ops.kernels.softmax_ce', 'engine.steps', "
        "'engine.trainer', 'ops.metrics', 'ops.kernels.eval_confusion', "
        "'ops.tta', 'ops.boundary', 'utils.visualize', 'engine.evaluate', "
        "'ops.kernels.fused_matmul_bn', 'ops.kernels.cmajor_matmul', "
        "'tools.bench_cmajor', 'tools.bench_fused_matmul']\n"
        "assert all(pkg.__name__ + '.' + n in names for n in new), names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30
    # torch imports tqdm where it is installed, so sys.modules cannot show
    # that the port does not: read its sources and the smoke script
    root = Path(__file__).resolve().parents[1]
    sources = list((root / "pytorch_segmentation_tpu_torch").rglob("*.py"))
    for src in sources + [root / "chip_smoke.py"]:
        assert not re.search(r"^\s*(import|from)\s+(tqdm|cv2|jax|flax)\b",
                             src.read_text(), re.M), src


def test_serve_cli_needs_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU refusal")
    from pytorch_segmentation_tpu_torch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--weights", weights[2], "--port", "0"])


def test_serve_cli_needs_weights(tmp_path, capsys):
    """No seeded fallback: a server without a checkpoint does not start."""
    from pytorch_segmentation_tpu_torch.serve import main
    for argv in ([], ["--weights", str(tmp_path / "missing.pt")]):
        with pytest.raises(SystemExit) as err:
            main(argv + ["--port", "0"])
        assert err.value.code == 2
    assert "missing.pt" in capsys.readouterr().err


def test_serve_cli_dp_serves_over_a_local_mesh(tmp_path):
    """`serve --dp` builds its server over the local mesh (on the CPU the
    one device asked for): its padded batch rounds up to the card count and
    its masks are those of the server without it."""
    from pytorch_segmentation_tpu_torch import serve
    from pytorch_segmentation_tpu_torch.engine.checkpoint import (
        save_checkpoint)
    from pytorch_segmentation_tpu_torch.utils.weights import (
        seeded_state_dict)
    path = str(tmp_path / "unet.pt")
    save_checkpoint(path, seeded_state_dict(build_model("unet", NC), seed=0))
    argv = ["--model", "unet", "-nc", str(NC), "-s", "64", "64",
            "--weights", path, "--max-batch", "3"]
    batch = np.random.default_rng(2).integers(0, 256, (3, 64, 64, 3),
                                              dtype=np.uint8)
    plain = serve.build_server(serve.parse_args(argv), "cpu")
    dp = serve.build_server(serve.parse_args(argv + ["--dp"]), "cpu")
    assert dp.max_batch == plain.max_batch == 3
    assert np.array_equal(dp._run_batch(batch), plain._run_batch(batch))


@pytest.mark.parametrize("argv,item", [
    (["--moe", "4"], 10), (["--moe-top-k", "1"], 10),
    (["--scan-blocks"], None)],
    ids=["moe", "moe-top-k", "scan-blocks"])
def test_serve_cli_refuses_unported_flags(argv, item, tmp_path, capsys):
    """The root serve CLI's flags whose machinery is not ported exit 2 and
    name their ROADMAP item (not argparse's 'unrecognized arguments').
    `--scan-blocks`, ported for segformer, exits 2 with the JAX CLI's
    message for the default model, deeplabv3plus."""
    from pytorch_segmentation_tpu_torch import serve
    weights = tmp_path / "w.pt"
    weights.touch()
    with pytest.raises(SystemExit) as err:
        serve.parse_args(["--weights", str(weights)] + argv)
    assert err.value.code == 2
    name = argv[0][2:].replace("-", "_")
    if item is None:
        assert ("--scan-blocks targets the transformer family's stacked "
                "block stages (segformer)" in capsys.readouterr().err)
        assert name not in serve.UNPORTED
        return
    assert (f"{argv[0]} is not ported yet (ROADMAP queue 1 item {item}"
            in capsys.readouterr().err)
    assert serve.UNPORTED[name][1] == item


def test_serve_cli_wires_tta_and_ema(tmp_path, monkeypatch):
    """--tta, --tta-scales and --ema reach MaskServer and load_model_bundle
    (the server is built on the CPU, around the checkpoint's EMA
    weights); without them, no TTA and the live weights."""
    from pytorch_segmentation_tpu_torch import serve
    from pytorch_segmentation_tpu_torch.engine.checkpoint import (
        save_checkpoint)
    from pytorch_segmentation_tpu_torch.utils.weights import (
        seeded_state_dict)

    class Tiny(torch.nn.Module):  # the wiring is the point, not the model
        def __init__(self, num_classes, **_):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, num_classes, 1)
            self.bn = torch.nn.BatchNorm2d(num_classes)

        def forward(self, x):
            return self.bn(self.conv(x))

    def small(name, num_classes, **kw):
        assert name == "deeplabv3plus" and kw["dtype"] == torch.bfloat16
        return Tiny(num_classes)

    model = Tiny(NC)
    live = seeded_state_dict(model, seed=1)
    ema = {k: v + 1.0 for k, v in live.items()
           if k in dict(model.named_parameters())}
    path = str(tmp_path / "ema.pt")
    save_checkpoint(path, model_state=live, ema=ema)

    calls = {}

    def recording(name, real):
        def call(*args, **kwargs):
            calls[name] = (kwargs, real(*args, **kwargs))
            return calls[name][1]
        return call

    monkeypatch.setattr(serve, "build_model", small)
    monkeypatch.setattr(serve, "load_model_bundle",
                        recording("bundle", serve.load_model_bundle))
    monkeypatch.setattr(serve, "MaskServer",
                        recording("server", serve.MaskServer))
    size = ["-nc", str(NC), "-s", str(HW), str(HW)]
    opt = serve.parse_args(["--weights", path, "--tta", "--tta-scales",
                            "0.75", "1.25", "--ema", *size])
    assert (opt.tta, opt.tta_scales, opt.ema) == (True, [0.75, 1.25], True)
    server = serve.build_server(opt, "cpu")
    assert server is calls["server"][1]
    assert calls["bundle"][0]["use_ema"] is True
    assert calls["server"][0]["tta_flip"] is True
    assert calls["server"][0]["tta_scales"] == (0.75, 1.25)
    params = dict(calls["bundle"][1].named_parameters())
    for key, value in ema.items():
        torch.testing.assert_close(params[key].float(), value.float())

    calls.clear()
    serve.build_server(serve.parse_args(["--weights", path, *size]), "cpu")
    assert calls["bundle"][0]["use_ema"] is False
    assert (calls["server"][0]["tta_flip"],
            calls["server"][0]["tta_scales"]) == (False, ())
    params = dict(calls["bundle"][1].named_parameters())
    for key in ema:
        torch.testing.assert_close(params[key].float(), live[key].float())
