"""PyTorch port: the train, test and inference command lines and the
Trainer's resume, warmup and profile (CPU).

- Each port CLI has the root CLI's flags with their defaults (read from the
  root files' `add_argument` calls), and each flag whose machinery is not
  ported exits with status 2 naming its ROADMAP item; `main` passes every
  `train()` keyword (the pattern of tests/test_cli_wiring.py).
- `inference()` against the JAX `inference()` on a one-convolution model
  and its torch twin with the weights carried across: masks equal wherever
  the top-2 probability gap is above GAP. The images are the model size or
  twice it, where the u8 resizes of both packages are exact.
- `Trainer(resume=True)`: 2 + 2 epochs equal 4 straight, to RESUME_TOL.
- One CPU run of train (1 epoch) -> train --resume (to 2) -> test ->
  inference on a shallow DeepLabV3+ (one block a stage) at -s 64 64 from
  PNG files.
"""

import ast
import json
import os
import os.path as osp

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.engine.trainer import ModelBundle
from pytorch_segmentation_tpu.inference import inference as jax_inference
from pytorch_segmentation_tpu_torch import inference as tinference
from pytorch_segmentation_tpu_torch import test as ttest
from pytorch_segmentation_tpu_torch import train as ttrain
from pytorch_segmentation_tpu_torch.data import (CocoDataset, DataLoader,
                                                 Fetcher, PostFetch)
from pytorch_segmentation_tpu_torch.data.colormap import colorize_mask
from pytorch_segmentation_tpu_torch.data.resize_host import resize_u8
from pytorch_segmentation_tpu_torch.engine import test as engine_test
from pytorch_segmentation_tpu_torch.engine.checkpoint import load_model_bundle
from pytorch_segmentation_tpu_torch.engine.trainer import Trainer
from pytorch_segmentation_tpu_torch.models import DeepLabV3Plus, build_model
from pytorch_segmentation_tpu_torch.nn import blocks as tblocks
from pytorch_segmentation_tpu_torch.utils.imgcodecs import imread
from pytorch_segmentation_tpu_torch.utils.synthetic import make_synthetic_coco

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
GAP = 1e-4
RESUME_TOL = 1e-6
CLIS = {"train.py": ttrain, "test.py": ttest, "inference.py": tinference}


def _root_flags(filename):
    """{option strings: default} of every add_argument call in a root CLI
    (store_true: False), read from its source without running it."""
    tree = ast.parse(open(osp.join(ROOT, filename)).read())
    flags = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            continue
        names = tuple(a.value for a in node.args)
        kw = {k.arg: k.value for k in node.keywords}
        if "default" in kw:
            default = eval(compile(ast.Expression(kw["default"]), "", "eval"))
        elif "action" in kw and kw["action"].value == "store_true":
            default = False
        else:
            default = None
        flags[names] = default
    return flags


@pytest.mark.parametrize("filename", sorted(CLIS))
def test_cli_has_the_root_flags_and_defaults(filename):
    want = _root_flags(filename)
    if filename == "inference.py":  # the port's checkpoints are .pt files
        assert want[("--weights",)] == "weights/best.ckpt"
        want[("--weights",)] = "weights/best.pt"
    parser = CLIS[filename].build_parser()
    got = {tuple(a.option_strings) or (a.dest,): a.default
           for a in parser._actions if a.dest != "help"}
    assert got == want


# a value away from the default, for each unported option that takes one
_VALUES = {"bn_subsample": "2", "loss": "dice",
           "class_weights": "1,2", "label_smoothing": "0.1", "ohem": "0.2",
           "cutmix": "0.5", "mosaic": "0.5", "distill": "t.pt",
           "distill_model": "fpn", "distill_variant": "b1",
           "distill_weight": "0.5", "distill_temp": "3", "tp": "2",
           "pp": "2", "ep": "2", "spatial": "2", "moe": "4",
           "calib_batches": "2"}
_POSITIONAL = {"train.py": ["data", "--model", "deeplabv3plus"],
               "test.py": ["val.json"], "inference.py": ["in", "out"]}
_REFUSED = [(f, n) for f in sorted(CLIS) for n in CLIS[f].UNPORTED]


@pytest.mark.parametrize("filename,name", _REFUSED,
                         ids=[f"{f[:-3]}-{n}" for f, n in _REFUSED])
def test_unported_flag_exits_2_naming_its_item(filename, name, capsys):
    flag = "--" + name.replace("_", "-")
    argv = _POSITIONAL[filename] + [flag]
    if name in _VALUES:
        argv.append(_VALUES[name])
    with pytest.raises(SystemExit) as err:
        CLIS[filename].parse_args(argv)
    assert err.value.code == 2
    item = CLIS[filename].UNPORTED[name][1]
    assert f"{flag} is not ported yet (ROADMAP queue 1 item {item}" in \
        capsys.readouterr().err


@pytest.mark.parametrize("filename", sorted(CLIS))
def test_unported_model_and_shapes_exit_2(filename, capsys):
    """A variant a family lacks and (train) non-square sizes exit 2; every
    one of the JAX CLIs' 17 model names parses, maskformer with its r50
    and tiny variants."""
    base = [a for a in _POSITIONAL[filename] if a not in ("--model",
                                                          "deeplabv3plus")]
    refused = [base + ["--model", "deeplabv3plus", "--variant", "r50"]]
    if filename == "train.py":
        refused += [base + ["--model", "deeplabv3plus", "-s", "64", "48"]]
    for argv in refused:
        with pytest.raises(SystemExit) as err:
            CLIS[filename].parse_args(argv)
        assert err.value.code == 2
    err = capsys.readouterr().err
    assert "has no variants" in err
    if filename == "train.py":
        assert "square images only so far (ROADMAP queue 1 item 8" in err
        assert CLIS[filename].parse_args(base).model == "unet"  # the default
    names = [a.choices for a in CLIS[filename].build_parser()._actions
             if a.dest == "model"][0]
    assert len(names) == 17
    for model in names:
        opt = CLIS[filename].parse_args(base + ["--model", model])
        assert opt.model == model
    for variant in ("r50", "tiny"):
        opt = CLIS[filename].parse_args(base + ["--model", "maskformer",
                                                "--variant", variant])
        assert (opt.model, opt.variant) == ("maskformer", variant)


@pytest.mark.parametrize("cli", ["train", "test", "inference", "serve"])
def test_scan_blocks_takes_segformer_only(cli, tmp_path, capsys,
                                          monkeypatch):
    """Each command line takes `--scan-blocks` with `--model segformer` and
    builds the stacked layout from it; with another family it exits 2 with
    the JAX CLIs' message."""
    from pytorch_segmentation_tpu_torch import serve as tserve
    weights = tmp_path / "w.pt"
    weights.touch()
    head = {"train": ["data"], "test": ["val.json"], "inference": ["in", "out"],
            "serve": ["--weights", str(weights)]}[cli]
    module = {"train": ttrain, "test": ttest, "inference": tinference,
              "serve": tserve}[cli]
    argv = head + ["--model", "segformer", "--variant", "tiny-d4",
                   "--scan-blocks"]
    opt = module.parse_args(argv)
    assert (opt.model, opt.scan_blocks) == ("segformer", True)
    with pytest.raises(SystemExit) as err:
        module.parse_args(head + ["--model", "pspnet", "--scan-blocks"])
    assert err.value.code == 2
    assert ("--scan-blocks targets the transformer family's stacked block "
            "stages (segformer)" in capsys.readouterr().err)

    class Built(Exception):
        pass

    class Data:
        classes = ["background", "a"]

        def __init__(self, *args, **kwargs):
            pass

        def __len__(self):
            return 4

    def build(name, num_classes, **kwargs):
        raise Built(build_model(name, num_classes, **kwargs))

    monkeypatch.setattr(module, "build_model", build)
    monkeypatch.setitem(ttrain.DATASETS, "coco", (Data, "train.json", ""))
    monkeypatch.setitem(ttest.DATASETS, "coco", Data)
    with pytest.raises(Built) as built:
        if cli == "train":
            ttrain.train("d", "segformer", 1, (64, 64), 2, 1, 1e-3, False,
                         False, "", 0, False, False, False, True, True,
                         variant="tiny-d4", scan_blocks=True,
                         dataset="coco", device="cpu")
        elif cli == "test":
            ttest.run(opt, "cpu")
        elif cli == "inference":
            tinference.run("in", str(tmp_path / "out"), (64, 64), 2, "",
                           "segformer", variant="tiny-d4", scan_blocks=True,
                           device="cpu")
        else:
            tserve.build_server(opt, "cpu")
    model = built.value.args[0]
    assert hasattr(model.backbone, "blocks3")
    assert not hasattr(model.backbone, "block3_0")


def test_train_main_passes_every_train_keyword():
    import inspect
    src = inspect.getsource(ttrain.main)
    for p in inspect.signature(ttrain.train).parameters:
        if p in ("data_dir", "model_name", "device"):
            continue  # data=opt.data, model=opt.model, the caller's device
        assert f"{p}=opt." in src, p
    assert "data_dir=opt.data" in src and "model_name=opt.model" in src
    with pytest.raises(NotImplementedError, match="--qat is not ported"):
        ttrain.train("d", "deeplabv3plus", 1, (64, 64), 2, 1, 1e-3, False,
                     False, "", 1, False, False, False, False, False,
                     qat=True, device="cpu")


class _JaxConv(fnn.Module):
    classes: int

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Conv(self.classes, (1, 1), name="conv")(x)


@pytest.mark.parametrize("legacy_preproc,tta", [(False, False), (True, True)],
                         ids=["imagenet", "legacy_flip"])
def test_inference_matches_jax(legacy_preproc, tta):
    classes, size_wh = 5, (24, 20)
    rng = np.random.default_rng(6)
    module = _JaxConv(classes)
    params = module.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 20, 24, 3)))["params"]
    kernel = np.asarray(params["conv"]["kernel"])
    twin = torch.nn.Conv2d(3, classes, 1)
    with torch.no_grad():
        twin.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        twin.bias.copy_(torch.from_numpy(
            rng.standard_normal(classes).astype(np.float32)))
    params = {"conv": {"kernel": kernel, "bias": twin.bias.detach().numpy()}}
    bundle = ModelBundle(module, params, {})
    # twice the model size, and the model size: exact u8 resizes in both
    imgs = [rng.integers(0, 256, (40, 48, 3), np.uint8),
            rng.integers(0, 256, (20, 24, 3), np.uint8),
            rng.integers(0, 256, (40, 48, 3), np.uint8)]
    want = jax_inference(bundle, imgs, size_wh, legacy_preproc=legacy_preproc,
                         tta_flip=tta)
    got = tinference.inference(twin.eval(), imgs, size_wh,
                               legacy_preproc=legacy_preproc, tta_flip=tta)
    infer = tinference.make_infer_fn(twin, legacy_preproc, tta_flip=tta)
    for img, g, w in zip(imgs, got, want):
        assert g.shape == w.shape == img.shape[:2]
        small = resize_u8(img, size_wh, "linear")[:, :, ::-1]
        probs = tinference.resize_probs(infer(small[None])[0],
                                        img.shape[:2]).numpy()
        ranked = -np.sort(-probs, axis=-1)
        clear = ranked[..., 0] - ranked[..., 1] > GAP
        assert clear.mean() > 0.9
        assert np.array_equal(g[clear], w[clear])
    with pytest.raises(NotImplementedError, match="quant.py"):
        tinference.inference(twin, imgs, size_wh, int8=True)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.block = tblocks.ConvNormAct(3, 8, dtype=torch.float32)
        self.cls_conv = torch.nn.Conv2d(8, 3, 1)

    def forward(self, x):
        return self.cls_conv(self.block(x))


class _Fetcher:
    """The same (images, segs, valid) batches every epoch."""

    def __init__(self, n, seed=0, hw=12):
        rng = np.random.default_rng(seed)
        self.batches = [(rng.standard_normal((2, hw, hw, 3), np.float32),
                         rng.integers(0, 3, (2, hw, hw)).astype(np.int32))
                        for _ in range(n)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return ((x, y, len(x)) for x, y in self.batches)


@pytest.mark.parametrize("adam", [False, True], ids=["sgd", "adam"])
def test_resume_equals_training_straight_through(tmp_path, adam):
    options = dict(adam=adam, lr=1e-2, lr_schedule="cosine", warmup_steps=2,
                   total_steps=12, ema_decay=0.9, weight_decay=1e-3,
                   device="cpu", log=False, log_dir=str(tmp_path / "runs"))

    def trainer(workdir, **extra):
        return Trainer(_Tiny(), _Fetcher(3), workdir=str(workdir), seed=4,
                       **options, **extra)

    straight = trainer(tmp_path / "a")
    for _ in range(4):
        straight.step()
    first = trainer(tmp_path / "b")
    for _ in range(2):
        first.step()
    first.metrics = 0.25
    first.save()
    resumed = trainer(tmp_path / "b", resume=True)
    assert (resumed.epoch, resumed.metrics, resumed.state.step) == (2, 0.25, 6)
    for _ in range(2):
        resumed.step()
    assert resumed.epoch == straight.epoch == 4
    assert resumed.state.step == straight.state.step == 12
    want, got = straight.module.state_dict(), resumed.module.state_dict()
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0,
                                   atol=RESUME_TOL)
    for name, value in straight.state.ema_params.items():
        torch.testing.assert_close(resumed.state.ema_params[name], value,
                                   rtol=0, atol=RESUME_TOL)
    want = straight.optimizer.state_dict()["state"]
    got = resumed.optimizer.state_dict()["state"]
    assert want.keys() == got.keys()
    for index in want:
        for key, value in want[index].items():
            torch.testing.assert_close(got[index][key], value, rtol=0,
                                       atol=RESUME_TOL)
    assert (resumed.optimizer.schedule(resumed.state.step)
            == straight.optimizer.schedule(straight.state.step))


def test_warmup_leaves_the_weights_and_profile_writes_a_trace(tmp_path,
                                                              capsys):
    trainer = Trainer(_Tiny(), _Fetcher(8), device="cpu", ema_decay=0.5,
                      profile=True, log_dir=str(tmp_path), seed=1)
    before = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    ema = {k: v.clone() for k, v in trainer.state.ema_params.items()}
    trainer.warmup([(12, 12), (16, 20)], batch_size=2, label_hw=(12, 12))
    assert "warmup: compiled train step @ 16x20" in capsys.readouterr().out
    for k, v in trainer.module.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in trainer.state.ema_params.items():
        assert torch.equal(v, ema[k]), k
    assert trainer.state.step == 0 and not trainer.optimizer.state_dict()[
        "state"]
    trainer.step()
    with open(tmp_path / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("convolution" in e.get("name", "") for e in events)


def _shallow(name, num_classes, **kwargs):
    return DeepLabV3Plus(num_classes=num_classes, backbone_layers=(1, 1, 1, 1),
                         **kwargs)


def test_cli_train_resume_test_inference_on_the_cpu(tmp_path, monkeypatch,
                                                    capsys):
    for module in CLIS.values():
        monkeypatch.setattr(module, "build_model", _shallow)
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "coco")
    make_synthetic_coco(data, num_train=4, num_val=2, img_size=(80, 60),
                        seed=1, num_classes=3)
    argv = [data, "--model", "deeplabv3plus", "--dataset", "coco",
            "-s", "64", "64", "-bs", "2", "-a", "1", "--num-workers", "2"]
    first = ttrain.main(argv + ["--epochs", "1"], device="cpu")
    assert first.epoch == 1 and first.state.step == 2
    saved = torch.load("weights/last.pt", weights_only=True)
    assert saved["epoch"] == 1 and saved["best_miou"] == first.metrics > 0
    resumed = ttrain.main(argv + ["--epochs", "2", "--resume"], device="cpu")
    with open("runs/log.jsonl") as f:
        records = [json.loads(line) for line in f]
    val = [r for r in records if "val_miou" in r]
    assert [r["epoch"] for r in val] == [0, 1]
    assert resumed.epoch == 2 and resumed.state.step == 4
    assert resumed.metrics == max(first.metrics, val[-1]["val_miou"])
    assert "save best, miou" in capsys.readouterr().out

    # test: the CLI's mIoU is engine.test's on the same weights and files
    miou = ttest.main([osp.join(data, "val.json"), "--weights",
                       "weights/best.pt", "-s", "64", "64", "-bs", "2",
                       "--num-workers", "1"], device="cpu")
    val_set = CocoDataset(osp.join(data, "val.json"), img_size=(64, 64),
                          augments=False)
    model = load_model_bundle(_shallow("deeplabv3plus", 4),
                              "weights/best.pt", "cpu")
    want = engine_test(model, Fetcher(DataLoader(val_set, 2),
                                      PostFetch(device="cpu")),
                       device="cpu", show_first_batch=False)
    assert miou == want and 0.0 <= miou <= 1.0

    # inference: the masks of inference() at each image's size, as PNGs
    os.makedirs("imgs")
    for name in ("val_0000.jpg", "val_0001.jpg"):
        os.link(osp.join(data, name), osp.join("imgs", name))
    masks = tinference.main(["imgs", "out", "-s", "64", "64", "-nc", "4",
                             "--weights", "weights/best.pt", "-bs", "2"],
                            device="cpu")
    imgs = [imread(osp.join("imgs", n)) for n in sorted(masks)]
    want = tinference.inference(model, imgs, (64, 64))
    for (name, mask), img, w in zip(sorted(masks.items()), imgs, want):
        assert mask.shape == img.shape[:2] == (60, 80)
        assert np.array_equal(mask, w)
        written = imread(osp.join("out", osp.splitext(name)[0] + ".png"))
        assert np.array_equal(written, colorize_mask(mask))
