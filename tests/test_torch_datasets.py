"""PyTorch port: the file-reading side of the data path against the JAX
package and OpenCV on the same files (CPU): `utils/imgcodecs.imread`
against `cv2.imread`, the numpy resizes against `cv2.resize`, the rasterizer (native
and numpy) and `mask_from_colors` against the JAX functions,
`make_synthetic_coco`'s JSON against the JAX one's, and the dataset classes'
records against the JAX classes' records (the JPEG codec's own tests are in
test_torch_jpeg.py).

Tolerances, fixed before the comparison: PNG and JPEG decoding, nearest
resizes, the
polygon fill, the colour map and every label are bit-equal. Images resized
with cubic (datasets) or u8 linear (inference input) interpolation are
within one level of cv2's, on at most CUBIC_SHARE / LINEAR_SHARE of the
elements (cv2 rounds some fixed-point sums another way: measured up to
6.1% cubic and 1.3% linear). The f32 linear resize of probabilities is
within PROBS_TOL of cv2's.
"""

import json
import os
import random
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from pytorch_segmentation_tpu.data import colormap as jcolormap
from pytorch_segmentation_tpu.data import datasets as jdatasets
from pytorch_segmentation_tpu.data import rasterize as jrasterize
from pytorch_segmentation_tpu.utils import synthetic as jsynthetic
from pytorch_segmentation_tpu_torch import data as tdata
from pytorch_segmentation_tpu_torch.data import colormap as tcolormap
from pytorch_segmentation_tpu_torch.data import datasets as tdatasets
from pytorch_segmentation_tpu_torch.data import rasterize as trasterize
from pytorch_segmentation_tpu_torch.data.resize_host import (resize_probs,
                                                             resize_u8)
from pytorch_segmentation_tpu_torch.utils import imgcodecs, png
from pytorch_segmentation_tpu_torch.utils import synthetic as tsynthetic

torch.set_num_threads(1)

CUBIC_SHARE = 0.08
LINEAR_SHARE = 0.02
PROBS_TOL = 1e-5


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write_png(path, samples, color, depth, palette=None, interlace=0):
    """A PNG with `samples` ([H, W] or [H, W, C] ints below 2**depth)
    packed at `depth` bits, every row filter 0, from the specification."""
    h, w = samples.shape[:2]
    flat = samples.reshape(h, -1).astype(np.uint8)
    if depth < 8:
        per = 8 // depth
        flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
        flat = flat.reshape(h, -1, per)
        flat = sum(flat[:, :, i] << (8 - depth * (i + 1))
                   for i in range(per)).astype(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), flat], axis=1)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    data += _chunk(b"IDAT", zlib.compress(raw.tobytes()))
    with open(path, "wb") as f:
        f.write(data + _chunk(b"IEND", b""))


# (colour type, bit depth): gray, RGB, palette, gray + alpha, RGBA
PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (6, 8)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("flags", [cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE],
                         ids=["color", "gray"])
@pytest.mark.parametrize("color,depth", PNG_KINDS,
                         ids=[f"type{c}_{d}bit" for c, d in PNG_KINDS])
def test_imread_matches_cv2(tmp_path, color, depth, flags):
    rng = np.random.default_rng(color * 10 + depth)
    shape = (13, 29) + ((CHANNELS[color],) if CHANNELS[color] > 1 else ())
    samples = rng.integers(0, 2 ** depth, shape)
    palette = (rng.integers(0, 256, (2 ** depth, 3)) if color == 3
               else None)
    path = str(tmp_path / "img.png")
    _write_png(path, samples, color, depth, palette)
    want = cv2.imread(path, flags)
    got = imgcodecs.imread(path, flags)
    assert imgcodecs.IMREAD_COLOR == cv2.IMREAD_COLOR
    assert imgcodecs.IMREAD_GRAYSCALE == cv2.IMREAD_GRAYSCALE
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_imread_refuses_what_it_cannot_read(tmp_path):
    """A JPEG is read now (as cv2 reads it, whatever its suffix: the bytes'
    signature decides); 16-bit and interlaced PNGs, bytes of another format
    and a missing file still raise."""
    img = np.random.default_rng(0).integers(0, 256, (9, 11, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    (tmp_path / "a.png").write_bytes((tmp_path / "a.jpg").read_bytes())
    cv2.imwrite(str(tmp_path / "b.png"), img.astype(np.uint16) * 257)
    _write_png(str(tmp_path / "c.png"), img, 2, 8, interlace=1)
    cv2.imwrite(str(tmp_path / "d.bmp"), img)
    for name in ("a.jpg", "a.png"):
        for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
            assert np.array_equal(
                imgcodecs.imread(str(tmp_path / name), flags),
                cv2.imread(str(tmp_path / "a.jpg"), flags))
    with pytest.raises(ValueError, match="bit depth 16"):
        imgcodecs.imread(str(tmp_path / "b.png"))
    with pytest.raises(ValueError, match="interlace 1"):
        imgcodecs.imread(str(tmp_path / "c.png"))
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        imgcodecs.imread(str(tmp_path / "d.bmp"))
    with pytest.raises(FileNotFoundError):
        imgcodecs.imread(str(tmp_path / "missing.png"))
    assert tdatasets.IMG_EXT == jdatasets.IMG_EXT


RESIZES = [((480, 640, 3), (513, 513)), ((37, 53, 3), (64, 64)),
           ((60, 80), (100, 77)), ((513, 513, 3), (64, 64)),
           ((20, 30, 3), (60, 40))]


@pytest.mark.parametrize("src_shape,size_wh", RESIZES,
                         ids=[f"{'x'.join(map(str, s))}_to_{w}x{h}"
                              for s, (w, h) in RESIZES])
def test_u8_resizes_match_cv2(src_shape, size_wh):
    """Nearest bit-equal; cubic and linear within one level on a stated
    share of the elements (the largest share seen is asserted below it)."""
    img = np.random.default_rng(sum(src_shape)).integers(
        0, 256, src_shape, dtype=np.uint8)
    for name, flag, share in (("nearest", cv2.INTER_NEAREST, 0.0),
                              ("cubic", cv2.INTER_CUBIC, CUBIC_SHARE),
                              ("linear", cv2.INTER_LINEAR, LINEAR_SHARE)):
        want = cv2.resize(img, size_wh, interpolation=flag)
        got = resize_u8(img, size_wh, name)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        diff = np.abs(got.astype(np.int32) - want)
        assert diff.max() <= (0 if name == "nearest" else 1), name
        assert (diff > 0).mean() <= share, (name, (diff > 0).mean())
    # downscales by exactly 2 are cv2's area average: exact
    half = (src_shape[1] // 2, src_shape[0] // 2)
    if src_shape[0] % 2 == 0 and src_shape[1] % 2 == 0:
        assert np.array_equal(resize_u8(img, half, "linear"),
                              cv2.resize(img, half))


@pytest.mark.parametrize("hw,out_hw", [((17, 23), (64, 48)),
                                       ((64, 48), (17, 23)),
                                       ((32, 32), (96, 100))])
def test_probability_resize_matches_cv2(hw, out_hw):
    probs = np.random.default_rng(hw[0]).random((*hw, 5)).astype(np.float32)
    want = cv2.resize(probs, (out_hw[1], out_hw[0]))
    got = resize_probs(torch.from_numpy(probs), out_hw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= PROBS_TOL
    batch = resize_probs(torch.from_numpy(probs)[None], out_hw)
    assert torch.equal(batch[0], got)


def _polygons():
    """Integer, float, off-image, self-crossing and degenerate polygons."""
    rng = np.random.default_rng(5)
    cases = []
    for k in range(60):
        h, w = (int(v) for v in rng.integers(5, 70, 2))
        n = int(rng.integers(3, 12))
        if k % 3 == 0:
            pts = rng.integers(-10, 80, (n, 2))
        elif k % 3 == 1:
            pts = rng.uniform(-10, 80, (n, 2)).astype(np.float32)
        else:
            pts = rng.integers(0, min(h, w), (n, 2))
        cases.append(((h, w), pts))
    cases.append(((10, 10), np.array([[2, 2], [7, 2]])))  # two points
    cases.append(((10, 10), np.array([[1, 1], [8, 1], [4, 1]])))  # a line
    return cases


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_fill_polygon_matches_jax(backend):
    fill = {"native": trasterize.fill_polygon,
            "numpy": trasterize.fill_polygon_reference}[backend]
    for (h, w), pts in _polygons():
        want = np.zeros((h, w), np.uint8)
        jrasterize.fill_polygon(want, pts, 7)
        got = np.zeros((h, w), np.uint8)
        assert fill(got, pts, 7) is got
        assert np.array_equal(got, want), (h, w, pts.tolist())


def test_mask_from_colors_matches_jax():
    rng = np.random.default_rng(3)
    cmap = jcolormap.VOC_COLORMAP
    ids = rng.integers(0, 40, (31, 47))
    img = np.where((ids < 32)[..., None], cmap[np.minimum(ids, 31)],
                   rng.integers(0, 256, (31, 47, 3))).astype(np.uint8)
    want = jcolormap.mask_from_colors(img, cmap)
    assert np.array_equal(tcolormap.mask_from_colors(img, cmap), want)
    assert np.array_equal(tcolormap.mask_from_colors_reference(img, cmap),
                          want)
    assert np.array_equal(tdata.VOC_COLORMAP, cmap)


def test_synthetic_coco_json_matches_jax(tmp_path):
    """The same JSON, `.jpg` names included (the files themselves are held
    byte for byte in test_torch_jpeg.py)."""
    jsynthetic.make_synthetic_coco(str(tmp_path / "j"), 5, 3, 48, seed=4,
                                   num_classes=5)
    tsynthetic.make_synthetic_coco(str(tmp_path / "t"), 5, 3, 48, seed=4,
                                   num_classes=5)
    for split in ("train", "val"):
        want = json.loads((tmp_path / "j" / f"{split}.json").read_text())
        got = json.loads((tmp_path / "t" / f"{split}.json").read_text())
        assert got == want
        for info in got["images"]:
            path = str(tmp_path / "t" / info["file_name"])
            assert info["file_name"].endswith(".jpg")
            assert np.array_equal(imgcodecs.imread(path), cv2.imread(path))


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """Non-square JPEG COCO files written by the port's generator."""
    root = tmp_path_factory.mktemp("coco")
    tsynthetic.make_synthetic_coco(str(root), 6, 2, (120, 90), seed=2,
                                   num_classes=4)
    return str(root)


def _assert_records_equal(jds, tds):
    """Labels bit-equal, images within one level on <= CUBIC_SHARE."""
    assert len(tds) == len(jds) and tds.classes == jds.classes
    for i in range(len(jds)):
        (jimg, jseg), (timg, tseg) = jds[i], tds[i]
        assert timg.dtype == np.uint8 and timg.shape == jimg.shape
        assert tseg.dtype == np.uint8 and np.array_equal(tseg, jseg), i
        diff = np.abs(timg.astype(np.int32) - jimg)
        assert diff.max() <= 1 and (diff > 0).mean() <= CUBIC_SHARE, i


@pytest.mark.parametrize("rect", [False, True], ids=["resize", "rect"])
def test_coco_dataset_records_match_jax(coco_dir, rect):
    path = os.path.join(coco_dir, "train.json")
    jds = jdatasets.CocoDataset(path, img_size=(64, 48), rect=rect)
    tds = tdata.CocoDataset(path, img_size=(64, 48), rect=rect,
                            cache_images=True)
    _assert_records_equal(jds, tds)
    assert tds.class_presence() == jds.class_presence()
    assert tds[0][0] is tds[0][0]  # the cached record


@pytest.mark.parametrize("rect", [False, True], ids=["resize", "rect"])
def test_coco_instance_records_match_jax_after_the_same_seed(coco_dir,
                                                             rect):
    path = os.path.join(coco_dir, "train.json")
    jds = jdatasets.CocoInstance(path, img_size=(48, 48), rect=rect)
    tds = tdata.CocoInstance(path, img_size=(48, 48), rect=rect)
    assert [d[0] for d in tds.data] == [d[0] for d in jds.data]
    for seed in range(3):
        random.seed(seed)
        want = [jds[i] for i in range(len(jds))]
        random.seed(seed)
        got = [tds[i] for i in range(len(tds))]
        for (jimg, jseg), (timg, tseg) in zip(want, got):
            assert np.array_equal(tseg, jseg)
            diff = np.abs(timg.astype(np.int32) - jimg)
            assert diff.max() <= 1 and (diff > 0).mean() <= CUBIC_SHARE


@pytest.fixture(scope="module")
def segimg_dir(tmp_path_factory):
    """The voc2dataset.py layout: classes.names, images/, labels/ and a list
    file; colour labels as palette PNGs (VOC's own) and as RGB PNGs, id
    labels as gray PNGs (labels_id/)."""
    root = tmp_path_factory.mktemp("segimg")
    rng = np.random.default_rng(8)
    for sub in ("images", "labels", "labels_id"):
        (root / sub).mkdir()
    names = []
    for i in range(4):
        h, w = 40 + 3 * i, 56 - 2 * i
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        (root / "images" / f"im{i}.png").write_bytes(png.encode_png(img))
        ids = np.repeat(np.repeat(rng.integers(0, 5, (4, 4)), 12, 0), 14,
                        1)[:h, :w]
        if i % 2:   # VOC's palette label PNGs (RGB palette entries)
            palette = jcolormap.VOC_COLORMAP[:, ::-1]
            _write_png(str(root / "labels" / f"im{i}.png"), ids, 3, 8,
                       palette)
        else:
            bgr = jcolormap.VOC_COLORMAP[ids]
            (root / "labels" / f"im{i}.png").write_bytes(
                png.encode_png(np.ascontiguousarray(bgr[:, :, ::-1])))
        (root / "labels_id" / f"im{i}.png").write_bytes(
            png.encode_png(ids.astype(np.uint8)))
        names.append(f"im{i}.png")
    (root / "classes.names").write_text("\n".join(
        ["background", "a", "b", "c", "d"]))
    (root / "train.txt").write_text("\n".join(names))
    return root


@pytest.mark.parametrize("rect", [False, True], ids=["resize", "rect"])
def test_segimg_and_idimg_records_match_jax(segimg_dir, rect):
    path = str(segimg_dir / "train.txt")
    jds = jdatasets.SegImgDataset(path, img_size=32, rect=rect)
    tds = tdata.SegImgDataset(path, img_size=32, rect=rect)
    _assert_records_equal(jds, tds)
    assert tds.class_presence() == jds.class_presence()
    # id labels: the same layout with labels_id/ as labels/
    id_root = segimg_dir.parent / (segimg_dir.name + "_id")
    if not id_root.exists():
        id_root.mkdir()
        for sub, src in (("images", "images"), ("labels", "labels_id")):
            os.symlink(segimg_dir / src, id_root / sub)
        for name in ("classes.names", "train.txt"):
            os.symlink(segimg_dir / name, id_root / name)
    jds = jdatasets.IdImgDataset(str(id_root / "train.txt"), img_size=32,
                                 rect=rect)
    tds = tdata.IdImgDataset(str(id_root / "train.txt"), img_size=32,
                             rect=rect)
    _assert_records_equal(jds, tds)
    assert tds.class_presence() == jds.class_presence()


def test_a_jpeg_dataset_fails_when_constructed(tmp_path):
    """A JPEG dataset is built and read now, as cv2 reads its files; one
    whose files have a suffix of IMG_EXT the port does not read (BMP, TIFF,
    DNG, WebP) still fails when it is constructed."""
    img = np.random.default_rng(1).integers(0, 256, (8, 8, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    for name in ("a.jpg", "a.webp"):
        coco = {"images": [{"id": 0, "file_name": name, "width": 8,
                            "height": 8}],
                "annotations": [], "categories": [{"id": 0, "name": "x"}]}
        (tmp_path / f"{name}.json").write_text(json.dumps(coco))
    tds = tdata.CocoDataset(str(tmp_path / "a.jpg.json"), img_size=8)
    want = cv2.imread(str(tmp_path / "a.jpg"))[:, :, ::-1]
    assert np.array_equal(tds[0][0], want)  # 8x8 to 8x8: no resampling
    with pytest.raises(ValueError, match="a.webp: only PNG and JPEG.*item 13"):
        tdata.CocoDataset(str(tmp_path / "a.webp.json"))
