"""PyTorch port: the JPEG codec (`csrc/jpeg_codec.cpp`, `utils/jpeg.py`,
`utils/imgcodecs.py`) against OpenCV and the JAX package on the CPU.

Tolerances, fixed before the comparison: none. Every decode equals
`cv2.imdecode` / `cv2.imread` bit for bit in IMREAD_COLOR and
IMREAD_GRAYSCALE (EXIF orientation included); every encode equals
`cv2.imencode(".jpg")` byte for byte; the synthetic set equals the JAX
generator's files byte for byte and `fill_poly` equals `cv2.fillPoly`
pixel for pixel. Corrupt, truncated and unsupported input raises
ValueError.
"""

import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

from pytorch_segmentation_tpu.data import datasets as jdatasets
from pytorch_segmentation_tpu.utils import synthetic as jsynthetic
from pytorch_segmentation_tpu_torch import data as tdata
from pytorch_segmentation_tpu_torch._native import JpegError
from pytorch_segmentation_tpu_torch.utils import imgcodecs, jpeg
from pytorch_segmentation_tpu_torch.utils import synthetic as tsynthetic
from test_torch_datasets import _assert_records_equal
from torch_jpeg_util import (FIXTURE_DIR, cv2_jpeg, exif_jpeg, pil_jpeg,
                             smooth_bgr, write_fixtures)

SIZES = [(1, 1), (7, 13), (37, 53), (16, 16), (97, 65)]
SAMPLINGS = ["444", "422", "420", "440", "411"]
QUALITIES = [30, 75, 95, 100]


def _matrix():
    """(id, make) over the decode matrix: every size with every sampling,
    the qualities in turn; then the coding options, a gray source, Adobe
    RGB and the eight EXIF orientations."""
    cases = []
    for i, hw in enumerate(SIZES):
        for j, samp in enumerate(SAMPLINGS):
            q = QUALITIES[(i + j) % len(QUALITIES)]
            cases.append((f"{hw[0]}x{hw[1]}_{samp}_q{q}",
                          lambda hw=hw, q=q, s=samp, k=10 * i + j: cv2_jpeg(
                              smooth_bgr(k, *hw), q, s)))
    for hw in ((37, 53), (97, 65), (7, 13)):
        for samp in ("420", "444", "422"):
            tag = f"{hw[0]}x{hw[1]}_{samp}"
            cases.append((f"progressive_{tag}", lambda hw=hw, s=samp: cv2_jpeg(
                smooth_bgr(hw[0], *hw), 90, s, progressive=True)))
    cases += [
        ("restart3_97x65_422", lambda: cv2_jpeg(smooth_bgr(3, 97, 65), 90,
                                                "422", restart=3)),
        ("restart3_37x53_420", lambda: cv2_jpeg(smooth_bgr(4, 37, 53), 75,
                                                "420", restart=3)),
        ("restart1_progressive_37x53_440", lambda: cv2_jpeg(
            smooth_bgr(5, 37, 53), 95, "440", progressive=True, restart=1)),
        ("optimized_97x65_420", lambda: cv2_jpeg(smooth_bgr(6, 97, 65), 80,
                                                 optimize=True)),
        ("optimized_7x13_411", lambda: cv2_jpeg(smooth_bgr(7, 7, 13), 100,
                                                "411", optimize=True)),
        ("pil_progressive_97x65_444", lambda: pil_jpeg(
            smooth_bgr(8, 97, 65), progressive=True, subsampling=0)),
        ("gray_37x53", lambda: cv2_jpeg(smooth_bgr(9, 37, 53, gray=True))),
        ("gray_progressive_97x65", lambda: pil_jpeg(
            smooth_bgr(10, 97, 65, gray=True), progressive=True)),
        ("adobe_rgb_37x53", lambda: pil_jpeg(smooth_bgr(11, 37, 53),
                                             keep_rgb=True)),
        ("adobe_rgb_progressive_97x65", lambda: pil_jpeg(
            smooth_bgr(12, 97, 65), keep_rgb=True, progressive=True)),
    ]
    for o in range(1, 9):
        cases.append((f"exif_orientation{o}", lambda o=o: exif_jpeg(
            smooth_bgr(20 + o, 37, 53), o)))
    cases.append(("exif_orientation6_big_endian", lambda: exif_jpeg(
        smooth_bgr(29, 37, 53), 6, big_endian=True)))
    return cases


MATRIX = _matrix()


@pytest.mark.parametrize("make", [m for _, m in MATRIX],
                         ids=[n for n, _ in MATRIX])
def test_decode_matches_cv2(make, tmp_path):
    data = make()
    buf = np.frombuffer(data, np.uint8)
    for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        want = cv2.imdecode(buf, flags)
        for got in (jpeg.decode_jpeg(data, flags),
                    imgcodecs.imdecode(data, flags)):
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert got.flags.c_contiguous
            assert np.array_equal(got, want)
    path = str(tmp_path / "img.jpeg")
    with open(path, "wb") as f:
        f.write(data)
    assert np.array_equal(imgcodecs.imread(path), cv2.imread(path))
    assert jpeg.IMREAD_COLOR == imgcodecs.IMREAD_COLOR == cv2.IMREAD_COLOR
    assert (jpeg.IMREAD_GRAYSCALE == imgcodecs.IMREAD_GRAYSCALE
            == cv2.IMREAD_GRAYSCALE)


@pytest.mark.parametrize("quality", [None, 50, 100],
                         ids=["default", "q50", "q100"])
@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
def test_encode_matches_cv2(gray, quality):
    for seed, hw in enumerate(SIZES + [(480, 64)]):
        img = smooth_bgr(seed, *hw, gray=gray)
        params = [] if quality is None else [cv2.IMWRITE_JPEG_QUALITY,
                                             quality]
        ok, want = cv2.imencode(".jpg", img, params)
        assert ok
        got = (jpeg.encode_jpeg(img) if quality is None
               else jpeg.encode_jpeg(img, quality))
        assert got == want.tobytes(), hw
        # and it decodes as cv2 decodes it
        assert np.array_equal(jpeg.decode_jpeg(got, 1 - int(gray)),
                              cv2.imdecode(want, 1 - int(gray)))
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((4, 4, 4), np.uint8))


def _markers(data):
    """Positions of every marker before the entropy data ends."""
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] not in (0x00, 0xFF)]


SOURCES = {
    "baseline": lambda: cv2_jpeg(smooth_bgr(40, 37, 53)),
    "progressive": lambda: cv2_jpeg(smooth_bgr(41, 37, 53), 90, "444",
                                    progressive=True),
    "restart": lambda: cv2_jpeg(smooth_bgr(42, 37, 53), 90, "422",
                                restart=2),
}


@pytest.mark.parametrize("source", list(SOURCES))
def test_corrupt_input_raises(source):
    """Truncated at every marker: ValueError. Seeded byte flips anywhere:
    ValueError or an image of the frame's shape, never a crash; flips of a
    frame, table or scan marker's code to a reserved one: ValueError."""
    data = SOURCES[source]()
    shape = jpeg.decode_jpeg(data).shape
    for cut in _markers(data) + [len(data) - 1]:
        with pytest.raises(ValueError):
            jpeg.decode_jpeg(data[:cut])
    with pytest.raises(ValueError):
        imgcodecs.imdecode(data[:len(data) // 2])
    rng = np.random.default_rng(len(source))
    raised = 0
    for _ in range(200):
        bad = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        for flags in (jpeg.IMREAD_COLOR, jpeg.IMREAD_GRAYSCALE):
            try:
                img = jpeg.decode_jpeg(bytes(bad), flags)
            except ValueError:
                raised += 1
                continue
            assert img.dtype == np.uint8 and img.ndim in (2, 3)
    assert raised > 0
    for pos in _markers(data):
        if data[pos + 1] in (0xC0, 0xC2, 0xC4, 0xDB, 0xDA):
            bad = bytearray(data)
            bad[pos + 1] = 0xC8  # JPG, a reserved code
            with pytest.raises(ValueError):
                jpeg.decode_jpeg(bytes(bad))


def test_refused_fixtures_raise_their_codes():
    """Each committed file the codec refuses: its own error code, raised as
    ValueError by decode_jpeg, imdecode and through a server's 400 path."""
    with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    codes = set()
    for case in manifest["refuse"]:
        with open(os.path.join(FIXTURE_DIR, case["jpeg"]), "rb") as f:
            data = f.read()
        with pytest.raises(JpegError) as err:
            jpeg.decode_jpeg(data)
        assert err.value.code == case["code"], case["name"]
        with pytest.raises(ValueError):
            imgcodecs.imdecode(data)
        codes.add(case["code"])
    assert codes == set(range(-9, -1))  # every refusal, each its own code
    with pytest.raises(JpegError) as err:
        jpeg.decode_jpeg(b"GIF89a")
    assert err.value.code == -1
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        imgcodecs.imdecode(b"GIF89a")


def test_committed_fixtures_regenerate_and_decode(tmp_path):
    """The committed fixtures are what cv2 and PIL write now, byte for byte,
    and the port reads and writes them as chip_smoke.py requires."""
    written = write_fixtures(str(tmp_path))
    assert sorted(written) == sorted(os.listdir(FIXTURE_DIR))
    for name, data in written.items():
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            assert f.read() == data, name
    assert sum(map(len, written.values())) < 200_000
    manifest = json.loads(written["manifest.json"])
    for case in manifest["decode"]:
        data = written[case["jpeg"]]
        color = imgcodecs.imdecode(written[case["color"]])
        gray = imgcodecs.imdecode(written[case["gray"]],
                                  imgcodecs.IMREAD_GRAYSCALE)
        assert list(color.shape) == case["shape"]
        assert np.array_equal(imgcodecs.imdecode(data), color), case["name"]
        assert np.array_equal(
            imgcodecs.imdecode(data, imgcodecs.IMREAD_GRAYSCALE), gray)
    for case in manifest["encode"]:
        flags = (imgcodecs.IMREAD_GRAYSCALE if case["name"].startswith("gray")
                 else imgcodecs.IMREAD_COLOR)
        src = imgcodecs.imdecode(written[case["source"]], flags)
        assert (jpeg.encode_jpeg(src, case["quality"])
                == written[case["jpeg"]]), case["name"]


def test_threads_decode_and_encode_at_once():
    """Four threads through the codec at once (ctypes drops the GIL): the
    same bytes and pixels as one at a time."""
    imgs = [smooth_bgr(50 + i, 120 + 8 * i, 96) for i in range(8)]
    blobs = [jpeg.encode_jpeg(img) for img in imgs]
    serial = [jpeg.decode_jpeg(b) for b in blobs]
    with ThreadPoolExecutor(4) as pool:
        again = list(pool.map(jpeg.encode_jpeg, imgs * 3))
        decoded = list(pool.map(jpeg.decode_jpeg, blobs * 3))
    assert again == blobs * 3
    assert all(np.array_equal(a, b) for a, b in zip(decoded, serial * 3))


def _with_app1(data, body):
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
            + data[2:])


def _tiff(order, mark, ifd, entries, count=None):
    """A TIFF header in byte order `order` ("<" or ">") whose IFD at `ifd`
    counts `count` entries (default: as many as given)."""
    head = (b"II" if order == "<" else b"MM") + struct.pack(
        order + "HI", mark, ifd)
    body = struct.pack(order + "H", len(entries) if count is None else count)
    for tag, value in entries:
        body += struct.pack(order + "HHIHH", tag, 3, 1, value, 0)
    return head + b"\x00" * (ifd - 8) + body + struct.pack(order + "I", 0)


def test_exif_orientation_reader():
    """OpenCV's reading of the APP1 Exif segments, held against cv2.imdecode
    on headers made by hand: either byte order, other tags before the
    orientation, a segment without an orientation entry (the next one
    counts), an XMP APP1 first, a bad tag mark, an IFD or an entry count
    past the end, a string or rational field past the end before the
    orientation entry, values outside 1..8."""
    img = smooth_bgr(60, 9, 14)
    for o in range(1, 9):
        for big in (False, True):
            assert jpeg.exif_orientation(exif_jpeg(img, o, big)) == o
    plain = cv2_jpeg(img)
    assert jpeg.exif_orientation(plain) == 1
    exif = b"Exif\x00\x00"
    xmp = b"http://ns.adobe.com/xap/1.0/\x00<x/>"
    good3 = exif + _tiff("<", 42, 8, [(0x0112, 3)])

    def two(first, second):
        return _with_app1(_with_app1(plain, second), first)

    def raw_ifd(*entries):  # little-endian entries packed as given
        return (exif + b"II" + struct.pack("<HIH", 42, 8, len(entries))
                + b"".join(entries) + b"\x00" * 4)

    bad_string = struct.pack("<HHII", 0x010F, 2, 20, 5000)
    bad_rational = struct.pack("<HHII", 0x011A, 5, 1, 9000)
    orient6 = struct.pack("<HHIHH", 0x0112, 3, 1, 6, 0)
    variants = {
        "other_tags_first": (_with_app1(plain, exif + _tiff(
            "<", 42, 8, [(0x0100, 14), (0x0128, 2), (0x0112, 6)])), 6),
        "big_endian_at_20": (_with_app1(plain, exif + _tiff(
            ">", 42, 20, [(0x0112, 7)])), 7),
        "xmp_first": (two(xmp, exif + _tiff("<", 42, 8, [(0x0112, 6)])), 6),
        "first_wins": (two(exif + _tiff("<", 42, 8, [(0x0112, 6)]), good3),
                       6),
        "bad_mark_then_good": (two(exif + _tiff(
            "<", 43, 8, [(0x0112, 6)]), good3), 3),
        "no_orientation_then_good": (two(exif + _tiff(
            "<", 42, 8, [(0x0128, 2)]), good3), 3),
        "ifd_past_end": (_with_app1(plain, exif + _tiff(
            "<", 42, 8, [(0x0112, 6)])[:8]), 1),
        "count_past_end": (two(exif + _tiff(
            "<", 42, 8, [(0x0112, 8)], count=9), good3), 8),
        "string_past_end_first": (two(raw_ifd(bad_string, orient6), good3),
                                  3),
        "rational_past_end_first": (_with_app1(plain, raw_ifd(
            bad_rational, orient6)), 1),
        "short_string_in_place": (_with_app1(plain, raw_ifd(
            struct.pack("<HHII", 0x010F, 2, 4, 0), orient6)), 6),
        "value_9": (two(exif + _tiff("<", 42, 8, [(0x0112, 9)]), good3), 9),
        "no_exif_prefix": (_with_app1(plain, b"Exif" + _tiff(
            "<", 42, 8, [(0x0112, 6)])), 1),
    }
    for name, (data, orientation) in variants.items():
        assert jpeg.exif_orientation(data) == orientation, name
        for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
            assert np.array_equal(jpeg.decode_jpeg(data, flags), want), name


def test_jpeg_coco_records_match_jax(tmp_path):
    """A JPEG COCO set that the JAX generator wrote: the port's CocoDataset
    gives the JAX one's records (labels bit-equal, images as the datasets'
    resize tolerance allows), and a dataset of another IMG_EXT suffix still
    refuses when built."""
    root = str(tmp_path / "coco")
    jsynthetic.make_synthetic_coco(root, 6, 2, 72, seed=3, num_classes=4)
    path = os.path.join(root, "train.json")
    for rect in (False, True):
        jds = jdatasets.CocoDataset(path, img_size=(64, 48), rect=rect)
        tds = tdata.CocoDataset(path, img_size=(64, 48), rect=rect)
        _assert_records_equal(jds, tds)
    for img_path, _ in tds.data:
        assert np.array_equal(imgcodecs.imread(img_path), cv2.imread(img_path))


@pytest.mark.parametrize("size", [64, 45], ids=["64", "45"])
def test_synthetic_set_equals_the_jax_generators_files(tmp_path, size):
    """JSON and every .jpg byte for byte (at 64x64 seed 4, 3 of the 9
    images differed by up to 164 levels before the shapes were drawn as
    cv2.fillPoly draws them)."""
    jsynthetic.make_synthetic_coco(str(tmp_path / "j"), 6, 3, size, seed=4,
                                   num_classes=3)
    tsynthetic.make_synthetic_coco(str(tmp_path / "t"), 6, 3, size, seed=4,
                                   num_classes=3)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert sum(n.endswith(".jpg") for n in names) == 9
    for name in names:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


@pytest.mark.parametrize("corners", [3, 4], ids=["triangles", "quads"])
def test_fill_poly_matches_cv2(corners):
    rng = np.random.default_rng(corners)
    for _ in range(150):
        h, w = (int(v) for v in rng.integers(4, 130, 2))
        pts = np.stack([rng.integers(0, w, corners),
                        rng.integers(0, h, corners)], 1).astype(np.int32)
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = np.zeros((h, w, 3), np.uint8)
        cv2.fillPoly(want, [pts], color)
        got = np.zeros((h, w, 3), np.uint8)
        tsynthetic.fill_poly(got, pts, color)
        assert np.array_equal(got, want), pts.tolist()
