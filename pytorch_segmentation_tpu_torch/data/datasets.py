"""Host-side datasets (port of pytorch_segmentation_tpu/data/datasets.py
without OpenCV).

The host decodes, converts BGR to RGB, resizes or rect-pads to the static
`img_size`, rasterizes COCO polygons and maps label colours to ids; the
device runs the augmentation policy (data/augment.py) and the normalization
(data/pipeline.py). Datasets yield (img uint8 [H, W, 3] RGB, seg uint8
[H, W]).

What the JAX package does through OpenCV runs here through the port's own
code: `cv2.imread` through `utils/imgcodecs.imread` (PNG and JPEG, each
equal to cv2's decode; a dataset with files of the other suffixes of
`IMG_EXT` raises when it is constructed), `cv2.resize` through
`data/resize_host.resize_u8` (labels bit-equal, images within one level),
the polygon fill and the colour map through the native library
(`_native.py`). `CocoInstance` makes the same `random` calls in the same
order as the JAX class, so after the same `random.seed` it picks the same
instance and crop.
"""

from __future__ import annotations

import json
import os.path as osp
import random

import numpy as np

from ..utils.imgcodecs import IMREAD_COLOR, IMREAD_GRAYSCALE, imread
from .colormap import VOC_COLORMAP, mask_from_colors
from .rasterize import fill_polygon, rasterize_annotations
from .resize_host import resize_u8

__all__ = [
    "IMG_EXT", "READ_EXT", "IMAGENET_MEAN", "IMAGENET_STD",
    "BasicDataset", "CocoDataset", "CocoInstance", "IdImgDataset",
    "SegImgDataset",
]

# the image suffixes the JAX package lists (its IMG_EXT); of these the port
# reads PNG and JPEG (READ_EXT)
IMG_EXT = (".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".dng", ".webp")
READ_EXT = (".jpg", ".jpeg", ".png")
# where the other formats stand in the work still to do
OTHER_FORMATS_ITEM = "ROADMAP queue 1 item 13, BMP, TIFF, DNG and WebP"

# ImageNet statistics on the 0..255 scale, RGB order
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], dtype=np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], dtype=np.float32)


def _require_readable(paths) -> None:
    """Raise at construction for a file the port cannot decode, by its
    suffix (the decode itself goes by the bytes' signature, as cv2's)."""
    for path in paths:
        if osp.splitext(path)[1].lower() not in READ_EXT:
            raise ValueError(f"{path}: only PNG and JPEG files are read so "
                             f"far ({OTHER_FORMATS_ITEM})")


class BasicDataset:
    """Base dataset: resize / rect-pad to static shape (reference
    utils/datasets.py:149-213). `img_size` is (width, height) like the
    reference's `-s` flag.

    cache_images=True (train.py --cache-images) keeps host records in RAM
    after the first epoch: deterministic datasets (CocoDataset,
    SegImgDataset) cache the FINAL static-size (img, seg) record — decode,
    rasterize/color-map and resize all run once; CocoInstance (random
    per-access crop) caches decoded source images only. Opt-in: RAM is
    ~HxWx4 bytes per cached record (513^2 ~ 1 MB/sample). Safe with the
    threaded loader (one shared in-process cache; cached arrays are marked
    read-only, downstream BGR->RGB copies)."""

    # subclasses whose get_data is random per access (CocoInstance) set
    # False: only the image decode is cached, never the record
    deterministic_records = True

    def __init__(self, img_size=(224, 224), augments: bool = True,
                 multi_scale: bool = False, rect: bool = False,
                 cache_images: bool = False):
        if isinstance(img_size, int):
            img_size = (img_size, img_size)
        self.img_size = tuple(int(v) for v in img_size)
        self.rect = rect
        self.multi_scale = multi_scale
        self.augments = augments  # consumed by the device pipeline
        self.cache_images = bool(cache_images)
        self._record_cache: dict = {}
        self._decode_cache: dict = {}
        self.data: list = []
        self.classes: list[str] = []

    # subclasses return (bgr_img HWC uint8, seg HW uint8)
    def get_data(self, idx):
        raise NotImplementedError

    def class_presence(self):
        """Per-image list of sets of present non-background class ids,
        or None when the dataset can't provide it cheaply — consumed by
        repeat-factor balancing (data/loader.py repeat_factors)."""
        return None

    def _imread(self, path, flags=IMREAD_COLOR):
        """`utils/imgcodecs.imread` with the opt-in decode cache (GIL-safe dict
        ops; cached arrays are read-only — callers copy before mutating)."""
        if not self.cache_images:
            return imread(path, flags)
        img = self._decode_cache.get((path, flags))
        if img is None:
            img = imread(path, flags)
            img.setflags(write=False)
            self._decode_cache[(path, flags)] = img
        return img

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        cache_record = self.cache_images and self.deterministic_records
        if cache_record:
            hit = self._record_cache.get(int(idx))
            if hit is not None:
                return hit
        img, seg = self.get_data(idx)
        img = np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB
        tw, th = self.img_size
        h, w = img.shape[:2]
        if self.rect:
            # aspect-keep resize + center pad with the ImageNet mean pixel
            # (reference utils/datasets.py:166-180)
            scale = min(tw / w, th / h)
            nw, nh = int(w * scale), int(h * scale)
            img = resize_u8(img, (nw, nh), "cubic")
            seg = resize_u8(seg, (nw, nh), "nearest")
            pad_x, pad_y = tw - nw, th - nh
            left, top = pad_x // 2, pad_y // 2
            img_out = np.empty((th, tw, 3), dtype=np.uint8)
            img_out[...] = IMAGENET_MEAN.round().astype(np.uint8)
            img_out[top:top + nh, left:left + nw] = img
            seg_out = np.zeros((th, tw), dtype=np.uint8)
            seg_out[top:top + nh, left:left + nw] = seg
            img, seg = img_out, seg_out
        else:
            img = resize_u8(img, (tw, th), "cubic")
            seg = resize_u8(seg, (tw, th), "nearest")
        seg = seg.astype(np.uint8)
        if cache_record:
            img.setflags(write=False)
            seg.setflags(write=False)
            self._record_cache[int(idx)] = (img, seg)
        return img, seg


class SegImgDataset(BasicDataset):
    """classes.names colormap + labels/*.png (reference
    utils/datasets.py:216-257)."""

    def __init__(self, path, img_size=224, augments=True, multi_scale=False,
                 rect=False, colormap=VOC_COLORMAP, cache_images=False):
        super().__init__(img_size, augments, multi_scale, rect,
                         cache_images=cache_images)
        self.path = path
        self.colormap = np.asarray(colormap, dtype=np.uint8)
        self._build()
        self.data.sort()

    def _build(self):
        data_dir = osp.dirname(self.path)
        with open(osp.join(data_dir, "classes.names")) as f:
            self.classes = [c for c in f.read().split("\n") if c]
        image_dir = osp.join(data_dir, "images")
        label_dir = osp.join(data_dir, "labels")
        with open(self.path) as f:
            names = [n for n in f.read().split("\n") if n]
        names = list(set(names))
        self.data = [
            (osp.join(image_dir, name),
             osp.join(label_dir, osp.splitext(name)[0] + ".png"))
            for name in names if osp.splitext(name)[1] in IMG_EXT
        ]
        _require_readable(p for pair in self.data for p in pair)

    def get_data(self, idx):
        img = self._imread(self.data[idx][0])
        seg_color = self._imread(self.data[idx][1])
        seg = mask_from_colors(seg_color, self.colormap)
        return img, seg

    def class_presence(self):
        """One pass over the label PNGs at startup (decode-only, no
        image reads); ids >= len(classes) (e.g. a 255 void band) are
        dropped."""
        out = []
        nc = len(self.classes)
        for _, label_path in self.data:
            seg = self._read_label(label_path)
            ids = np.unique(seg) if seg is not None else np.empty(0, int)
            out.append({int(c) for c in ids if 0 < c < nc})
        return out

    def _read_label(self, path):
        try:
            seg_color = self._imread(path)
        except OSError:  # an unreadable label counts as no class
            return None
        return mask_from_colors(seg_color, self.colormap)


class IdImgDataset(SegImgDataset):
    """labels/*.png store CLASS IDS directly in the gray channel — the
    Cityscapes `labelIds` / ADE20K annotation convention — instead of
    palette colors. Same on-disk layout as SegImgDataset (classes.names +
    images/ + labels/*.png + list file), wired as `--dataset idimg`.

    Ids survive untouched through the nearest-neighbor resizes, so the
    255 ignore convention passes straight through — train/eval with
    `--ignore-index 255` to exclude those pixels from the loss and the
    confusion counts. (Rect padding still labels the pad region 0, like
    every dataset here — reference utils/datasets.py:166-180 semantics.)
    """

    def get_data(self, idx):
        img = self._imread(self.data[idx][0])
        seg = self._imread(self.data[idx][1], IMREAD_GRAYSCALE)
        return img, seg

    def _read_label(self, path):
        try:
            return self._imread(path, IMREAD_GRAYSCALE)
        except OSError:  # an unreadable label counts as no class
            return None


class _CocoBase(BasicDataset):
    def __init__(self, path, img_size=224, augments=True, multi_scale=False,
                 rect=False, cache_images=False):
        super().__init__(img_size, augments, multi_scale, rect,
                         cache_images=cache_images)
        with open(path) as f:
            self.coco = json.load(f)
        self.img_root = osp.dirname(path)
        self._build()
        self.data.sort(key=lambda d: d[0])

    def _build(self):
        self.classes = ["background"] + [c["name"] for c in self.coco["categories"]]
        by_id: dict = {}
        order = []
        for info in self.coco["images"]:
            by_id[info["id"]] = (osp.join(self.img_root, info["file_name"]),
                                 info, [])
            order.append(info["id"])
        for ann in self.coco["annotations"]:
            entry = by_id.get(ann["image_id"])
            if entry is None:
                continue
            if not self._keep_ann(ann, entry[1]):
                continue
            entry[2].append(ann)
        self.data = [(by_id[i][0], by_id[i][2]) for i in order]
        self.data = self._filter(self.data)
        _require_readable(path for path, _ in self.data)

    def _keep_ann(self, ann, img_info):
        return True

    def _filter(self, data):
        return data

    def class_presence(self):
        """From the COCO annotations directly (no mask rasterization):
        class id = category_id + 1, matching rasterize_annotations."""
        return [{int(a["category_id"]) + 1 for a in anns}
                for _, anns in self.data]


class CocoDataset(_CocoBase):
    """COCO JSON polygons -> semantic mask (reference
    utils/datasets.py:260-303)."""

    def get_data(self, idx):
        path, anns = self.data[idx]
        img = self._imread(path)
        seg = rasterize_annotations(img.shape[0], img.shape[1], anns)
        return img, seg


class CocoInstance(_CocoBase):
    """Single-instance random-crop dataset (reference
    utils/datasets.py:306-391): pick one valid polygon, crop a random window
    extending up to 100px beyond its bbox, rasterize only that instance.

    Fixes the reference's dense-image-id indexing bug
    (utils/datasets.py:337 indexes coco['images'] by annotation image_id;
    SURVEY.md §2.2) by resolving image info through an id map.
    """

    MIN_EXTENT = 50
    CROP_MARGIN = 100
    deterministic_records = False  # random crop/instance pick per access

    def _keep_ann(self, ann, img_info):
        seg = ann.get("segmentation")
        if not seg:
            return False
        poly = np.asarray(seg, dtype=np.float64).reshape(-1)
        xs, ys = poly[0::2], poly[1::2]
        return (xs.max() < img_info["width"] and ys.max() < img_info["height"]
                and poly.min() >= 0)

    def _filter(self, data):
        return [d for d in data if len(d[1]) > 0]

    def get_data(self, idx):
        path, anns = self.data[idx]
        img = self._imread(path)
        h, w = img.shape[:2]
        # choose a polygon with sufficient extent, like the reference's
        # retry loop (utils/datasets.py:352-361)
        ann = None
        p = None
        for _ in range(len(anns)):
            cand = random.choice(anns)
            pts = np.asarray(cand["segmentation"], dtype=np.float64).reshape(-1, 2)
            pts = pts.astype(np.int64)
            if (pts[:, 0].min() < 0 or pts[:, 1].min() < 0
                    or pts[:, 0].max() >= w or pts[:, 1].max() >= h
                    or pts[:, 0].max() - pts[:, 0].min() < self.MIN_EXTENT
                    or pts[:, 1].max() - pts[:, 1].min() < self.MIN_EXTENT):
                ann, p = cand, pts  # keep as last resort, keep searching
                continue
            ann, p = cand, pts
            break
        m = self.CROP_MARGIN
        x1 = max(0, random.randint(p[:, 0].min() - m, p[:, 0].min()))
        x2 = min(w, random.randint(p[:, 0].max(), p[:, 0].max() + m))
        y1 = max(0, random.randint(p[:, 1].min() - m, p[:, 1].min()))
        y2 = min(h, random.randint(p[:, 1].max(), p[:, 1].max() + m))
        if x2 > x1 and y2 > y1:
            img = img[y1:y2, x1:x2]
            p = p - np.array([[x1, y1]])
        seg = np.zeros(img.shape[:2], dtype=np.uint8)
        fill_polygon(seg, p, int(ann["category_id"]) + 1)
        return img, seg
