"""The Python side of the port's JPEG codec (`csrc/jpeg_codec.cpp`, built
and bound by `_native.jpeg_lib`).

`decode_jpeg(data, flags)` gives what `cv2.imdecode(buf, flags)` gives for
IMREAD_COLOR (BGR) and IMREAD_GRAYSCALE (the Y plane), the EXIF orientation
included: as OpenCV, it reads the TIFF header of the APP1 `Exif` segments
(either byte order), takes tag 0x0112 and applies orientations 2-8 with
ExifTransform's flips and transposes. `encode_jpeg(img, quality=95)` gives
the bytes of `cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])`:
baseline, 4:2:0 for colour. What the codec refuses raises ValueError
(`_native.JpegError`).
"""

from __future__ import annotations

import numpy as np

from .._native import jpeg_lib

__all__ = ["decode_jpeg", "encode_jpeg", "exif_orientation",
           "apply_orientation", "IMREAD_COLOR", "IMREAD_GRAYSCALE"]

# the cv2 flags the decoder takes, with cv2's values
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1
_ORIENTATION_TAG = 0x0112


# the IFD tags OpenCV's ExifReader parses, by how it reads them: strings
# (a count, then the bytes in place or at an offset), unsigned rationals at
# an offset (how many), and SHORT values in place; the rest are skipped
_STRING_TAGS = {0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298}
_RATIONAL_TAGS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3,
                  0x0214: 6}
_SHORT_TAGS = {_ORIENTATION_TAG, 0x0128, 0x0213}


def _app1_segments(data: bytes):
    """The content of each APP1 segment before the first SOS, walking the
    markers as libjpeg does (bytes that are not a marker skipped)."""
    pos, n = 2, len(data)
    while pos < n:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return
        marker = data[pos]
        pos += 1
        if marker == 0 or marker == 0x01 or 0xD0 <= marker <= 0xD8:
            continue  # stuffed byte, TEM, RSTn, SOI: no segment
        if marker in (0xD9, 0xDA) or pos + 2 > n:
            return
        length = (data[pos] << 8) | data[pos + 1]
        if marker == 0xE1:
            yield data[pos + 2:pos + length]
        pos += max(length, 2)


def _tiff_orientation(tiff: bytes):
    """The first orientation entry of the TIFF header's first IFD, read as
    OpenCV's ExifReader reads the entries: in order, each tag's own fields
    bounds-checked; a read past the end ends the walk. None if no
    orientation entry came before the end."""
    little = len(tiff) >= 2 and tiff[0] == tiff[1] == ord("I")
    order = "little" if little else "big"  # OpenCV reads "MM" or other so

    def uint(at, size):
        if at + size - 1 >= len(tiff):
            raise IndexError
        return int.from_bytes(tiff[at:at + size], order)

    try:
        if uint(2, 2) != 0x002A:
            return None
        offset = uint(4, 4)
        for i in range(uint(offset, 2)):
            entry = offset + 2 + 12 * i
            tag = uint(entry, 2)
            if tag in _SHORT_TAGS:
                value = uint(entry + 8, 2)
                if tag == _ORIENTATION_TAG:
                    return value
            elif tag in _STRING_TAGS:
                size = uint(entry + 4, 4)
                at = 8 if size <= 4 else uint(entry + 8, 4)
                if at > len(tiff) or at + size > len(tiff):
                    raise IndexError
            elif tag in _RATIONAL_TAGS:
                at = uint(entry + 8, 4)
                for k in range(2 * _RATIONAL_TAGS[tag]):
                    uint(at + 4 * k, 4)
    except IndexError:
        pass
    return None


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation OpenCV reads from JPEG bytes (1 when there is
    none): the APP1 segments that start with `Exif\\0\\0` in order, each
    one's rest as a TIFF header ("II" little endian, else big; 0x002A),
    until one's first IFD yields an orientation entry (`_tiff_orientation`);
    its SHORT value."""
    for app1 in _app1_segments(data):
        if app1[:6] == b"Exif\x00\x00":
            value = _tiff_orientation(app1[6:])
            if value is not None:
                return value
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform: the stored image turned upright. Values
    outside 2..8 leave it as it is."""
    flips = {2: (False, 1), 3: (False, -1), 4: (False, 0), 5: (True, None),
             6: (True, 1), 7: (True, -1), 8: (True, 0)}
    if orientation not in flips:
        return img
    transpose, flip = flips[orientation]
    if transpose:
        img = img.swapaxes(0, 1)
    if flip == 1:      # cv2.flip(img, 1): around the vertical axis
        img = img[:, ::-1]
    elif flip == 0:    # around the horizontal axis
        img = img[::-1]
    elif flip == -1:   # both
        img = img[::-1, ::-1]
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] BGR (IMREAD_COLOR) or [H, W]
    (IMREAD_GRAYSCALE), upright by the EXIF orientation, as cv2.imdecode
    gives them. Raises ValueError on what the codec does not read."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"decode_jpeg: flags {flags}: IMREAD_COLOR or "
                         "IMREAD_GRAYSCALE only")
    img = jpeg_lib().decode(data, gray=flags == IMREAD_GRAYSCALE)
    return apply_orientation(img, exif_orientation(data))


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """uint8 [H, W, 3] BGR or [H, W] gray -> the JPEG bytes
    cv2.imencode(".jpg", img) writes at this quality (95 by default)."""
    return jpeg_lib().encode(img, quality)
