"""IFUNC Image Memory (IM) decoding without PIL: ``Image.open(p)
.convert("RGB")`` of an IM file (Pillow 12.1's ``ImImagePlugin``), bit
for bit. cv2 reads no IM (``imread`` gives None).

The header is text lines of ``key: value`` up to a 0x1A byte
(``pil_open.im_header``); ``Image type`` picks PIL's mode and raw mode
(``ImImagePlugin.OPEN``), ``Image size (x*y)`` the size (512 x 512 by
default). With a ``Lut`` line, 768 bytes after the 0x1A are a palette of
three 256-byte planes: an 8-bit gray image (with or without alpha) whose
palette is not gray becomes palette indices, a gray one or an RGB image
keeps its pixels.
Rows run bottom-up from the end of the header (and palette).

Read here: 1-bit (``0 1``, ``L 1``, ``B1``: most significant bit first,
a set bit white), 8-bit gray (``Greyscale``, ``Grayscale``, or no type)
and palette, RGB of line-interleaved planes (``RGB``) or interleaved
(``X 24``), RGBA and RGBX of line-interleaved planes (alpha dropped),
gray and alpha (``LA``), 16-bit gray (``L 16``, ``L 16L``, ``L 16B``),
32-bit integers (``L 32S``) and the float modes of 8 to 32 bits (``L 8``,
``L 8S``, ``L 16S``, ``L 32``, ``L 32F``, ``L*8``, ``L*16``, ``L*32``). PIL
turns 16- and 32-bit integers to RGB clipped to 0..255, floats truncated
toward zero and clipped, NaN as 0. The other types (RGB3/RYB3 planes,
RLB, PA, CMYK, YCC, fields of 2-33 bits) raise naming ROADMAP.md queue 1
item 29b.
"""

from __future__ import annotations

import numpy as np

from vido_slam_tpu_torch.io import pil_open
from vido_slam_tpu_torch.io.limits import check_pil_size

ITEM = "ROADMAP.md queue 1 item 29b"

# "Image type" -> (PIL's mode, raw mode) of ImImagePlugin.OPEN, the types
# read here
OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
        "B1 image": ("1", "1"), "Greyscale image": ("L", "L"),
        "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"),
        "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
        "L 32 F image": ("F", "F;32"), "LA image": ("LA", "LA;L"),
        "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

# raw mode -> (numpy dtype of a sample, planes a row, line-interleaved)
_RAW = {"L": ("u1", 1, False), "RGB": ("u1", 3, False),
        "RGB;L": ("u1", 3, True), "RGBA;L": ("u1", 4, True),
        "RGBX;L": ("u1", 4, True), "LA;L": ("u1", 2, True),
        "I;16": ("<u2", 1, False), "I;16L": ("<u2", 1, False),
        "I;16B": (">u2", 1, False), "I;32": ("<i4", 1, False),
        "I;32S": ("<i4", 1, False), "F;8": ("u1", 1, False),
        "F;8S": ("i1", 1, False), "F;16S": ("<i2", 1, False),
        "F;32": ("<u4", 1, False), "F;32F": ("<f4", 1, False),
        "F;16": ("<u2", 1, False)}

# the (mode, raw mode) pairs read here: OPEN's, and a type of "L" itself
_READ = {(m, r) for m, r in OPEN.values() if r in _RAW or r == "1"} | {
    ("L", "L")}


class CorruptIm(OSError):
    """Bytes PIL fails on."""


def read_pil(data: bytes) -> np.ndarray:
    """``np.asarray(Image.open(p).convert("RGB"))`` of IM bytes: (H, W, 3)
    uint8 RGB. Raises where PIL raises; ValueError naming item 29b for a
    type not read here."""
    info, pos = pil_open.im_header(data)
    size = pil_open.im_size(info)
    W, H = size[0], size[1]
    kind = info.get("Image type")
    mode, raw = ("L", "L") if kind is None else OPEN.get(kind, (kind, "L"))
    if (mode, raw) not in _READ:
        raise ValueError(f"IM image type {kind!r} is not supported ({ITEM})")
    if not (isinstance(W, int) and isinstance(H, int)):
        raise CorruptIm("IM size is no integer")
    check_pil_size(W, H)
    palette = None
    if "Lut" in info:
        lut = np.frombuffer(data[pos:pos + 768], np.uint8)
        pos += 768
        gray = bool(np.all((lut[:256] == lut[256:512])
                           & (lut[256:512] == lut[512:])))
        if mode in ("L", "LA") and not gray:
            palette = lut.reshape(3, 256).T     # P, or PA of PA;L
    if raw == "1":
        row = (W + 7) // 8
        flat = data[pos:pos + row * H]
        if len(flat) < row * H:
            raise CorruptIm("image file is truncated")
        bits = np.unpackbits(np.frombuffer(flat, np.uint8).reshape(H, row),
                             axis=1)[:, :W]
        img = np.where(bits, 255, 0).astype(np.uint8)[..., None]
        return np.ascontiguousarray(np.repeat(img[::-1], 3, -1))
    dtype, planes, lines = _RAW[raw]
    size = np.dtype(dtype).itemsize * W * H * planes
    flat = data[pos:pos + size]
    if len(flat) < size:
        raise CorruptIm("image file is truncated")
    px = np.frombuffer(flat, dtype)
    if lines:
        px = px.reshape(H, planes, W).transpose(0, 2, 1)
    else:
        px = px.reshape(H, W, planes)
    px = px[::-1, :, :3]
    if raw.startswith("F"):
        with np.errstate(invalid="ignore"):
            v = px.astype(np.float32)
            px = np.trunc(np.where(np.isnan(v), 0, np.clip(v, 0, 255)))
    if px.dtype != np.uint8:
        px = np.clip(px, 0, 255).astype(np.uint8)
    if palette is not None:
        return np.ascontiguousarray(palette[px[..., 0]])
    if px.shape[-1] < 3:
        px = np.repeat(px[..., :1], 3, -1)
    return np.ascontiguousarray(px)
