"""Inputs no earlier probe fed the readers of the formats PIL opens and cv2
does not (``io/tga.py``, ``pcx.py``, ``sgi.py``, ``qoi.py``, ``ico.py``,
``im.py``), each against PIL's ``Image.open(p).convert("RGB")`` and
``cv2.imread`` (None) on the same bytes: Targa colour maps of every entry
depth from a first entry past 0, attribute bits in the descriptor, maps
in true-colour files; PCX of versions 0-3 at 8 bits (PIL refuses them);
SGI run-length tables pointing into the header and past the end at odd
offsets; QOI images whose colours collide in the index; icons of 2-bit
and run-length BMP entries and of cut PNG entries; IM files with a
``Lut`` on every image type.

Bar: bit-equal to PIL, or a raise where PIL raises (the plugin's own
error or ValueError naming the ROADMAP.md item of a type the port
refuses); the host loops' plain twins equal to the C++ ones where PIL
reads the file; imread None as cv2.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import (_rle, dib, write_ico, write_im, write_pcx,
                                  write_qoi, write_sgi, write_tga)
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import pcx, pil_open, qoi, sgi, tga

TWINS = {"tga": tga, "pcx": pcx, "sgi": sgi, "qoi": qoi}


def _against_pil(tmp_path, kind, data):
    path = str(tmp_path / f"x.{kind}")
    with open(path, "wb") as f:
        f.write(data)
    for flag in (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH):
        assert cv2.imread(path, flag) is None and td.imread(path, flag) is None
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        return False
    try:
        got = td.read_rgb_pil(path)
    except ValueError as e:
        assert "item 29b" in str(e)
        return None
    np.testing.assert_array_equal(got, ref)
    if kind in TWINS and pil_open.pil_format(data) is not None:
        np.testing.assert_array_equal(TWINS[kind].read_pil(data, plain=True),
                                      ref)
    return True


@pytest.mark.parametrize("seed", range(3))
def test_targa_colour_maps_and_attribute_bits(tmp_path, seed):
    rng = np.random.RandomState(seed)
    read = 0
    for t in range(30):
        H, W = rng.randint(1, 20), rng.randint(1, 20)
        n, start = rng.randint(1, 300), rng.randint(0, 4)
        pal = rng.randint(0, 256, (n, 3))
        md = int(rng.choice([15, 16, 24, 32]))
        kind = int(rng.choice([1, 9, 2, 10, 3, 11]))
        flags = int(rng.choice([0, 0x20, 0x10, 0x30])) | int(
            rng.choice([0, 1, 8, 15]))
        depth = {1: 8, 9: 8, 2: int(rng.choice([16, 24, 32])), 10: 24,
                 3: 8, 11: 8}[kind]
        if kind in (1, 9):
            px = rng.randint(start, start + n, (H, W)) % 256
        elif kind == 2 and depth == 16:
            px = rng.randint(0, 65536, (H, W))
        elif kind in (2, 10):
            px = rng.randint(0, 256, (H, W, depth // 8))
        else:
            px = rng.randint(0, 256, (H, W))
        data = bytearray(write_tga(
            px, kind, depth, palette=pal if kind in (1, 9) or rng.rand() < 0.5
            else None, map_depth=16 if md in (15, 16) else md,
            map_start=start, flags=flags))
        if md == 15 and data[1] == 1:
            data[7] = 15
        read += bool(_against_pil(tmp_path, "tga", bytes(data)))
    assert read


def test_pcx_versions_0_to_3_at_8_bits(tmp_path):
    rng = np.random.RandomState(3)
    seen = set()
    for t in range(24):
        H, W, planes = rng.randint(1, 20), rng.randint(1, 30), int(
            rng.choice([1, 3]))
        version = int(rng.choice([0, 2, 3, 5]))
        data = write_pcx(rng.randint(0, 256, (H, planes, W)), 8,
                         version=version,
                         palette256=rng.randint(0, 256, (256, 3))
                         if planes == 1 else None)
        seen.add((version == 5, _against_pil(tmp_path, "pcx", data)))
    assert (False, False) in seen and (True, True) in seen


def test_sgi_tables_into_the_header_and_past_the_end(tmp_path):
    rng = np.random.RandomState(4)
    for t in range(40):
        H, W, z = rng.randint(1, 12), rng.randint(1, 20), int(
            rng.choice([1, 3, 4]))
        bpc = int(rng.choice([1, 2]))
        px = rng.randint(0, 256 if bpc == 1 else 65536, (H, W, z))
        data = bytearray(write_sgi(px.astype(np.uint8 if bpc == 1
                                             else np.uint16), bpc))
        n = H * z
        for k in range(rng.randint(1, 4)):
            i = rng.randint(0, n)
            where = rng.randint(0, 3)
            value = (rng.randint(0, 512) | 1 if where == 0 else
                     len(data) + rng.randint(-3, 40) if where == 1 else
                     rng.randint(512, len(data)) | 1)
            struct.pack_into(">I", data, 512 + 4 * i, value)
            if rng.rand() < 0.5:
                struct.pack_into(">I", data, 512 + 4 * n + 4 * i,
                                 rng.randint(0, 60))
        _against_pil(tmp_path, "sgi", bytes(data))


def test_qoi_index_collisions(tmp_path):
    rng = np.random.RandomState(5)

    def bucket(c):
        return (c[0] * 3 + c[1] * 5 + c[2] * 7 + 255 * 11) % 64
    for t in range(12):
        H, W = rng.randint(1, 16), rng.randint(1, 16)
        base = rng.randint(0, 256, (8, 3))
        colours = [c for c in rng.randint(0, 256, (3000, 3))
                   if bucket(c) == bucket(base[0])][:6] + list(base[:4])
        rgb = np.array(colours)[rng.randint(0, len(colours), (H, W))]
        assert _against_pil(tmp_path, "qoi", write_qoi(rgb.astype(np.uint8)))


@pytest.mark.parametrize("entry", ["2-bit", "rle8", "rle4", "cut png"])
def test_icon_entries(tmp_path, entry):
    rng = np.random.RandomState(len(entry))
    for size in (1, 4, 16, 32):
        H = W = size
        if entry == "2-bit":
            data = dib(rng.randint(0, 4, (H, W)), 2,
                       palette=rng.randint(0, 256, (4, 3)))
            meta = (W, H, 4, 2)
        elif entry.startswith("rle"):
            bits = 8 if entry == "rle8" else 4
            px = rng.randint(0, 1 << bits, (H, W)).astype(np.uint8)
            head = bytearray(dib(px, bits, palette=rng.randint(
                0, 256, (1 << bits, 3))))[:40 + 4 * (1 << bits)]
            body = _rle(px[::-1], bits == 4)
            struct.pack_into("<II", head, 16, 1 if bits == 8 else 2,
                             len(body))
            data = bytes(head) + body + bytes((W + 31) // 32 * 4 * H)
            meta = (W, H, 0 if bits == 8 else 16, bits)
        else:
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 256, (H, W, 3)).astype(
                np.uint8)).save(buf, "PNG")
            png = buf.getvalue()
            data = png[:rng.randint(8, len(png) + 1)]
            meta = (W, H, 0, 32)
        _against_pil(tmp_path, "ico", write_ico([data], [meta]))


@pytest.mark.parametrize("kind", ["L 8", "P 8", "RGB", "L 16", "F 32F",
                                  "L 32S", "1 1", "RGBA", "CMYK", "YCC",
                                  "LA"])
def test_im_lut_on_every_type(tmp_path, kind):
    rng = np.random.RandomState(len(kind))
    H, W = 7, 9
    px = {"L 8": rng.randint(0, 256, (H, W)).astype(np.uint8),
          "P 8": rng.randint(0, 256, (H, W)).astype(np.uint8),
          "RGB": rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
          "L 16": rng.randint(0, 65536, (H, W)).astype("<u2"),
          "F 32F": (rng.randn(H, W) * 100).astype("<f4"),
          "L 32S": rng.randint(-999, 999, (H, W)).astype("<i4"),
          "1 1": (rng.rand(H, W) > 0.5).astype(np.uint8) * 255,
          "RGBA": rng.randint(0, 256, (H, W, 4)).astype(np.uint8),
          "CMYK": rng.randint(0, 256, (H, W, 4)).astype(np.uint8),
          "YCC": rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
          "LA": rng.randint(0, 256, (H, W, 2)).astype(np.uint8)}[kind]
    name = {"RGB": "RGB3", "RGBA": "RGBA4", "CMYK": "CMYK4",
            "YCC": "YCC3"}.get(kind, kind)
    for lut in (None, bytes(rng.randint(0, 256, 768).astype(np.uint8))):
        _against_pil(tmp_path, "im", write_im(px, f"{name} image", lut=lut))
