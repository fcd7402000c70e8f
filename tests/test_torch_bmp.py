"""The port's BMP reader (``io/bmp.py``) through ``io/datasets.imread``
against ``cv2.imread`` (IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_ANYDEPTH)
and through ``read_rgb_pil`` against PIL's
``Image.open(p).convert("RGB")``, on the same bytes.

Bar: bit-equal on every file, None where cv2 gives None, a raise where PIL
raises. The files, written by ``tests/image_encoders.write_bmp`` (neither
library writes most of them) and by cv2 and PIL: 1-, 4- and 8-bit
palettes (a short palette, the exact gray ramp PIL reads as gray, the
black-and-white pair it reads as bilevel), RLE4 and RLE8 (runs, absolute
runs of odd length, end of line, end of bitmap before the last row, a
delta, a run that fills a row exactly, a run past its row, a stream that
ends early), 16-bit 5-5-5 (BI_RGB and BI_BITFIELDS) and 5-6-5, 24-bit,
32-bit with its fourth byte dropped (BI_RGB and BI_BITFIELDS), each
bottom-up and top-down, at odd widths (row padding), and truncated files.
Where cv2 and PIL part (5-bit fields shifted or scaled, gray palettes,
RLE's edge cases), each reader copies its own library. WebP, JPEG 2000
and OpenEXR still raise a ValueError naming the format.
"""

import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import write_bmp
from vido_slam_tpu_torch.io import bmp
from vido_slam_tpu_torch.io import datasets as td

SIZES = [(13, 17), (8, 8), (5, 3), (1, 1), (20, 31)]


def _check(path):
    """The port against cv2 in its three modes and against PIL; returns
    (cv2 gave an image, PIL gave an image)."""
    images = []
    for flag in (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH):
        ref = cv2.imread(path, flag)
        got = td.imread(path, flag)
        if ref is None:
            assert got is None, (path, flag)
        else:
            assert got is not None and got.dtype == ref.dtype \
                and got.shape == ref.shape, (path, flag)
            np.testing.assert_array_equal(got, ref)
        images.append(ref is not None)
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        return images[0], False
    got = td.read_rgb_pil(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, ref)
    return images[0], True


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up",
                                                          "top_down"])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_palettes(tmp_path, bits, top_down):
    rng = np.random.RandomState(bits)
    path = str(tmp_path / "p.bmp")
    n = 1 << bits
    for H, W in SIZES:
        pal = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        idx = rng.randint(0, n, (H, W)).astype(np.uint8)
        write_bmp(path, idx, bits, palette=pal, top_down=top_down)
        assert _check(path) == (True, True)
        ramp = np.repeat(np.arange(n, dtype=np.uint8)[:, None], 3, 1)
        if bits == 1:
            ramp = np.array([[0] * 3, [255] * 3], np.uint8)
        write_bmp(path, idx, bits, palette=ramp, top_down=top_down)
        _check(path)
        if bits == 8:   # indices past a short palette
            write_bmp(path, idx, bits, palette=pal[:100], top_down=top_down)
            assert _check(path) == (True, True)


def _rle_runs(rng, H, W, n):
    runs = np.repeat(rng.randint(0, n, (H, W // 3 + 1)), 3, 1)[:, :W]
    runs[:, ::5] = rng.randint(0, n, runs[:, ::5].shape)
    return runs.astype(np.uint8)


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up",
                                                          "top_down"])
@pytest.mark.parametrize("bits", [4, 8])
def test_rle(tmp_path, bits, top_down):
    rng = np.random.RandomState(bits + 2)
    path = str(tmp_path / "r.bmp")
    n = 1 << bits
    for H, W in SIZES:
        pal = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        write_bmp(path, _rle_runs(rng, H, W, n), bits, palette=pal,
                  rle=True, top_down=top_down)
        assert _check(path)[0]


def _raw_rle(path, stream, bits, W, H, pal):
    """An RLE BMP of the given stream of bytes."""
    write_bmp(path, np.zeros((H, W), np.uint8), bits, palette=pal, rle=True)
    with open(path, "rb") as f:
        data = f.read()
    offset = struct.unpack_from("<I", data, 10)[0]
    with open(path, "wb") as f:
        f.write(data[:offset] + bytes(stream))


def _row(v):
    return [10, v, 0, 0]


RLE_STREAMS = {
    "delta within a row": [3, 0x55, 0, 2, 2, 0, 5, 0x66, 0, 0] + _row(0x77)
    + _row(0x88) + _row(0x99) + [0, 1],
    "delta down a row (RLE8)": [3, 0x55, 0, 2, 2, 1, 4, 0x77, 0, 0]
    + _row(0x99) + [10, 0x33, 0, 1],
    "runs filling rows exactly, then EOL": _row(5) + _row(6) + _row(7)
    + _row(8) + [0, 1],
    "runs filling rows exactly, no EOL": [10, 5, 10, 6, 10, 7, 10, 8, 0, 1],
    "run past its row": [12, 5, 0, 0, 10, 6, 0, 1],
    "end of bitmap in the first row": [4, 5, 0, 1],
    "end of bitmap in the last row": _row(5) + _row(6) + _row(7)
    + [3, 8, 0, 1],
    "absolute runs of odd length": [0, 5, 1, 2, 3, 4, 5, 0, 5, 9, 0, 0]
    + _row(3) + _row(4) + _row(2) + [0, 1],
    "EOL at a row's start": _row(5) + [0, 0] + _row(7) + [0, 1],
    "no end of bitmap": _row(5) + _row(6) + _row(7) + _row(8),
    "stream ends early": _row(5) + _row(6),
}


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("case", list(RLE_STREAMS))
def test_rle_streams_at_their_edges(tmp_path, case, bits):
    """Hand-made streams of a 10 x 4 image, where cv2 and PIL part: each
    reader holds to its own library (an RLE4 delta down a row, which cv2
    reads as a skip along the rows that ignores dy, since queue 1 item
    27)."""
    rng = np.random.RandomState(len(case))
    pal = rng.randint(0, 256, (1 << bits, 3)).astype(np.uint8)
    path = str(tmp_path / "s.bmp")
    _raw_rle(path, RLE_STREAMS[case], bits, 10, 4, pal)
    _check(path)


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up",
                                                          "top_down"])
@pytest.mark.parametrize("layout", ["555", "555 fields", "565 fields",
                                    "24", "32", "32 fields"])
def test_direct_colour(tmp_path, layout, top_down):
    rng = np.random.RandomState(len(layout))
    path = str(tmp_path / "d.bmp")
    for H, W in SIZES:
        if layout.startswith("5"):
            px = rng.randint(0, 65536, (H, W)).astype(np.uint16)
            fields = {"555": None, "555 fields": (0x7C00, 0x3E0, 0x1F),
                      "565 fields": (0xF800, 0x7E0, 0x1F)}[layout]
            write_bmp(path, px, 16, fields=fields, top_down=top_down)
        else:
            bits = int(layout[:2])
            px = rng.randint(0, 256, (H, W, bits // 8)).astype(np.uint8)
            fields = (0xFF0000, 0xFF00, 0xFF) if "fields" in layout else None
            write_bmp(path, px, bits, fields=fields, top_down=top_down)
        assert _check(path) == (True, True)


def test_where_cv2_and_pil_part():
    """A 5-bit field: cv2 shifts it, PIL scales it; a gray read is cv2's
    fixed-point weights."""
    px = np.array([[0x7FFF, 0x0421]], np.uint16)  # white; 1 in each field
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = d + "/f.bmp"
        write_bmp(path, px, 16)
        np.testing.assert_array_equal(td.imread(path)[0],
                                      [[248, 248, 248], [8, 8, 8]])
        np.testing.assert_array_equal(td.read_rgb_pil(path)[0],
                                      [[255, 255, 255], [8, 8, 8]])
    assert (bmp.CB, bmp.CG, bmp.CR) == (1868, 9617, 4899)


def test_files_cv2_and_pil_write(tmp_path):
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (21, 33, 3)).astype(np.uint8)
    path = str(tmp_path / "w.bmp")
    assert cv2.imwrite(path, img)
    assert _check(path) == (True, True)
    assert cv2.imwrite(path, img[..., 0])
    assert _check(path) == (True, True)
    for mode in ("RGB", "RGBA", "L", "1", "P"):
        Image.fromarray(img[..., ::-1]).convert(mode).save(path)
        assert _check(path) == (True, True)


def test_truncated_files(tmp_path):
    """Cut in the header, the palette, the pixels and the last row's
    padding: cv2 gives None wherever its reads run out, PIL raises (but for
    the last row's padding, which its raw decoder does not read)."""
    rng = np.random.RandomState(3)
    path = str(tmp_path / "t.bmp")
    write_bmp(path, rng.randint(0, 256, (9, 13)).astype(np.uint8), 8,
              palette=rng.randint(0, 256, (256, 3)).astype(np.uint8))
    with open(path, "rb") as f:
        data = f.read()
    seen = set()
    for cut in (1, 10, 30, 60, 500, len(data) - 20, len(data) - 3,
                len(data) - 1):
        with open(path, "wb") as f:
            f.write(data[:cut])
        assert cv2.imread(path) is None
        seen.add(_check(path))
    assert seen == {(False, False), (False, True)}


@pytest.mark.parametrize("name,head", [
    ("TIFF", b"II*\x00"), ("TIFF", b"MM\x00*"), ("WebP", b"RIFF"),
    ("JPEG 2000", b"\x00\x00\x00\x0cjP"), ("JPEG 2000", b"\xff\x4f\xff\x51"),
    ("HDR", b"#?RADIANCE"), ("OpenEXR", b"\x76\x2f\x31\x01")])
def test_other_formats_still_raise_naming_them(tmp_path, name, head):
    """The formats cv2 decodes and the port lacks raise ValueError naming
    them. TIFF and HDR are read since slice 19: their signature and 64
    zero bytes are no image, which the port finds as cv2 does (None);
    ``RIFF`` alone is no WebP signature (cv2 wants ``WEBP`` and a chunk
    after it), nor the first six bytes of JP2's twelve: each raises once
    it has its whole signature; lossless WebP is read since slice 20 and
    lossy WebP since slice 23, and a WebP of zero sizes is no image
    (None), so the WebP case reads cv2's lossy file as cv2 does. OpenEXR
    gives None since slice 21, as cv2 built without OpenEXR ("OpenEXR:
    NO") does."""
    path = str(tmp_path / "x.img")
    with open(path, "wb") as f:
        f.write(head + bytes(64))
    if name in ("TIFF", "HDR", "WebP") or head == b"\x00\x00\x00\x0cjP":
        assert cv2.imread(path) is None and td.imread(path) is None
        if name in ("TIFF", "HDR"):
            return
        with open(path, "wb") as f:    # the whole of cv2's signature
            f.write(head + bytes(4) + b"WEBPVP8 " + bytes(64)
                    if name == "WebP" else head + b"  \r\n\x87\n" + bytes(64))
        if name == "WebP":   # lossy WebP reads, its zero sizes give None
            assert cv2.imread(path) is None and td.imread(path) is None
            ok, enc = cv2.imencode(".webp", np.zeros((4, 4, 3), np.uint8),
                                   [cv2.IMWRITE_WEBP_QUALITY, 80])
            with open(path, "wb") as f:
                f.write(enc.tobytes())
            for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE,
                         cv2.IMREAD_ANYDEPTH):
                np.testing.assert_array_equal(td.imread(path, flag),
                                              cv2.imread(path, flag))
            return
    if name == "OpenEXR":   # cv2 built without OpenEXR: None
        assert cv2.imread(path) is None and td.imread(path) is None
        return
    with pytest.raises(ValueError, match=name):
        td.imread(path)


def test_committed_bmp_fixtures_read_as_cv2_and_pil():
    """The BMP fixtures of tools/make_image_fixtures.py (one a layout, read
    by chip_smoke.py phase (s) against the digests) against cv2 and PIL."""
    import os

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data", "bmp")
    names = sorted(os.listdir(root))
    assert len(names) == 10
    for name in names:
        assert _check(os.path.join(root, name)) == (True, True)


def _v3_bmp(path, px, header, masks, alpha=0):
    """A 32-bit BI_BITFIELDS BMP of a ``header``-byte info header that
    holds its own (red, green, blue) masks and, from 56 bytes, ``alpha``'s;
    rows bottom-up."""
    H, W = px.shape[:2]
    head = struct.pack("<IiiHHIIiiII", header, W, H, 1, 32, 3, 4 * H * W,
                       2835, 2835, 0, 0)
    head += struct.pack("<3I", *masks)[:header - 40]
    if header >= 56:
        head += struct.pack("<I", alpha)
    head += bytes(header - len(head))
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 14 + header + px.size, 0, 0,
                                    14 + header))
        f.write(head + px[::-1].tobytes())


MASKS = {"default": (0xFF0000, 0xFF00, 0xFF), "swapped": (0xFF, 0xFF00,
                                                          0xFF0000),
         "10-bit": (0x3FF00000, 0xFFC00, 0x3FF), "3-bit": (0xE0, 0x1C, 0x3),
         "high": (0xFFFF0000, 0xFF00, 0xFF), "a zero": (0, 0xFF00, 0xFF),
         "split": (0xFF00FF, 0xFF00, 0xFF0000)}


@pytest.mark.parametrize("masks", list(MASKS))
@pytest.mark.parametrize("header", [52, 56, 64, 108, 124])
def test_v3_to_v5_bitfields_read_as_cv2(tmp_path, header, masks):
    """Fault H (found by step 0 of slice 19): cv2 5.0 reads a 32-bit
    BI_BITFIELDS file of a 56-byte or larger header by the masks in that
    header (each field scaled to 8 bits by 255 / its maximum in float32,
    truncated; a gray read weighs them in float32 and truncates), not as
    the BGRA of smaller headers; a zero mask falls back to BGRA."""
    rng = np.random.RandomState(header + len(masks))
    px = rng.randint(0, 256, (6, 9, 4)).astype(np.uint8)
    px[0, :2] = [[255, 255, 255, 255], [0, 0, 0, 0]]
    path = str(tmp_path / "v.bmp")
    _v3_bmp(path, px, header, MASKS[masks], alpha=0xFF000000)
    assert _check(path)[0]


def test_rle4_deltas_off_their_row(tmp_path):
    """Queue 1 item 27: random RLE4 streams of deltas that leave their row
    (cv2 skips dx pixels along the rows, filling palette entry 0, and
    ignores dy), ends of line and bitmap, runs and absolute runs, against
    cv2 and PIL."""
    rng = np.random.RandomState(27)
    path = str(tmp_path / "d.bmp")
    for _ in range(120):
        W, H = rng.randint(1, 12), rng.randint(1, 6)
        stream = []
        for _ in range(rng.randint(1, 12)):
            r = rng.rand()
            if r < 0.35:
                stream += [int(rng.randint(1, 8)), int(rng.randint(0, 256))]
            elif r < 0.6:
                stream += [0, 2, int(rng.randint(0, 14)),
                           int(rng.randint(0, 4))]
            elif r < 0.75:
                stream += [0, 0]
            elif r < 0.9:
                c = int(rng.randint(3, 8))
                body = [int(v) for v in rng.randint(0, 256, (c + 1) // 2)]
                stream += [0, c] + body + [0] * (len(body) % 2)
            else:
                stream += [0, 1]
        pal = rng.randint(0, 256, (16, 3)).astype(np.uint8)
        _raw_rle(path, stream + [0, 1] * int(rng.rand() < 0.7), 4, W, H, pal)
        _check(path)
