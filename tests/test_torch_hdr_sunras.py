"""The port's Radiance HDR (``io/hdr.py``) and Sun raster
(``io/sunras.py``) readers through ``io/datasets.imread`` against
``cv2.imread`` (IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_ANYDEPTH) and, for
Sun raster, through ``read_rgb_pil`` against PIL's
``Image.open(p).convert("RGB")`` (PIL opens no HDR file).

Bar: bit-equal, None where cv2 gives None, a raise where PIL raises.
HDR: new-style run-length rows and flat ones (a row that is not encoded
ends the encoding), every exponent, header lines before and after the
FORMAT line, the orientations and FORMATs cv2 refuses, cut files; the
float gray of cv2 5.0's cvtColor (its 8-wide loop, its 4-wide step's
lanes) and the 8-bit gray of its colour read (15-bit weights). Sun
raster: depths 1, 4, 8, 24 and 32, colour maps short and full, types 0-3
(cv2 reads 0 and 1 only; PIL reads byte encoding with runs across rows),
a GIMP brush's header PIL takes first, cut files.
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import hdr_rle_row, write_hdr, write_sunras
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import hdr

FLAGS = (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH)


def _check(path):
    """The port against cv2's three reads and PIL; returns (cv2's colour
    read gave an image, PIL's did)."""
    seen = []
    for flag in FLAGS:
        ref = cv2.imread(path, flag)
        got = td.imread(path, flag)
        if ref is None:
            assert got is None, (path, flag)
        else:
            assert got is not None and got.dtype == ref.dtype \
                and got.shape == ref.shape, (path, flag)
            np.testing.assert_array_equal(got, ref)
        seen.append(ref is not None)
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        return seen[0], False
    np.testing.assert_array_equal(td.read_rgb_pil(path), ref)
    return seen[0], True


def _rgbe(rng, H, W, exps=(0, 100, 120, 128, 129, 136, 140, 200, 255)):
    rgbe = rng.randint(0, 256, (H, W, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.choice(exps, (H, W))
    return rgbe


@pytest.mark.parametrize("rle", [True, False], ids=["rle", "flat"])
@pytest.mark.parametrize("width", [1, 5, 7, 8, 12, 13, 31, 40])
def test_hdr_widths(tmp_path, width, rle):
    """Widths around the 8-wide loop and its 4-wide step (the float gray
    of lanes 0 and 2 is summed in another order), under 8 (never run-length
    encoded), runs and literals."""
    rng = np.random.RandomState(width + rle)
    path = str(tmp_path / "h.hdr")
    for H in (1, 3, 9):
        rgbe = _rgbe(rng, H, width)
        rgbe[:, ::3] = rgbe[:, :1]
        write_hdr(path, rgbe, rle=rle)
        assert _check(path) == (True, False)


HEADERS = {
    "RGBE": b"#?RGBE\n",
    "lines before": b"#?RADIANCE\nEXPOSURE=1.0\nSOFTWARE=x\n",
    "a blank line first": b"#?RADIANCE\n\n",
    "a long line": b"#?RGBE" + b"x" * 200 + b"\n",
}
TAILS = {
    "+Y": b"FORMAT=32-bit_rle_rgbe\n\n+Y 3 +X 9\n",
    "-X": b"FORMAT=32-bit_rle_rgbe\n\n-Y 3 -X 9\n",
    "X first": b"FORMAT=32-bit_rle_rgbe\n\n+X 9 -Y 3\n",
    "xyze": b"FORMAT=32-bit_rle_xyze\n\n-Y 3 +X 9\n",
    "lines after FORMAT": b"FORMAT=32-bit_rle_rgbe\nGAMMA=2\n\n-Y 3 +X 9\n",
    "no spaces": b"FORMAT=32-bit_rle_rgbe\n\n-Y3+X9\n",
    "CR LF": b"FORMAT=32-bit_rle_rgbe\r\n\r\n-Y 3 +X 9\r\n",
    "trailing blanks": b"FORMAT=32-bit_rle_rgbe  \n\n-Y 3 +X 9\n",
    "zero height": b"FORMAT=32-bit_rle_rgbe\n\n-Y 0 +X 9\n",
}


@pytest.mark.parametrize("tail", list(TAILS))
@pytest.mark.parametrize("head", list(HEADERS))
def test_hdr_headers(tmp_path, head, tail):
    rng = np.random.RandomState(len(head) + len(tail))
    path = str(tmp_path / "h.hdr")
    body = b"".join(hdr_rle_row(r) for r in _rgbe(rng, 3, 9))
    with open(path, "wb") as f:
        f.write(HEADERS[head] + TAILS[tail] + body)
    _check(path)


def test_hdr_streams_at_their_edges(tmp_path):
    """A row that does not start 2 2 ends the encoding (the rest flat), a
    row of another width, a run of 0 or past its channel, cut files, and
    what cv2 writes."""
    rng = np.random.RandomState(3)
    path = str(tmp_path / "e.hdr")
    rgbe = _rgbe(rng, 4, 10)
    rows = [hdr_rle_row(r) for r in rgbe]
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 10\n"
    streams = [rows[0] + rgbe[1:].tobytes(),
               rows[0] + hdr_rle_row(rgbe[1, :9]) + b"".join(rows[2:]),
               rows[0] + bytes([2, 2, 0, 10, 128, 5]) + bytes(80),
               rows[0] + bytes([2, 2, 0, 10, 139, 5]) + bytes(80)]
    for body in streams:
        with open(path, "wb") as f:
            f.write(head + body)
        _check(path)
    data = head + b"".join(rows)
    for cut in range(len(head) - 5, len(data), 17):
        with open(path, "wb") as f:
            f.write(data[:cut])
        _check(path)
    for scale in (0.001, 1.0, 1e3, 1e30):
        f = (rng.rand(6, 11, 3) * scale).astype(np.float32)
        assert cv2.imwrite(path, f)
        assert _check(path) == (True, False)


def test_hdr_grays():
    """cv2 5.0's float gray and 8-bit gray, on values where the other sums
    part from them by an ulp and a unit."""
    bgr = np.array([[[2.84375, 2.5625, 5.4375]]], np.float32)
    assert hdr.gray_float(bgr)[0, 0] == np.float32(3.4541876)
    b, g, r = bgr[0, 0]
    other = hdr.fma32(np.array([r]), 0.299, hdr.fma32(
        np.array([g]), 0.587, np.array([b]) * np.float32(0.114)))
    assert other[0] == np.float32(3.4541874)
    c = np.array([[201, 187, 83], [10, 2, 14]], np.uint8)
    np.testing.assert_array_equal(hdr.gray_u8(c), [157, 7])
    x = np.array([1.0], np.float32)
    assert hdr.fma32(x, 1.0, np.array([2.0 ** -24], np.float32))[0] == 1.0


@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
@pytest.mark.parametrize("kind", ["standard", "rgb", "rle", "map",
                                  "short map"])
def test_sun_raster(tmp_path, depth, kind):
    """Each depth in each type, with and without a colour map: cv2 reads
    types 0 and 1 of depths 1, 8, 24 and 32 (a map only below 24 bits; a
    gray read of a file of no map is 0), PIL all types but 4-bit maps'
    and 1-bit ones'."""
    rng = np.random.RandomState(depth * 11 + len(kind))
    path = str(tmp_path / "s.ras")
    for H, W in ((1, 1), (5, 7), (6, 16), (9, 13)):
        if depth in (1, 4, 8):
            px = rng.randint(0, 1 << depth, (H, W)).astype(np.uint8)
        else:
            px = rng.randint(0, 256, (H, W, depth // 8)).astype(np.uint8)
        if depth == 4:
            # two 4-bit indices a byte, written as 8-bit rows of half width
            pairs = np.zeros((H, (W + 1) // 2 * 2), np.uint8)
            pairs[:, :W] = px
            px8 = (pairs[:, 0::2] << 4 | pairs[:, 1::2]).astype(np.uint8)
            write_sunras(path, px8, 8, rle=kind == "rle")
            with open(path, "rb") as f:
                data = bytearray(f.read())
            data[4:8] = W.to_bytes(4, "big")
            data[12:16] = (4).to_bytes(4, "big")
            with open(path, "wb") as f:
                f.write(bytes(data))
            _check(path)
            continue
        if np.ndim(px) == 3:
            px[:, ::2] = px[:, :1]
        pal = None
        if kind in ("map", "short map"):
            n = 1 << min(depth, 8) if kind == "map" else 3
            pal = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        write_sunras(path, px, depth, palette=pal, rle=kind == "rle",
                     rgb=kind == "rgb")
        _check(path)


def test_sun_raster_edges(tmp_path):
    """Cut anywhere, a run across a row's end (PIL carries it on), the
    0x80 escape, the GIMP brush PIL opens first (width 1, length 1 or
    4), and cv2's own 8- and 24-bit files."""
    rng = np.random.RandomState(5)
    path = str(tmp_path / "e.ras")
    px = np.repeat(rng.randint(0, 256, (6, 3)), 5, 1)[:, :13].astype(np.uint8)
    px[2, 4:7] = 0x80
    write_sunras(path, px, 8, rle=True)
    with open(path, "rb") as f:
        data = f.read()
    seen = set()
    for cut in range(20, len(data), 7):
        with open(path, "wb") as f:
            f.write(data[:cut])
        seen.add(_check(path))
    assert (False, False) in seen
    for length in (1, 4, 9):
        write_sunras(path, np.array([[5], [7]], np.uint8), 8)
        with open(path, "rb") as f:
            d = bytearray(f.read())
        d[16:20] = length.to_bytes(4, "big")
        with open(path, "wb") as f:
            f.write(bytes(d))
        assert _check(path) == (True, length not in (1, 4))
    for img in (rng.randint(0, 256, (7, 9, 3)).astype(np.uint8),
                rng.randint(0, 256, (7, 9)).astype(np.uint8)):
        assert cv2.imwrite(path, img)
        assert _check(path) == (True, True)
