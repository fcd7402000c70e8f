"""The port's Netpbm reader (``io/pxm.py``: PBM, PGM, PPM, PAM, PFM)
through ``io/datasets.imread`` against ``cv2.imread`` (IMREAD_COLOR,
IMREAD_GRAYSCALE, IMREAD_ANYDEPTH) and through ``read_rgb_pil`` against
PIL's ``Image.open(p).convert("RGB")``, on the same bytes.

Bar: bit-equal, None where cv2 gives None, a raise where PIL raises. The
files: every kind in ASCII and binary at maxvals 1 to 65535 (cv2 scales
ASCII 8-bit samples and clamps ASCII ones, takes binary ones as stored;
PIL scales each by Python's round), headers with comments, tabs, CR LF,
comments inside and right after numbers, odd numbers; samples past
maxval, negative or non-numeric, files cut anywhere; PAM of each TUPLTYPE
cv2 reads (an alpha channel raises ValueError naming item 28a); PFM of
either scale sign, channel count and special values (cv2 5.0 gives None
where the read's channel count is not the file's).
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import pxm

FLAGS = (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH)


def _check(path, data):
    """``data`` at ``path`` read by the port as cv2 reads it in its three
    modes and as PIL reads it; returns (cv2 gave an image, PIL did)."""
    with open(path, "wb") as f:
        f.write(data)
    seen = []
    for flag in FLAGS:
        ref = cv2.imread(path, flag)
        got = td.imread(path, flag)
        if ref is None:
            assert got is None, (data[:40], flag)
        else:
            assert got is not None and got.dtype == ref.dtype \
                and got.shape == ref.shape, (data[:40], flag)
            np.testing.assert_array_equal(got, ref)
        seen.append(ref is not None)
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        return seen[0], False
    got = td.read_rgb_pil(path)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, ref)
    return seen[0], True


def _file(kind, px, maxval, sep=b"\n", ascii_sep=b" "):
    H, W = px.shape[:2]
    head = b"P%d" % kind + sep + b"%d %d" % (W, H)
    if kind in (1, 4):
        body = px.reshape(H, -1)
    else:
        head += sep + b"%d" % maxval
        body = px
    if kind <= 3:
        return head + b"\n" + ascii_sep.join(
            b"%d" % v for v in body.reshape(-1)) + b"\n"
    if kind == 4:
        return head + b"\n" + np.packbits(body, axis=1).tobytes()
    return head + b"\n" + (body.astype(">u2") if maxval > 255
                           else body.astype(np.uint8)).tobytes()


SIZES = [(1, 1), (3, 5), (8, 8), (13, 9), (2, 31)]


@pytest.mark.parametrize("maxval", [1, 2, 5, 100, 255, 256, 1000, 4095,
                                    65534, 65535])
@pytest.mark.parametrize("kind", [2, 3, 5, 6])
def test_gray_and_colour_at_every_maxval(tmp_path, kind, maxval):
    rng = np.random.RandomState(kind * 7 + maxval % 97)
    nch = 3 if kind in (3, 6) else 1
    for i, (H, W) in enumerate(SIZES):
        px = rng.randint(0, maxval + 1, (H, W, nch))
        if i == 1:
            px[..., 0] = maxval          # the top and the bottom
            px[..., -1] = 0
        assert _check(str(tmp_path / "p.pnm"), _file(kind, px, maxval)) \
            == (True, True)


@pytest.mark.parametrize("kind", [1, 4])
def test_bitmaps(tmp_path, kind):
    rng = np.random.RandomState(kind)
    for H, W in SIZES + [(4, 9), (7, 16)]:
        bits = rng.randint(0, 2, (H, W)).astype(np.uint8)
        assert _check(str(tmp_path / "b.pbm"), _file(kind, bits, 1)) \
            == (True, True)
    # P1's digits need no separators; a digit past 1 is black in cv2 and
    # refused by PIL
    _check(str(tmp_path / "b.pbm"), b"P1\n3 2\n010110\n")
    _check(str(tmp_path / "b.pbm"), b"P1\n3 2\n0 2 0 1 1 0\n")


HEADERS = {
    "tabs": b"P5\t3\t2\t255\t",
    "crlf": b"P5\r\n3 2\r\n255\r\n",
    "comment lines": b"P5\n# a\n# b\n3 2\n255\n",
    "comment after a number": b"P5\n3 2 # size\n255\n",
    "comment right after maxval": b"P5\n3 2\n255#x\n",
    "comment inside a number": b"P5\n3 2\n2#x\n55\n",
    "comment ended by CR": b"P5\n#c\r3 2\n255\n",
    "two spaces": b"P5\n3  2\n255\n",
    "leading zeros": b"P5\n003 2\n0255\n",
    "plus sign": b"P5\n+3 2\n255\n",
    "maxval 0": b"P5\n3 2\n0\n",
    "maxval 65536": b"P5\n3 2\n65536\n",
    "width 0": b"P5\n0 2\n255\n",
    "no whitespace after the magic": b"P5x3 2\n255\n",
    "number too long": b"P5\n99999999999 2\n255\n",
}


@pytest.mark.parametrize("case", list(HEADERS))
def test_headers_where_the_readers_part(tmp_path, case):
    """cv2 reads digits only and consumes one byte after a number (a
    comment right after maxval eats the raster's first byte); PIL's tokens
    end at whitespace and skip comments inside them."""
    px = bytes(range(7, 7 + 12))
    _check(str(tmp_path / "h.pgm"), HEADERS[case] + px + b"tail")


ASCII_RASTERS = {
    "above maxval": b"1 2 300 4 5 6",
    "negative": b"1 -2 3 4 5 6",
    "a letter": b"1 x 3 4 5 6",
    "huge": b"1 2 99999999999 4 5 6",
    "short": b"1 2 3 4 5",
    "no whitespace at the end": b"1 2 3 4 5 6",
    "a comment": b"1 2 # c\n3 4 5 6\n",
    "a long last token": b"1 2 3 4 5 6 12345678901",
    "extra values": b"1 2 3 4 5 6 7 8 9\n",
}


@pytest.mark.parametrize("case", list(ASCII_RASTERS))
@pytest.mark.parametrize("maxval", [255, 1000])
def test_ascii_rasters_at_their_edges(tmp_path, case, maxval):
    data = b"P2\n3 2\n%d\n" % maxval + ASCII_RASTERS[case]
    _check(str(tmp_path / "a.pgm"), data)


@pytest.mark.parametrize("kind", [1, 2, 3, 4, 5, 6])
def test_cut_files(tmp_path, kind):
    """Cut anywhere: None where cv2's reads run out, a raise where PIL's
    do."""
    rng = np.random.RandomState(10 + kind)
    maxval = 1 if kind in (1, 4) else (300 if kind in (5, 6) else 255)
    nch = 3 if kind in (3, 6) else 1
    px = rng.randint(0, maxval + 1, (5, 7, nch))
    if kind in (1, 4):
        px = px[..., 0].astype(np.uint8)
    data = _file(kind, px, maxval)
    seen = set()
    for cut in sorted(set(np.linspace(1, len(data) - 1, 12).astype(int))):
        seen.add(_check(str(tmp_path / "c.pnm"), data[:cut]))
    assert (False, False) in seen


@pytest.mark.parametrize("tupltype", [
    cv2.IMWRITE_PAM_FORMAT_GRAYSCALE, cv2.IMWRITE_PAM_FORMAT_RGB,
    cv2.IMWRITE_PAM_FORMAT_BLACKANDWHITE, cv2.IMWRITE_PAM_FORMAT_NULL],
    ids=["gray", "rgb", "bw", "none"])
@pytest.mark.parametrize("depth", [8, 16])
def test_pam_as_cv2_writes_it(tmp_path, tupltype, depth):
    """cv2's PAM: samples as stored, an RGB file read in colour keeps its
    R, G, B order, MAXVAL 1 reads packed bits; PIL opens no PAM; the
    empty TUPLTYPE cv2 writes for FORMAT_NULL is one it cannot read."""
    rng = np.random.RandomState(tupltype + depth)
    c = 3 if tupltype == cv2.IMWRITE_PAM_FORMAT_RGB else 1
    for H, W in SIZES:
        img = rng.randint(0, 1 << depth, (H, W, c)).astype(
            np.uint16 if depth == 16 else np.uint8)
        if tupltype == cv2.IMWRITE_PAM_FORMAT_BLACKANDWHITE:
            img = (img & 1).astype(np.uint8)
        ok, enc = cv2.imencode(".pam", img, [cv2.IMWRITE_PAM_TUPLETYPE,
                                             tupltype])
        assert ok
        # cv2 writes an empty TUPLTYPE for FORMAT_NULL and fails on it
        assert _check(str(tmp_path / "p.pam"), enc.tobytes()) == (
            tupltype != cv2.IMWRITE_PAM_FORMAT_NULL, False)


def _pam(depth, maxval, tupltype, px):
    H, W = px.shape[:2]
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (
        W, H, depth, maxval)
    if tupltype:
        head += b"TUPLTYPE " + tupltype + b"\n"
    return head + b"# a comment\nENDHDR\n" + (
        px.astype(">u2") if maxval > 255 else px.astype(np.uint8)).tobytes()


@pytest.mark.parametrize("case", [
    (1, 100, b"GRAYSCALE"), (3, 200, b"RGB"), (1, 1, b""), (1, 255, b""),
    (3, 255, b""), (1, 1000, b""), (2, 255, b""), (4, 255, b""),
    (1, 255, b"GRAY"), (5, 255, b"RGB"), (1, 1, b"GRAYSCALE")],
    ids=lambda c: f"d{c[0]}-m{c[1]}-{c[2].decode() or 'none'}")
def test_pam_headers(tmp_path, case):
    """MAXVAL below 255 is not scaled, 1 is bit mode whatever TUPLTYPE; a
    file of no TUPLTYPE must be 8-bit gray or RGB; an unknown TUPLTYPE or
    DEPTH fails, as in cv2."""
    depth, maxval, tupltype = case
    rng = np.random.RandomState(depth * 13 + maxval)
    px = rng.randint(0, maxval + 1, (4, 6, depth))
    _check(str(tmp_path / "p.pam"), _pam(depth, maxval, tupltype, px))


@pytest.mark.parametrize("tupltype,depth", [
    (b"RGB_ALPHA", 4), (b"GRAYSCALE_ALPHA", 2), (b"RGB", 1),
    (b"GRAYSCALE", 3)])
def test_pam_that_cv2_reads_from_memory_it_never_writes(tmp_path, tupltype,
                                                        depth):
    """An alpha channel, or a TUPLTYPE that does not match DEPTH: cv2
    leaves part of its image unwritten, so the port raises ValueError
    naming item 28a (a known deviation)."""
    px = np.full((3, 5, depth), 9)
    path = str(tmp_path / "a.pam")
    with open(path, "wb") as f:
        f.write(_pam(depth, 255, tupltype, px))
    with pytest.raises(ValueError, match="item 28a"):
        td.imread(path)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("scale", [-1.0, 1.0, -3.0, 0.25, -123.456])
def test_pfm(tmp_path, channels, scale):
    """Rows bottom-up, samples over |scale| in float32 (little-endian for
    a negative scale), the 8-bit reads rounded half to even and saturated,
    NaN and out-of-range values 0; cv2 5.0 gives None where the read's
    channel count is not the file's (a cv2 fault the JAX package
    inherits); PIL opens ``Pf`` (unscaled, truncated) and not ``PF``."""
    rng = np.random.RandomState(channels)
    vals = (rng.randn(6, 7, channels) * 200).astype(np.float32)
    vals.flat[:8] = [0.5, 1.5, 2.5, np.nan, np.inf, -np.inf, 3e10, 254.5]
    head = b"P%s\n7 6\n%r\n" % (b"F" if channels == 3 else b"f", scale)
    data = head + vals.astype("<f4" if scale < 0 else ">f4").tobytes()
    want_pil = channels == 1
    assert _check(str(tmp_path / "p.pfm"), data) == (channels == 3,
                                                     want_pil)


def test_pfm_as_cv2_writes_it_and_cut(tmp_path):
    rng = np.random.RandomState(5)
    for shape in ((9, 4), (9, 4, 3)):
        ok, enc = cv2.imencode(".pfm", (rng.rand(*shape) * 2).astype(
            np.float32))
        data = enc.tobytes()
        _check(str(tmp_path / "p.pfm"), data)
        for cut in (3, 10, len(data) // 2, len(data) - 1):
            _check(str(tmp_path / "p.pfm"), data[:cut])
    _check(str(tmp_path / "p.pfm"), b"Pf\n2 1\nabc\n" + bytes(8))
    _check(str(tmp_path / "p.pfm"), b"Pf 2 1\n-1\n" + bytes(8))


def test_saturate_matches_cv2_rounding():
    v = np.array([0.5, 1.5, 2.5, -0.4, 255.4, 255.5, 256, np.nan, 2.0 ** 31,
                  -(2.0 ** 31) - 256, 2.0 ** 31 - 128], np.float32)
    np.testing.assert_array_equal(pxm.saturate_u8(v),
                                  [0, 2, 2, 0, 255, 255, 255, 0, 0, 0, 255])
