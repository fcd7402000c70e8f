"""The arithmetic-coded, lossless and 12-bit JPEGs of ROADMAP.md queue 1
item 24 through ``io/jpeg.py`` (``csrc/jpeg_decode.cpp``:
``jpeg_decode_arith_scan``, ``jpeg_decode_lossless_scan``) and
``io/datasets.py`` against ``cv2.imread`` (cv2 5.0, libjpeg-turbo 3.1.2)
and PIL 12.1 (libjpeg-turbo 3.1) on the same bytes.

The files come from ``tests/image_encoders.py``: arithmetic coding
(``reencode_jpeg(arithmetic=True)``, T.81 Annex D as jcarith.c writes it)
of a baseline file's coefficients, lossless files
(``write_lossless_jpeg``), 12-bit ones (``encode_coefficients``). The
encoder is held to the standard apart from the port: cv2's read of an
arithmetic re-coding equals its read of the baseline file.

Found by probe and held here: cv2 and PIL call libjpeg-turbo's 8-bit
interface, so every 12-bit JPEG and every lossless one of 9-16 bits gives
None in cv2 under each flag and raises in PIL (PIL also refuses lossless
files of 2-7 bits); an arithmetic-coded lossless file (SOF11) fails in
both; a lossless file converts no colours (gray only to gray, RGB only to
BGR, a JFIF one to nothing), is box-upsampled, and one without JFIF or
Adobe markers is RGB whatever its component ids; PIL fails on an
arithmetic-coded scan that crosses one of the 64 KiB blocks it feeds
libjpeg. Bar: bit-equal, None where cv2 gives None, a raise where PIL
raises; the C++ decoders equal their Python versions on every file.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import (Scan, encode_coefficients, reencode_jpeg,
                                  write_lossless_jpeg)
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import jpeg

FLAGS = (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH)
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111}
JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def _adobe(transform):
    return b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes(
        [transform])


def _image(h, w, seed):
    rng = np.random.RandomState(seed)
    return cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                            (5, 5), 2)


def _check(tmp_path, data, plain=True):
    """The port against cv2's three reads (C++ and, with ``plain``, the
    Python decoders) and against PIL; returns (cv2's colour read gave an
    image, PIL did)."""
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    seen = []
    for flag in FLAGS:
        ref = cv2.imread(path, flag)
        got = td.imread(path, flag)
        reads = [got]
        if plain:
            try:
                reads.append(jpeg.decode_jpeg(
                    data, gray=flag != td.IMREAD_COLOR, plain=True))
            except jpeg.CorruptJpeg:
                reads.append(None)
        for r in reads:
            if ref is None:
                assert r is None, flag
            else:
                assert r is not None and r.dtype == ref.dtype \
                    and r.shape == ref.shape, flag
                np.testing.assert_array_equal(r, ref)
        seen.append(ref is not None)
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        return seen[0], False
    np.testing.assert_array_equal(td.read_rgb_pil(path), ref)
    return seen[0], True


SCRIPTS = {
    "sequential": (dict(scans=[Scan([0, 1, 2])], progressive=False)),
    "restarts": dict(scans=[Scan([0, 1, 2])], progressive=False, restart=3),
    "dac": dict(scans=[Scan([0, 1, 2])], progressive=False,
                dac={0: 0x52, 1: 0x31, 16: 2, 17: 30}),
    "two scans": dict(scans=[Scan([0]), Scan([1, 2])], progressive=False),
    "progressive": dict(scans=[Scan([0, 1, 2], 0, 0, 0)] + [
        Scan([c], 1, 63, 0) for c in range(3)], progressive=True),
    "successive approximation": dict(scans=[
        Scan([0, 1, 2], 0, 0, 1), Scan([0], 1, 5, 2), Scan([1], 1, 63, 1),
        Scan([2], 1, 63, 1), Scan([0], 6, 63, 2),
        Scan([0, 1, 2], 0, 0, 0, ah=1), Scan([0], 1, 63, 1, ah=2),
        Scan([0], 1, 63, 0, ah=1), Scan([1], 1, 63, 0, ah=1),
        Scan([2], 1, 63, 0, ah=1)], progressive=True, restart=2,
        dac={0: 0x20, 16: 60}),
    "smoothing": dict(scans=[Scan([0, 1, 2], 0, 0, 1), Scan([0], 1, 5, 0)],
                      progressive=True),
}


@pytest.mark.parametrize("layout", list(SAMPLING))
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_arithmetic_recoding_reads_as_cv2_and_pil(tmp_path, layout, script):
    """An arithmetic re-coding of a cv2 baseline file: cv2 reads it as it
    reads the baseline file (the encoder is right), the port reads it as
    cv2 and PIL do; cut at three points and with bytes overwritten in its
    scans, as they do too (jdarith.c's zero data past a marker, its error
    state that leaves the restart interval as it was)."""
    img = _image(21, 35, len(script))
    base = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      SAMPLING[layout]])[1].tobytes()
    data = reencode_jpeg(base, arithmetic=True, **SCRIPTS[script])
    assert (b"\xff\xca" if SCRIPTS[script]["progressive"]
            else b"\xff\xc9") in data
    if script != "smoothing":      # every coefficient sent
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(data, np.uint8), 1),
            cv2.imdecode(np.frombuffer(base, np.uint8), 1))
    assert _check(tmp_path, data) == (True, True)
    rng = np.random.RandomState(len(script) + len(layout))
    for cut in (0.4, 0.7, 0.95):
        _check(tmp_path, data[:int(len(data) * cut)])
    start = data.find(b"\xff\xda") + 14
    for _ in range(2):
        bad = bytearray(data)
        for i in rng.randint(start, len(data) - 2, 3):
            bad[i] = rng.randint(256)
        _check(tmp_path, bytes(bad))


@pytest.mark.parametrize("what", ["gray", "tables 2 and 15", "dc only"])
def test_arithmetic_gray_table_numbers_and_dc_only(tmp_path, what):
    """A gray file; conditioning tables numbered past 3 (arithmetic coding
    has 16, set by DAC); a progressive script that sends only DC bands."""
    img = _image(17, 26, 7)
    if what == "gray":
        base = cv2.imencode(".jpg", img[..., 0])[1].tobytes()
        data = reencode_jpeg(base, [Scan([0])], progressive=False,
                             arithmetic=True, restart=2)
    elif what == "dc only":
        base = cv2.imencode(".jpg", img)[1].tobytes()
        data = reencode_jpeg(base, [Scan([0, 1, 2], 0, 0, 2), Scan(
            [0, 1, 2], 0, 0, 1, ah=2)], progressive=True, arithmetic=True)
    else:
        base = cv2.imencode(".jpg", img)[1].tobytes()
        data = bytearray(reencode_jpeg(base, [Scan([0, 1, 2])],
                                       progressive=False, arithmetic=True,
                                       dac={0: 0x41, 1: 0x33, 16: 9,
                                            17: 1}))
        sos = data.find(b"\xff\xda")
        for k in range(3):       # name tables 2 and 15 in the scan
            data[sos + 6 + 2 * k] = 0x22 if k == 0 else 0xFF
        dac = data.find(b"\xff\xcc")
        data[dac + 4:dac + 12] = bytes([2, 0x41, 15, 0x33, 18, 9, 31, 1])
        data = bytes(data)
    assert _check(tmp_path, data)[0]


def test_pil_fails_where_an_arithmetic_scan_crosses_its_block(tmp_path):
    """PIL feeds libjpeg 64 KiB at a time and jdarith.c cannot suspend:
    a scan whose data runs past a block's end fails ("broken data
    stream"); cv2's stdio source reads on. Files on both sides of the
    boundary."""
    rng = np.random.RandomState(3)
    outcomes = set()
    for h, w in ((90, 120), (300, 380)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        base = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                          95])[1].tobytes()
        for progressive in (False, True):
            scans = [Scan([0, 1, 2], 0, 0, 0)] + [
                Scan([c], 1, 63, 0) for c in range(3)] if progressive \
                else [Scan([0, 1, 2])]
            data = reencode_jpeg(base, scans, progressive=progressive,
                                 arithmetic=True)
            outcomes.add(_check(tmp_path, data, plain=False))
    assert outcomes == {(True, True), (True, False)}


PRECISIONS = [2, 5, 8]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_gray_reads_as_cv2_and_pil(tmp_path, precision, predictor):
    """Gray lossless files of each predictor, point transforms 0 and 1, a
    restart every MCU row or none: cv2's gray reads (its colour read
    fails), PIL's at 8 bits (it refuses the others)."""
    rng = np.random.RandomState(precision * 8 + predictor)
    g = rng.randint(0, 1 << precision, (9, 14))
    for pt, rows in ((0, 0), (1, 1)):
        data = write_lossless_jpeg([g], precision=precision,
                                   predictor=predictor, pt=pt,
                                   restart_rows=rows)
        got = td.imread(_path(tmp_path, data), td.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(got, (g >> pt) << pt)
        assert _check(tmp_path, data) == (False, precision == 8)


def _path(tmp_path, data):
    path = str(tmp_path / "g.jpg")
    with open(path, "wb") as f:
        f.write(data)
    return path


@pytest.mark.parametrize("case", [
    "rgb", "rgb 420", "rgb 420 scans", "rgb 422 restarts", "cmyk", "ycck",
    "jfif", "adobe rgb", "adobe ycc", "ids RGB", "ids 4 5 6", "rgb 6-bit"])
def test_lossless_colour_reads_as_cv2_and_pil(tmp_path, case):
    """Three- and four-component lossless files: RGB (box-upsampled where
    subsampled, one scan a component, restarts), CMYK, and the colour
    spaces libjpeg cannot convert in lossless mode (YCbCr by JFIF or Adobe
    transform 1, YCCK): the port reads or fails as cv2 and PIL do."""
    rng = np.random.RandomState(len(case))
    P = 6 if "6-bit" in case else 8
    planes = [rng.randint(0, 1 << P, (13, 17)) for _ in range(4)]
    kw = dict(precision=P, predictor=int(rng.randint(1, 8)))
    if case == "cmyk":
        data = write_lossless_jpeg(planes, **kw)
    elif case == "ycck":
        data = write_lossless_jpeg(planes, head=_adobe(2), **kw)
    elif case.startswith("rgb 42"):
        sub = planes[:1] + [p[:, :9] if case == "rgb 422 restarts"
                            else p[:7, :9] for p in planes[1:3]]
        samp = [(2, 1) if "422" in case else (2, 2), (1, 1), (1, 1)]
        data = write_lossless_jpeg(sub, sampling=samp, size=(13, 17),
                                   interleave="scans" not in case,
                                   restart_rows=2 if "restarts" in case
                                   else 0, **kw)
    else:
        head = {"jfif": JFIF, "adobe rgb": _adobe(0),
                "adobe ycc": _adobe(1)}.get(case, b"")
        ids = {"ids RGB": [82, 71, 66], "ids 4 5 6": [4, 5, 6]}.get(case)
        data = write_lossless_jpeg(planes[:3], head=head, ids=ids, **kw)
    colour, pil = _check(tmp_path, data)
    assert colour == (case not in ("jfif", "adobe ycc", "ycck"))


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgb scans"])
def test_lossless_cut_and_corrupt_read_as_cv2_and_pil(tmp_path, kind):
    """Lossless files cut at every tenth of their data and with bytes
    overwritten: the rest of the MCU row from zero bits, then rows of the
    restarted predictor's value, as libjpeg-turbo gives them; a file of
    one scan a component cut before its last scan starts fails (the
    components no scan reached are read from a buffer never written)."""
    rng = np.random.RandomState(11)
    n = 1 if kind == "gray" else 3
    data = write_lossless_jpeg([rng.randint(0, 256, (12, 15))
                                for _ in range(n)], precision=8, predictor=4,
                               restart_rows=0 if "scans" in kind else 3,
                               interleave="scans" not in kind)
    start = data.find(b"\xff\xda") + 8 + 2 * n
    seen = set()
    for k in range(1, 10):
        seen.add(_check(tmp_path,
                        data[:start + (len(data) - start) * k // 10])[0])
    # (a gray file's colour read fails at every cut: lossless converts none)
    assert seen == {"gray": {False}, "rgb": {True},
                    "rgb scans": {False, True}}[kind]
    for _ in range(4):
        bad = bytearray(data)
        for i in rng.randint(start, len(data) - 2, 2):
            bad[i] = rng.randint(256)
        _check(tmp_path, bytes(bad))


@pytest.mark.parametrize("case", [
    "lossless 9-bit", "lossless 12-bit", "lossless 16-bit", "lossy 12-bit",
    "progressive 12-bit", "arithmetic 12-bit", "sof11"])
def test_modes_cv2_and_pil_cannot_read_fail_as_they_do(tmp_path, case):
    """What libjpeg-turbo decodes only through its 12- and 16-bit
    interfaces, which neither cv2 nor PIL calls, and SOF11, which it does
    not decode: None in cv2 under every flag, a raise in PIL, and the same
    in the port (no ValueError naming an item: there is no image to
    port)."""
    rng = np.random.RandomState(5)
    if case.startswith("lossless"):
        P = int(case.split()[1].split("-")[0])
        data = write_lossless_jpeg([rng.randint(0, 1 << P, (6, 9))],
                                   precision=P, predictor=2)
    elif case == "sof11":
        data = bytearray(write_lossless_jpeg([rng.randint(0, 256, (6, 9))],
                                             precision=8, predictor=2))
        data[data.find(b"\xff\xc3") + 1] = 0xCB
        data = bytes(data)
    else:
        base = cv2.imencode(".jpg", _image(16, 24, 3))[1].tobytes()
        co = jpeg.read_coefficients(base)
        co12 = co._replace(frame=co.frame._replace(precision=12),
                           quant=[q * 16 for q in co.quant])
        scans = [Scan([0, 1, 2], 0, 0, 0)] + [
            Scan([c], 1, 63, 0) for c in range(3)]
        data = encode_coefficients(
            co12, scans if case.startswith("progressive") else
            [Scan([0, 1, 2])], progressive=case.startswith("progressive"),
            arithmetic=case.startswith("arithmetic"))
    assert _check(tmp_path, data) == (False, False)


def _both(data):
    """``read_coefficients`` by the C++ and by the Python scan decoders:
    both results, or (None, None) where both fail alike."""
    out = []
    for plain in (False, True):
        try:
            out.append(jpeg.read_coefficients(data, plain=plain))
        except jpeg.CorruptJpeg as e:
            out.append(str(e))
    if isinstance(out[0], str):
        assert out[0] == out[1]
        return None, None
    return out


def test_cpp_scan_decoders_equal_their_python_versions():
    """``jpeg_decode_arith_scan`` and ``jpeg_decode_lossless_scan`` against
    ``arith_scan_plain`` and ``lossless_scan_plain`` on random scan data
    (the coefficient buffers and planes they leave, their stop records),
    under every table and script shape."""
    rng = np.random.RandomState(9)
    base = cv2.imencode(".jpg", _image(19, 27, 1))[1].tobytes()
    for script in SCRIPTS.values():
        good = reencode_jpeg(base, arithmetic=True, **script)
        start = good.find(b"\xff\xda")
        for _ in range(3):
            data = bytearray(good)
            data[start + 14:] = rng.randint(0, 256, len(data) - start - 14,
                                            ).astype(np.uint8).tobytes()
            a, b = _both(bytes(data))
            if a is not None:
                for x, y in zip(a.coefs, b.coefs):
                    np.testing.assert_array_equal(x, y)
                assert a.last_good == b.last_good and a.scans == b.scans
    for P, n, psv in ((8, 1, 4), (3, 3, 7), (8, 4, 6)):
        good = write_lossless_jpeg([rng.randint(0, 1 << P, (10, 13))
                                    for _ in range(n)], precision=P,
                                   predictor=psv, restart_rows=2)
        start = good.find(b"\xff\xda") + 8 + 2 * n
        for _ in range(3):
            data = bytearray(good)
            k = rng.randint(start, len(data))
            data[k:] = rng.randint(0, 256, len(data) - k).astype(
                np.uint8).tobytes()
            a, b = _both(bytes(data))
            if a is not None:
                for x, y in zip(a.planes, b.planes):
                    np.testing.assert_array_equal(x, y)


def test_committed_jpeg24_fixtures_read_as_cv2_and_pil():
    """What chip_smoke.py phase (u1) checks on the card for tests/data/
    jpeg24 (the digests of cv2's and PIL's reads), here also against cv2
    and PIL themselves."""
    import os

    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert chip_smoke.check_format_fixtures(root, ("jpeg24",)) == 14 * 7
    directory = os.path.join(root, "tests", "data", "jpeg24")
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            data = f.read()
        ref = cv2.imread(os.path.join(directory, name))
        got = td.imread(os.path.join(directory, name))
        assert (ref is None) == (got is None), name
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
        try:
            pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except (OSError, ValueError, SyntaxError):
            continue
        np.testing.assert_array_equal(
            td.read_rgb_pil(os.path.join(directory, name)), pil)


@pytest.mark.parametrize("dac", [
    "00 21", "00 12", "00 21 00", "20 05", "10 05", "", "05", "1f 3f 0f ff"])
def test_dac_segments_as_cv2_reads_them(tmp_path, dac):
    """DAC segments in a Huffman-coded file, which libjpeg parses all the
    same: a valid one, L above U, an odd length, an index past 31, an AC
    table's K, an empty one; None where cv2 gives None."""
    import struct

    body = bytes.fromhex(dac)
    base = cv2.imencode(".jpg", _image(16, 16, 2))[1].tobytes()
    data = base[:2] + b"\xff\xcc" + struct.pack(">H", len(body) + 2) + \
        body + base[2:]
    _check(tmp_path, data)
