"""The port's JPEG decoder (``io/jpeg.py``, ``csrc/jpeg_decode.cpp``) and
``io/datasets.imread`` on JPEG files, against ``cv2.imread`` on the same
bytes (cv2 5.0 with libjpeg-turbo 3.1).

Every read is bit-equal to cv2's: each sampling layout cv2 writes (4:4:4,
4:2:2, 4:2:0, 4:4:0, 4:1:1), gray files, restart intervals, optimised
Huffman tables, qualities 5-100 (16-bit DQT tables at the lowest), odd and
tiny frame sizes, EXIF orientations 1-8, files cut short at every 97th
byte and files with bytes overwritten inside the entropy-coded data. The
C++ steps are bit-equal to their numpy plain versions; the committed
fixtures (tests/data/jpeg, tools/make_jpeg_fixtures.py) decode to the
arrays committed beside them. Lossless, arithmetic-coded and 12-bit files
read as cv2 reads them (test_torch_jpeg_arith.py holds them at length;
progressive ones: test_torch_jpeg_progressive.py); the format follows the
signature, not the extension."""

import hashlib
import os
import shutil
import struct

import cv2
import numpy as np
import pytest

from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import jpeg

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jpeg")
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}
SIZES = [(37, 53), (64, 96), (1, 7), (5, 2), (3, 3), (9, 17)]


def _image(h, w, seed, channels=3):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256,
                     ((xx + yy) * 2) % 256], -1)
    noise = rng.randint(0, 256, (h, w, 3))
    img = np.where(rng.rand(h, w, 1) < 0.3, noise, base).astype(np.uint8)
    return img if channels == 3 else img[..., 0]


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return path


def _check(path):
    """Every read of ``path`` in the port against cv2.imread: COLOR,
    GRAYSCALE and ANYDEPTH; None where cv2 gives None."""
    for flag in (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH):
        ref = cv2.imread(path, flag)
        got = td.imread(path, flag)
        if ref is None:
            assert got is None, (path, flag)
            continue
        assert got is not None and got.dtype == ref.dtype \
            and got.shape == ref.shape, (path, flag)
        np.testing.assert_array_equal(got, ref)


def _encode(img, *params):
    ok, enc = cv2.imencode(".jpg", img, list(params))
    assert ok
    return enc.tobytes()


@pytest.mark.parametrize("layout", list(SAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sampling_layouts_bit_equal(tmp_path, layout, size):
    for i, (q, extra) in enumerate([
            (95, []), (50, [cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
            (10, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]), (100, [])]):
        data = _encode(_image(*size, seed=i), cv2.IMWRITE_JPEG_QUALITY, q,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[layout],
                       *extra)
        _check(_write(str(tmp_path / f"{i}.jpg"), data))


@pytest.mark.parametrize("size", SIZES + [(8, 8), (100, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_gray_files_bit_equal(tmp_path, size):
    for i, q in enumerate((90, 5, 100)):
        data = _encode(_image(*size, seed=i, channels=1),
                       cv2.IMWRITE_JPEG_QUALITY, q,
                       cv2.IMWRITE_JPEG_RST_INTERVAL, i)
        _check(_write(str(tmp_path / f"{i}.jpg"), data))


def _sixteen_bit_dqt(data, scale):
    """``data`` with each DQT table rewritten as a 16-bit table (Pq = 1) of
    its values times ``scale``."""
    out, pos = bytearray(data[:2]), 2
    for m, body, end in jpeg._segments(data):
        out += data[pos:end - len(body) - 4]
        if m == 0xDB:
            tables, k = b"", 0
            while k < len(body):
                q = np.frombuffer(body[k + 1:k + 65], np.uint8)
                tables += bytes([0x10 | body[k] & 15]) + (
                    q.astype(np.int64) * scale).astype(">u2").tobytes()
                k += 65
            out += b"\xff\xdb" + struct.pack(">H", len(tables) + 2) + tables
        else:
            out += data[end - len(body) - 4:end]
        pos = end
        if m == 0xDA:
            break
    return bytes(out + data[pos:])


@pytest.mark.parametrize("scale", [1, 3, 300])
def test_sixteen_bit_quantisation_tables(tmp_path, scale):
    """cv2 writes 8-bit DQT tables; the same files with their tables as
    16-bit ones (values up to 76500 past 255 at the largest scale, whose
    dequantised coefficients leave 16 bits) decode as cv2's."""
    for q in (5, 50, 95):
        data = _encode(_image(24, 40, 3), cv2.IMWRITE_JPEG_QUALITY, q)
        wide = _sixteen_bit_dqt(data, scale)
        assert len(wide) == len(data) + 2 * 64   # two tables of 64 values
        _check(_write(str(tmp_path / f"q{q}.jpg"), wide))


def test_truncated_files_as_cv2(tmp_path):
    """Cut at every 97th byte (in the header: None; in the scan: the rest
    of the frame uniform gray, as libjpeg pads with its fake EOI), with and
    without a restart interval."""
    for rst in (0, 3):
        data = _encode(_image(64, 96, rst), cv2.IMWRITE_JPEG_QUALITY, 90,
                       cv2.IMWRITE_JPEG_RST_INTERVAL, rst)
        for cut in [0, 1, 2, 5] + list(range(97, len(data), 97)) + [
                len(data) - 1, len(data) - 2, len(data) - 3]:
            _check(_write(str(tmp_path / f"t{rst}_{cut}.jpg"), data[:cut]))


@pytest.mark.parametrize("quality", [95, 50, 5])
def test_corrupt_entropy_data_as_cv2(tmp_path, quality):
    """One to three bytes overwritten inside the scan: bad Huffman codes,
    stray markers and coefficients past 16 bits (the 16-bit lanes of
    libjpeg-turbo's SIMD IDCT, csrc/jpeg_decode.cpp) decode as cv2's."""
    rng = np.random.RandomState(quality)
    data = _encode(_image(64, 96, 1), cv2.IMWRITE_JPEG_QUALITY, quality,
                   cv2.IMWRITE_JPEG_RST_INTERVAL, 4 if quality == 50 else 0)
    sos = data.find(b"\xff\xda")
    for t in range(40):
        d = bytearray(data)
        for _ in range(rng.randint(1, 4)):
            d[rng.randint(sos + 14, len(d) - 2)] = rng.randint(0, 256)
        _check(_write(str(tmp_path / f"c{t}.jpg"), bytes(d)))


@pytest.mark.parametrize("what", ["no_soi", "no_sof", "bad_dht", "no_dqt",
                                  "empty_frame", "sof5", "unknown_marker"])
def test_corrupt_headers_are_none_as_cv2(tmp_path, what):
    data = bytearray(_encode(_image(16, 24, 0), cv2.IMWRITE_JPEG_QUALITY, 80))

    def seg(marker):
        return data.find(bytes([0xFF, marker]))
    if what == "no_soi":
        data[1] = 0x00
    elif what == "no_sof":
        data[seg(0xC0) + 1] = 0xFE        # the frame header becomes COM
    elif what == "bad_dht":
        p = seg(0xC4)
        data[p + 5:p + 21] = bytes([0, 3] + [0] * 14)   # 3 codes of 2 bits
    elif what == "no_dqt":
        data[seg(0xDB) + 1] = 0xFE
    elif what == "empty_frame":
        p = seg(0xC0)
        data[p + 5:p + 7] = b"\x00\x00"   # height 0
    elif what == "sof5":
        data[seg(0xC0) + 1] = 0xC5
    elif what == "unknown_marker":
        data[seg(0xDB) + 1] = 0xF0       # a JPGn segment before the scan
    path = _write(str(tmp_path / "h.jpg"), bytes(data))
    assert cv2.imread(path) is None
    _check(path)
    with pytest.raises(jpeg.CorruptJpeg):
        jpeg.decode_jpeg(bytes(data))


def _exif(orientation, endian):
    e = "<" if endian == b"II" else ">"
    tiff = endian + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1) \
        + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) \
        + struct.pack(e + "I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("endian", [b"II", b"MM"], ids=["intel", "motorola"])
def test_exif_orientation_applied_as_cv2(tmp_path, endian):
    data = _encode(_image(21, 34, 2), cv2.IMWRITE_JPEG_QUALITY, 90)
    for orientation in range(10):
        d = data[:2] + _exif(orientation, endian) + data[2:]
        _check(_write(str(tmp_path / f"o{orientation}.jpg"), d))


@pytest.mark.parametrize("mode,what", [
    ("lossless", "lossless"),
    ("arith", "arithmetic"), ("12bit", "12-bit"), ("cmyk", "CMYK"),
    ("adobe", "Adobe")])
def test_refused_modes_raise_naming_them(tmp_path, mode, what):
    """The modes once refused read as cv2 reads them, since queue 1 items
    24 and 25: a baseline file's SOF rewritten to lossless (SOF3: its scan
    is no valid lossless scan) or to arithmetic coding (SOF9: its Huffman
    data read as arithmetic-coded data), or its precision to 12 (which cv2
    does not decode): None where cv2 gives None, cv2's image where it
    decodes; a CMYK file PIL wrote and a file of an Adobe marker read
    bit-equal to cv2. No ValueError is left to name a mode."""
    data = bytearray(_encode(_image(16, 24, 0), cv2.IMWRITE_JPEG_QUALITY, 80,
                             *(mode if isinstance(mode, list) else [])))
    sof = data.find(b"\xff\xc0")
    if mode == "lossless":
        data[sof + 1] = 0xC3
    elif mode == "arith":
        data[sof + 1] = 0xC9
    elif mode == "12bit":
        data[sof + 4] = 12
    elif mode == "cmyk":
        import io
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(np.dstack([_image(16, 24, 0), _image(16, 24, 1)[
            ..., :1]]), "CMYK").save(buf, "JPEG", quality=80)
        data = bytearray(buf.getvalue())
    elif mode == "adobe":
        body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
        data[2:2] = b"\xff\xee" + struct.pack(">H", len(body) + 2) + body
    path = _write(str(tmp_path / "r.jpg"), bytes(data))
    assert (cv2.imread(path) is not None) == (mode in ("arith", "cmyk",
                                                       "adobe")), what
    _check(path)


def test_format_follows_the_signature(tmp_path):
    """The format follows the signature, not the extension: a ``.jpg``
    holding PNG bytes reads as the PNG, a ``.png`` holding JPEG bytes as
    the JPEG, one holding BMP bytes as the BMP, one holding TIFF bytes as
    the TIFF, one holding lossless or lossy WebP bytes as the WebP, as cv2
    reads them all."""
    img = _image(16, 16, 0)
    path = str(tmp_path / "0000000000.jpg")
    cv2.imwrite(path, img)
    _check(path)
    png_as_jpg = str(tmp_path / "png.jpg")
    cv2.imwrite(str(tmp_path / "a.png"), img)
    shutil.copy(str(tmp_path / "a.png"), png_as_jpg)
    _check(png_as_jpg)
    jpg_as_png = str(tmp_path / "jpg.png")
    shutil.copy(path, jpg_as_png)
    _check(jpg_as_png)
    bmp = str(tmp_path / "b.png")
    cv2.imwrite(str(tmp_path / "b.bmp"), img)
    shutil.copy(str(tmp_path / "b.bmp"), bmp)
    _check(bmp)
    tiff = str(tmp_path / "t.png")
    cv2.imwrite(str(tmp_path / "t.tiff"), img)
    shutil.copy(str(tmp_path / "t.tiff"), tiff)
    assert cv2.imread(tiff) is not None
    _check(tiff)
    webp = str(tmp_path / "w.png")
    assert cv2.imwrite(str(tmp_path / "w.webp"), img,
                       [cv2.IMWRITE_WEBP_QUALITY, 80])
    shutil.copy(str(tmp_path / "w.webp"), webp)
    assert cv2.imread(webp) is not None
    _check(webp)
    lossless = str(tmp_path / "l.png")
    assert cv2.imwrite(str(tmp_path / "l.webp"), img,
                       [cv2.IMWRITE_WEBP_QUALITY, 101])
    shutil.copy(str(tmp_path / "l.webp"), lossless)
    _check(lossless)


def test_cpp_steps_equal_plain_full_frame():
    """IDCT, upsampling and colour: the C++ steps against the numpy plain
    versions on a 1242 x 375 frame of each layout, and on random
    coefficients past 16 bits."""
    img = _image(375, 1242, 5)
    for samp in SAMPLING.values():
        data = _encode(img, cv2.IMWRITE_JPEG_QUALITY, 95,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp)
        for gray in (False, True):
            np.testing.assert_array_equal(
                jpeg.decode_jpeg(data, gray=gray),
                jpeg.decode_jpeg(data, gray=gray, plain=True))
    rng = np.random.RandomState(0)
    coef = rng.randint(-2048, 2048, (6, 5, 64)).astype(np.int16)
    coef[0, :, 8:] = 0                      # blocks with rows 1-7 zero
    quant = rng.randint(1, 65536, 64).astype(np.uint16)
    np.testing.assert_array_equal(jpeg._idct(coef, quant),
                                  jpeg.idct_plain(coef, quant))
    plane = rng.randint(0, 256, (16, 24)).astype(np.uint8)
    for size in ((16, 24), (13, 21), (16, 2), (1, 3)):
        for expand in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (3, 2)):
            ow = max(1, size[1] * expand[0] - 1)    # cropped, as the
            oh = max(1, size[0] * expand[1] - 1)    # image's odd sizes
            np.testing.assert_array_equal(
                jpeg._upsample(plane, size, expand, ow, oh),
                jpeg.upsample_plain(plane, size, expand, ow, oh))
    y, cb, cr = (rng.randint(0, 256, 5000).astype(np.uint8) for _ in range(3))
    np.testing.assert_array_equal(jpeg._ycc_to_bgr(y, cb, cr),
                                  jpeg.ycc_to_bgr_plain(y, cb, cr))


def test_committed_fixtures_decode_to_their_arrays():
    """What chip_smoke.py phase (k) checks on the card: each layout fixture
    against cv2's committed arrays, by both paths, and the KITTI frames
    against cv2's frame 0 and the SHA-256 of cv2's decode of each; here
    also against cv2 itself."""
    ref = np.load(os.path.join(DATA, "layouts.npz"))
    names = [n for n in ref.files if not n.endswith("_gray")]
    assert sorted(names) == sorted(["s444", "s422", "s420", "s440",
                                    "restart", "optimized", "gray"])
    for name in names:
        path = os.path.join(DATA, "layouts", name + ".jpg")
        with open(path, "rb") as f:
            data = f.read()
        for gray, key in ((False, name), (True, name + "_gray")):
            for plain in (False, True):
                np.testing.assert_array_equal(
                    jpeg.decode_jpeg(data, gray=gray, plain=plain), ref[key])
        _check(path)
    kitti = np.load(os.path.join(DATA, "kitti.npz"))
    frames = sorted(os.listdir(os.path.join(DATA, "kitti")))
    assert len(frames) == len(kitti["sha256"]) == 24
    for k, name in enumerate(frames):
        got = td.imread(os.path.join(DATA, "kitti", name))
        assert got.shape == (375, 1242, 3)
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            kitti["sha256"][k]
        if k == 0:
            np.testing.assert_array_equal(got, kitti["frame0"])
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(DATA) for f in fs)
    assert total < 2 << 20
