"""The port's JPEG decoder on the files beyond one baseline scan
(``io/jpeg.py``, ``csrc/jpeg_decode.cpp``), against ``cv2.imread`` (cv2 5.0
with libjpeg-turbo 3.1) in its three read modes and PIL's
``Image.open(p).convert("RGB")`` on the same bytes.

Bar: bit-equal on every file, None where cv2 gives None, a raise where PIL
raises. The files: progressive JPEGs cv2 writes (every sampling layout
and gray, qualities 5-100, restart intervals, optimised tables, EXIF
orientations), the same cut at many points (libjpeg's block smoothing of
the incomplete coefficients, cv2's image; PIL's "image file is
truncated") or with bytes overwritten inside their scans, baseline files
without their DHT segments (libjpeg's standard tables; a progressive file
without them fails, as in cv2), and files cv2 and PIL cannot write, built
by ``tests/image_encoders.py`` from the coefficients of a file cv2 wrote:
sequential scans of one component each (any order, one component never
scanned, standard tables), progressive scripts of spectral selection
only, a DC never refined, AC bands never sent (smoothing at output), a
DC-only file, AC first scans at Al 1 without refinement, and quantisation
tables redefined between scans (each component keeps the table of its
first scan). The C++ steps equal their numpy plain versions on each kind.
"""


import os

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import Scan, drop_segments, reencode_jpeg
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import jpeg

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}
SIZES = [(37, 53), (64, 96), (1, 7), (5, 2), (9, 17), (72, 40)]


def _image(h, w, seed, channels=3):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256,
                     ((xx + yy) * 2) % 256], -1)
    noise = rng.randint(0, 256, (h, w, 3))
    img = np.where(rng.rand(h, w, 1) < 0.3, noise, base).astype(np.uint8)
    return img if channels == 3 else img[..., 0]


def _encode(img, *params):
    ok, enc = cv2.imencode(".jpg", img, list(params))
    assert ok
    return enc.tobytes()


def _progressive(img, *params):
    return _encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *params)


def _check(path, data, pil=True):
    """``data`` written to ``path`` and read by the port as cv2 reads it in
    its three modes (None where cv2 gives None) and as PIL reads it (a
    raise where PIL raises)."""
    with open(path, "wb") as f:
        f.write(data)
    for flag in (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH):
        ref = cv2.imread(path, flag)
        got = td.imread(path, flag)
        if ref is None:
            assert got is None, (path, flag)
            continue
        assert got is not None and got.dtype == ref.dtype \
            and got.shape == ref.shape, (path, flag)
        np.testing.assert_array_equal(got, ref)
    if not pil:
        return
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        return
    np.testing.assert_array_equal(td.read_rgb_pil(path), ref)


@pytest.mark.parametrize("layout", list(SAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_layouts_bit_equal(tmp_path, layout, size):
    for i, (q, extra) in enumerate([
            (95, []), (50, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
            (10, [cv2.IMWRITE_JPEG_RST_INTERVAL, 1]), (100, []), (5, [])]):
        data = _progressive(_image(*size, seed=i), cv2.IMWRITE_JPEG_QUALITY,
                            q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            SAMPLING[layout], *extra)
        assert data[data.find(b"\xff\xc2") + 1] == 0xC2
        _check(str(tmp_path / f"{i}.jpg"), data)


@pytest.mark.parametrize("size", SIZES + [(8, 8), (100, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_gray_bit_equal(tmp_path, size):
    for i, q in enumerate((90, 5, 100, 60)):
        data = _progressive(_image(*size, seed=i, channels=1),
                            cv2.IMWRITE_JPEG_QUALITY, q,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, i)
        _check(str(tmp_path / f"{i}.jpg"), data)


def test_progressive_exif_orientations(tmp_path):
    """cv2 applies the orientation, PIL does not (``read_rgb_pil``)."""
    for o in range(1, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        path = str(tmp_path / f"o{o}.jpg")
        Image.fromarray(_image(21, 34, o)).save(path, exif=exif.tobytes(),
                                                quality=90, progressive=True)
        with open(path, "rb") as f:
            _check(path, f.read())


@pytest.mark.parametrize("layout,size", [
    ("444", (64, 96)), ("420", (64, 96)), ("440", (72, 40)),
    ("420", (23, 41)), ("422", (17, 50)), ("gray", (40, 56))])
def test_cut_progressive_files(tmp_path, layout, size):
    """Cut at every 37th byte and near the end, with and without a restart
    interval: cv2 decodes what the scans read hold, smoothing the blocks
    whose low coefficients are incomplete (those of the rows the last scan
    did not reach by its previous scans' bits); PIL raises."""
    for rst in (0, 3):
        img = _image(*size, seed=rst, channels=1 if layout == "gray" else 3)
        extra = [] if layout == "gray" else [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[layout]]
        data = _progressive(img, cv2.IMWRITE_JPEG_QUALITY, 90,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, rst, *extra)
        cuts = list(range(37, len(data), 37)) + [len(data) - 1,
                                                  len(data) - 2]
        smoothed = 0
        for cut in cuts:
            part = data[:cut]
            _check(str(tmp_path / f"c{rst}_{cut}.jpg"), part)
            try:
                smoothed += jpeg.smoothing(jpeg.read_coefficients(part))
            except jpeg.CorruptJpeg:
                pass
            if cut > data.find(b"\xff\xda"):
                with pytest.raises(jpeg.TruncatedJpeg):
                    jpeg.decode_jpeg(part, strict=True)
        assert smoothed > len(cuts) // 3


@pytest.mark.parametrize("quality", [95, 50, 5])
def test_corrupt_progressive_scans(tmp_path, quality):
    """One to three bytes overwritten after the first scan's header: bad
    codes, stray markers (a stray APPn whose length runs past the end, a
    DHT lost, an unknown marker after a scan), resynchronised restarts."""
    rng = np.random.RandomState(quality)
    for samp in (0x221111, 0x111111):
        data = _progressive(_image(72, 88, 1), cv2.IMWRITE_JPEG_QUALITY,
                            quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp,
                            cv2.IMWRITE_JPEG_RST_INTERVAL,
                            4 if quality == 50 else 0)
        sos = data.find(b"\xff\xda")
        for t in range(30):
            d = bytearray(data)
            for _ in range(rng.randint(1, 4)):
                d[rng.randint(sos + 10, len(d) - 2)] = rng.randint(0, 256)
            _check(str(tmp_path / f"x{samp}_{t}.jpg"), bytes(d))


def test_files_without_huffman_tables(tmp_path):
    """A baseline file with its DHT segments dropped decodes by libjpeg's
    standard tables (those a file cv2 writes without
    IMWRITE_JPEG_OPTIMIZE holds: the same image; an optimised one's codes
    read by them); a progressive file without a table it needs fails."""
    img = _image(48, 80, 4)
    for optimize in (0, 1):
        data = _encode(img, cv2.IMWRITE_JPEG_QUALITY, 85,
                       cv2.IMWRITE_JPEG_OPTIMIZE, optimize)
        bare = drop_segments(data, 0xC4)
        assert b"\xff\xc4" not in bare[:bare.find(b"\xff\xda")]
        _check(str(tmp_path / f"b{optimize}.jpg"), bare)
        if not optimize:
            np.testing.assert_array_equal(jpeg.decode_jpeg(bare),
                                          jpeg.decode_jpeg(data))
    for gray in (False, True):
        data = _progressive(img[..., 0] if gray else img,
                            cv2.IMWRITE_JPEG_QUALITY, 85)
        bare = drop_segments(data, 0xC4)
        path = str(tmp_path / f"p{gray}.jpg")
        _check(path, bare)
        assert cv2.imread(path) is None


SCRIPTS = {
    "sequential one a component": (
        [Scan([0]), Scan([1]), Scan([2])], False, {}),
    "sequential Cr Y Cb, standard tables": (
        [Scan([2]), Scan([0]), Scan([1])], False, {"standard_tables": True}),
    "sequential Y then Cb Cr interleaved, no DHT": (
        [Scan([0]), Scan([1, 2])], False,
        {"standard_tables": True, "write_dht": False}),
    "sequential Cr never scanned": ([Scan([0]), Scan([1])], False, {}),
    "spectral selection only": (
        [Scan([0, 1, 2], 0, 0)] + [Scan([c], 1, 5) for c in range(3)]
        + [Scan([c], 6, 63) for c in range(3)], True, {}),
    "DC never refined": (
        [Scan([0, 1, 2], 0, 0, 1)] + [Scan([c], 1, 63) for c in range(3)],
        True, {}),
    "AC 6-63 never sent": (
        [Scan([0, 1, 2], 0, 0)] + [Scan([c], 1, 5) for c in range(3)],
        True, {}),
    "DC only at Al 2": ([Scan([0, 1, 2], 0, 0, 2)], True, {}),
    "AC first at Al 1, never refined": (
        [Scan([0], 0, 0), Scan([1, 2], 0, 0)]
        + [Scan([c], 1, 63, 1) for c in range(3)], True, {}),
}


@pytest.mark.parametrize("layout", ["420", "444", "440"])
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_scripts_cv2_does_not_write(tmp_path, script, layout):
    """Each script re-encoded from a baseline file cv2 wrote, with and
    without a restart interval (EOB runs flushed at each RSTn), at two
    sizes (the 37 x 53 one with partial MCUs at the right and bottom)."""
    scans, progressive, kw = SCRIPTS[script]
    for size in ((64, 96), (37, 53)):
        base = _encode(_image(*size, seed=3), cv2.IMWRITE_JPEG_QUALITY, 85,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[layout])
        for rst in (0, 3):
            data = reencode_jpeg(base, scans, progressive=progressive,
                                 restart=rst, **kw)
            path = str(tmp_path / f"{size[0]}_{rst}.jpg")
            _check(path, data)
            assert cv2.imread(path) is not None
    co = jpeg.read_coefficients(data)
    assert co.scans == len(scans)
    assert jpeg.smoothing(co) == (script in (
        "AC 6-63 never sent", "DC only at Al 2",
        "AC first at Al 1, never refined"))


@pytest.mark.parametrize("progressive", [False, True])
def test_quantisation_tables_latched_at_each_components_first_scan(
        tmp_path, progressive):
    """Table 0 redefined after Y's first scan (and, progressive, before its
    AC scans): Y keeps the table it started with, as jdinput.c latches it;
    the decode at the redefined table differs."""
    base = _encode(_image(64, 96, 5), cv2.IMWRITE_JPEG_QUALITY, 80,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111)
    other = {0: np.full(64, 7, np.uint8)}
    if progressive:
        scans = [Scan([0, 1, 2], 0, 0), Scan([0], 1, 63, 0, other),
                 Scan([1], 1, 63), Scan([2], 1, 63)]
    else:
        scans = [Scan([0]), Scan([1], dqt=other), Scan([2])]
    data = reencode_jpeg(base, scans, progressive=progressive)
    _check(str(tmp_path / "q.jpg"), data)
    co = jpeg.read_coefficients(data)
    assert co.quant[0][0] != 7
    late = bytearray(data)   # the same file with the new table up front
    first = late.find(b"\xff\xdb") + 5
    late[first:first + 64] = bytes([7] * 64)
    assert not np.array_equal(jpeg.decode_jpeg(bytes(late)),
                              jpeg.decode_jpeg(data))


def test_cpp_steps_equal_plain_on_every_kind():
    """IDCT, upsampling and colour in numpy (``plain=True``) give the C++
    path's bits on progressive, smoothed, sequential multi-scan and cut
    files."""
    img = _image(75, 130, 9)
    base = _encode(img, cv2.IMWRITE_JPEG_QUALITY, 85,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111)
    prog = _progressive(img, cv2.IMWRITE_JPEG_QUALITY, 85)

    def cut(at):   # the first cut from `at` on that leaves an image
        while True:
            try:
                jpeg.read_coefficients(prog[:at])
                return prog[:at]
            except jpeg.CorruptJpeg:
                at += 1
    files = [prog, cut(len(prog) // 2), cut(len(prog) * 3 // 4),
             reencode_jpeg(base, SCRIPTS["DC only at Al 2"][0],
                           progressive=True),
             reencode_jpeg(base, SCRIPTS["sequential one a component"][0],
                           progressive=False)]
    for data in files:
        for gray in (False, True):
            np.testing.assert_array_equal(
                jpeg.decode_jpeg(data, gray=gray),
                jpeg.decode_jpeg(data, gray=gray, plain=True))


@pytest.mark.parametrize("what", ["arithmetic-coded progressive",
                                  "arithmetic-coded lossless", "lossless",
                                  "12-bit", "YCCK", "Adobe"])
def test_modes_still_refused_name_themselves(tmp_path, what):
    """A progressive file's SOF rewritten to arithmetic coding (SOF10: its
    Huffman data read as arithmetic-coded data), arithmetic lossless
    (SOF11, which libjpeg-turbo does not decode), lossless (SOF3) or its
    precision to 12 (which cv2 and PIL do not decode) reads as cv2 and PIL
    read it since queue 1 item 24: an image or None, a raise in PIL; no
    mode is left to name. YCCK and Adobe-transformed colour are read since
    queue 1 item 25: a progressive CMYK file PIL wrote, its Adobe
    transform set to 2 (YCCK), and a progressive file of an Adobe marker
    of transform 2 read as cv2 and PIL read them."""
    data = bytearray(_progressive(_image(16, 24, 0),
                                  cv2.IMWRITE_JPEG_QUALITY, 80))
    sof = data.find(b"\xff\xc2")
    match = what
    if what == "arithmetic-coded progressive":
        data[sof + 1] = 0xCA
    elif what == "arithmetic-coded lossless":
        data[sof + 1] = 0xCB
    elif what == "lossless":
        data[sof + 1] = 0xC3
    elif what == "12-bit":
        data[sof + 4] = 12
    elif what == "YCCK":
        import io
        buf = io.BytesIO()
        Image.fromarray(np.dstack([_image(16, 24, 0), _image(16, 24, 1)[
            ..., :1]]), "CMYK").save(buf, "JPEG", quality=80,
                                     progressive=True)
        data = bytearray(buf.getvalue())
        data[data.find(b"\xff\xeeAdobe"[:4]) + 15] = 2
    elif what == "Adobe":
        body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 2])
        data[2:2] = b"\xff\xee" + bytes([0, len(body) + 2]) + body
    decodes = cv2.imread(_check_path(tmp_path, data)) is not None
    assert decodes == (what in ("YCCK", "Adobe",
                                "arithmetic-coded progressive")), match
    _check(str(tmp_path / "r.jpg"), bytes(data))


def _check_path(tmp_path, data):
    path = str(tmp_path / "r.jpg")
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path


def test_committed_fixtures_read_as_cv2_and_pil():
    """What chip_smoke.py phase (s) checks on the card: the fixtures of
    tools/make_image_fixtures.py (progressive layouts, one sequential scan
    a component, a smoothed script, no DHT, a cut file; the BMP layouts)
    in every read mode against the digests of cv2's and PIL's reads, and
    the progressive KITTI frames against cv2's SHA-256; here also against
    cv2 and PIL themselves."""
    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert chip_smoke.check_image_fixtures(root) == 10 * 6 + 10 * 4
    data = os.path.join(root, chip_smoke.PROGRESSIVE_FIXTURES)
    for name in sorted(os.listdir(os.path.join(data, "layouts"))):
        path = os.path.join(data, "layouts", name)
        with open(path, "rb") as f:
            _check(str(path) + ".copy", f.read())
        os.remove(str(path) + ".copy")
    digests = np.load(os.path.join(data, "kitti.npz"))["sha256"]
    frames = sorted(os.listdir(os.path.join(data, "kitti")))
    assert len(frames) == len(digests) == 24
    for k, name in enumerate(frames):
        path = os.path.join(data, "kitti", name)
        got = td.imread(path)
        assert got.shape == (375, 1242, 3)
        assert chip_smoke.image_digest(got).endswith(digests[k])
        if k < 2:
            np.testing.assert_array_equal(got, cv2.imread(path))
            np.testing.assert_array_equal(
                td.read_rgb_pil(path), np.asarray(Image.open(path)))
    sizes = [os.path.getsize(os.path.join(d, f))
             for d, _, fs in os.walk(data) for f in fs]
    assert sum(sizes) < 2 << 20


@pytest.mark.parametrize("transform", ["none", 0, 1, 2, 7],
                         ids=lambda t: f"adobe{t}")
@pytest.mark.parametrize("layout", ["444", "420 progressive", "422",
                                    "411 progressive"])
def test_four_component_jpegs_as_cv2_and_pil(tmp_path, layout, transform):
    """Queue 1 item 25: four-component JPEGs PIL writes, their Adobe
    transform as given (none or 0: CMYK; 2 and the unknown 1 and 7: YCCK,
    libjpeg's ycck_cmyk_convert). cv2 takes the inks for Adobe's inverted
    ones (grfmt_jpeg.cpp's CMYK -> BGR and -> gray), PIL inverts them on
    open ("CMYK;I") and converts (cmyk2rgb); cut files too. The C++ steps
    equal the plain ones."""
    import io
    import struct

    rng = np.random.RandomState(len(layout) + len(str(transform)))
    sub = {"444": 0, "420 progressive": 2, "422": 1,
           "411 progressive": 2}[layout]
    for H, W in ((1, 1), (16, 16), (23, 37), (40, 9)):
        ink = rng.randint(0, 256, (H, W, 4)).astype(np.uint8)
        ink[::2] = ink[:1]
        buf = io.BytesIO()
        Image.fromarray(ink, "CMYK").save(
            buf, "JPEG", quality=int(rng.choice([30, 90, 100])),
            subsampling=sub, progressive="progressive" in layout)
        data = bytearray(buf.getvalue())
        at = data.find(b"\xff\xee")
        if transform == "none":
            n = struct.unpack(">H", data[at + 2:at + 4])[0]
            data = data[:at] + data[at + 2 + n:]
        else:
            data[at + 15] = transform
        path = str(tmp_path / "c.jpg")
        _check(path, bytes(data))
        for gray in (False, True):
            np.testing.assert_array_equal(
                jpeg.decode_jpeg(bytes(data), gray=gray),
                jpeg.decode_jpeg(bytes(data), gray=gray, plain=True))
        _check(path, bytes(data[:len(data) * 2 // 3]))


@pytest.mark.parametrize("marker", ["adobe0", "adobe0 after JFIF",
                                    "adobe1", "adobe2", "ids RGB",
                                    "ids RGB with JFIF", "ids other"])
def test_rgb_coded_three_component_jpegs(tmp_path, marker):
    """libjpeg's colour space of three components: JFIF means YCbCr,
    else Adobe transform 0 RGB (1 and others YCbCr), else component ids
    82, 71, 66 RGB; an RGB file's gray read is libjpeg's rgb_gray_convert
    (16-bit weights)."""
    import struct

    img = _image(27, 35, 4)
    for samp in (0x111111, 0x221111):
        data = _progressive(img, cv2.IMWRITE_JPEG_QUALITY, 90,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, samp)
        app0 = data.find(b"\xff\xe0")
        n = struct.unpack(">H", data[app0 + 2:app0 + 4])[0]
        bare = data[:app0] + data[app0 + 2 + n:]
        base = data if "JFIF" in marker else bare
        if marker.startswith("adobe"):
            body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, int(marker[5])])
            base = base[:2] + b"\xff\xee" + struct.pack(
                ">H", len(body) + 2) + body + base[2:]
        else:
            ids = b"RGB" if "RGB" in marker else b"\x07\x08\x09"
            out = bytearray(base)
            sof = out.find(b"\xff\xc2")
            for k in range(3):
                out[sof + 10 + 3 * k] = ids[k]
            at = 0
            while True:
                at = out.find(b"\xff\xda", at + 2)
                if at < 0:
                    break
                for k in range(out[at + 4]):
                    out[at + 5 + 2 * k] = ids[out[at + 5 + 2 * k] - 1]
            base = bytes(out)
        _check(str(tmp_path / "r.jpg"), base)
        for gray in (False, True):
            np.testing.assert_array_equal(
                jpeg.decode_jpeg(base, gray=gray),
                jpeg.decode_jpeg(base, gray=gray, plain=True))


def test_cmyk_and_ycck_jpegs_of_the_test_encoder(tmp_path):
    """``tests/image_encoders.write_cmyk_jpeg``'s CMYK and YCCK files
    (the YCCK file's C, M, Y stored as YCbCr) read as cv2 and PIL read
    them."""
    from tests.image_encoders import write_cmyk_jpeg

    rng = np.random.RandomState(25)
    for H, W in ((8, 8), (19, 27)):
        rgb = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        for ycck in (False, True):
            path = str(tmp_path / "e.jpg")
            write_cmyk_jpeg(path, rgb, ycck=ycck)
            with open(path, "rb") as f:
                data = f.read()
            _check(path, data)
            assert jpeg.read_coefficients(data).space == (
                "ycck" if ycck else "cmyk")
