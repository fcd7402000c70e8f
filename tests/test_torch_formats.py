"""The port's image dispatch (``io/datasets.imread``, ``read_rgb_pil``,
``image_format``) against ``cv2.imread`` and PIL on the formats cv2 tells
by signature, and the committed fixtures of slice 19 through
``chip_smoke.check_format_fixtures``.

Fault G: ``imread`` gave None for PBM, PGM, PPM, PAM, PFM, Sun raster,
GIF and AVIF files cv2 decodes (every signature it did not know went to
the PNG decoder), so the CLI skipped such frames as missing and the depth
and mask loaders raised FileNotFoundError on files that exist. Now every
file cv2 decodes reads as cv2 reads it, or raises ValueError naming its
ROADMAP.md queue 1 item (GIF and AVIF, 28b).

Bar: bit-equal, None where cv2 gives None, a raise where PIL raises.
"""

import io
import os
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import (gif_frame, write_hdr, write_sunras,
                                  write_tiff, write_vp8l)
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io.limits import ImageTooLarge

FLAGS = {"color": td.IMREAD_COLOR, "gray": td.IMREAD_GRAYSCALE,
         "anydepth": td.IMREAD_ANYDEPTH}


def _image(h=13, w=17, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _pnm(kind, img, maxval=255, ascii_=False):
    H, W = img.shape[:2]
    head = b"P%d\n%d %d\n" % (kind, W, H)
    if kind not in (1, 4):
        head += b"%d\n" % maxval
    if ascii_:
        return head + b" ".join(b"%d" % v for v in img.reshape(-1)) + b"\n"
    if kind == 4:
        return head + np.packbits(img, axis=1).tobytes()
    return head + (img.astype(">u2") if maxval > 255 else img).tobytes()


def _encoded(ext, img, *params):
    ok, enc = cv2.imencode(ext, img, list(params))
    assert ok
    return enc.tobytes()


def fault_g_files():
    """Each format of fault G: name -> bytes cv2 decodes."""
    img = _image()
    g = img[..., 1]
    deep = g.astype(np.uint16) * 257 + 3
    bits = (g > 127).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "GIF")
    return {
        "pgm_p2": _pnm(2, g % 200, 199, ascii_=True),
        "pgm_p5_8bit": _pnm(5, g),
        "pgm_p5_16bit": _pnm(5, deep, 65535),
        "ppm_p3": _pnm(3, img[..., ::-1], ascii_=True),
        "ppm_p6": _pnm(6, img[..., ::-1]),
        "pbm_p1": _pnm(1, bits, ascii_=True),
        "pbm_p4": _pnm(4, bits),
        "pam": _encoded(".pam", img),
        "pfm": _encoded(".pfm", img.astype(np.float32) / 255),
        "sunras": _encoded(".ras", img),
        "gif": buf.getvalue(),
        "webp": _encoded(".webp", img, cv2.IMWRITE_WEBP_QUALITY, 101),
        "avif": _encoded(".avif", img),
    }


FAULT_G = list(fault_g_files())


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("fmt", FAULT_G)
def test_imread_never_returns_none_where_cv2_decodes(tmp_path, fmt, flag):
    """Fault G: where cv2 decodes the file, the port gives cv2's array or
    raises ValueError naming the queue 1 item of a format it lacks; where
    cv2 gives None (a PFM read at another channel count), None."""
    path = str(tmp_path / "frame.png")       # the name the CLI expects
    with open(path, "wb") as f:
        f.write(fault_g_files()[fmt])
    ref = cv2.imread(path, FLAGS[flag])
    if fmt == "avif":
        assert ref is not None
        with pytest.raises(ValueError, match="item 28b"):
            td.imread(path, FLAGS[flag])
        return
    got = td.imread(path, FLAGS[flag])
    if ref is None:
        assert fmt == "pfm" and flag != "color" and got is None
        return
    assert got is not None and got.dtype == ref.dtype \
        and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_depth_and_mask_loaders_read_pgm_and_tiff(tmp_path):
    """The demo's loaders on a 16-bit PGM and a 16-bit Deflate TIFF depth
    map and an 8-bit PGM mask, each under the .png name the reader
    expects: cv2's values (fault G raised FileNotFoundError here)."""
    rng = np.random.RandomState(4)
    depth = rng.randint(0, 65536, (9, 14)).astype(np.uint16)
    mask = rng.randint(0, 5, (9, 14)).astype(np.uint8)
    pgm, tif, msk = (str(tmp_path / n) for n in ("d.png", "t.png", "m.png"))
    with open(pgm, "wb") as f:
        f.write(_pnm(5, depth, 65535))
    write_tiff(tif, depth, photometric=1, compression=8, predictor=2)
    with open(msk, "wb") as f:
        f.write(_pnm(5, mask))
    for path in (pgm, tif):
        np.testing.assert_array_equal(
            td.load_depth_png(path),
            cv2.imread(path, cv2.IMREAD_ANYDEPTH).astype(np.float32))
    np.testing.assert_array_equal(td.load_mask_png(msk),
                                  cv2.imread(msk, cv2.IMREAD_GRAYSCALE))


def _signature_files(tmp_path):
    img = _image(32, 32)
    path = str(tmp_path / "x")
    files = {"png": _encoded(".png", img), "jpeg": _encoded(".jpg", img),
             "bmp": _encoded(".bmp", img), "webp": _encoded(".webp", img),
             "avif": _encoded(".avif", img), "sunras": _encoded(".ras", img),
             "pxm": _encoded(".ppm", img), "pam": _encoded(".pam", img),
             "pfm": _encoded(".pfm", img.astype(np.float32)),
             "tiff": _encoded(".tiff", img), "hdr": _encoded(
                 ".hdr", img.astype(np.float32)),
             "jpeg2000": b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(32),
             "openexr": b"\x76\x2f\x31\x01" + bytes(32)}
    write_tiff(path, img, photometric=2, bigtiff=True, big_endian=True)
    with open(path, "rb") as f:
        files["bigtiff"] = f.read()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "GIF")
    files["gif"] = buf.getvalue()
    return files


def test_image_format_follows_cv2s_signatures(tmp_path):
    """``image_format`` names the decoder cv2's ``findDecoder`` picks, by
    each decoder's own signature check; bytes no decoder claims (``RIFF``
    without WEBP, a PPM signature without its whitespace, six bytes of
    JP2's twelve) are no image, as in cv2."""
    for fmt, data in _signature_files(tmp_path).items():
        want = "tiff" if fmt == "bigtiff" else fmt
        assert td.image_format(data) == want, fmt
    for data in (b"RIFF" + bytes(60), b"P6x 3 2 255\n" + bytes(18),
                 b"\x00\x00\x00\x0cjP" + bytes(30), b"\xff\xd8\x00" +
                 bytes(30), b"#?RAD" + bytes(30)):
        assert td.image_format(data) is None
        path = str(tmp_path / "n.img")
        with open(path, "wb") as f:
            f.write(data)
        assert cv2.imread(path) is None and td.imread(path) is None


@pytest.mark.parametrize("fmt,item", [
    ("webp", "26d"), ("jpeg2000", "26b"), ("openexr", "26b"),
    ("gif", "28b"), ("avif", "28b")])
def test_formats_the_port_lacks_name_their_item(tmp_path, fmt, item):
    """Both readers raise ValueError naming the queue 1 item. A lossy WebP
    (cv2 at quality 80) is read since item 26d, as cv2 and PIL read it;
    GIF is read since item 28b's GIF part, as cv2 and PIL read it;
    OpenEXR (item 1 of queue 1 since slice 21) is read as cv2 and PIL
    read it: cv2, built without OpenEXR, gives None under every flag, and
    PIL has no plugin for it."""
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_signature_files(tmp_path)[fmt] if fmt != "webp" else
                _encoded(".webp", _image(32, 32), cv2.IMWRITE_WEBP_QUALITY,
                         80))
    if fmt in ("gif", "webp"):
        for flag in FLAGS.values():
            np.testing.assert_array_equal(td.imread(path, flag),
                                          cv2.imread(path, flag))
        np.testing.assert_array_equal(
            td.read_rgb_pil(path), np.asarray(Image.open(path).convert(
                "RGB")))
        return
    if fmt == "openexr":
        for flag in FLAGS.values():
            assert cv2.imread(path, flag) is None
            assert td.imread(path, flag) is None
        with pytest.raises(OSError):
            Image.open(path)
        with pytest.raises(OSError, match="cannot identify"):
            td.read_rgb_pil(path)
        return
    with pytest.raises(ValueError, match=f"item {item}"):
        td.imread(path)
    with pytest.raises(ValueError, match=f"item {item}"):
        td.read_rgb_pil(path)


def test_read_rgb_pil_opens_what_pil_opens(tmp_path):
    """``read_rgb_pil`` on each format: PIL's RGB where PIL opens the file
    (PPM, ``Pf`` PFM, TIFF, Sun raster, CMYK JPEG), a raise where it does
    not (PAM, colour PFM, HDR)."""
    img = _image(11, 19, 3)
    files = {"ppm": _encoded(".ppm", img), "pgm": _encoded(".pgm",
                                                           img[..., 0]),
             "pf": _encoded(".pfm", img[..., 0].astype(np.float32)),
             "PF": _encoded(".pfm", img.astype(np.float32)),
             "pam": _encoded(".pam", img), "ras": _encoded(".ras", img),
             "tif": _encoded(".tiff", img),
             "hdr": _encoded(".hdr", img.astype(np.float32) / 255)}
    buf = io.BytesIO()
    Image.fromarray(np.dstack([img, img[..., :1]]), "CMYK").save(buf, "JPEG")
    files["cmyk"] = buf.getvalue()
    path = str(tmp_path / "x.png")
    opened = []
    for name, data in files.items():
        with open(path, "wb") as f:
            f.write(data)
        try:
            ref = np.asarray(Image.open(path).convert("RGB"))
        except (OSError, ValueError, SyntaxError):
            with pytest.raises((OSError, ValueError)):
                td.read_rgb_pil(path)
            continue
        np.testing.assert_array_equal(td.read_rgb_pil(path), ref)
        opened.append(name)
    assert opened == ["ppm", "pgm", "pf", "ras", "tif", "cmyk"]


def test_hdr_and_sun_raster_through_imread(tmp_path):
    """The two dispatch paths of formats whose own tests hold the decoders
    (test_torch_hdr_sunras.py): one file each through ``imread``."""
    rng = np.random.RandomState(8)
    rgbe = rng.randint(0, 256, (5, 12, 4)).astype(np.uint8)
    rgbe[..., 3] = 130
    hdr_path, ras_path = str(tmp_path / "h.png"), str(tmp_path / "s.png")
    write_hdr(hdr_path, rgbe)
    write_sunras(ras_path, rng.randint(0, 256, (5, 12)).astype(np.uint8), 8,
                 palette=rng.randint(0, 256, (256, 3)).astype(np.uint8))
    for path in (hdr_path, ras_path):
        for flag in FLAGS.values():
            np.testing.assert_array_equal(td.imread(path, flag),
                                          cv2.imread(path, flag))


def test_committed_format_fixtures_read_as_cv2_and_pil():
    """What chip_smoke.py phase (t1) checks on the card: every fixture of
    tests/data/{pxm, tiff, hdr, sunras, cmyk} against the digests of
    cv2's three reads and PIL's RGB (TIFF and JPEG also by their plain
    versions); here also against cv2 and PIL themselves."""
    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert chip_smoke.check_format_fixtures(root) == 244
    for fmt in chip_smoke.FORMAT_FIXTURES:
        directory = os.path.join(root, "tests", "data", fmt)
        for name in sorted(os.listdir(directory)):
            path = os.path.join(directory, name)
            for flag in FLAGS.values():
                ref, got = cv2.imread(path, flag), td.imread(path, flag)
                assert (ref is None) == (got is None), (path, flag)
                if ref is not None:
                    assert got.dtype == ref.dtype
                    np.testing.assert_array_equal(got, ref)
    sizes = [os.path.getsize(os.path.join(root, "tests", "data", d, f))
             for d in chip_smoke.FORMAT_FIXTURES
             for f in os.listdir(os.path.join(root, "tests", "data", d))]
    assert sum(sizes) < 1 << 20


@pytest.mark.parametrize("fmt,key", [
    ("pxm", "p5_16"), ("pxm", "pf_mono_gray"), ("tiff", "g16_be_lzw_any"),
    ("tiff", "rgb8_planar2_gray"), ("hdr", "rle"), ("sunras", "d8_rle_pil"),
    ("cmyk", "ycck_gray")])
def test_format_fixture_check_fails_on_a_wrong_digest(tmp_path, fmt, key):
    """``check_format_fixtures`` is no check unless it fails where a read
    differs from its digest: one digest of a copy of the fixtures is
    changed (a colour, gray, any-depth, "None" or PIL one), and the check
    must raise."""
    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = tmp_path / "tests" / "data"
    for name in chip_smoke.FORMAT_FIXTURES:
        shutil.copytree(os.path.join(root, "tests", "data", name),
                        data / name)
        ref = dict(np.load(os.path.join(root, "tests", "data",
                                        name + ".npz")))
        if name == fmt:
            ref[key] = np.array("0" * len(str(ref[key])))
        np.savez(data / (name + ".npz"), **ref)
    with pytest.raises(RuntimeError, match="chip_smoke check failed"):
        chip_smoke.check_format_fixtures(str(tmp_path))


def _tiff_gray8(W, H, body):
    """A classic little-endian TIFF of one 8-bit gray strip of W x H."""
    tags = [(256, 4, W), (257, 4, H), (258, 3, 8), (259, 3, 1), (262, 3, 1),
            (273, 4, 8 + 2 + 9 * 12 + 4), (277, 3, 1), (278, 4, H),
            (279, 4, (W * H) & 0xFFFFFFFF)]
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHI", t, k, 1) + struct.pack(
            "<HH" if k == 3 else "<I", *((v, 0) if k == 3 else (v,)))
        for t, k, v in tags) + struct.pack("<I", 0)
    return b"II*\0" + struct.pack("<I", 8) + ifd + body


def _png_gray8(W, H, body):
    def chunk(kind, b):
        return (struct.pack(">I", len(b)) + kind + b
                + struct.pack(">I", zlib.crc32(kind + b)))
    rows = b"".join(b"\0" + body[y * W:(y + 1) * W] for y in range(H)) \
        if body else b"\0"
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _sized_file(fmt, W, H):
    """A file of ``fmt`` whose header claims W x H, its samples written
    where they are few (at most 1 << 21), else the header alone."""
    full = W * H <= 1 << 21
    n = W * H if full else 0
    if fmt == "pgm":
        return b"P5\n%d %d\n255\n" % (W, H) + bytes(n)
    if fmt == "pbm":
        return b"P4\n%d %d\n" % (W, H) + bytes((W + 7) // 8 * H if full
                                               else 0)
    if fmt == "pam":
        return (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH 1\nMAXVAL 255\n"
                b"TUPLTYPE GRAYSCALE\nENDHDR\n" % (W, H) + bytes(n))
    if fmt == "pfm":
        return b"Pf\n%d %d\n-1.0\n" % (W, H) + bytes(4 * n)
    if fmt == "hdr":
        return (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n"
                % (H, W) + bytes(4 * n))
    if fmt == "sunras":
        head = struct.pack(">8I", 0x59A66A95, W & 0xFFFFFFFF,
                           H & 0xFFFFFFFF, 8, (W * H) & 0xFFFFFFFF, 1, 0, 0)
        return head + bytes(((W + 1) & -2) * H if full else 0)
    if fmt == "bmp":
        stride = (W + 3) & -4
        off = 14 + 40 + 1024
        return (struct.pack("<2sIHHI", b"BM", 0, 0, 0, off)
                + struct.pack("<IiiHHIIiiII", 40, min(W, 2 ** 31 - 1),
                              min(H, 2 ** 31 - 1), 1, 8, 0, 0, 0, 0, 0, 0)
                + bytes(1024) + bytes(stride * H if full else 0))
    if fmt == "tiff":
        return _tiff_gray8(W, H, bytes(n))
    if fmt == "png":
        return _png_gray8(W, H, bytes(n))
    if fmt == "gif":         # a 1 x 1 frame on the screen, a 2-entry table
        return (b"GIF89a" + struct.pack("<2H", W, H) + b"\x80\x00\x00"
                + bytes(6) + gif_frame(np.zeros((1, 1), np.uint8)) + b";")
    if fmt == "webp":        # a VP8X canvas over a 1 x 1 VP8L image
        image = write_vp8l(np.zeros((1, 1), np.uint32))[12:]
        body = b"VP8X" + struct.pack("<I", 10) + bytes(4) + struct.pack(
            "<I", W - 1)[:3] + struct.pack("<I", H - 1)[:3] + image
        return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body
    jpg = _encoded(".jpg", np.zeros((8, 8), np.uint8))
    at = jpg.index(b"\xff\xc0") + 5
    return jpg[:at] + struct.pack(">HH", H, W) + jpg[at + 4:]


SIDE, PIXELS = 1 << 20, 1 << 30
SIZES = [(SIDE, 1), (SIDE + 1, 1), (1, SIDE + 1), (SIDE, PIXELS // SIDE + 1),
         (2 ** 31 - 1, 2 ** 31 - 1), (2 ** 31, 1), (1, 2 ** 31),
         (2 ** 31, 2 ** 31)]
SIZE_CASES = [(fmt, W, H) for fmt in ("pgm", "pbm", "pam", "pfm", "hdr",
                                      "sunras", "bmp", "tiff")
              for W, H in SIZES]
# libpng's user limit (10^6 a side) and libjpeg's (65500 a side) come
# before cv2's own
SIZE_CASES += [("png", 10 ** 6, 1), ("png", 10 ** 6 + 1, 1),
               ("png", 1, 10 ** 6 + 1), ("png", 10 ** 6, 1073),
               ("png", 10 ** 6, 1074), ("jpeg", 65500, 1),
               ("jpeg", 65501, 1), ("jpeg", 1, 65501),
               ("jpeg", 65500, PIXELS // 65500 + 1), ("jpeg", 65535, 65535)]
# GIF's 16-bit sides pass cv2's side limit, not its pixel limit; a WebP
# canvas (24-bit sides) is checked before its image
SIZE_CASES += [("gif", 65535, 1), ("gif", 1, 65535), ("gif", 65535, 16385),
               ("gif", 65535, 65535), ("webp", 1, 1), ("webp", SIDE, 1),
               ("webp", SIDE + 1, 1), ("webp", 1, SIDE + 1),
               ("webp", SIDE, PIXELS // SIDE + 1)]


@pytest.mark.parametrize("fmt,W,H", SIZE_CASES)
def test_imread_holds_cv2s_size_limits(tmp_path, fmt, W, H):
    """cv2.imread's size rule (loadsave.cpp::validateInputImageSize: sides
    of at most 1 << 20, at most 1 << 30 pixels), held after the header
    and before any sample is read or allocated: past it cv2 raises, and
    the port raises ImageTooLarge; at it, both read the file alike; a
    header the format's own reader refuses first gives None in both."""
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(_sized_file(fmt, W, H))
    for flag in FLAGS.values():
        try:
            ref = cv2.imread(path, flag)
        except cv2.error:
            ref = "raises"
        try:
            got = td.imread(path, flag)
        except ImageTooLarge:
            got = "raises"
        if isinstance(ref, str) or ref is None:
            assert got is ref if ref is None else got == ref, (flag, got)
        else:
            assert not isinstance(got, str) and got is not None, flag
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


def _exr_header(W, H, tiled=False):
    """An OpenEXR scan-line (or tiled) file's header, written from the
    format's layout: magic, version 2 (flag 0x200 for tiles), the required
    attributes (channels R, G, B as HALF, compression NONE, the data and
    display windows, line order, pixel aspect ratio, screen window), the
    end of the header, an offset table and one line of zeros."""
    def attr(name, kind, value):
        return (name.encode() + b"\0" + kind.encode() + b"\0"
                + struct.pack("<i", len(value)) + value)

    chans = b"".join(c + b"\0" + struct.pack("<iB3xii", 1, 0, 1, 1)
                     for c in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    head = (b"\x76\x2f\x31\x01" + struct.pack("<I", 2 | (0x200 if tiled
                                                        else 0))
            + attr("channels", "chlist", chans)
            + attr("compression", "compression", b"\0")
            + attr("dataWindow", "box2i", box)
            + attr("displayWindow", "box2i", box)
            + attr("lineOrder", "lineOrder", b"\0")
            + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
            + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
            + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
            + b"\0")
    table = len(head) + 8 * H
    lines = b"".join(struct.pack("<ii", y, 6 * W) + bytes(6 * W)
                     for y in range(H))
    offsets = b"".join(struct.pack("<Q", table + y * (8 + 6 * W))
                       for y in range(H))
    return head + offsets + lines


@pytest.mark.parametrize("tiled", [False, True], ids=["scanline", "tiled"])
def test_openexr_gives_none_as_cv2_without_openexr(tmp_path, tiled):
    """Queue 1 item 1: the cv2 the port is held to is built without
    OpenEXR (``getBuildInformation``: "OpenEXR: NO"), so ``cv2.imread``
    gives None on an EXR file under every flag, and so does ``imread``
    (the parent raised naming item 26b); PIL has no EXR plugin, and
    ``read_rgb_pil`` raises as ``Image.open`` does."""
    assert "OpenEXR:                     NO" in cv2.getBuildInformation() \
        or "OpenEXR: NO" in " ".join(cv2.getBuildInformation().split())
    path = str(tmp_path / "x.exr")
    with open(path, "wb") as f:
        f.write(_exr_header(5, 3, tiled))
    assert td.image_format(open(path, "rb").read()) == "openexr"
    for flag in FLAGS.values():
        assert cv2.imread(path, flag) is None
        assert td.imread(path, flag) is None
    with pytest.raises(OSError):
        Image.open(path)
    with pytest.raises(OSError, match="cannot identify"):
        td.read_rgb_pil(path)
