"""The port's reader with PIL's semantics (``io/datasets.py::read_rgb_pil``)
against ``np.asarray(Image.open(path).convert("RGB"))``, and the COCO
dataset that reads with it (``data/coco.py``) against the JAX package's,
which reads through PIL.

Bar: bit-equal on every file. The files: the committed JPEG fixtures
(tests/data/jpeg, every layout and the KITTI frames), JPEGs with each EXIF
orientation 1-8 (PIL applies none, where ``imread`` applies it as cv2
does), PNGs of every colour type at 8 and 16 bits (16-bit gray is PIL's
``I;16``, clipped at 255, where cv2 keeps the high byte), palette, LA,
RGBA and 1-, 2- and 4-bit gray. ``imread`` stays cv2's: it still applies
the orientation and keeps the high byte. A JPEG whose bytes end before
libjpeg is done with it raises OSError, as PIL does ("image file is
truncated"), where ``imread`` returns cv2's gray-filled image; the files
libjpeg only warns about (a cut scan followed by an EOI, a marker inside
the scan) read as PIL reads them.
"""

import glob
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from vido_slam_tpu.data import coco as jc
from vido_slam_tpu_torch.data import coco as tc
from vido_slam_tpu_torch.io.datasets import imread, read_rgb_pil

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pil(path):
    return np.asarray(Image.open(path).convert("RGB"))


def oriented_jpeg(path, arr, orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    Image.fromarray(arr).save(path, exif=exif.tobytes(), quality=90)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every file the tests read, written from seeds."""
    d = str(tmp_path_factory.mktemp("pil"))
    rng = np.random.RandomState(0)
    out = {}

    def add(name, write):
        out[name] = os.path.join(d, name)
        write(out[name])

    img = rng.randint(0, 256, (48, 64, 3), np.uint8)
    for o in range(1, 9):
        add(f"orient{o}.jpg", lambda p, o=o: oriented_jpeg(p, img, o))
    add("gray.jpg", lambda p: Image.fromarray(img[..., 1]).save(p))
    ramp = np.array([0, 200, 255, 256, 13000, 61420], np.uint16)
    add("gray16_ramp.png", lambda p: chip_smoke.write_png(
        p, np.tile(ramp, (4, 2))))
    add("gray16.png", lambda p: chip_smoke.write_png(
        p, rng.randint(0, 65536, (20, 30)).astype(np.uint16)))
    rgb16 = rng.randint(0, 65536, (20, 30, 3)).astype(np.uint16)
    rgb16[0, 0] = (13000, 65535, 256)            # BGR: reads (1, 255, 50)
    add("rgb16.png", lambda p: chip_smoke.write_png(p, rgb16))
    add("rgba16.png", lambda p: chip_smoke.write_png(
        p, rng.randint(0, 65536, (20, 30, 4)).astype(np.uint16)))
    add("la16.png", lambda p: chip_smoke.write_png(
        p, rng.randint(0, 65536, (20, 30, 2)).astype(np.uint16)))
    for name, shape in (("gray8.png", (20, 30)), ("la8.png", (20, 30, 2)),
                        ("bgr8.png", (20, 30, 3)), ("bgra8.png", (20, 30, 4))):
        add(name, lambda p, s=shape: chip_smoke.write_png(
            p, rng.randint(0, 256, s, np.uint8)))
    pal = Image.fromarray(rng.randint(0, 12, (20, 30)).astype(np.uint8), "P")
    pal.putpalette(rng.randint(0, 256, 36).tolist())
    add("palette.png", pal.save)
    add("palette_trns.png", lambda p: pal.save(p, transparency=3))
    add("bilevel.png", lambda p: Image.fromarray(
        rng.randint(0, 2, (20, 30)).astype(bool)).save(p))
    for bits in (1, 2, 4):
        add(f"gray{bits}bit.png", lambda p, b=bits: low_bit_gray_png(
            p, rng.randint(0, 1 << b, (20, 30)), b))
    return out


def low_bit_gray_png(path, values, bits):
    """A gray PNG of 1, 2 or 4 bits a sample, rows unfiltered."""
    import struct
    import zlib
    h, w = values.shape
    per = 8 // bits
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = values
    fields = padded.reshape(h, -1, per) << (
        bits * np.arange(per - 1, -1, -1, dtype=np.uint8))
    rows = np.bitwise_or.reduce(fields, axis=-1).astype(np.uint8)
    body = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, 0, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(body.tobytes()))
                + chunk(b"IEND", b""))


def test_committed_jpeg_fixtures_read_as_pil():
    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "data", "jpeg",
                                          "*", "*.jpg")))
    assert len(paths) >= 30
    for p in paths:
        np.testing.assert_array_equal(read_rgb_pil(p), pil(p), err_msg=p)


def test_every_png_mode_and_orientation_reads_as_pil(files):
    for name, p in files.items():
        got = read_rgb_pil(p)
        assert got.dtype == np.uint8 and got.flags.c_contiguous, name
        np.testing.assert_array_equal(got, pil(p), err_msg=name)


def test_where_pil_and_cv2_part(files):
    """The two cases the reader exists for, against ``imread`` (cv2)."""
    ramp = read_rgb_pil(files["gray16_ramp.png"])
    np.testing.assert_array_equal(ramp[0, :6, 0], [0, 200, 255, 255, 255,
                                                   255])
    np.testing.assert_array_equal(imread(files["gray16_ramp.png"])[0, :6, 0],
                                  [0, 0, 0, 1, 50, 239])
    np.testing.assert_array_equal(read_rgb_pil(files["rgb16.png"])[0, 0],
                                  [1, 255, 50])
    for o in range(5, 9):
        p = files[f"orient{o}.jpg"]
        assert read_rgb_pil(p).shape == (48, 64, 3)
        assert imread(p).shape == (64, 48, 3)
        np.testing.assert_array_equal(imread(p), cv2.imread(p))
    with pytest.raises(FileNotFoundError):
        read_rgb_pil(os.path.join(ROOT, "no_such_image.png"))


@pytest.fixture(scope="module")
def coco_tree(files, tmp_path_factory):
    """A COCO tree of an Orientation-6 JPEG, a 16-bit gray PNG, a palette
    PNG and a 16-bit RGB PNG, one box each (two on the JPEG)."""
    root = str(tmp_path_factory.mktemp("coco_pil"))
    rng = np.random.RandomState(1)
    images, annotations = [], []
    names = ["orient6.jpg", "gray16.png", "palette.png", "rgb16.png"]
    for i, name in enumerate(names):
        img = Image.open(files[name])
        w, h = img.size
        with open(files[name], "rb") as f, \
                open(os.path.join(root, name), "wb") as g:
            g.write(f.read())
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
        for k in range(2 if i == 0 else 1):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1,
                "category_id": 3, "iscrowd": 0,
                "bbox": [x, y, rng.uniform(6, w / 2), rng.uniform(6, h / 2)]})
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 3, "name": "car"}]}, f)
    return path, root


def test_coco_samples_of_pil_only_files_equal_jax(coco_tree):
    ann, root = coco_tree
    kw = dict(input_hw=(64, 96), max_boxes=4)
    jd = jc.CocoDetectionDataset(ann, root, **kw)
    td = tc.CocoDetectionDataset(ann, root, **kw)
    assert td.ids == jd.ids and len(td) == 4
    for i in range(len(jd)):
        np.testing.assert_array_equal(td.load_image(td.ids[i]),
                                      jd.load_image(jd.ids[i]))
        a, b = jd[i], td[i]
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if x is None:
                assert y is None, f
            else:
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                              err_msg=f)
    jb, tb = jd.batch([0, 1, 2, 3]), td.batch([0, 1, 2, 3])
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def _jpeg_cuts(seed, **save):
    """A 64 x 96 JPEG and its cuts inside the header, inside the scan(s)
    and just before its EOI."""
    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (64, 96, 3), np.uint8)).save(
        buf, "JPEG", quality=90, **save)
    data = buf.getvalue()
    sos = data.find(b"\xff\xda")
    return data, [sos // 2, sos + 20, len(data) // 2, len(data) * 3 // 4,
                  len(data) - 2, len(data) - 1]


@pytest.mark.parametrize("save", [{}, {"progressive": True}],
                         ids=["baseline", "progressive"])
def test_truncated_jpeg_raises_as_pil(tmp_path, save):
    """Every cut raises where PIL raises (the parent returned the gray-filled
    image of a cut scan); ``imread`` keeps cv2's image."""
    data, cuts = _jpeg_cuts(7, **save)
    for cut in cuts:
        path = str(tmp_path / f"cut{cut}.jpg")
        with open(path, "wb") as f:
            f.write(data[:cut])
        with pytest.raises(OSError):
            pil(path)
        with pytest.raises(OSError):
            read_rgb_pil(path)
        ref = cv2.imread(path)
        got = imread(path)
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
    path = str(tmp_path / "half.jpg")
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    assert imread(path).shape == (64, 96, 3)


@pytest.mark.parametrize("save", [{}, {"progressive": True}],
                         ids=["baseline", "progressive"])
def test_jpegs_libjpeg_only_warns_about_read_as_pil(tmp_path, save):
    """A cut scan followed by an EOI, an RSTn, an EOI or a COM inside the
    scan: libjpeg warns and PIL reads them, as the reader does; a stray
    DHT or an unknown marker inside a baseline scan fails after the image
    in libjpeg, so PIL raises and so does the reader."""
    data, cuts = _jpeg_cuts(8, **save)
    sos = data.find(b"\xff\xda")
    files = {f"cut{c}+eoi": data[:c] + b"\xff\xd9" for c in cuts[2:4]}
    at = (sos + len(data)) // 2
    for name, marker in (("rst", b"\xff\xd3"), ("eoi", b"\xff\xd9"),
                         ("com", b"\xff\xfe\x00\x04ab"),
                         ("dht", b"\xff\xc4"), ("unknown", b"\xff\x55")):
        files[name] = data[:at] + marker + data[at:]
    raised = 0
    for name, d in files.items():
        path = str(tmp_path / f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(d)
        try:
            ref = pil(path)
        except OSError:
            with pytest.raises((OSError, ValueError)):
                read_rgb_pil(path)
            raised += 1
            continue
        np.testing.assert_array_equal(read_rgb_pil(path), ref, err_msg=name)
    assert raised < len(files)


# ---------------------------------------------------------------------------
# fault J: files PIL opens that the parent refused as "no image PIL opens"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,save", [
    ("TGA", {}), ("TGA", {"compression": "tga_rle"}), ("PCX", {}),
    ("SGI", {}), ("ICO", {}), ("QOI", {}), ("IM", {}), ("DDS", {}),
    ("XBM", {}), ("MSP", {})],
    ids=["tga", "tga_rle", "pcx", "sgi", "ico", "qoi", "im", "dds", "xbm",
         "msp"])
def test_files_pil_opens_read_as_pil(tmp_path, fmt, save):
    """A 23 x 17 RGB image (bilevel for XBM and MSP) saved by PIL: cv2 and
    ``imread`` give None, ``read_rgb_pil`` reads it bit-equal to PIL, and
    the plugin no reader ports (DDS) raises naming item 29b. The parent
    raised "no image PIL opens (cannot identify image file)" on each."""
    from vido_slam_tpu_torch.io import pil_open

    rng = np.random.RandomState(26)
    img = Image.fromarray(rng.randint(0, 256, (17, 23, 3)).astype(np.uint8))
    if fmt in ("XBM", "MSP"):
        img = img.convert("1")
    path = str(tmp_path / "probe")
    img.save(path, fmt, **save)
    assert cv2.imread(path) is None and imread(path) is None
    with open(path, "rb") as f:
        assert pil_open.pil_format(f.read()) == Image.open(path).format == \
            fmt
    if fmt == "DDS":
        with pytest.raises(ValueError, match="item 29b"):
            read_rgb_pil(path)
        return
    np.testing.assert_array_equal(read_rgb_pil(path), pil(path))


def test_eps_raises_as_pil_without_ghostscript(tmp_path):
    """EPS: PIL needs Ghostscript to load it and raises without it; so does
    the reader (the parent said no plugin opened it)."""
    path = str(tmp_path / "x.eps")
    Image.new("RGB", (8, 6), (10, 20, 30)).save(path, "EPS")
    with pytest.raises(OSError):
        pil(path)
    with pytest.raises(OSError, match="Ghostscript"):
        read_rgb_pil(path)


def test_bytes_no_plugin_takes_raise_as_pil(tmp_path):
    """Bytes no plugin takes (a Targa header PIL refuses, text, an OpenEXR
    header) raise as PIL's "cannot identify image file"."""
    path = str(tmp_path / "x.img")
    for data in (b"\x00\x07\x02" + bytes(40), b"hello world\n" * 4,
                 b"\x76\x2f\x31\x01" + bytes(40)):
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(OSError):
            pil(path)
        with pytest.raises(OSError, match="cannot identify"):
            read_rgb_pil(path)


# ---------------------------------------------------------------------------
# fault K: PIL's decompression bomb limit, from the header
# ---------------------------------------------------------------------------

def _png_header(W, H, ctype=0, rows=None):
    """A PNG of W x H 8-bit pixels (colour type ``ctype``; 3 with a
    two-colour PLTE) whose zlib stream holds ``rows`` rows of each value
    (a stream cut before its end where None)."""
    import zlib

    body = struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)
    ihdr = struct.pack(">I", 13) + b"IHDR" + body + struct.pack(
        ">I", zlib.crc32(b"IHDR" + body))
    if ctype == 3:
        plte = b"PLTE" + bytes([200, 100, 50, 1, 2, 3])
        ihdr += struct.pack(">I", 6) + plte + struct.pack(
            ">I", zlib.crc32(plte))
    n = {0: 1, 2: 3, 3: 1}[ctype] * W
    idat = zlib.compress(bytes(2 * (n + 1)))[:-6] if rows is None else \
        zlib.compress(b"".join(bytes([0]) + bytes([1 + k % 3]) * n
                               for k in range(rows)))
    return (b"\x89PNG\r\n\x1a\n" + ihdr + struct.pack(">I", len(idat))
            + b"IDAT" + idat + struct.pack(">I", zlib.crc32(b"IDAT" + idat))
            + b"\x00\x00\x00\x00IEND\xaeB`\x82")


def _tiff_header(W, H):
    entries = [(256, 4, W), (257, 4, H), (258, 3, 8), (259, 3, 1),
               (262, 3, 1), (273, 4, 8), (277, 3, 1), (278, 4, H),
               (279, 4, W * H)]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII", tag, kind, 1, v) for tag, kind, v in entries)
    return b"II*\x00" + struct.pack("<I", 16) + bytes(8) + ifd + bytes(4)


def _bomb_file(fmt, W, H):
    """A small file whose header declares W x H."""
    from tests.image_encoders import write_gif, gif_frame, write_vp8l

    buf = io.BytesIO()
    small = Image.new("RGB", (4, 3), (9, 8, 7))
    if fmt == "png":
        return _png_header(W, H)
    if fmt == "bmp":
        small.save(buf, "BMP")
        d = bytearray(buf.getvalue())
        d[18:26] = struct.pack("<ii", W, H)
        return bytes(d)
    if fmt == "tiff":
        return _tiff_header(W, H)
    if fmt == "tga":
        small.save(buf, "TGA")
        d = bytearray(buf.getvalue())
        d[12:16] = struct.pack("<HH", W, H)
        return bytes(d)
    if fmt == "gif":
        return write_gif((W, H), [gif_frame(np.zeros((3, 4), np.uint8))],
                         palette=np.zeros((4, 3)))
    if fmt == "webp":
        d = bytearray(write_vp8l(np.zeros((3, 4), np.uint32)))
        bits = (W - 1) | (H - 1) << 14
        d[21:25] = struct.pack("<I", bits | (d[24] & 0xF0) << 24)
        return bytes(d)
    if fmt == "jpeg":
        small.save(buf, "JPEG")
        d = bytearray(buf.getvalue())
        sof = d.find(b"\xff\xc0")
        d[sof + 5:sof + 9] = struct.pack(">HH", H, W)
        return bytes(d)
    if fmt == "ppm":
        return f"P6 {W} {H} 255\n".encode() + bytes(30)
    if fmt == "sun":
        return struct.pack(">8I", 0x59A66A95, W, H, 8, 0, 1, 0, 0) + bytes(9)
    if fmt == "pcx":
        small.save(buf, "PCX")
        d = bytearray(buf.getvalue())
        d[8:12] = struct.pack("<HH", W - 1, H - 1)
        return bytes(d)
    if fmt == "sgi":
        small.save(buf, "SGI")
        d = bytearray(buf.getvalue())
        d[6:10] = struct.pack(">HH", W, H)
        return bytes(d)
    if fmt == "qoi":
        return b"qoif" + struct.pack(">II", W, H) + b"\x03\x00" + bytes(20)
    if fmt == "xbm":
        return (f"#define a_width {W}\n#define a_height {H}\n"
                f"static char a_bits[] = {{ 0x00 }};\n").encode()
    if fmt == "im":
        return (f"Image type: Greyscale image\nImage size (x*y): {W}*{H}\n"
                ).encode() + b"\x1a" + bytes(20)
    assert fmt == "msp"
    words = [0x6144, 0x4D6E, W, H, 1, 1, 1, 1, W, H, 0, 0, 0, 0, 0, 0]
    check = 0
    for w in words:
        check ^= w
    words[12] = check
    return struct.pack("<16H", *words) + bytes(20)


BOMB_FORMATS = ["png", "bmp", "tiff", "tga", "gif", "webp", "jpeg", "ppm",
                "sun", "pcx", "sgi", "qoi", "xbm", "im", "msp"]


@pytest.mark.parametrize("fmt", BOMB_FORMATS)
def test_header_past_pils_limit_raises_as_pil(tmp_path, fmt):
    """Fault K: a header of 20000 x 20000 pixels (more than twice
    ``Image.MAX_IMAGE_PIXELS``) makes ``Image.open`` raise
    ``DecompressionBombError`` before it decodes anything; so does the
    reader, from the header (the parent read on, raising on the missing
    data or decoding it)."""
    from vido_slam_tpu_torch.io.limits import DecompressionBombError

    W, H = (16000, 16000) if fmt == "webp" else (20000, 20000)
    path = str(tmp_path / "bomb")
    with open(path, "wb") as f:
        f.write(_bomb_file(fmt, W, H))
    with pytest.raises(Image.DecompressionBombError):
        pil(path)
    with pytest.raises(DecompressionBombError):
        read_rgb_pil(path)


@pytest.mark.parametrize("fmt", ["png", "tga", "bmp"])
def test_header_in_pils_warning_band_is_read_on(tmp_path, fmt):
    """Between ``MAX_IMAGE_PIXELS`` and twice it PIL only warns and reads
    on: here it then fails on the missing data, and the reader fails
    there too, not at the limit."""
    from vido_slam_tpu_torch.io.limits import DecompressionBombError

    path = str(tmp_path / "band")
    with open(path, "wb") as f:
        f.write(_bomb_file(fmt, 10000, 10000))
    with pytest.warns(Image.DecompressionBombWarning):
        with pytest.raises(OSError):
            pil(path)
    with pytest.raises((OSError, ValueError)) as raised:
        read_rgb_pil(path)
    assert not isinstance(raised.value, DecompressionBombError)


# ---------------------------------------------------------------------------
# PNG by PIL's chunk rules
# ---------------------------------------------------------------------------

def test_png_read_by_pils_chunk_rules(tmp_path):
    """PIL reads a PNG without IEND, with a bad IDAT CRC, with data after
    IEND, with its IDAT cut after the image's bytes (the zlib checksum
    missing) and with a zlib stream that ends before the image (the rows
    it lacks stay 0: black, or palette entry 0), and refuses a bad CRC
    before IDAT and a stream cut before its end; the reader does the same
    (the parent refused the first four and the short streams, as libpng
    does for cv2)."""
    import zlib

    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, (5, 7, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "PNG")
    d = buf.getvalue()
    i = d.index(b"IDAT")
    n = struct.unpack(">I", d[i - 4:i])[0]
    bad_idat = bytearray(d)
    bad_idat[i + 4 + n] ^= 1
    text = b"tEXta\x00b"
    bad_text = struct.pack(">I", 3) + text + struct.pack(
        ">I", zlib.crc32(text) ^ 1)
    files = {"no_iend": d[:-12], "bad_idat_crc": bytes(bad_idat),
             "trailing": d + b"garbage", "cut_adler": d[:i + 4 + n - 2],
             "bad_text_crc": d[:33] + bad_text + d[33:],
             "cut_data": d[:i + 4 + n // 2],
             "stream_ends_gray": _png_header(7, 5, 0, 2),
             "stream_ends_palette": _png_header(7, 5, 3, 3),
             "stream_ends_rgb": _png_header(7, 5, 2, 4),
             "stream_cut": _png_header(7, 5, 2)}
    read = []
    for name, data in files.items():
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(data)
        try:
            ref = pil(path)
        except OSError:
            with pytest.raises((OSError, ValueError)):
                read_rgb_pil(path)
            continue
        np.testing.assert_array_equal(read_rgb_pil(path), ref, err_msg=name)
        read.append(name)
    assert read == ["no_iend", "bad_idat_crc", "trailing", "cut_adler",
                    "stream_ends_gray", "stream_ends_palette",
                    "stream_ends_rgb"]
