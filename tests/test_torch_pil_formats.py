"""The formats PIL opens and cv2 does not (ROADMAP.md queue 1 item 29):
Targa, PCX, SGI, QOI, XBM, IM, ICO and MSP through ``io/datasets.py``'s
``read_rgb_pil`` against PIL's ``Image.open(p).convert("RGB")`` and
through ``imread`` against ``cv2.imread`` (None under every flag), on the
same bytes; ``io/pil_open.pil_format`` against the plugin ``Image.open``
picks; each host C++ loop (``csrc/pil_decode.cpp``) against its Python
version.

The files: the committed fixtures of tests/data/pil29 (PIL's writers and
tests/image_encoders.py's hand-made layouts, with the digests of both
libraries' reads in tests/data/pil29.npz, which chip_smoke.py phase (v1)
holds on the card's machine), and seeded random files of each format,
cut, padded and corrupt: headers of every mode PIL takes and many it does
not, run-length streams that cross rows and overrun them, tables that
point anywhere, ops past the image's end. Found by probe and held here
(each module's docstring has its rules): PIL's Targa runs may not leave a
row while literals may, 32-bit maps fail, a gray file is read through its
map; PCX rows of padded planes are moved together by integer divisions; an
SGI row's table length counts packets, and PIL stops without an error at
a last packet that is not the end; XBM's decoder looks for a lower-case
``x``; MSP rows are joined whatever their lengths. Bar: bit-equal, a
raise where PIL raises.
"""

import io
import os
import struct
import warnings

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import (dib, write_ico, write_im, write_msp2,
                                  write_pcx, write_sgi, write_tga)
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import (ico, im, msp, pcx, pil_open, qoi, sgi,
                                    tga, xbm)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "pil29")
FLAGS = (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH)
MODULES = {"TGA": tga, "PCX": pcx, "SGI": sgi, "QOI": qoi, "XBM": xbm,
           "MSP": msp, "IM": im, "ICO": ico}
# the modules whose loops run in host C++ with a plain version beside them
PLAIN = ("TGA", "PCX", "SGI", "QOI", "XBM", "MSP")

warnings.simplefilter("ignore", UserWarning)


def _pil(path):
    """(PIL's format, its RGB) or (its format or None, the exception)."""
    try:
        opened = Image.open(path)
    except Exception as e:                 # noqa: BLE001 - every raise
        return None, e
    try:
        return opened.format, np.asarray(opened.convert("RGB"))
    except Exception as e:                 # noqa: BLE001
        return opened.format, e


def _check(path, data=None):
    """The port against PIL and cv2 on one file; returns PIL's format (None
    where ``Image.open`` raises) and whether PIL read it."""
    if data is not None:
        with open(path, "wb") as f:
            f.write(data)
    with open(path, "rb") as f:
        data = f.read()
    fmt, want = _pil(path)
    if fmt is not None:
        assert pil_open.pil_format(data) == fmt
    for flag in FLAGS:
        assert cv2.imread(path, flag) is None
        assert td.imread(path, flag) is None
    if isinstance(want, Exception):
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        if fmt in PLAIN:
            with pytest.raises((OSError, ValueError)):
                MODULES[fmt].read_pil(data, plain=True)
        return fmt, False
    got = td.read_rgb_pil(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if fmt in PLAIN:
        np.testing.assert_array_equal(
            MODULES[fmt].read_pil(data, plain=True), want)
    return fmt, True


def _digest(img):
    import hashlib

    return ",".join(map(str, img.shape)) + ":" + hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


@pytest.mark.parametrize("fname", sorted(os.listdir(FIXTURES)))
def test_committed_fixture_reads_as_pil_and_cv2(fname):
    """Each fixture: PIL's read live and its committed digest, cv2's None
    (live and committed), the plugin PIL picks."""
    path = os.path.join(FIXTURES, fname)
    name = os.path.splitext(fname)[0]
    ref = np.load(os.path.join(ROOT, "tests", "data", "pil29.npz"))
    for suffix in ("", "_gray", "_any"):
        assert str(ref[name + suffix]) == "None"
    fmt, read = _check(path)
    assert (name + "_pil" in ref.files) == read
    if read:
        assert _digest(td.read_rgb_pil(path)) == str(ref[name + "_pil"])
    assert fmt == name.split("_")[0].upper() or not read


def test_fixture_check_holds_every_read():
    """chip_smoke.py (v1): 72 files, three cv2 reads and PIL's each, and
    the plain versions of the host loops on the 53 files that have them."""
    import chip_smoke

    assert chip_smoke.check_format_fixtures(ROOT, ("pil29",)) == 341


# ---------------------------------------------------------------------------
# seeded random files of each format
# ---------------------------------------------------------------------------

def _rbytes(rng, n):
    return rng.randint(0, 256, max(n, 0)).astype(np.uint8).tobytes()


def _maybe_cut(rng, data, head=0):
    if rng.rand() < 0.12:
        return data[:rng.randint(head, len(data) + 1)]
    if rng.rand() < 0.1:
        return data + _rbytes(rng, rng.randint(1, 12))
    return data


def _tga(rng):
    kind = int(rng.choice([1, 2, 3, 9, 10, 11]))
    depth = int(rng.choice([8, 16, 24, 32, 1])) if kind & 3 != 1 else 8
    H, W = rng.randint(1, 12), rng.randint(1, 20)
    flags = int(rng.choice([0, 0x10, 0x20, 0x30, 0x08]))
    pal, map_depth = None, 24
    if kind & 3 == 1 or rng.rand() < 0.08:
        pal = rng.randint(0, 256, (rng.randint(2, 40), 3))
        map_depth = int(rng.choice([16, 24, 24, 32]))
    if depth == 1:
        px = rng.randint(0, 2, (H, W))
    elif depth == 16 and kind & 3 == 2:
        px = (rng.randint(0, 1 << 16, (H, W)) // 1024 * 1024).astype(
            np.uint16)
    else:
        chans = {8: 1, 16: 2, 24: 3, 32: 4}[depth]
        px = (rng.randint(0, 256, (H, W, chans)) // 64 * 64).astype(np.uint8)
        if kind & 3 == 1:
            px = rng.randint(0, len(pal), (H, W)).astype(np.uint8)
        elif chans == 1:
            px = px[..., 0]
    data = write_tga(px, kind, depth, palette=pal, map_depth=map_depth,
                     map_start=int(rng.choice([0, 0, 3])), flags=flags,
                     cross_rows=rng.rand() < 0.3)
    if kind & 8 and rng.rand() < 0.1:
        data += bytes([0x80 | 127]) + bytes(4)     # a run leaves the row
    return _maybe_cut(rng, data, 18)


def _pcx(rng):
    H, W = rng.randint(1, 10), rng.randint(1, 40)
    bits, planes = [(1, 1), (1, 2), (1, 4), (8, 1), (8, 3)][rng.randint(5)]
    px = rng.randint(0, 2 if bits == 1 else 256, (H, planes, W))
    if bits == 8:
        px = px // 64 * 64
    stride = (W * bits + 7) // 8
    bpl = int(rng.choice([stride, stride + 1, stride + 2]))
    tail = None
    if bits == 8 and planes == 1 and rng.rand() < 0.6:
        tail = rng.randint(0, 256, (256, 3)) if rng.rand() < 0.7 else \
            np.arange(256).repeat(3).reshape(256, 3)
    data = write_pcx(px, bits, version=int(rng.choice([5, 5, 0, 2, 3])),
                     palette16=rng.randint(0, 256, (16, 3)),
                     palette256=tail, bytes_per_line=bpl,
                     origin=(int(rng.choice([0, 4])), 0))
    if rng.rand() < 0.5:
        data += bytes(769)
    return _maybe_cut(rng, data, 128)


def _sgi(rng):
    H, W = rng.randint(1, 8), rng.randint(1, 30)
    z, bpc = int(rng.choice([1, 3, 4])), int(rng.choice([1, 2]))
    px = rng.randint(0, 256 if bpc == 1 else 65536, (H, W, z))
    if rng.rand() < 0.5:
        px = px // 4096 * 4096 if bpc == 2 else px // 64 * 64
    data = bytearray(write_sgi(px.astype(np.uint16 if bpc == 2 else
                                         np.uint8), bpc,
                               rle=rng.rand() < 0.8,
                               share_rows=rng.rand() < 0.3))
    if data[2] == 1 and rng.rand() < 0.3:
        # a length table in packets, or anything: PIL's own reading of it
        k = 512 + 4 * H * z + 4 * rng.randint(0, H * z)
        data[k:k + 4] = struct.pack(">I", int(rng.choice([1, 2, 3, 1000])))
    return _maybe_cut(rng, bytes(data), 512)


def _qoi(rng):
    H, W = rng.randint(1, 10), rng.randint(1, 20)
    ch = int(rng.choice([3, 4, 4, 0]))
    if rng.rand() < 0.5:
        img = (rng.randint(0, 256, (H, W, 4)) // 32 * 32).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img[..., :3] if ch == 3 else img).save(buf, "QOI")
        data = bytearray(buf.getvalue())
        data[12] = ch
        return _maybe_cut(rng, bytes(data), 14)
    ops = bytearray()
    for _ in range(rng.randint(0, 3 * H * W)):
        c = rng.randint(6)
        ops += [bytes([0xFE]) + _rbytes(rng, 3), bytes([0xFF]) +
                _rbytes(rng, 4), bytes([rng.randint(64)]),
                bytes([0x40 | rng.randint(64)]),
                bytes([0x80 | rng.randint(64), rng.randint(256)]),
                bytes([0xC0 | rng.randint(62)])][c]
    return _maybe_cut(rng, b"qoif" + struct.pack(">II", W, H) +
                      bytes([ch, 0]) + bytes(ops) + bytes(7) + b"\x01", 14)


def _xbm(rng):
    H, W = rng.randint(1, 8), rng.randint(1, 30)
    row = (W + 7) // 8
    vals = rng.randint(0, 256, max(0, row * H + rng.randint(-2, 3)))
    sep = [", ", ",", " ,\n  ", "x"][rng.randint(4)]
    hexes = sep.join(("0x%02x" if rng.rand() < 0.7 else "0x%02X") % v
                     for v in vals)
    hot = "#define a_x_hot 1\n#define a_y_hot 3\n" if rng.rand() < 0.3 \
        else ""
    return (f"#define im_width {W}\n#define im_height {H}\n{hot}"
            f"static char im_bits[] = {{\n{hexes}\n}};\n").encode()


def _msp(rng):
    H, W = rng.randint(1, 8), rng.randint(1, 40)
    bits = rng.randint(0, 2, (H, W))
    if rng.rand() < 0.5:
        bits[:, ::2] = bits[:, :1]
    if rng.rand() < 0.4:
        buf = io.BytesIO()
        Image.fromarray(bits.astype(bool)).save(buf, "MSP")
        return _maybe_cut(rng, buf.getvalue(), 32)
    data = write_msp2(bits, blank_rows=tuple(rng.randint(0, H, 2)))
    return _maybe_cut(rng, data, 32)


def _im(rng):
    H, W = rng.randint(1, 8), rng.randint(1, 20)
    kinds = ["Greyscale image", "RGB image", "X 24 image", "L 16 image",
             "L 16B image", "L 32F image", "L 8S image", "L 32S image",
             "0 1 image", "RGBA image", "LA image"]
    kind = kinds[rng.randint(len(kinds))]
    mode, raw = im.OPEN[kind]
    size = {"1": 1}.get(raw, 0)
    nbytes = ((W + 7) // 8) * H if size else W * H * 4 * 4
    lut = None
    if rng.rand() < 0.25:
        lut = _rbytes(rng, 768) if rng.rand() < 0.6 else \
            np.tile(np.arange(256, dtype=np.uint8), 3).tobytes()
    data = write_im(np.zeros((H, W)), kind, lut=lut,
                    raw=_rbytes(rng, nbytes))
    return _maybe_cut(rng, data, 20)


def _ico(rng):
    n = rng.randint(1, 4)
    images, directory = [], []
    for _ in range(n):
        h, w = rng.randint(1, 30), rng.randint(1, 30)
        bits = int(rng.choice([1, 4, 8, 24, 32]))
        if rng.rand() < 0.3:
            buf = io.BytesIO()
            Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(
                np.uint8)).save(buf, "PNG")
            data = buf.getvalue()
        elif bits <= 8:
            data = dib(rng.randint(0, 1 << bits, (h, w)), bits,
                       palette=rng.randint(0, 256, (1 << bits, 3)),
                       mask=rng.randint(0, 2, (h, w)))
        else:
            data = dib(rng.randint(0, 256, (h, w, bits // 8)), bits)
        if rng.rand() < 0.1:
            data = data[:rng.randint(40, len(data))]
        images.append(data)
        directory.append((w if rng.rand() < 0.8 else rng.randint(1, 256),
                          h, int(rng.choice([0, 0, 2, 16])),
                          bits if rng.rand() < 0.8 else 0))
    return write_ico(images, directory)


MAKERS = {"TGA": _tga, "PCX": _pcx, "SGI": _sgi, "QOI": _qoi, "XBM": _xbm,
          "MSP": _msp, "IM": _im, "ICO": _ico}


@pytest.mark.parametrize("fmt", sorted(MAKERS))
def test_random_files_read_as_pil(tmp_path, fmt):
    """150 seeded files of the format, each against PIL and cv2 live;
    both reads and raises must come out."""
    rng = np.random.RandomState(sorted(MAKERS).index(fmt) + 290)
    path = str(tmp_path / "x.img")
    seen = {True: 0, False: 0}
    for _ in range(150):
        opened, read = _check(path, MAKERS[fmt](rng))
        assert opened in (fmt, None)
        seen[read] += 1
    assert seen[True] >= 30 and seen[False] >= 3, seen


def test_host_loops_equal_their_plain_versions():
    """Each C++ loop against its Python version on seeded streams: the
    bytes and the errors (truncated data, overruns) alike."""
    rng = np.random.RandomState(7)

    def same(fn, *args):
        outs = []
        for plain in (False, True):
            try:
                outs.append(fn(*args, plain=plain))
            except (OSError, ValueError) as e:
                outs.append(type(e))
        assert outs[0] == outs[1]
        return outs[0]

    kinds = set()
    for _ in range(300):
        stream = bytes(rng.choice([0, 1, 0x7F, 0x80, 0x81, 0xC3, 0xFF, 5],
                                  rng.randint(0, 300)).astype(np.uint8))
        pixel = int(rng.choice([1, 2, 3, 4]))
        w, h = rng.randint(1, 10), rng.randint(1, 6)
        got = same(tga.rle, stream, 0, pixel, w * pixel, h)
        kinds.add(got if isinstance(got, type) else bytes)
        same(pcx.rle, stream, 0, w * 3, w, 0, h)
        same(pcx.rle, stream, 0, 2 * ((w + 7) // 8), w, 2, h)
        tables = struct.pack(f">{2 * h}I", *(
            [512 + 8 * h + rng.randint(0, 40) for _ in range(h)]
            + [rng.randint(0, 6) for _ in range(h)]))
        same(sgi.rle, bytes(512) + tables + stream, w, h, 1,
             int(rng.choice([1, 2])))
        same(qoi.decode, bytes(14) + stream, w, h, int(rng.choice([3, 4])))
        same(xbm.hex_bytes, b"x" + stream.replace(b"\x05", b"x"), 0, w * h)
        rowmap = struct.pack(f"<{h}H", *rng.randint(0, 8, h))
        same(msp.rle, bytes(32) + rowmap + stream, w * 8, h)
    assert kinds == {bytes, tga.CorruptTga}


def test_pil_format_names_the_plugin_pil_opens(tmp_path):
    """``pil_format`` against ``Image.open(...).format`` on seeded bytes
    behind every plugin's magic (and none), Targa-like headers and text
    headers: the same plugin where PIL opens the file, and where it does
    not, a raise in ``read_rgb_pil`` too."""
    rng = np.random.RandomState(11)
    magics = [b"BM", b"\x28\0\0\0", b"GIF89a", b"\xff\xd8\xff", b"P6", b"Pf",
              b"\x89PNG\r\n\x1a\n", b"BLP1", b"BUFR", b"\0\0\2\0",
              b"\x0a\x05\x01\x08", b"\xb1\x68\xde\x3a", b"DDS ", b"%!PS",
              b"SIMPLE  =                    T", b"FTEX", b"GRIB\0\0\0\x01",
              b"\x89HDF\r\n\x1a\n", b"icns", b"\0\0\1\0",
              b"Image type: L image\n", b"\x1c\x02\x00",
              b"\0\0\0\0\0\0\0\x04", b"\0\0\1\xb3", b"II*\0", b"DanM",
              b"LinS", b"\200\350\000\000", b"8BPS\0\1", b"qoif", b"\x01\xda",
              b"\x59\xa6\x6a\x95", b"RIFF\0\0\0\0WEBPVP8L",
              b"\xd7\xcd\xc6\x9a\0\0", b"\x01\0\0\0", b"/* XPM */",
              b"P7 332", b"#define a_width 3\n#define a_height 2\n", b""]
    path = str(tmp_path / "x.img")
    opened = set()
    for k in range(600):
        if k % 3 == 2:
            head = bytearray(_rbytes(rng, 18))
            head[0] = int(rng.choice([0, 1, 28]))
            head[1] = int(rng.choice([0, 1]))
            head[2] = int(rng.choice([1, 2, 3, 9, 10, 11, 5]))
            head[16] = int(rng.choice([1, 8, 16, 24, 32]))
            data = bytes(head) + _rbytes(rng, rng.randint(0, 600))
        else:
            data = magics[rng.randint(len(magics))] + _rbytes(
                rng, rng.randint(0, 300))
        with open(path, "wb") as f:
            f.write(data)
        fmt, want = _pil(path)
        if fmt is None:
            with pytest.raises((OSError, ValueError)):
                td.read_rgb_pil(path)
            continue
        opened.add(fmt)
        assert pil_open.pil_format(data) == fmt
    assert {"TGA", "MPEG", "BUFR", "GRIB", "HDF5"} <= opened, opened


def test_pil_format_on_every_committed_image():
    """``pil_format`` names the plugin ``Image.open`` picks on every image
    file under tests/data (JPEG, BMP, PxM, TIFF, HDR, Sun raster, GIF,
    WebP, item 29's); where PIL cannot open one, ``read_rgb_pil`` raises
    too."""
    n = 0
    for d, _, names in os.walk(os.path.join(ROOT, "tests", "data")):
        for name in names:
            if name.endswith((".npz", ".npy")):
                continue
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                data = f.read()
            fmt, _ = _pil(path)
            if fmt is None:
                with pytest.raises((OSError, ValueError)):
                    td.read_rgb_pil(path)
            else:
                assert pil_open.pil_format(data) == fmt, path
            n += 1
    assert n >= 220
