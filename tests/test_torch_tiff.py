"""The port's TIFF reader (``io/tiff.py`` with ``csrc/tiff_decode.cpp``)
through ``io/datasets.imread`` against ``cv2.imread`` (libtiff 4.7;
IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_ANYDEPTH) and through
``read_rgb_pil`` against PIL's ``Image.open(p).convert("RGB")``, on the
same bytes, and the host C++ codecs against their plain versions.

Bar: bit-equal, None where cv2 gives None, a raise where PIL raises, and
the C++ LZW, PackBits and predictor steps equal to their plain versions on
every input, corrupt and cut ones too (both fail alike). The files,
written by ``tests/image_encoders.write_tiff`` and by cv2 and PIL: 1-, 8-
and 16-bit gray (min-is-black and min-is-white), 32-bit floats, gray with
alpha, 8- and 16-bit RGB with extra samples of each kind, an 8-bit
palette; strips of any height, tiles over the edge, planar
configurations 1 and 2, classic and BigTIFF, both byte orders; no
compression, LZW of both bit orders, Deflate (8 and 32946), PackBits,
predictors 2 and 3; orientations 1-8; cut files. Modes the port lacks
raise ValueError naming ROADMAP.md queue 1 item 26c, and so do the
layouts whose cv2 read garbles its pixels (libtiff's RGBA tile readers
on flipped or gray tiles, separate planes read as interleaved).
"""

import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import lzw_encode, packbits, write_tiff
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import tiff

FLAGS = (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH)


def _check(path):
    """The port against cv2 in its three modes (plain codecs too) and
    against PIL; returns (cv2's colour read gave an image, PIL did), with
    None for a read the port refuses with ValueError naming item 26c."""
    with open(path, "rb") as f:
        data = f.read()
    seen = []
    for flag in FLAGS:
        ref = cv2.imread(path, flag)
        try:
            got = td.imread(path, flag)
        except ValueError as e:
            assert "item 26c" in str(e)
            seen.append(None)
            continue
        if ref is None:
            assert got is None, (path, flag)
        else:
            assert got is not None and got.dtype == ref.dtype \
                and got.shape == ref.shape, (path, flag)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(
                tiff.read_cv2(data, flag, plain=True), ref)
        seen.append(ref is not None)
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        return seen[0], False
    try:
        got = td.read_rgb_pil(path)
    except ValueError as e:
        assert "item 26c" in str(e)
        return seen[0], None
    np.testing.assert_array_equal(got, ref)
    return seen[0], True


def _pixels(kind, H, W, rng):
    """(samples, write_tiff keywords) of a kind."""
    if kind == "g1":
        return rng.randint(0, 2, (H, W)).astype(np.uint8), dict(bits=1)
    if kind == "g8":
        return rng.randint(0, 256, (H, W)).astype(np.uint8), {}
    if kind == "g16":
        return rng.randint(0, 65536, (H, W)).astype(np.uint16), {}
    if kind == "f32":
        return (rng.randn(H, W) * 100).astype(np.float32), {}
    if kind == "ga8":
        return rng.randint(0, 256, (H, W, 2)).astype(np.uint8), dict(
            extra=(2,))
    if kind == "rgb8":
        return rng.randint(0, 256, (H, W, 3)).astype(np.uint8), {}
    if kind == "rgb16":
        return rng.randint(0, 65536, (H, W, 3)).astype(np.uint16), {}
    if kind.startswith("rgba"):
        dt = np.uint16 if kind.startswith("rgba16") else np.uint8
        extra = {"": (), "x": (0,), "a": (1,), "u": (2,)}[kind.split("_")[1]]
        return rng.randint(0, np.iinfo(dt).max + 1, (H, W, 4)).astype(dt), \
            dict(extra=extra)
    cmap = rng.randint(0, 65536 if kind == "pal16" else 256, (3, 256))
    return rng.randint(0, 256, (H, W)).astype(np.uint8), dict(
        colormap=cmap.astype(np.uint16))


KINDS = {"g1": (0, 1), "g8": (0, 1), "g16": (0, 1), "f32": (1,),
         "ga8": (1,), "rgb8": (2,), "rgb16": (2,), "rgba8_": (2,),
         "rgba8_x": (2,), "rgba8_a": (2,), "rgba8_u": (2,),
         "rgba16_u": (2,), "rgba16_a": (2,), "pal16": (3,), "pal8": (3,)}
COMPRESSIONS = {"none": 1, "lzw": 5, "deflate": 8, "adobe": 32946,
                "packbits": 32773}


@pytest.mark.parametrize("comp", list(COMPRESSIONS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_layouts_against_cv2_and_pil(tmp_path, kind, comp):
    """Each kind and compression in strips (one, several, a short last),
    tiles, separate planes, both byte orders, BigTIFF, the predictor."""
    rng = np.random.RandomState(len(kind) * 31 + COMPRESSIONS[comp] % 89)
    path = str(tmp_path / "t.tif")
    variants = [dict(), dict(rows_per_strip=4), dict(tile=(16, 32)),
                dict(big_endian=True, rows_per_strip=7),
                dict(bigtiff=True), dict(planar=2, rows_per_strip=5)]
    reads = 0
    for i, extra in enumerate(variants):
        H, W = [(13, 17), (21, 9), (35, 40), (1, 33), (16, 16), (9, 8)][i]
        px, kw = _pixels(kind, H, W, rng)
        if i % 2:
            px = np.repeat(px[:, :1], W, 1)       # runs
        pred = 1
        if COMPRESSIONS[comp] in (5, 8, 32946) and kind != "g1" and i >= 2:
            pred = 3 if kind == "f32" else 2
        for ph in KINDS[kind]:
            write_tiff(path, px, photometric=ph, predictor=pred,
                       compression=COMPRESSIONS[comp], **kw, **extra)
            reads += _check(path)[0] is not None
    assert reads


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientations(tmp_path, orientation):
    """cv2 flips for 2-4, transposes 5-8 only where the image is square
    (elsewhere it fails its own check: None); PIL applies all but reads
    5-8 into swapped sizes (refused: item 26c); tiles flipped by libtiff
    one by one are refused."""
    rng = np.random.RandomState(orientation)
    path = str(tmp_path / "o.tif")
    for kind, (H, W), kw in (("rgb8", (7, 11), {}), ("g16", (9, 9), {}),
                             ("f32", (6, 6), {}), ("g8", (5, 8), {}),
                             ("pal8", (20, 20), dict(tile=(16, 16))),
                             ("rgb8", (20, 33), dict(tile=(16, 16)))):
        px, kwp = _pixels(kind, H, W, rng)
        ph = {"rgb8": 2, "pal8": 3}.get(kind, 1)
        write_tiff(path, px, photometric=ph, orientation=orientation,
                   **kw, **kwp)
        _check(path)


def test_cv2_and_pil_writers(tmp_path):
    """Files cv2 and PIL write: cv2's 8-bit, 16-bit and float TIFFs (LZW by
    default) and each compression it offers; PIL's modes and codecs."""
    rng = np.random.RandomState(3)
    path = str(tmp_path / "w.tif")
    for img in (rng.randint(0, 256, (21, 30, 3)).astype(np.uint8),
                rng.randint(0, 256, (21, 30)).astype(np.uint8),
                rng.randint(0, 65536, (21, 30)).astype(np.uint16),
                rng.randint(0, 65536, (21, 30, 3)).astype(np.uint16),
                (rng.rand(21, 30) * 50).astype(np.float32)):
        for comp in (None, 1, 5, 8, 32946, 32773):
            params = [] if comp is None else [cv2.IMWRITE_TIFF_COMPRESSION,
                                              comp]
            if cv2.imwrite(path, img, params):
                assert _check(path)[0] == (img.dtype != np.float32)
    img = rng.randint(0, 256, (21, 30, 3)).astype(np.uint8)
    for mode in ("RGB", "RGBA", "L", "1", "P", "I;16", "F", "LA"):
        im = Image.fromarray(img).convert(mode) if mode not in (
            "I;16", "F") else Image.fromarray(
                (img[..., 0].astype(np.uint16) * 250) if mode == "I;16"
                else img[..., 0].astype(np.float32) / 3)
        for comp in ("raw", "tiff_lzw", "tiff_deflate",
                     "tiff_adobe_deflate", "packbits"):
            im.save(path, compression=comp)
            _check(path)


def test_eight_bit_reads_of_wider_samples(tmp_path):
    """libtiff's RGBA reader, under cv2's 8-bit reads: 16-bit gray shifted
    right by 8, 16-bit colour scaled by (v * 255 + 32767) // 65535;
    IMREAD_ANYDEPTH keeps 16 bits (min-is-white not inverted) and floats;
    floats give None under the 8-bit reads; unassociated alpha is
    premultiplied, associated and unspecified alpha dropped."""
    path = str(tmp_path / "w.tif")
    v = np.arange(65536, dtype=np.uint16).reshape(128, 512)
    write_tiff(path, v, photometric=1, compression=8)
    np.testing.assert_array_equal(td.imread(path, td.IMREAD_GRAYSCALE),
                                  (v >> 8).astype(np.uint8))
    np.testing.assert_array_equal(td.imread(path, td.IMREAD_ANYDEPTH), v)
    rgb = np.stack([v, v[::-1], v.T.reshape(128, 512)], -1)
    write_tiff(path, rgb, photometric=2, compression=5)
    scaled = ((rgb.astype(np.int64) * 255 + 32767) // 65535)[..., ::-1]
    np.testing.assert_array_equal(td.imread(path), scaled)
    assert _check(path) == (True, True)
    write_tiff(path, v, photometric=0)
    np.testing.assert_array_equal(td.imread(path, td.IMREAD_ANYDEPTH), v)
    assert _check(path) == (True, True)
    write_tiff(path, np.full((2, 2), 1.5, np.float32), photometric=1)
    assert td.imread(path) is None and cv2.imread(path) is None
    assert td.imread(path, td.IMREAD_ANYDEPTH).dtype == np.float32
    rgba = np.array([[[200, 100, 50, 128], [200, 100, 50, 0]]], np.uint8)
    for extra, first in (((2,), [25, 50, 100]), ((1,), [50, 100, 200]),
                         ((0,), [50, 100, 200])):
        write_tiff(path, rgba, photometric=2, extra=extra)
        np.testing.assert_array_equal(td.imread(path)[0, 0], first)
        _check(path)


@pytest.mark.parametrize("what,kw", [
    ("JPEG compression", dict(compression=7)),
    ("CCITT compression", dict(compression=4, bits=1)),
    ("YCbCr", dict(photometric=6)),
    ("CMYK", dict(photometric=5, channels=4)),
    ("LogLuv", dict(photometric=32845)),
    ("fill order 2", dict(fill_order=2)),
    ("12-bit samples", dict(bits=12)),
    ("samples of format 2", dict(sample_format=2)),
    ("4-bit palette", dict(photometric=3, bits=4))])
def test_modes_the_port_lacks_name_their_item(tmp_path, what, kw):
    """Valid headers of the modes the port lacks raise ValueError naming
    item 26c, never None (the fields of a written file rewritten)."""
    import struct

    kw = dict(kw)
    channels = kw.pop("channels", 3 if kw.get("photometric") in (6,) else 1)
    ph = kw.pop("photometric", 1)
    rng = np.random.RandomState(1)
    px = rng.randint(0, 256, (8, 8, channels)).astype(np.uint8)
    path = str(tmp_path / "m.tif")
    write_tiff(path, px, photometric=1 if ph == 32845 else min(ph, 2)
               if ph != 3 else 3, colormap=np.zeros((3, 256), np.uint16)
               if ph == 3 else None)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    ifd = struct.unpack_from("<I", data, 4)[0]
    fields = {259: kw.get("compression"), 262: ph if ph != 1 else None,
              258: kw.get("bits"), 266: kw.get("fill_order"),
              339: kw.get("sample_format")}
    n = struct.unpack_from("<H", data, ifd)[0]
    for i in range(n):
        p = ifd + 2 + 12 * i
        tag, typ, count = struct.unpack_from("<HHI", data, p)
        if fields.get(tag) is not None and count == 1:
            struct.pack_into("<H", data, p + 8, fields[tag])
    if kw.get("fill_order"):
        # append FillOrder: rewrite the directory with one more entry
        entries = bytes(data[ifd + 2:ifd + 2 + 12 * n]) + struct.pack(
            "<HHIHH", 266, 3, 1, 2, 0)
        entries = b"".join(sorted(entries[i:i + 12]
                                  for i in range(0, len(entries), 12)))
        data = data[:ifd] + struct.pack("<H", n + 1) + entries + bytes(4) \
            + data[ifd + 2 + 12 * n + 4:]
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="item 26c") as e:
        td.imread(path)
    assert not isinstance(e.value, tiff.CorruptTiff)


def test_cut_files(tmp_path):
    """Cut in the header, the data and the directory (written last): None
    where libtiff fails; PIL keeps the directory entries before a cut,
    as its reader does, and reads past a strip's byte count."""
    rng = np.random.RandomState(2)
    path = str(tmp_path / "c.tif")
    seen = set()
    for kind, comp in (("rgb8", 1), ("g16", 5), ("pal8", 1), ("f32", 8),
                       ("g1", 32773)):
        px, kw = _pixels(kind, 19, 23, rng)
        ph = {"rgb8": 2, "pal8": 3}.get(kind, 1)
        write_tiff(path, px, photometric=ph, compression=comp, **kw)
        with open(path, "rb") as f:
            data = f.read()
        for cut in sorted(set(np.linspace(5, len(data) - 1, 16)
                              .astype(int))):
            with open(path, "wb") as f:
                f.write(data[:cut])
            seen.add(_check(path))
    assert (False, False) in seen and (False, True) in seen


def _lzw_streams():
    """LZW streams (libtiff's encoder here) crossing each code width, a
    table reset, the KwKwK case, both bit orders, and cut or corrupted."""
    rng = np.random.RandomState(7)
    out = []
    for n in (0, 1, 2, 300, 700, 1500, 3000, 9000):
        for kind in ("noise", "runs", "kwkwk"):
            if kind == "noise":
                raw = rng.randint(0, 256, n).astype(np.uint8).tobytes()
            elif kind == "runs":
                raw = np.repeat(rng.randint(0, 4, n // 5 + 1), 5)[:n] \
                    .astype(np.uint8).tobytes()
            else:
                raw = b"a" * n
            for old in (False, True):
                out.append((raw, lzw_encode(raw, old)))
    return out


def test_lzw_cpp_equals_plain_on_every_stream():
    """Whole, cut and corrupted streams: the C++ decoder and its plain
    version return the same bytes, or both fail."""
    rng = np.random.RandomState(8)
    for raw, enc in _lzw_streams():
        np.testing.assert_equal(tiff.lzw_decode(enc, len(raw)), raw)
        np.testing.assert_equal(tiff.lzw_decode(enc, len(raw), plain=True),
                                raw)
        variants = [enc[:len(enc) // 2], enc[:-1]]
        if len(enc) > 4:
            bad = bytearray(enc)
            bad[rng.randint(2, len(enc))] ^= 0xFF
            variants.append(bytes(bad))
        for v in variants:
            outs = []
            for plain in (False, True):
                try:
                    outs.append(tiff.lzw_decode(v, len(raw), plain))
                except tiff.CorruptTiff:
                    outs.append(None)
            assert outs[0] == outs[1]


def test_packbits_cpp_equals_plain():
    """Runs across row ends, the -128 no-op, literals cut by the data's
    end or by the strip's size."""
    rng = np.random.RandomState(9)
    for n in (1, 7, 130, 1000):
        raw = np.repeat(rng.randint(0, 3, n), rng.randint(1, 200, n))[
            :4 * n].astype(np.uint8).tobytes()
        enc = packbits(raw)
        for src in (enc, b"\x80" + enc, enc[:-3], enc + b"\x05ab"):
            for need in (len(raw), len(raw) // 2, len(raw) + 4):
                outs = []
                for plain in (False, True):
                    try:
                        outs.append(tiff.packbits_decode(src, need, plain))
                    except tiff.CorruptTiff:
                        outs.append(None)
                assert outs[0] == outs[1]
                if src is enc and need <= len(raw):
                    assert outs[0] == raw[:need]


@pytest.mark.parametrize("nbytes,predictor", [(1, 2), (2, 2), (4, 2),
                                              (4, 3)])
def test_predictors_cpp_equal_plain(nbytes, predictor):
    """Horizontal differencing at 8, 16 and 32 bits and the floating-point
    predictor, both byte orders, odd row lengths and sample counts."""
    rng = np.random.RandomState(nbytes * predictor)
    for rows, cols, spp in ((1, 1, 1), (3, 7, 3), (5, 33, 4), (2, 2, 2)):
        buf = rng.randint(0, 256, rows * cols * spp * nbytes).astype(
            np.uint8).tobytes()
        for be in (False, True):
            a = tiff.undo_predictor(buf, rows, cols, spp, nbytes, predictor,
                                    be)
            b = tiff.undo_predictor(buf, rows, cols, spp, nbytes, predictor,
                                    be, plain=True)
            assert a == b


def test_deflate_and_predictor_three_on_big_endian_floats(tmp_path):
    """Big-endian floats through Deflate and predictor 3 (byte planes,
    most significant first, whatever the byte order), cv2's ANYDEPTH read
    and PIL's (libtiff hands PIL native floats, which its big-endian
    rawmode swaps again)."""
    rng = np.random.RandomState(11)
    f = (rng.randn(17, 23) * 1e3).astype(np.float32)
    path = str(tmp_path / "f.tif")
    for comp, pred in ((8, 3), (32946, 1), (1, 1), (5, 3)):
        write_tiff(path, f, photometric=1, compression=comp, predictor=pred,
                   big_endian=True)
        np.testing.assert_array_equal(td.imread(path, td.IMREAD_ANYDEPTH), f)
        assert _check(path) == (False, True)
    raw = zlib.compress(f.tobytes())[:-5]
    assert len(raw) > 0
