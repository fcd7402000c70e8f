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
raise ValueError naming ROADMAP.md queue 1 item 26e, and so do the
layouts whose cv2 read garbles its pixels (libtiff's RGBA tile readers
on flipped or gray tiles, separate planes read as interleaved) — but only
where cv2 decodes the file: where cv2 gives None, the port gives None
(fault M: the codecs cv2's libtiff lacks, LZMA and Zstandard among them,
and the sample layouts its reads refuse).
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


def _refusal(e, refuse):
    """Whether ``e`` is a refusal naming item 26e that ``refuse`` allows:
    True, any; else one whose message holds one of its strings."""
    msg = str(e)
    return "item 26e" in msg and (refuse is True or any(
        r in msg for r in refuse))


def _check(path, refuse=True):
    """The port against cv2 in its three modes (plain codecs too) and
    against PIL; returns (cv2's colour read gave an image, PIL did), with
    None for a read the port refuses with ValueError naming item 26e, which
    it may only where cv2 decodes the file (where PIL decodes it, for
    ``read_rgb_pil``), and only as ``refuse`` allows (``_refusal``)."""
    with open(path, "rb") as f:
        data = f.read()
    seen = []
    for flag in FLAGS:
        ref = cv2.imread(path, flag)
        try:
            got = td.imread(path, flag)
        except ValueError as e:
            assert _refusal(e, refuse) and ref is not None, (path, flag, e)
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
        assert _refusal(e, refuse), (path, e)
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


def _pack12(px: np.ndarray) -> bytes:
    """12-bit samples packed MSB first, rows padded to a byte."""
    bits = np.unpackbits(px.astype(">u2").view(np.uint8).reshape(
        px.shape[0], -1, 2), axis=-1)[..., 4:].reshape(px.shape[0], -1)
    return np.packbits(bits, axis=1).tobytes()


@pytest.mark.parametrize("what", ["CIELab", "12-bit samples",
                                  "separate YCbCr planes",
                                  "palette with alpha"])
def test_modes_the_port_lacks_name_their_item(tmp_path, what):
    """Files of the modes the port lacks, which cv2 decodes, raise
    ValueError naming item 26e under the flag cv2 decodes them with, never
    None (item 26c's modes are read: tests/test_torch_tiff26c.py)."""
    rng = np.random.RandomState(1)
    path = str(tmp_path / "m.tif")
    flag = td.IMREAD_COLOR
    if what == "CIELab":
        write_tiff(path, rng.randint(0, 256, (8, 8, 3)).astype(np.uint8),
                   photometric=8)
    elif what == "12-bit samples":
        px = rng.randint(0, 4096, (8, 8)).astype(np.uint16)
        write_tiff(path, px, photometric=1, bits=12, chunks=[_pack12(px)])
        flag = td.IMREAD_ANYDEPTH
    elif what == "separate YCbCr planes":
        write_tiff(path, rng.randint(0, 256, (8, 8, 3)).astype(np.uint8),
                   photometric=6, planar=2, tags={530: (3, [1, 1])})
    else:
        write_tiff(path, rng.randint(0, 256, (8, 8, 2)).astype(np.uint8),
                   photometric=3, extra=(2,),
                   colormap=rng.randint(0, 65536, (3, 256)))
    assert cv2.imread(path, flag) is not None
    with pytest.raises(ValueError, match="item 26e") as e:
        td.imread(path, flag)
    assert not isinstance(e.value, tiff.CorruptTiff)


FAULT_M = {
    "lzma": dict(compression=34925),
    "zstd": None,                        # written by PIL
    "i32": dict(dtype=np.int32),
    "u32_rgb": dict(dtype=np.uint32, channels=3),
    "f16": dict(dtype=np.float16),
    "g12_color": dict(bits=12),
    "g24": dict(bits=24),
    "mixed_bits": dict(mixed=True),
    "logluv_raw": dict(photometric=32845),
    "palette16": dict(photometric=3, dtype=np.uint16),
}


@pytest.mark.parametrize("name", list(FAULT_M))
def test_fault_m_none_where_cv2_gives_none(tmp_path, name):
    """Fault M: TIFFs cv2 gives None on (a codec its libtiff is built
    without: LZMA, Zstandard; samples its reads refuse: 32-bit integers
    and 16-bit floats under the 8-bit reads, 12-bit samples there, 24-bit
    samples, mixed sizes, LogLuv without its codec, 16-bit palettes) give
    None from imread under each flag where cv2 gives None, and cv2's own
    array where it decodes (signed 32-bit samples under IMREAD_ANYDEPTH:
    int32), not ValueError."""
    rng = np.random.RandomState(len(name))
    path = str(tmp_path / f"{name}.tif")
    kw = FAULT_M[name]
    if kw is None:
        Image.fromarray(rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)) \
            .save(path, compression="zstd")
    else:
        kw = dict(kw)
        dt = kw.pop("dtype", np.uint8)
        channels = kw.pop("channels", 1)
        bits = kw.pop("bits", None)
        mixed = kw.pop("mixed", False)
        info = np.iinfo(dt) if np.dtype(dt).kind in "iu" else None
        shape = (9, 11, channels) if channels > 1 else (9, 11)
        if info is not None:
            px = rng.randint(int(info.min), int(info.max) + 1, shape,
                             dtype=np.int64).astype(dt)
        else:
            px = rng.randn(*shape).astype(dt)
        ph = kw.pop("photometric", 1 if channels == 1 else 2)
        extra = {}
        if bits == 12:
            px = (px.astype(np.uint16) & 4095)
            extra = dict(chunks=[_pack12(px)], bits=12)
        elif bits == 24:
            extra = dict(chunks=[bytes(9 * 11 * 3)], bits=24)
        if mixed:
            px = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
            ph = 2
            extra = dict(chunks=[bytes(9 * 11 * 4)],
                         tags={258: (3, [8, 8, 16])})
        if ph == 3:
            extra["colormap"] = rng.randint(0, 65536, (3, 65536))
        write_tiff(path, px, photometric=ph, **kw, **extra)
    nones = 0
    for flag in FLAGS:
        ref = cv2.imread(path, flag)
        if ref is None:
            assert td.imread(path, flag) is None, (name, flag)
            nones += 1
        elif name == "g12_color":       # 12-bit samples stay item 26e's
            with pytest.raises(ValueError, match="item 26e"):
                td.imread(path, flag)
        else:
            got = td.imread(path, flag)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
    assert nones


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
