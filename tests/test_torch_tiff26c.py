"""The TIFF modes of ROADMAP.md queue 1 item 26c, part 1, through
``io/datasets.imread`` against ``cv2.imread`` (IMREAD_COLOR,
IMREAD_GRAYSCALE, IMREAD_ANYDEPTH) and through ``read_rgb_pil`` against
PIL's ``Image.open(p).convert("RGB")``, on the same bytes: JPEG-in-TIFF
(YCbCr at 1x1, 2x1 and 2x2, RGB, gray, CMYK; strips, tiles, both byte
orders), subsampled YCbCr without JPEG (libtiff's TIFFYCbCrtoRGB, the
ReferenceBlackWhite and YCbCrCoefficients tags), CMYK of 8 and 16 bits,
CCITT fax (compressions 2, 3 with 1-D and 2-D rows, 4 and 32771), fill
order 2, 2- and 4-bit gray, 1-, 2- and 4-bit palettes, signed and 32-bit
integers, 16- and 64-bit floats, LZMA; and the host C++ fax decoder
(``csrc/fax_decode.cpp``) against its plain Python twin.

Bar: bit-equal, None where cv2 gives None, a raise where PIL raises; a
refusal (ValueError naming item 26e) only where cv2 or PIL decodes the
file and garbles or keeps pixels libtiff failed to decode
(``tests/test_torch_tiff._check``); the committed fixtures of
tests/data/tiff26c also against the digests of cv2's and PIL's reads in
tests/data/tiff26c.npz (tools/make_image_fixtures.py); the C++ fax
decoder equal to its twin on every stream, cut and corrupt ones too.
"""

import hashlib
import lzma
import os
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import (fax_encode, jpeg_tiff_chunks, lzw_encode,
                                  packbits, write_tiff, ycbcr_chunks)
from tests.test_torch_tiff import FLAGS, _check
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import tiff, tiff_fax

DATA = os.path.join(os.path.dirname(__file__), "data")
# the refusals these well-formed random files may meet: the layouts whose
# PIL or cv2 read garbles its pixels (PIL unpacks an uncompressed separate
# plane by its rawmode's first letter; libtiff aligns RLE-W runs by the
# buffer's address)
GARBLED = ("a separate plane that PIL unpacks by another mode",
           "word-aligned CCITT runs")
FIXTURES = sorted(os.listdir(os.path.join(DATA, "tiff26c")))


def _digest(img) -> str:
    if img is None:
        return "None"
    return ",".join(map(str, img.shape)) + ":" + hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def digests():
    return np.load(os.path.join(DATA, "tiff26c.npz"))


@pytest.mark.parametrize("fname", FIXTURES)
def test_fixture_against_cv2_pil_and_digests(fname, digests):
    """Each committed fixture: imread under the three flags and
    read_rgb_pil bit-equal to cv2 and PIL here and to the committed
    digests, the plain codecs too; none is refused."""
    path = os.path.join(DATA, "tiff26c", fname)
    name = os.path.splitext(fname)[0]
    with open(path, "rb") as f:
        data = f.read()
    for flag, suffix in zip(FLAGS, ("", "_gray", "_any")):
        ref = cv2.imread(path, flag)
        got = td.imread(path, flag)
        plain = tiff.read_cv2(data, flag, plain=True)
        for img in (got, plain):
            assert _digest(img) == _digest(ref) == str(digests[name + suffix])
            if ref is not None:
                assert img.dtype == ref.dtype
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        assert name + "_pil" not in digests.files
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        return
    got = td.read_rgb_pil(path)
    np.testing.assert_array_equal(got, ref)
    assert _digest(got) == str(digests[name + "_pil"])


def test_fixtures_cover_each_mode():
    """The fixtures hold every mode of the slice, read by both libraries
    where both read it."""
    names = {os.path.splitext(f)[0] for f in FIXTURES}
    for prefix in ("jpeg_ycc11", "jpeg_ycc21", "jpeg_ycc22", "ycc22",
                   "cmyk8", "cmyk16", "fax_rle", "fax_g3_1d", "fax_g3_2d",
                   "fax_g4", "fax_rlew", "fill2_", "g2", "g4", "pal1",
                   "pal2", "pal4", "i8", "i16", "i32", "u32", "f16", "f64",
                   "lzma_"):
        assert any(n.startswith(prefix) for n in names), prefix


def test_pil_modes_are_open_info():
    """io/tiff.py's table of PIL's modes is TiffImagePlugin.OPEN_INFO."""
    from PIL import TiffImagePlugin
    assert tiff.PIL_MODES == {(k[0] == b"MM",) + k[1:]: v for k, v in
                              TiffImagePlugin.OPEN_INFO.items()}


# ---------------------------------------------------------------------------
# random files of each mode, against cv2 and PIL
# ---------------------------------------------------------------------------

def _layout(rng, H, W, tiles=True, planar=True):
    kw = {}
    k = rng.randint(0, 6 if planar else 5)
    if k == 1:
        kw["rows_per_strip"] = rng.randint(1, H + 1)
    elif k == 2 and tiles:
        kw["tile"] = (16 * rng.randint(1, 4), 16 * rng.randint(1, 3))
    elif k == 3:
        kw["big_endian"] = True
    elif k == 4:
        kw["bigtiff"] = True
    elif k == 5:
        kw["planar"] = 2
        kw["rows_per_strip"] = rng.randint(1, H + 1)
    return kw


@pytest.mark.parametrize("seed", range(4))
def test_jpeg_in_tiff(tmp_path, seed):
    """JPEG strips and tiles: YCbCr at 1x1, 2x1 and 2x2 (libjpeg's
    colour conversion and fancy upsampling, as libtiff's JPEGCOLORMODE_RGB
    asks), RGB, gray and CMYK as coded; a short last strip; big-endian."""
    rng = np.random.RandomState(seed)
    path = str(tmp_path / "j.tif")
    for t in range(6):
        H, W = rng.randint(1, 50), rng.randint(1, 70)
        kw = _layout(rng, H, W, planar=False)
        kw.pop("bigtiff", None)
        what = rng.randint(0, 4)
        sub = rng.randint(0, 3) if what == 0 else 0
        hv = [(1, 1), (2, 1), (2, 2)][sub]
        if "rows_per_strip" in kw:
            kw["rows_per_strip"] = -(-kw["rows_per_strip"] // (8 * hv[1])) \
                * 8 * hv[1]
        yy, xx = np.mgrid[:H, :W]
        px = np.stack([(xx * 5 + yy * 3) % 256, (yy * 7) % 256,
                       (xx * 11) % 256, (xx + yy) % 256], -1).astype(np.uint8)
        px = [px[..., :3], px[..., :3], px[..., 0], px][what]
        tables, chunks = jpeg_tiff_chunks(
            px, subsampling=sub, quality=int(rng.randint(30, 95)),
            rows_per_strip=kw.get("rows_per_strip"), tile=kw.get("tile"))
        ph = (6, 2, 1, 5)[what]
        tags = {347: (7, tables)}
        if ph == 6:
            tags[530] = (3, list(hv))
        write_tiff(path, px, photometric=ph, compression=7, chunks=chunks,
                   tags=tags, **kw)
        assert _check(path) == (True, True)


@pytest.mark.parametrize("seed", range(4))
def test_ycbcr_units(tmp_path, seed):
    """Subsampled YCbCr without JPEG at every subsampling libtiff's RGBA
    reader takes, in strips (4x4 units of an odd count a row lose the
    strip's last bytes to TIFFScanlineSize's rounding) and tiles (the 4x4
    routine skips the columns past the image edge by 4x2 units' bytes),
    under each codec; PIL raises or garbles uncompressed YCbCr (refused)."""
    rng = np.random.RandomState(10 + seed)
    path = str(tmp_path / "y.tif")
    for t in range(8):
        H, W = rng.randint(1, 50), rng.randint(1, 70)
        kw = _layout(rng, H, W, planar=False)
        hv = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)][
            rng.randint(0, 7)]
        if "rows_per_strip" in kw:
            kw["rows_per_strip"] = -(-kw["rows_per_strip"] // hv[1]) * hv[1]
        comp = int(rng.choice([1, 5, 8, 32773]))
        px = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        enc = {1: bytes, 5: lzw_encode, 8: zlib.compress,
               32773: packbits}[comp]
        chunks = ycbcr_chunks(px, hv, rows_per_strip=kw.get(
            "rows_per_strip"), tile=kw.get("tile"))
        tags = {530: (3, list(hv))}
        if rng.rand() < 0.3:
            tags[532] = (5, [(16, 1), (235, 1), (128, 1), (240, 1),
                             (128, 1), (240, 1)])
        write_tiff(path, px, photometric=6, compression=comp,
                   chunks=[enc(c) for c in chunks], tags=tags, **kw)
        assert _check(path)[0]


@pytest.mark.parametrize("seed", range(3))
def test_cmyk(tmp_path, seed):
    """CMYK of 8 bits (libtiff's ``(255 - k) * (255 - c) // 255`` for cv2,
    Convert.c's cmyk2rgb for PIL, which differ) and 16 bits (cv2: None;
    PIL: the high bytes), an extra sample, InkSet 2 (cv2: None), separate
    planes."""
    rng = np.random.RandomState(20 + seed)
    path = str(tmp_path / "c.tif")
    for t in range(8):
        H, W = rng.randint(1, 40), rng.randint(1, 50)
        kw = _layout(rng, H, W)
        b = int(rng.choice([8, 16]))
        spp = int(rng.choice([4, 4, 5]))
        px = rng.randint(0, 1 << b, (H, W, spp)).astype(
            np.uint8 if b == 8 else np.uint16)
        tags = {332: (3, [2])} if rng.rand() < 0.2 else {}
        write_tiff(path, px, photometric=5, extra=(0,) * (spp - 4),
                   compression=int(rng.choice([1, 5, 8, 32773, 34925])),
                   tags=tags, **kw)
        _check(path, refuse=GARBLED)


@pytest.mark.parametrize("mode", tiff_fax.MODES)
def test_fax_layouts(tmp_path, mode):
    """CCITT fax of each mode (T.4 with and without fill bits before the
    EOLs, 2-D rows every k rows), in strips and tiles, both photometrics,
    fill order 2; bit-equal to cv2 and PIL."""
    rng = np.random.RandomState(mode % 97)
    path = str(tmp_path / "f.tif")
    comp = {103: 3}.get(mode, mode)
    t4 = {3: {292: (4, [0])}, 103: {292: (4, [1])}}.get(mode, {})
    for t in range(10):
        H, W = rng.randint(1, 50), rng.randint(1, 80)
        kw = _layout(rng, H, W, planar=False)
        px = (rng.rand(H, W) > rng.rand()).astype(np.uint8)
        if t % 2:
            px = np.repeat(px[:1], H, 0)
            px[rng.randint(0, H):, rng.randint(0, W):] ^= 1
        k, fill = rng.randint(1, 4), bool(rng.rand() < 0.5)
        if "tile" in kw:
            tw, th = kw["tile"]
            pad = np.zeros((-(-H // th) * th, -(-W // tw) * tw), np.uint8)
            pad[:H, :W] = px
            chunks = [fax_encode(pad[y:y + th, x:x + tw], mode, k=k,
                                 eol_fill=fill)
                      for y in range(0, H, th) for x in range(0, W, tw)]
        else:
            rps = kw.get("rows_per_strip", H)
            chunks = [fax_encode(px[y:y + rps], mode, k=k, eol_fill=fill)
                      for y in range(0, H, rps)]
        order = 2 if rng.rand() < 0.3 else 1
        if order == 2:
            chunks = [c.translate(tiff_fax.REVERSED) for c in chunks]
        write_tiff(path, px, bits=1, photometric=int(rng.randint(0, 2)),
                   compression=comp, chunks=chunks, tags=t4,
                   fill_order=order, **kw)
        _check(path, refuse=GARBLED)


def test_fax_against_pil_writer(tmp_path):
    """PIL's CCITT writers (modified Huffman, T.4 1-D, T.6) on random
    masks of several widths, through cv2 and PIL."""
    rng = np.random.RandomState(30)
    path = str(tmp_path / "p.tif")
    for t in range(8):
        H, W = rng.randint(1, 60), rng.randint(1, 300)
        px = rng.rand(H, W) > rng.rand()
        for comp in ("tiff_ccitt", "group3", "group4"):
            Image.fromarray(px).save(path, compression=comp)
            assert _check(path) == (True, True)


@pytest.mark.parametrize("kind", ["sub", "signed", "wide", "fill2"])
def test_sample_sizes_and_formats(tmp_path, kind):
    """2- and 4-bit gray (cv2: None; PIL: scaled), 1-, 2- and 4-bit
    palettes (cv2 reads 1 and 4, not 2), signed samples (cv2: unsigned
    under the 8-bit reads, the signed array under IMREAD_ANYDEPTH; PIL:
    L, I;16S, I;32S), 32-bit unsigned, 16- and 64-bit floats; fill order 2
    under each codec."""
    rng = np.random.RandomState(len(kind) * 7)
    path = str(tmp_path / "s.tif")
    for t in range(12):
        H, W = rng.randint(1, 40), rng.randint(1, 50)
        kw = _layout(rng, H, W)
        comp = int(rng.choice([1, 5, 8, 32773]))
        if kind == "sub":
            kw.pop("planar", None)
            b, ph = int(rng.choice([1, 2, 4])), int(rng.choice([0, 1, 3]))
            px = rng.randint(0, 1 << b, (H, W)).astype(np.uint8)
            cmap = rng.randint(0, 65536 if rng.rand() < 0.5 else 256,
                               (3, 1 << b)) if ph == 3 else None
            write_tiff(path, px, bits=b, photometric=ph, colormap=cmap,
                       compression=comp, **kw)
        else:
            if kind == "signed":
                dt = rng.choice([np.int8, np.int16, np.int32])
            elif kind == "wide":
                dt = rng.choice([np.uint32, np.float16, np.float64])
            else:
                dt = rng.choice([np.uint8, np.uint16, np.float32])
                kw["fill_order"] = 2
            dt = np.dtype(dt)
            spp = int(rng.choice([1, 1, 3]))
            if dt.kind == "f":
                px = (rng.randn(H, W, spp) * 300).astype(dt)
            else:
                info = np.iinfo(dt)
                px = rng.randint(int(info.min), int(info.max) + 1,
                                 (H, W, spp), dtype=np.int64).astype(dt)
            pred = 2 if comp in (5, 8) and dt.kind != "f" and \
                rng.rand() < 0.5 else 1
            write_tiff(path, px, photometric=1 if spp == 1 else 2,
                       compression=comp, predictor=pred, **kw)
        _check(path, refuse=GARBLED)


def test_lzma_and_zstd(tmp_path):
    """LZMA (34925): cv2's libtiff lacks the codec (None); PIL reads it,
    the port by the standard library's lzma, through predictor 2 too;
    Zstandard: None, and PIL's read is refused naming item 26e."""
    rng = np.random.RandomState(40)
    path = str(tmp_path / "z.tif")
    for mode in ("RGB", "L", "CMYK", "I;16", "F", "1", "P"):
        img = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
        im = Image.fromarray(img).convert(mode) if mode not in (
            "I;16", "F") else Image.fromarray(
                img[..., 0].astype(np.uint16) * 99 if mode == "I;16"
                else img[..., 0].astype(np.float32) / 3)
        im.save(path, compression="lzma")
        assert _check(path) == (False, True)
    px = rng.randint(0, 65536, (21, 19)).astype(np.uint16)
    write_tiff(path, px, photometric=1, compression=34925, predictor=2,
               rows_per_strip=5)
    np.testing.assert_array_equal(td.read_rgb_pil(path)[..., 0],
                                  np.minimum(px, 255))
    Image.fromarray(px[..., None].repeat(3, -1).astype(np.uint8)).save(
        path, compression="zstd")
    assert _check(path) == (False, None)
    assert lzma.decompress(lzma.compress(b"x")) == b"x"


def test_cut_and_corrupt(tmp_path):
    """JPEG, fax, YCbCr and CMYK files (directory first) cut and with
    bytes flipped in their data: None where cv2 fails, a refusal where
    libtiff's RGBA reader keeps a chunk it failed to decode, else cv2's
    and PIL's pixels."""
    rng = np.random.RandomState(50)
    path = str(tmp_path / "c.tif")
    H, W = 24, 40
    mask = (rng.rand(H, W) > 0.7)
    rgb = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    sources = []
    for comp in ("group3", "group4", "tiff_ccitt"):
        Image.fromarray(mask).save(path, compression=comp,
                                   tiffinfo={278: 8})
        sources.append(open(path, "rb").read())
    for mode in ("RGB", "YCbCr", "CMYK"):
        Image.fromarray(rgb).convert(mode).save(
            path, compression="jpeg" if mode != "CMYK" else "tiff_lzw",
            tiffinfo={278: 8})
        sources.append(open(path, "rb").read())
    outcomes = set()
    for data in sources:
        pg = tiff.read_page(data)
        lo, hi = min(pg.offsets), max(o + c for o, c in zip(pg.offsets,
                                                            pg.counts))
        for t in range(6):
            d = bytearray(data)
            if t < 3:
                i = rng.randint(lo, hi)
                d[i] ^= 1 << rng.randint(0, 8)
            else:
                # the strips cut short in place: the counts kept
                end = rng.randint(lo + 1, hi)
                d[end:hi] = bytes(hi - end)
            with open(path, "wb") as f:
                f.write(bytes(d))
            outcomes.add(_check(path))
    assert (True, True) in outcomes


@pytest.mark.parametrize("seed", range(2))
def test_jpeg_tables_cut_short(tmp_path, seed):
    """Fault N: a JPEGTables field cut inside a segment, or without its
    EOI. libtiff's tables source gives libjpeg fake EOIs past the field's
    end, so the cut segment reads on through FF D9 bytes and cv2 and PIL
    decode the strip with those quantisation or Huffman values, or fail
    with libjpeg; the port read the strip's own bytes there."""
    from tests.image_encoders import split_jpeg
    rng = np.random.RandomState(60 + seed)
    path = str(tmp_path / "t.tif")
    H, W = rng.randint(8, 40), rng.randint(8, 60)
    px = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    data = cv2.imencode(".jpg", px, [cv2.IMWRITE_JPEG_QUALITY, 60])[1]
    tables, strip, sof = split_jpeg(data.tobytes())
    hv = [sof[7] >> 4, sof[7] & 15]
    outcomes = set()
    cuts = list(rng.randint(2, len(tables) - 2, 12)) + [len(tables) - 2]
    for k in cuts:
        write_tiff(path, np.zeros((H, W, 3), np.uint8), photometric=6,
                   compression=7, chunks=[strip],
                   tags={347: (7, tables[:k]), 530: (3, hv)})
        outcomes.add(_check(path))
    assert (True, True) in outcomes and (False, False) in outcomes


@pytest.mark.parametrize("nf", [2, 5, 221])
def test_jpeg_chunk_of_other_components(tmp_path, nf):
    """A JPEG strip whose frame header names other than 1, 3 or 4
    components: libjpeg (past 10) or libtiff's JPEGPreDecode (another count
    than the strip's samples) fails it, so cv2 gives None and PIL raises."""
    with open(os.path.join(DATA, "tiff26c", "jpeg_ycc21.tif"), "rb") as f:
        data = bytearray(f.read())
    pg = tiff.read_page(bytes(data))
    sof = data.index(b"\xff\xc0", pg.offsets[0])
    assert sof < pg.offsets[0] + pg.counts[0]
    data[sof + 9] = nf
    path = str(tmp_path / "n.tif")
    with open(path, "wb") as f:
        f.write(bytes(data))
    assert _check(path, refuse=()) == (False, False)


# ---------------------------------------------------------------------------
# the host C++ fax decoder against its plain twin
# ---------------------------------------------------------------------------

def _fax_streams(rng):
    """(stream, rows, width, mode) of every mode: whole, cut, with bytes
    flipped, and random bytes."""
    out = []
    for mode in tiff_fax.MODES:
        for t in range(6):
            H, W = rng.randint(1, 30), rng.randint(1, 200)
            px = (rng.rand(H, W) > rng.rand()).astype(np.uint8)
            enc = fax_encode(px, mode, k=rng.randint(1, 4),
                             eol_fill=bool(t % 2))
            out.append((enc, H, W, mode))
            out.append((enc[:rng.randint(0, len(enc) + 1)], H, W, mode))
            bad = bytearray(enc)
            for _ in range(rng.randint(1, 4)):
                bad[rng.randint(0, len(bad))] ^= 1 << rng.randint(0, 8)
            out.append((bytes(bad), H, W, mode))
            out.append((rng.randint(0, 256, rng.randint(0, 40)).astype(
                np.uint8).tobytes(), H, W, mode))
    return out


def test_fax_cpp_equals_plain():
    """Every stream, whole, cut, corrupt or random: the C++ decoder and its
    plain twin return the same rows and bytes (-1 alike where libtiff
    fails the strip); whole streams decode to the pixels encoded."""
    rng = np.random.RandomState(60)
    whole = 0
    for src, H, W, mode in _fax_streams(rng):
        a = tiff_fax.decode(src, H, W, mode)
        b = tiff_fax.decode(src, H, W, mode, plain=True)
        assert a == b, (mode, H, W, len(src))
    for mode in (2, 3, 103, 4):
        px = (rng.rand(17, 45) > 0.5).astype(np.uint8)
        n, buf = tiff_fax.decode(fax_encode(px, mode), 17, 45, mode)
        got = np.unpackbits(np.frombuffer(buf, np.uint8).reshape(17, -1),
                            axis=1)[:, :45]
        assert n == 17
        np.testing.assert_array_equal(got, px)
        whole += 1
    assert whole == 4


def test_fax_tables_are_t4s():
    """The code tables: every run code prefix-free within its colour, the
    make-up codes where T.4 puts them, every main-table entry reached."""
    for codes in (tiff_fax.white_codes(), tiff_fax.black_codes()):
        strings = sorted(codes.values())
        assert len(set(strings)) == len(strings) == 64 + 27 + 13
        for x, y in zip(strings, strings[1:]):
            assert not y.startswith(x)
    tab = tiff_fax.tables()
    assert (tab[:128, 0] != tiff_fax.S_NULL).all()
    assert tab.shape == (128 + 4096 + 8192, 3)
