"""Write the progressive-JPEG and BMP fixtures of the port's readers with cv2
and PIL, and beside them what ``cv2.imread`` and PIL's
``Image.open(p).convert("RGB")`` decode from them: the card's machine has
neither, so chip_smoke.py phase (s) holds ``vido_slam_tpu_torch.io.jpeg``
and ``io.bmp`` to these committed digests.

  tests/data/progressive/layouts/<name>.jpg
        45 x 61 frames at quality 90: progressive 4:4:4, 4:2:2, 4:2:0,
        4:4:0, gray and 4:2:0 with a restart interval (cv2); a file of one
        sequential scan a component and a progressive script that never
        sends AC 6-63 (block smoothing at output), both re-encoded from a
        baseline file's coefficients (tests/image_encoders.py); a baseline
        file without its DHT segments; a progressive file cut at two
        thirds of its bytes;
  tests/data/progressive/layouts.npz
        digests (``digest``: shape and SHA-256) of cv2.imread of each with
        IMREAD_COLOR ("<name>") and IMREAD_GRAYSCALE ("<name>_gray"), and
        of PIL's RGB ("<name>_pil"; absent where PIL raises: the cut file);
  tests/data/progressive/kitti/<10 digits>.jpg
        the 24 KITTI frames of tests/data/jpeg/kitti as cv2 decodes them,
        written again progressive at their quality, 95;
  tests/data/progressive/kitti.npz
        the SHA-256 of cv2.imread of every frame ("sha256", in order);
  tests/data/bmp/<name>.bmp and tests/data/bmp.npz
        45 x 61 BMPs of each layout (tests/image_encoders.write_bmp): 1-,
        4- and 8-bit palettes, RLE4, RLE8, 16-bit 5-5-5 and 5-6-5, 24-bit,
        32-bit, a top-down 24-bit file; the digests of cv2's colour and gray
        reads and of PIL's RGB, as above;
  tests/data/<format>/<name>.<ext> and tests/data/<format>.npz, for the
  formats pxm, tiff, hdr, sunras and cmyk (slice 19) and jpeg24
  (arithmetic-coded, lossless and 12-bit JPEG), gif and webp (lossless)
  (slice 20), and pil29 (slice 21: TGA, PCX, SGI, QOI, XBM, IM, ICO and
  MSP, which cv2 gives None for; ``pil29_files``), tiff26c (slice 22)
  and webp26d, webp26d_kitti and webp26d_clip (slice 23: lossy WebP;
  ``webp26d_files``, and the KITTI and bench-clip frames chip_smoke.py
  phase (x) reads) (``FORMATS``)
        45 x 61 files of each layout those readers take: PBM, PGM and PPM
        in ASCII and binary at 8 and 16 bits and an odd maxval, PAM (gray,
        RGB, 16-bit RGB, black-and-white), PFM (gray and colour); TIFF
        (strips, tiles, planar 2, BigTIFF, both byte orders, no
        compression, LZW of both bit orders, Deflate, PackBits, both
        predictors; 1-, 8- and 16-bit gray, float, RGB, RGBA, a palette);
        Radiance HDR run-length and flat; Sun raster of depths 1, 8, 24
        and 32, a colour map, byte encoding, type 3; CMYK, YCCK and
        Adobe-RGB JPEGs; the digests ("digest", or "None" where cv2 gives
        None) of cv2.imread with IMREAD_COLOR ("<name>"), IMREAD_GRAYSCALE
        ("<name>_gray") and IMREAD_ANYDEPTH ("<name>_any"), and of PIL's
        RGB ("<name>_pil"; absent where PIL raises).

Run from the repository root: ``python tools/make_image_fixtures.py``.
"""

from __future__ import annotations

import hashlib
import os
import struct
import sys

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests.image_encoders import (Scan, dib, drop_segments,  # noqa: E402
                                  encode_coefficients, gif_frame, gif_lzw,
                                  reencode_jpeg, write_bmp, write_gif,
                                  write_hdr, write_ico, write_im,
                                  write_lossless_jpeg, write_msp2, write_pcx,
                                  write_sgi, write_sunras, write_tga,
                                  write_tiff, write_vp8, write_vp8l,
                                  alph_chunk, anmf_chunk, vp8x_chunk,
                                  webp_chunk, webp_file)
from vido_slam_tpu_torch.io import jpeg  # noqa: E402
from tools.make_jpeg_fixtures import textured  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data")
KITTI_IN = os.path.join(OUT, "jpeg", "kitti")
SIZE = (45, 61)

# name -> extra cv2.imwrite parameters of the progressive layouts
LAYOUTS = {
    "p444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111],
    "p422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111],
    "p420": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111],
    "p440": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x121111],
    "pgray": [],
    "prestart": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111,
                 cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
}


def _encode(img, params) -> bytes:
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def jpeg_files() -> dict:
    files = {}
    for i, (name, extra) in enumerate(LAYOUTS.items()):
        img = textured(*SIZE, 10 + i)
        if name == "pgray":
            img = img[..., 1]
        files[name] = _encode(img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                    cv2.IMWRITE_JPEG_PROGRESSIVE, 1] + extra)
    base = _encode(textured(*SIZE, 20), [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         0x221111])
    files["noninterleaved"] = reencode_jpeg(
        base, [Scan([0]), Scan([1]), Scan([2])], progressive=False)
    files["smoothed"] = reencode_jpeg(
        base, [Scan([0, 1, 2], 0, 0)] + [Scan([c], 1, 5) for c in range(3)],
        progressive=True)
    files["nodht"] = drop_segments(base, 0xC4)
    full = files["p420"]
    files["cut"] = full[:len(full) * 2 // 3]
    return files


def bmp_files(tmp: str) -> dict:
    rng = np.random.RandomState(30)
    H, W = SIZE
    bgr = textured(H, W, 31)
    out = {}

    def add(name, *args, **kw):
        path = os.path.join(tmp, name + ".bmp")
        write_bmp(path, *args, **kw)
        with open(path, "rb") as f:
            out[name] = f.read()
    for bits in (1, 4, 8):
        n = 1 << bits
        pal = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        add(f"pal{bits}", rng.randint(0, n, (H, W)).astype(np.uint8), bits,
            palette=pal)
        if bits > 1:
            runs = np.repeat(rng.randint(0, n, (H, W // 4 + 1)), 4,
                             1)[:, :W].astype(np.uint8)
            runs[:, ::7] = rng.randint(0, n, runs[:, ::7].shape)
            add(f"rle{bits}", runs, bits, palette=pal, rle=True)
    words = rng.randint(0, 65536, (H, W)).astype(np.uint16)
    add("rgb555", words, 16)
    add("rgb565", words, 16, fields=(0xF800, 0x7E0, 0x1F))
    add("bgr24", bgr, 24)
    add("bgra32", np.concatenate([bgr, rng.randint(0, 256, (H, W, 1))
                                  .astype(np.uint8)], -1), 32)
    add("topdown24", bgr[::-1], 24, top_down=True)
    return out


def digest(img) -> str:
    """An image's shape and the SHA-256 of its bytes, "h,w[,c]:<hex>"
    ("None" for no image)."""
    if img is None:
        return "None"
    return ",".join(map(str, img.shape)) + ":" + hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


def pxm_files() -> dict:
    """PBM, PGM, PPM, PAM and PFM files (name -> (extension, bytes))."""
    rng = np.random.RandomState(40)
    H, W = SIZE
    bgr = textured(H, W, 41)
    gray = bgr[..., 1]
    deep = (gray.astype(np.uint16) * 257 + rng.randint(0, 257, (H, W))
            ).astype(np.uint16)
    bits = (gray > 128).astype(np.uint8)
    out = {}

    def head(kind, maxval=None):
        return b"P%d\n# fixture\n%d %d\n" % (kind, W, H) + (
            b"%d\n" % maxval if maxval is not None else b"")
    ascii_rows = lambda a: b"\n".join(  # noqa: E731
        b" ".join(b"%d" % v for v in row) for row in a.reshape(H, -1)) + b"\n"
    out["p1_ascii"] = (".pbm", head(1) + ascii_rows(bits))
    out["p4"] = (".pbm", head(4) + np.packbits(bits, axis=1).tobytes())
    out["p2_ascii_max1000"] = (".pgm", head(2, 1000)
                               + ascii_rows(deep % 1100))
    out["p5_8"] = (".pgm", head(5, 255) + gray.tobytes())
    out["p5_16"] = (".pgm", head(5, 65535) + deep.astype(">u2").tobytes())
    out["p5_max4095"] = (".pgm", head(5, 4095)
                         + (deep >> 4).astype(">u2").tobytes())
    out["p5_max100"] = (".pgm", head(5, 100) + (gray % 101).tobytes())
    out["p3_ascii"] = (".ppm", head(3, 255) + ascii_rows(bgr[..., ::-1]))
    out["p6_8"] = (".ppm", head(6, 255) + bgr[..., ::-1].tobytes())
    rgb16 = bgr[..., ::-1].astype(np.uint16) * 257
    out["p6_16"] = (".ppm", head(6, 65535) + rgb16.astype(">u2").tobytes())
    pam = (("pam_grayscale", gray, cv2.IMWRITE_PAM_FORMAT_GRAYSCALE),
           ("pam_rgb", bgr, cv2.IMWRITE_PAM_FORMAT_RGB),
           ("pam_rgb16", bgr.astype(np.uint16) * 257,
            cv2.IMWRITE_PAM_FORMAT_RGB),
           ("pam_bw", bits, cv2.IMWRITE_PAM_FORMAT_BLACKANDWHITE))
    for name, img, kind in pam:
        ok, enc = cv2.imencode(".pam", img, [cv2.IMWRITE_PAM_TUPLETYPE, kind])
        assert ok
        out[name] = (".pam", enc.tobytes())
    f = (bgr.astype(np.float32) - 100) / 37
    for name, img in (("pf_mono", f[..., 0]), ("pf_rgb", f)):
        ok, enc = cv2.imencode(".pfm", img)
        assert ok
        out[name] = (".pfm", enc.tobytes())
    return out


def tiff_files(tmp: str) -> dict:
    """TIFF layouts (tests/image_encoders.write_tiff)."""
    rng = np.random.RandomState(50)
    H, W = SIZE
    bgr = textured(H, W, 51)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    deep = (bgr[..., 1].astype(np.uint16) * 257 + rng.randint(0, 257, (H, W))
            ).astype(np.uint16)
    depth = (deep.astype(np.float32) / 1000).astype(np.float32)
    alpha = rng.randint(0, 256, (H, W, 1)).astype(np.uint8)
    cmap = rng.randint(0, 65536, (3, 256)).astype(np.uint16)
    layouts = {
        "g8_lzw": (bgr[..., 1], dict(photometric=1, compression=5)),
        "g8_white_packbits": (bgr[..., 1], dict(photometric=0,
                                                compression=32773)),
        "g1": (bgr[..., 1] > 128, dict(photometric=1, bits=1)),
        "g16_deflate_pred2": (deep, dict(photometric=1, compression=8,
                                         predictor=2, rows_per_strip=8)),
        "g16_be_lzw": (deep, dict(photometric=1, compression=5,
                                  big_endian=True)),
        "g16_bigtiff": (deep, dict(photometric=1, compression=32946,
                                   bigtiff=True)),
        "f32_pred3": (depth, dict(photometric=1, compression=8, predictor=3)),
        "f32_be_tiles": (depth, dict(photometric=1, big_endian=True,
                                     tile=(32, 16))),
        "rgb8_lzw_old": (rgb, dict(photometric=2, compression=5,
                                   old_lzw=True, rows_per_strip=10)),
        "rgb8_planar2": (rgb, dict(photometric=2, planar=2,
                                   compression=32773)),
        "rgb8_tiles": (rgb, dict(photometric=2, compression=8,
                                 tile=(16, 32))),
        "rgb16_lzw_pred2": (rgb.astype(np.uint16) * 257 + 3,
                            dict(photometric=2, compression=5, predictor=2)),
        "rgba8_unassoc": (np.concatenate([rgb, alpha], -1),
                          dict(photometric=2, extra=(2,))),
        "pal8": (bgr[..., 2], dict(photometric=3, colormap=cmap,
                                   compression=5)),
        "g8_flipped": (bgr[..., 0], dict(photometric=1, orientation=3)),
    }
    out = {}
    for name, (px, kw) in layouts.items():
        path = os.path.join(tmp, name + ".tif")
        write_tiff(path, np.asarray(px).astype(
            np.uint8 if px.dtype == bool else px.dtype), **kw)
        with open(path, "rb") as f:
            out[name] = (".tif", f.read())
    return out


def _tiff_bytes(tmp: str, name: str, px: np.ndarray, **kw) -> tuple:
    path = os.path.join(tmp, name + ".tif")
    write_tiff(path, px, **kw)
    with open(path, "rb") as f:
        return ".tif", f.read()


def _pil_tiff(im, **kw) -> tuple:
    import io

    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return ".tif", buf.getvalue()


def tiff26c_files(tmp: str) -> dict:
    """The TIFF modes of ROADMAP.md item 26c, part 1: JPEG-in-TIFF (YCbCr
    at 1x1, 2x1 and 2x2 in strips and tiles, RGB, gray, CMYK), subsampled
    YCbCr without JPEG, CMYK of 8 and 16 bits, CCITT (modified Huffman
    runs, T.4 1-D with and without fill bits, T.4 2-D, T.6, word-aligned
    runs), fill order 2 under each codec, 2- and 4-bit gray, 1-, 2- and
    4-bit palettes, signed and 32-bit integers, 16- and 64-bit floats and
    LZMA (tests/image_encoders.py's writers, and PIL's)."""
    import zlib

    from tests.image_encoders import (fax_encode, jpeg_tiff_chunks,
                                      lzw_encode, packbits, ycbcr_chunks)

    rng = np.random.RandomState(270)
    H, W = SIZE
    bgr = textured(H, W, 271)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    gray = bgr[..., 1]
    ink = np.dstack([textured(H, W, 272), textured(H, W, 273)[..., :1]])
    mask = (gray > 128).astype(np.uint8)
    out = {}

    def tif(name, px, **kw):
        out[name] = _tiff_bytes(tmp, name, px, **kw)

    # JPEG-in-TIFF: YCbCr at three subsamplings, strips, tiles, big-endian
    for name, sub, hv, kw in (
            ("jpeg_ycc11", 0, (1, 1), dict(rows_per_strip=16)),
            ("jpeg_ycc21", 1, (2, 1), dict(rows_per_strip=8)),
            ("jpeg_ycc22", 2, (2, 2), {}),
            ("jpeg_ycc22_tiles", 2, (2, 2), dict(tile=(32, 16))),
            ("jpeg_ycc22_be", 2, (2, 2), dict(rows_per_strip=32,
                                              big_endian=True))):
        tables, chunks = jpeg_tiff_chunks(
            rgb, subsampling=sub, quality=85,
            rows_per_strip=kw.get("rows_per_strip"), tile=kw.get("tile"))
        tif(name, rgb, photometric=6, compression=7, chunks=chunks,
            tags={347: (7, tables), 530: (3, list(hv))}, **kw)
    tables, chunks = jpeg_tiff_chunks(gray, quality=90, rows_per_strip=16)
    tif("jpeg_gray", gray, photometric=1, compression=7, chunks=chunks,
        rows_per_strip=16, tags={347: (7, tables)})
    out["jpeg_rgb_pil"] = _pil_tiff(Image.fromarray(rgb), compression="jpeg",
                                    quality=80)
    out["jpeg_cmyk_pil"] = _pil_tiff(Image.fromarray(ink, "CMYK"),
                                     compression="jpeg", quality=80)
    # YCbCr data units without JPEG
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    for name, hv, comp, kw in (("ycc22_lzw", (2, 2), 5, {}),
                               ("ycc21_deflate", (2, 1), 8,
                                dict(rows_per_strip=10)),
                               ("ycc42_tiles_packbits", (4, 2), 32773,
                                dict(tile=(32, 32))),
                               ("ycc22_raw", (2, 2), 1,
                                dict(rows_per_strip=6))):
        chunks = ycbcr_chunks(ycc, hv, **kw)
        enc = {5: lzw_encode, 8: zlib.compress, 32773: packbits,
               1: bytes}[comp]
        tif(name, ycc, photometric=6, compression=comp,
            chunks=[enc(c) for c in chunks], tags={530: (3, list(hv))},
            **kw)
    chunks = ycbcr_chunks(ycc, (2, 2))
    tif("ycc22_lzw_refbw", ycc, photometric=6, compression=5,
        chunks=[lzw_encode(c) for c in chunks],
        tags={530: (3, [2, 2]), 529: (5, [(2990, 10000), (5870, 10000),
                                          (1140, 10000)]),
              532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                        (240, 1)])})
    # CMYK
    tif("cmyk8_lzw", ink, photometric=5, compression=5)
    tif("cmyk8_tiles", ink, photometric=5, tile=(16, 32))
    tif("cmyk16_deflate", ink.astype(np.uint16) * 257 + 5, photometric=5,
        compression=8, predictor=2)
    tif("cmyk8_extra", np.dstack([ink, gray]), photometric=5, extra=(0,),
        compression=32773)
    tif("cmyk8_inkset2", ink, photometric=5, tags={332: (3, [2])})
    # CCITT fax
    for name, mode, comp, t4, kw in (
            ("fax_rle", 2, 2, None, dict(rows_per_strip=16)),
            ("fax_g3_1d_eolfill", 3, 3, 4, {}),
            ("fax_g3_2d", 103, 3, 1, dict(rows_per_strip=20)),
            ("fax_g3_2d_eolfill", 103, 3, 5, {}),
            ("fax_g4", 4, 4, None, dict(rows_per_strip=30)),
            ("fax_g4_white", 4, 4, None, dict(photometric=0))):
        rps = kw.get("rows_per_strip", H)
        chunks = [fax_encode(mask[y:y + rps], mode, k=3,
                             eol_fill=bool(t4 and t4 & 4))
                  for y in range(0, H, rps)]
        tif(name, mask, bits=1, compression=comp, chunks=chunks,
            photometric=kw.get("photometric", 1), rows_per_strip=rps,
            tags={} if t4 is None else {292: (4, [t4])})
    # word-aligned runs: rows of one run each, which libtiff's alignment
    # keeps in step
    bars = np.zeros((H, W), np.uint8)
    bars[:, :17] = 1
    tif("fax_rlew", bars, bits=1, compression=32771, photometric=1,
        chunks=[fax_encode(bars, 32771)])
    out["fax_g3_pil"] = _pil_tiff(Image.fromarray(mask.astype(bool)),
                                  compression="group3")
    # fill order 2
    tif("fill2_g1", mask, bits=1, photometric=1, fill_order=2)
    tif("fill2_g8_lzw", gray, photometric=1, compression=5, fill_order=2)
    tif("fill2_rgb_packbits", rgb, photometric=2, compression=32773,
        fill_order=2)
    tif("fill2_g8_deflate", gray, photometric=0, compression=8,
        fill_order=2)
    tif("fill2_g4", mask, bits=1, compression=4, photometric=0,
        fill_order=2, chunks=[bytes(int(f"{b:08b}"[::-1], 2)
                                    for b in fax_encode(mask, 4))])
    # other sample sizes and formats
    for b in (2, 4):
        v = (gray >> (8 - b)).astype(np.uint8)
        tif(f"g{b}", v, bits=b, photometric=1, compression=5)
        tif(f"g{b}_white", v, bits=b, photometric=0)
    for b in (1, 2, 4):
        v = (gray >> (8 - b)).astype(np.uint8)
        cmap = rng.randint(0, 65536, (3, 1 << b))
        tif(f"pal{b}", v, bits=b, photometric=3, colormap=cmap)
        tif(f"pal{b}_8bitmap", v, bits=b, photometric=3,
            colormap=cmap >> 8, compression=32773)
    tif("i8", (gray.astype(np.int16) - 128).astype(np.int8), photometric=1)
    tif("i8_rgb_be", (rgb.astype(np.int16) - 128).astype(np.int8),
        photometric=2, big_endian=True, compression=5)
    deep = (gray.astype(np.int32) * 257 - 32768).astype(np.int16)
    tif("i16", deep, photometric=1, compression=8, predictor=2)
    tif("i16_be_lzw", deep, photometric=1, compression=5, big_endian=True)
    tif("i16_rgb", (rgb.astype(np.int32) * 200 - 20000).astype(np.int16),
        photometric=2)
    tif("i32", (gray.astype(np.int64) * 16777259 - 2 ** 31).astype(
        np.int32), photometric=1)
    tif("i32_be_deflate", (gray.astype(np.int32) - 100) * 3,
        photometric=1, big_endian=True, compression=8)
    tif("u32", gray.astype(np.uint32) * 16843009, photometric=1,
        compression=32773)
    tif("f16", (gray / 7).astype(np.float16), photometric=1)
    tif("f64", (gray / 7.0 - 3).astype(np.float64), photometric=1,
        compression=8)
    # LZMA (cv2's libtiff is built without it: None; PIL reads it)
    tif("lzma_rgb", rgb, photometric=2, compression=34925)
    tif("lzma_g16_pred2", gray.astype(np.uint16) * 250, photometric=1,
        compression=34925, predictor=2, rows_per_strip=12)
    out["lzma_cmyk_pil"] = _pil_tiff(Image.fromarray(ink, "CMYK"),
                                     compression="lzma")
    return out


def hdr_files(tmp: str) -> dict:
    rng = np.random.RandomState(60)
    H, W = SIZE
    rgbe = rng.randint(0, 256, (H, W, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.randint(120, 140, (H, W))
    rgbe[:, ::3] = rgbe[:, :1]
    out = {}
    f = textured(H, W, 61).astype(np.float32) / 97
    ok, enc = cv2.imencode(".hdr", f)
    assert ok
    out["cv2_rle"] = (".hdr", enc.tobytes())
    for name, rle in (("rle", True), ("flat", False)):
        path = os.path.join(tmp, name + ".hdr")
        write_hdr(path, rgbe, rle=rle, header=b"#?RADIANCE\nEXPOSURE=1.0\n")
        with open(path, "rb") as fh:
            out[name] = (".hdr", fh.read())
    return out


def sunras_files(tmp: str) -> dict:
    rng = np.random.RandomState(70)
    H, W = SIZE
    bgr = textured(H, W, 71)
    idx = bgr[..., 1]
    pal = rng.randint(0, 256, (200, 3)).astype(np.uint8)
    layouts = {
        "d8_map": (idx, 8, dict(palette=pal)),
        "d8_nomap": (idx, 8, {}),
        "d1": (idx > 128, 1, {}),
        "d24": (bgr, 24, {}),
        "d24_rgb": (bgr[..., ::-1], 24, dict(rgb=True)),
        "d32": (np.concatenate([bgr[..., :1], bgr], -1), 32, {}),
        "d8_rle": (np.repeat(idx[:, ::4], 4, 1)[:, :W], 8,
                   dict(palette=pal, rle=True)),
    }
    out = {}
    for name, (px, depth, kw) in layouts.items():
        path = os.path.join(tmp, name + ".ras")
        write_sunras(path, np.asarray(px).astype(np.uint8), depth, **kw)
        with open(path, "rb") as f:
            out[name] = (".ras", f.read())
    return out


def cmyk_files() -> dict:
    import io
    import struct

    H, W = SIZE
    ink = np.dstack([textured(H, W, 80), textured(H, W, 81)[..., :1]])
    out = {}
    for name, kw in (("cmyk", {}), ("cmyk_420_progressive",
                                    dict(subsampling=2, progressive=True))):
        buf = io.BytesIO()
        Image.fromarray(ink, "CMYK").save(buf, "JPEG", quality=90, **kw)
        out[name] = (".jpg", buf.getvalue())
    data = bytearray(out["cmyk"][1])
    data[data.find(b"\xff\xee") + 15] = 2
    out["ycck"] = (".jpg", bytes(data))
    app14 = data.find(b"\xff\xee")
    out["cmyk_no_adobe"] = (".jpg", bytes(data[:app14] + data[app14 + 16:]))
    base = _encode(textured(H, W, 82), [cv2.IMWRITE_JPEG_QUALITY, 90])
    app0 = base.find(b"\xff\xe0")
    n = struct.unpack(">H", base[app0 + 2:app0 + 4])[0]
    body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
    out["adobe_rgb"] = (".jpg", base[:2] + b"\xff\xee" + struct.pack(
        ">H", len(body) + 2) + body + base[app0 + 2 + n:])
    return out


def jpeg24_files() -> dict:
    """Arithmetic-coded JPEGs re-coded from cv2's baseline files (sequential
    with DAC conditioning and restarts, progressive with successive
    approximation, gray, cut), lossless JPEGs (gray at 8 and 5 bits, RGB
    with restarts, 4:2:0 RGB, CMYK, a JFIF one libjpeg cannot convert, a
    12-bit one cv2 cannot read) and a 12-bit lossy and an arithmetic
    lossless (SOF11) file, which cv2 and PIL fail on."""
    H, W = SIZE
    rng = np.random.RandomState(90)
    out = {}
    base = {k: _encode(textured(H, W, 91 + i), [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, f])
        for i, (k, f) in enumerate((("420", 0x221111), ("444", 0x111111),
                                    ("422", 0x211111)))}
    out["arith_seq_420"] = reencode_jpeg(base["420"], [Scan([0, 1, 2])],
                                         progressive=False, arithmetic=True)
    out["arith_seq_dac_rst"] = reencode_jpeg(
        base["444"], [Scan([0, 1, 2])], progressive=False, arithmetic=True,
        restart=3, dac={0: 0x52, 1: 0x31, 16: 2, 17: 30})
    out["arith_prog_sa"] = reencode_jpeg(
        base["422"], [Scan([0, 1, 2], 0, 0, 1), Scan([0], 1, 5, 2),
                      Scan([1], 1, 63, 1), Scan([2], 1, 63, 1),
                      Scan([0], 6, 63, 2), Scan([0, 1, 2], 0, 0, 0, ah=1),
                      Scan([0], 1, 63, 1, ah=2), Scan([0], 1, 63, 0, ah=1),
                      Scan([1], 1, 63, 0, ah=1), Scan([2], 1, 63, 0, ah=1)],
        progressive=True, arithmetic=True, restart=5)
    gray = _encode(textured(H, W, 94)[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 85])
    out["arith_gray"] = reencode_jpeg(gray, [Scan([0])], progressive=False,
                                      arithmetic=True)
    prog = reencode_jpeg(base["420"], [Scan([0, 1, 2], 0, 0, 0)] + [
        Scan([c], 1, 63, 0) for c in range(3)], progressive=True,
        arithmetic=True)
    out["arith_prog_cut"] = prog[:len(prog) * 2 // 3]
    g = textured(H, W, 95)[..., 1].astype(np.int64)
    out["lossless_gray8_p1"] = write_lossless_jpeg([g], precision=8,
                                                   predictor=1)
    out["lossless_gray5_p7_pt1"] = write_lossless_jpeg(
        [g >> 3], precision=5, predictor=7, pt=1)
    rgb = textured(H, W, 96)[..., ::-1].astype(np.int64)
    planes = [rgb[..., c] for c in range(3)]
    out["lossless_rgb_p4_rst"] = write_lossless_jpeg(
        planes, precision=8, predictor=4, restart_rows=5)
    sub = [planes[0], planes[1][::2, ::2], planes[2][::2, ::2]]
    out["lossless_rgb_420_p6"] = write_lossless_jpeg(
        sub, precision=8, predictor=6, sampling=[(2, 2), (1, 1), (1, 1)],
        size=(H, W))
    out["lossless_cmyk_p5"] = write_lossless_jpeg(
        planes + [g], precision=8, predictor=5)
    out["lossless_jfif"] = write_lossless_jpeg(
        planes, precision=8, predictor=1,
        head=b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
             b"\x00\x00")
    out["lossless_gray12"] = write_lossless_jpeg(
        [rng.randint(0, 4096, (H, W))], precision=12, predictor=2)
    co = jpeg.read_coefficients(base["444"])
    out["lossy_12bit"] = encode_coefficients(
        co._replace(frame=co.frame._replace(precision=12),
                    quant=[q * 16 for q in co.quant]), [Scan([0, 1, 2])],
        progressive=False)
    sof11 = bytearray(out["lossless_gray8_p1"])
    sof11[sof11.find(b"\xff\xc3") + 1] = 0xCB
    out["sof11"] = bytes(sof11)
    return {k: (".jpg", v) for k, v in out.items()}


def gif_files() -> dict:
    """GIFs of PIL's and cv2's writers, and hand-built ones (a local table
    and interlaced rows, a frame smaller than its screen over a background
    with a transparent index, a full table kept without a clear, no colour
    table at all, an animation, a cut file)."""
    import io

    H, W = SIZE
    rng = np.random.RandomState(100)
    img = textured(H, W, 101)
    out = {}
    buf = io.BytesIO()
    Image.fromarray(img[..., ::-1]).save(buf, "GIF")
    out["pil_rgb"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(img[..., 1]).save(buf, "GIF", interlace=True)
    out["pil_gray_interlaced"] = buf.getvalue()
    ok, enc = cv2.imencode(".gif", img)
    assert ok
    out["cv2_writer"] = enc.tobytes()
    pal = rng.randint(0, 256, (32, 3))
    idx = rng.randint(0, 32, (H, W)).astype(np.uint8)
    out["local_interlaced"] = write_gif((W, H), [gif_frame(
        idx, palette=pal, interlace=True)], palette=pal[::-1].copy())
    small = rng.randint(0, 16, (H - 10, W - 13)).astype(np.uint8)
    out["offset_transparent"] = write_gif((W, H), [gif_frame(
        small, offset=(6, 4), transparency=3, disposal=2)],
        palette=rng.randint(0, 256, (16, 3)), background=9)
    noise = rng.randint(0, 256, (H, W)).astype(np.uint8)
    out["deferred_clear"] = write_gif((W, H), [gif_frame(
        noise, min_code_size=8, clear_when_full=False)],
        palette=rng.randint(0, 256, (256, 3)))
    out["no_table"] = write_gif((W, H), [gif_frame(noise // 16)])
    out["animated"] = write_gif((W, H), [gif_frame(idx), gif_frame(
        idx[::-1].copy())], palette=pal)
    full = out["local_interlaced"]
    out["cut"] = full[:len(full) * 2 // 3]
    return {k: (".gif", v) for k, v in out.items()}


def webp_files() -> dict:
    """Lossless WebPs of cv2's and PIL's writers (with alpha, a palette,
    the fastest method, an animation's first frame) and hand-built ones
    (``write_vp8l``: every predictor mode, cross-colour with
    subtract-green, the colour cache and LZ77, bundled palettes of 2, 4
    and 16 colours, meta prefix codes)."""
    import io

    H, W = SIZE
    rng = np.random.RandomState(110)
    img = textured(H, W, 111)
    out = {}
    out["cv2_lossless"] = cv2.imencode(".webp", img, [
        cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes()
    rgba = np.dstack([img[..., ::-1], rng.randint(0, 256, (H, W, 1))
                      .astype(np.uint8)])
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, "WEBP", lossless=True, exact=True)
    out["pil_alpha"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray((img[..., ::-1] // 64 * 85).astype(np.uint8)).save(
        buf, "WEBP", lossless=True, method=6)
    out["pil_palette"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", lossless=True, method=0,
                              quality=0)
    out["pil_method0"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", lossless=True, save_all=True,
                              append_images=[Image.fromarray(img[::-1]
                                                             .copy())])
    out["pil_animated"] = buf.getvalue()
    b, g, r = (img[..., c].astype(np.uint32) for c in range(3))
    argb = np.uint32(0xFF000000) | r << 16 | g << 8 | b
    th, tw = (H + 3) // 4, (W + 3) // 4
    out["predictor_modes"] = write_vp8l(argb, predictor=(2, np.arange(
        th * tw).reshape(th, tw) % 16))
    out["cross_color_cache_lz77"] = write_vp8l(
        argb, cross_color=(3, rng.randint(0, 256, ((H + 7) // 8,
                                                   (W + 7) // 8, 3))),
        subtract_green=True, cache_bits=6, lz77=True, simple=False)
    for n in (2, 4, 16):
        colors = (rng.randint(0, 1 << 24, n).astype(np.uint32)
                  | np.uint32(0xFF000000))
        out[f"palette{n}"] = write_vp8l(colors[rng.randint(0, n, (H, W))],
                                        palette=colors)
    out["meta_codes"] = write_vp8l(argb, groups=rng.randint(
        0, 5, th * tw), group_bits=2, predictor=(2, rng.randint(
            0, 14, (th, tw))))
    return {k: (".webp", v) for k, v in out.items()}


def webp26d_files() -> dict:
    """Lossy WebPs (item 26d): cv2's and PIL's writers at several qualities
    and methods, with alpha (raw, VP8L-compressed, level-reduced), an
    animation's first frame, and hand-built ones: ALPH chunks of each
    filter, raw and VP8L (a palette: libwebp's 8-bit path), a lossy frame
    at an offset on an animation's canvas, VP8 key frames of random syntax
    (``write_vp8``: segments with and without a map, absolute and delta
    values, the simple and normal filters, sharpness, levels 0 and 63,
    filter deltas, 2, 4 and 8 token partitions, quantisers 0 and 127 with
    deltas, category-6 coefficients, skip flags, every intra mode), images
    of one pixel, row and column, and files both libraries fail on (a cut
    token partition, a bad ALPH header)."""
    import io

    H, W = SIZE
    rng = np.random.RandomState(260)
    img = textured(H, W, 261)
    rgb = np.ascontiguousarray(img[..., ::-1])
    yy, xx = np.mgrid[:H, :W]
    smooth = ((xx * 4 + yy * 3) % 256).astype(np.uint8)
    noisy = rng.randint(0, 256, (H, W)).astype(np.uint8)
    out = {}

    def pil(name, im, **kw):
        buf = io.BytesIO()
        im.save(buf, "WEBP", **kw)
        out[name] = buf.getvalue()
    pil("pil_q80", Image.fromarray(rgb), quality=80)
    pil("pil_q5_m6", Image.fromarray(rgb), quality=5, method=6)
    pil("pil_q100_m0", Image.fromarray(rgb), quality=100, method=0)
    out["cv2_q50"] = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY,
                                                 50])[1].tobytes()
    pil("pil_alpha_raw", Image.fromarray(np.dstack([rgb, noisy])),
        quality=80)
    pil("pil_alpha_vp8l", Image.fromarray(np.dstack([rgb, smooth])),
        quality=80)
    pil("pil_alpha_q30", Image.fromarray(np.dstack([rgb, smooth])),
        quality=60, alpha_quality=30)
    frames = [Image.fromarray(np.dstack([rgb, smooth])),
              Image.fromarray(np.dstack([rgb[::-1], noisy]))]
    pil("pil_animated", frames[0], save_all=True, append_images=frames[1:],
        quality=70)
    payload = out["pil_q80"][20:]
    vp8 = webp_chunk(b"VP8 ", payload[:struct.unpack(
        "<I", out["pil_q80"][16:20])[0]])
    for kind in (1, 2, 3):
        out[f"alph_raw_f{kind}"] = webp_file([
            vp8x_chunk(W, H, 0x10), alph_chunk(noisy, 0, kind), vp8])
        out[f"alph_vp8l_f{kind}"] = webp_file([
            vp8x_chunk(W, H, 0x10), alph_chunk(smooth, 1, kind, kind & 1),
            vp8])
    levels = (smooth // 64 * 85).astype(np.uint8)
    out["alph_palette"] = webp_file([vp8x_chunk(W, H, 0x10), alph_chunk(
        levels, 1, palette=[0xFF000000 | v << 8 for v in (0, 85, 170, 255)]),
        vp8])
    anim = webp_chunk(b"ANIM", bytes(6))
    out["anim_offset"] = webp_file([
        vp8x_chunk(W + 6, H + 4, 0x12), anim,
        anmf_chunk(alph_chunk(smooth, 1, 3) + vp8, 4, 2, W, H),
        anmf_chunk(vp8, 0, 0, W, H)])

    def frame(name, w=W, h=H, **kw):
        out[name] = webp_file([webp_chunk(b"VP8 ", write_vp8(
            np.random.RandomState(len(out)), w, h, **kw))])
    segs = [(10, 20), (60, -10), (-5, 40), (127, 63)]
    frame("syntax_segments_abs", segments=segs, update_map=True,
          absolute=True, filter_type=1, level=30, partitions=0)
    frame("syntax_segments_delta", segments=segs, update_map=False,
          absolute=False, filter_type=1, level=20, lf_deltas=[3, 0, 0, 0,
                                                             -9, 0, 0, 0])
    frame("syntax_simple_sharp7", filter_type=0, level=63, sharpness=7,
          lf_deltas=[-4, 1, 2, 3, 12, 1, 2, 3], segments=None)
    frame("syntax_level0", level=0, segments=segs, absolute=False,
          sharpness=3)
    for k in (1, 2, 3):
        frame(f"syntax_parts{1 << k}", partitions=k, filter_type=1,
              level=int(rng.randint(1, 64)), sharpness=k)
    frame("syntax_q0_skip", q=0, dq=[-15, 15, None, 7, -7], skip_p=100)
    frame("syntax_q127_cat6", q=127, dq=[15, 15, 15, 15, 15], cat6=0.3,
          scale=40.0)
    frame("syntax_i16", i4x4=0.0, skip_p=None, updates=0.3)
    frame("syntax_i4", i4x4=1.0, run_out=0.3, updates=0.5)
    frame("syntax_1x1", 1, 1)
    frame("syntax_17x1", 17, 1)
    frame("syntax_1x23", 1, 23)
    frame("syntax_scale_bits", scale_bits=3)
    cut = write_vp8(np.random.RandomState(7), W, H, partitions=0)
    out["fail_cut_partition"] = webp_file([webp_chunk(b"VP8 ",
                                                      cut[:-40])])
    out["fail_alph_header"] = webp_file([
        vp8x_chunk(W, H, 0x10), webp_chunk(b"ALPH", b"\x03" + noisy.tobytes()),
        vp8])
    return {k: (".webp", v) for k, v in out.items()}


def webp26d_kitti_files() -> dict:
    """The first 12 KITTI frames of tests/data/jpeg/kitti as cv2 decodes
    them, written again as lossy WebP by PIL at quality 80: the CLI's
    frames of chip_smoke.py phase (x3)."""
    import io

    out = {}
    for name in sorted(os.listdir(KITTI_IN))[:12]:
        bgr = cv2.imread(os.path.join(KITTI_IN, name), cv2.IMREAD_COLOR)
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).save(
            buf, "WEBP", quality=80)
        out[os.path.splitext(name)[0]] = (".webp", buf.getvalue())
    return out


def webp26d_clip_files() -> dict:
    """Bench-clip frames 0, 2, 4, 6 and 8 (assets/bench_clip_192x640_24.npz)
    as lossy WebPs for chip_smoke.py phase (x3)'s COCO tree: PIL at
    quality 80, with two VP8L-compressed alphas (halves, a gradient), an
    animation (its first frame the clip frame), and cv2 at quality 60."""
    import io

    clip = np.load(os.path.join(ROOT, "assets",
                                "bench_clip_192x640_24.npz"))["clip"]
    H, W = clip.shape[1:3]
    yy, xx = np.mgrid[:H, :W]
    alpha = ((xx + 2 * yy) % 256).astype(np.uint8)
    out = {}
    for k in range(5):
        rgb = clip[2 * k]
        buf = io.BytesIO()
        if k == 0:
            Image.fromarray(rgb).save(buf, "WEBP", quality=80)
        elif k in (1, 2):
            a = alpha if k == 2 else np.where(xx < W // 2, 255, 128
                                              ).astype(np.uint8)
            Image.fromarray(np.dstack([rgb, a])).save(buf, "WEBP",
                                                      quality=80)
        elif k == 3:
            Image.fromarray(rgb).save(buf, "WEBP", quality=80, save_all=True,
                                      append_images=[Image.fromarray(
                                          clip[2 * k + 1])])
        else:
            buf.write(cv2.imencode(".webp", np.ascontiguousarray(
                rgb[..., ::-1]), [cv2.IMWRITE_WEBP_QUALITY, 60])[1])
        out[f"frame{k}"] = (".webp", buf.getvalue())
    return out


def pil29_files() -> dict:
    """Files of the formats PIL opens and cv2 does not (ROADMAP.md queue 1
    item 29): PIL's own TGA, PCX, SGI, QOI, XBM, IM, ICO and MSP of each mode
    its writers take, and hand-built layouts they do not make
    (tests/image_encoders.py): run-length and colour-mapped Targa at 8, 16, 24
    and 32 bits, bottom-up and mirrored, literals across rows, a gray file read
    through its map, a 32-bit map and a 1-bit run-length file (both fail in
    PIL); PCX of 2 and 4 one-bit planes, padded rows, an origin off 0, a
    gray-ramp palette, no palette marker, versions 0-3; SGI run-length coded at
    1 and 2 bytes a channel, rows sharing bytes, 16-bit verbatim; QOI ops PIL's
    writer never emits (an index never written, a run past the end, channels
    0); XBM with a hotspot, upper case digits and stray characters, and with
    ``0X`` (PIL's decoder looks for a lower-case x only, and fails); IM 16-bit
    big-endian, interleaved RGB, a non-linear gray LUT, an RGB LUT; icons of
    several BMP (1, 4, 8, 24, 32 bits) and PNG entries with a directory that
    misstates sizes, and a cut AND mask (PIL fails); MSP version 2 with runs
    and blank rows, and cut."""
    import io

    H, W = SIZE
    rng = np.random.RandomState(120)
    img = textured(H, W, 121)                     # BGR
    rgb = np.ascontiguousarray(img[..., ::-1])
    gray = img[..., 1]
    out = {}

    def pil(name, im, fmt, ext, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        out[name] = (ext, buf.getvalue())

    base = Image.fromarray(rgb)
    alpha = rng.randint(0, 256, (H, W, 1)).astype(np.uint8)
    rgba = Image.fromarray(np.dstack([rgb, alpha]))
    pal_img = base.quantize(64)
    bw = Image.fromarray(gray > 128)
    # Targa
    for mode, im in (("rgb", base), ("rgba", rgba), ("l", base.convert("L")),
                     ("la", base.convert("LA")), ("p", pal_img),
                     ("1", bw)):
        pil(f"tga_pil_{mode}", im, "TGA", ".tga")
        if mode != "1":
            pil(f"tga_pil_{mode}_rle", im, "TGA", ".tga", rle=True)
    post = (img // 32 * 32).astype(np.uint8)      # runs for the packets
    pal = rng.randint(0, 256, (40, 3))
    idx = rng.randint(0, 40, (H, W)).astype(np.uint8) // 4 * 4
    words = (rng.randint(0, 1 << 15, (H, W)) // 64 * 64).astype(np.uint16)
    out["tga_rle_gray_bottom_up"] = (".tga", write_tga(
        post[..., 1], 11, 8, flags=0))
    out["tga_rle_rgb16"] = (".tga", write_tga(words, 10, 16, flags=0x20))
    out["tga_rle_bgr24_mirrored"] = (".tga", write_tga(
        post, 10, 24, flags=0x30))
    out["tga_rle_bgra32_cross_rows"] = (".tga", write_tga(
        np.dstack([post, alpha]), 10, 32, flags=0x10, cross_rows=True,
        id_section=b"fixture"))
    out["tga_rle_map16"] = (".tga", write_tga(
        idx + 5, 9, 8, palette=np.vstack([np.zeros((5, 3)), pal]),
        map_depth=16))
    out["tga_map24_start_bottom_up"] = (".tga", write_tga(
        idx + 3, 1, 8, palette=pal, map_start=3, flags=0x10))
    out["tga_gray_with_map"] = (".tga", write_tga(idx, 3, 8, palette=pal))
    out["tga_la16_bottom_up"] = (".tga", write_tga(
        np.dstack([gray, alpha[..., 0]]), 3, 16, flags=0))
    out["tga_map32_fails"] = (".tga", write_tga(idx, 1, 8, palette=pal,
                                                map_depth=32))
    out["tga_rle_1bit_fails"] = (".tga", write_tga(gray > 100, 11, 1))
    # PCX
    for mode, im in (("1", bw), ("l", base.convert("L")), ("p", pal_img),
                     ("rgb", base)):
        pil(f"pcx_pil_{mode}", im, "PCX", ".pcx")
    bits4 = rng.randint(0, 16, (H, W))
    out["pcx_planes4"] = (".pcx", write_pcx(
        np.stack([(bits4 >> p) & 1 for p in range(4)], 1), 1,
        palette16=rng.randint(0, 256, (16, 3))))
    out["pcx_planes2_padded"] = (".pcx", write_pcx(
        np.stack([(bits4 >> p) & 1 for p in range(2)], 1), 1,
        palette16=rng.randint(0, 256, (16, 3)), bytes_per_line=9,
        version=3))
    out["pcx_rgb_padded_origin"] = (".pcx", write_pcx(
        post.transpose(0, 2, 1)[:, ::-1], 8, bytes_per_line=W + 1,
        origin=(7, 3)))
    out["pcx_gray_ramp_palette"] = (".pcx", write_pcx(
        post[:, None, :, 0], 8, palette256=np.arange(256).repeat(3)
        .reshape(256, 3)))
    out["pcx_gray_no_marker"] = (".pcx", write_pcx(
        post[:, None, :, 0], 8) + bytes(769))
    out["pcx_1bit_v0"] = (".pcx", write_pcx((gray > 90)[:, None], 1,
                                            version=0))
    # SGI
    for mode, im in (("l", base.convert("L")), ("rgb", base),
                     ("rgba", rgba)):
        pil(f"sgi_pil_{mode}", im, "SGI", ".sgi")
        pil(f"sgi_pil_{mode}_bpc2", im, "SGI", ".sgi", bpc=2)
    wide = (post.astype(np.uint16) * 257
            + rng.randint(0, 3, post.shape)).astype(np.uint16)
    out["sgi_rle_rgb"] = (".sgi", write_sgi(post))
    out["sgi_rle_gray16"] = (".sgi", write_sgi(wide[..., :1], 2))
    out["sgi_rle_rgba16_shared"] = (".sgi", write_sgi(
        np.dstack([wide, wide[..., :1]]), 2, share_rows=True))
    out["sgi_rle_rows_shared"] = (".sgi", write_sgi(
        np.repeat(post[::9], 9, 0)[:H], share_rows=True))
    out["sgi_raw16_rgb"] = (".sgi", write_sgi(wide, 2, rle=False))
    # QOI
    pil("qoi_pil_rgb", base, "QOI", ".qoi")
    pil("qoi_pil_rgba", rgba, "QOI", ".qoi")
    ops = bytearray(b"\x05\xfe\x10\x20\x30\xc0\x3f\x55\x9f\x88"
                    b"\xff\x01\x02\x03\x80\x2d")
    while len(ops) < 3 * H * W:
        ops += bytes([0x40 | rng.randint(0, 64), 0x80 | rng.randint(0, 64),
                      rng.randint(0, 256), rng.randint(0, 64),
                      0xC0 | rng.randint(0, 62)])
    out["qoi_ops_channels0"] = (".qoi", b"qoif" + struct.pack(">II", W, H)
                                + b"\x00\x00" + bytes(ops) + bytes(7)
                                + b"\x01")
    out["qoi_ops_rgb"] = (".qoi", b"qoif" + struct.pack(">II", W, H)
                          + b"\x03\x01" + bytes(ops) + bytes(7) + b"\x01")
    # XBM
    pil("xbm_pil", bw, "XBM", ".xbm")
    pil("xbm_pil_hotspot", bw, "XBM", ".xbm", hotspot=(3, 4))
    row = (W + 7) // 8
    vals = rng.randint(0, 256, row * H)
    hexes = ",".join(("0x%02X" if k % 3 else "0x%02x") % v + (
        " /* 0X7F */" if k % 50 == 1 else "") for k, v in enumerate(vals))
    out["xbm_upper_stray"] = (".xbm", (
        f"#define fix_width {W}\n#define fix_height {H}\n"
        f"static unsigned char fix_bits[] = {{ 0xq1,\n{hexes} }};\n")
        .encode())
    out["xbm_capital_x_fails"] = (".xbm", (
        f"#define fix_width {W}\n#define fix_height {H}\n"
        f"static char fix_bits[] = {{\n{hexes.replace('0x', '0X')} }};\n")
        .encode())
    # IM
    for mode, im in (("1", bw), ("l", base.convert("L")), ("p", pal_img),
                     ("rgb", base), ("rgba", rgba), ("la", base.convert("LA")),
                     ("i16", Image.fromarray(wide[..., 0] // 128)),
                     ("f", Image.fromarray(
                         (rng.randn(H, W) * 150 + 100).astype(np.float32)))):
        pil(f"im_pil_{mode}", im, "IM", ".im")
    out["im_l16b"] = (".im", write_im(wide[..., 0] // 64, "L 16B image",
                                      raw=(wide[::-1, :, 0] // 64)
                                      .astype(">u2").tobytes()))
    out["im_x24"] = (".im", write_im(rgb, "X 24 image"))
    ramp = np.arange(256, dtype=np.uint8)
    out["im_lut_gray_nonlinear"] = (".im", write_im(
        gray, "Greyscale image", lut=(255 - ramp).tobytes() * 3))
    out["im_rgb_lut"] = (".im", write_im(
        rgb, "RGB image", lut=rng.randint(0, 256, 768).astype(np.uint8)
        .tobytes(), raw=np.ascontiguousarray(rgb[::-1].transpose(0, 2, 1))
        .tobytes()))
    # ICO
    pil("ico_pil_png", rgba, "ICO", ".ico", sizes=[(16, 16), (32, 32),
                                                    (48, 48)])
    pil("ico_pil_bmp", rgba, "ICO", ".ico", sizes=[(16, 16), (32, 32)],
        bitmap_format="bmp")
    small = rgb[:20, :24]
    ipal = rng.randint(0, 256, (16, 3))
    png = io.BytesIO()
    Image.fromarray(rgb[:30, :40]).save(png, "PNG")
    entries = [dib(rng.randint(0, 16, (20, 24)), 4, palette=ipal),
               dib(small[..., ::-1], 24, mask=rng.randint(0, 2, (20, 24))),
               dib(rng.randint(0, 2, (20, 24)), 1, palette=ipal[:2]),
               png.getvalue()]
    out["ico_bmp_entries"] = (".ico", write_ico(entries[:3], [
        (24, 20, 16, 4), (24, 20, 0, 24), (24, 20, 2, 1)]))
    out["ico_png_among_bmp"] = (".ico", write_ico(entries, [
        (24, 20, 16, 4), (24, 20, 0, 24), (24, 20, 2, 1), (40, 30, 0, 32)]))
    out["ico_depth_from_colors"] = (".ico", write_ico(
        [entries[0], dib(rng.randint(0, 256, (20, 24)), 8,
                         palette=rng.randint(0, 256, (256, 3)))],
        [(24, 20, 16, 0), (24, 20, 0, 8)]))
    out["ico_size_misstated"] = (".ico", write_ico(
        [dib(np.dstack([small[..., ::-1], alpha[:20, :24]]), 32)],
        [(16, 16, 0, 32)]))
    cut = write_ico(entries[1:2], [(24, 20, 0, 24)])
    out["ico_cut_mask_fails"] = (".ico", cut[:-30])
    # MSP
    pil("msp_pil_v1", bw, "MSP", ".msp")
    out["msp_v2"] = (".msp", write_msp2(gray > 120, blank_rows=(3, 17)))
    v2 = write_msp2(gray > 60)
    out["msp_v2_cut_fails"] = (".msp", v2[:len(v2) * 2 // 3])
    return out


def format_references(files: dict, tmp: str) -> dict:
    """The digests of cv2's three reads and of PIL's RGB of each file."""
    arrays = {}
    for name, (ext, data) in files.items():
        path = os.path.join(tmp, name + ext)
        with open(path, "wb") as f:
            f.write(data)
        arrays[name] = digest(cv2.imread(path, cv2.IMREAD_COLOR))
        arrays[name + "_gray"] = digest(cv2.imread(path,
                                                   cv2.IMREAD_GRAYSCALE))
        arrays[name + "_any"] = digest(cv2.imread(path,
                                                  cv2.IMREAD_ANYDEPTH))
        try:
            arrays[name + "_pil"] = digest(np.asarray(Image.open(path)
                                                      .convert("RGB")))
        except (OSError, ValueError, SyntaxError):
            pass
    return {k: np.array(v) for k, v in arrays.items()}


# the formats of slices 19-21: directory under tests/data -> its files
FORMATS = {"pxm": lambda tmp: pxm_files(), "tiff": tiff_files,
           "hdr": hdr_files, "sunras": sunras_files,
           "cmyk": lambda tmp: cmyk_files(),
           "jpeg24": lambda tmp: jpeg24_files(),
           "gif": lambda tmp: gif_files(), "webp": lambda tmp: webp_files(),
           "pil29": lambda tmp: pil29_files(), "tiff26c": tiff26c_files,
           "webp26d": lambda tmp: webp26d_files(),
           "webp26d_kitti": lambda tmp: webp26d_kitti_files(),
           "webp26d_clip": lambda tmp: webp26d_clip_files()}


def references(files: dict, tmp: str, ext: str) -> dict:
    """The digests of cv2's colour and gray reads and of PIL's RGB of each
    file."""
    arrays = {}
    for name, data in files.items():
        path = os.path.join(tmp, name + ext)
        with open(path, "wb") as f:
            f.write(data)
        color = cv2.imread(path, cv2.IMREAD_COLOR)
        assert color is not None, name
        arrays[name] = digest(color)
        arrays[name + "_gray"] = digest(cv2.imread(path,
                                                   cv2.IMREAD_GRAYSCALE))
        try:
            arrays[name + "_pil"] = digest(np.asarray(Image.open(path)
                                                      .convert("RGB")))
        except OSError:
            assert name == "cut", name
    return {k: np.array(v) for k, v in arrays.items()}


def write(directory: str, files: dict, ext: str) -> None:
    os.makedirs(directory, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(directory, name + ext), "wb") as f:
            f.write(data)


def main() -> None:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        jpegs = jpeg_files()
        write(os.path.join(OUT, "progressive", "layouts"), jpegs, ".jpg")
        np.savez_compressed(os.path.join(OUT, "progressive", "layouts.npz"),
                            **references(jpegs, tmp, ".jpg"))
        bmps = bmp_files(tmp)
        write(os.path.join(OUT, "bmp"), bmps, ".bmp")
        np.savez_compressed(os.path.join(OUT, "bmp.npz"),
                            **references(bmps, tmp, ".bmp"))
        for fmt, make in FORMATS.items():
            files = make(tmp)
            directory = os.path.join(OUT, fmt)
            os.makedirs(directory, exist_ok=True)
            for name, (ext, data) in files.items():
                with open(os.path.join(directory, name + ext), "wb") as f:
                    f.write(data)
            np.savez_compressed(os.path.join(OUT, fmt + ".npz"),
                                **format_references(files, tmp))
    kitti = os.path.join(OUT, "progressive", "kitti")
    os.makedirs(kitti, exist_ok=True)
    digests = []
    for name in sorted(os.listdir(KITTI_IN)):
        bgr = cv2.imread(os.path.join(KITTI_IN, name), cv2.IMREAD_COLOR)
        path = os.path.join(kitti, name)
        assert cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, 95,
                                       cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        dec = cv2.imread(path, cv2.IMREAD_COLOR)
        digests.append(hashlib.sha256(dec.tobytes()).hexdigest())
    np.savez_compressed(os.path.join(OUT, "progressive", "kitti.npz"),
                        sha256=np.array(digests))
    subs = ("progressive", "bmp") + tuple(FORMATS)
    paths = [os.path.join(d, f) for sub in subs
             for d, _, fs in os.walk(os.path.join(OUT, sub)) for f in fs]
    total = sum(map(os.path.getsize, paths + [
        os.path.join(OUT, s + ".npz") for s in ("bmp",) + tuple(FORMATS)]))
    print(f"fixtures written under {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
