"""The port's lossless WebP reader (``io/webp.py`` with
``csrc/webp_decode.cpp``) through ``io/datasets.imread`` against
``cv2.imread`` (OpenCV 5.0 over libwebp; IMREAD_COLOR, IMREAD_GRAYSCALE,
IMREAD_ANYDEPTH) and through ``read_rgb_pil`` against PIL's
``Image.open(p).convert("RGB")`` (libwebp's WebPAnimDecoder), on the same
bytes; the C++ VP8L decoder against its Python version.

The files: cv2's writer at quality 101 (lossless) and PIL's
(``lossless=True`` at every method, qualities, ``exact``), with alpha,
palettes, animations; and ``tests/image_encoders.write_vp8l``, which builds
what the writers leave out: every predictor mode (14 and 15 too), the
cross-colour and subtract-green transforms, bundled palettes of 1-256
colours, the colour cache at 1-11 bits, meta prefix codes, LZ77
references, simple and normal prefix codes with and without runs in the
code lengths, images of one pixel, row or column; then cut and corrupt
files. Found by probe and held here: the VP8L reader also gets the chunk's
padding byte; cv2 needs 32 bytes of file; both read through the demuxer,
which takes the first frame of an animation onto a transparent canvas.
Lossy WebP (``VP8 ``, with or without ``ALPH``) is read too
(tests/test_torch_webp_lossy.py holds it in full). Bar: bit-equal, None
where cv2 gives None, a raise where PIL raises.
"""

import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import write_vp8l
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import webp

FLAGS = (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH)


def _check(tmp_path, data, plain=True):
    """The port (C++ and, with ``plain``, the Python decoder) against
    cv2's three reads and PIL; returns (cv2's colour read gave an image,
    PIL did)."""
    path = str(tmp_path / "x.webp")
    with open(path, "wb") as f:
        f.write(data)
    seen = []
    for flag in FLAGS:
        ref = cv2.imread(path, flag)
        reads = [td.imread(path, flag)]
        if plain:
            reads.append(webp.read_cv2(data, flag, plain=True))
        for got in reads:
            if ref is None:
                assert got is None, flag
            else:
                assert got is not None and got.shape == ref.shape, flag
                np.testing.assert_array_equal(got, ref)
        seen.append(ref is not None)
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        return seen[0], False
    np.testing.assert_array_equal(td.read_rgb_pil(path), ref)
    if plain:
        np.testing.assert_array_equal(webp.read_pil(data, plain=True), ref)
    return seen[0], True


def _image(rng, h, w, kind):
    if kind == 0:
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == 1:
        return cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3)).astype(
            np.uint8), (5, 5), 3)
    if kind == 2:
        return (rng.randint(0, rng.randint(2, 20), (h, w, 1)).repeat(3, 2)
                * 7).astype(np.uint8)
    if kind == 3:
        return np.tile(rng.randint(0, 256, (1, w, 3)), (h, 1, 1)).astype(
            np.uint8)
    return (rng.randint(0, 3, (h, w, 3)) * 100).astype(np.uint8)


@pytest.mark.parametrize("seed", range(12))
def test_writer_files_read_as_cv2_and_pil(tmp_path, seed):
    """cv2's and PIL's lossless files of random, smooth, few-colour and
    repeating images, with and without alpha; each also cut and with bytes
    overwritten."""
    rng = np.random.RandomState(seed)
    for k in range(5):
        h, w = rng.randint(1, 50, 2)
        img = _image(rng, h, w, k)
        if rng.rand() < 0.4:
            img = np.concatenate([img, rng.randint(0, 256, (h, w, 1)).astype(
                np.uint8)], 2)
        files = [cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY,
                                             101])[1].tobytes()]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "WEBP", lossless=True,
                                  quality=int(rng.randint(0, 101)),
                                  method=int(rng.randint(0, 7)),
                                  exact=bool(rng.rand() < 0.5))
        files.append(buf.getvalue())
        for data in files:
            assert _check(tmp_path, data, plain=k < 2) == (len(data) >= 32,
                                                          True)
            _check(tmp_path, data[:rng.randint(12, len(data))], plain=False)
            bad = bytearray(data)
            for i in rng.randint(20, len(data), rng.randint(1, 3)):
                bad[i] = rng.randint(256)
            _check(tmp_path, bytes(bad), plain=k < 2)


def _argb(rng, h, w, smooth=False):
    if smooth:
        return (np.arange(h * w).reshape(h, w) % 7).astype(np.uint32) * \
            np.uint32(0x01020304)
    c = [rng.randint(0, 256, (h, w)).astype(np.uint32) for _ in range(4)]
    return c[0] << 24 | c[1] << 16 | c[2] << 8 | c[3]


FEATURES = {
    "plain": {}, "normal codes": dict(simple=False),
    "no runs": dict(runs=False), "cache 1": dict(cache_bits=1),
    "cache 4": dict(cache_bits=4), "cache 11": dict(cache_bits=11),
    "lz77": dict(lz77=True), "lz77 cache": dict(lz77=True, cache_bits=3),
    "subtract green": dict(subtract_green=True)}


@pytest.mark.parametrize("size", [(9, 13), (1, 1), (1, 7), (6, 1),
                                  (17, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
def test_every_vp8l_feature_reads_as_cv2_and_pil(tmp_path, size, smooth):
    """``write_vp8l`` streams of each feature alone and all together: the
    port reads them as the pixels written, as cv2 (where the file has its
    32 bytes) and PIL do."""
    rng = np.random.RandomState(size[0] * 40 + size[1] + smooth)
    H, W = size
    argb = _argb(rng, H, W, smooth)
    th, tw = (H + 3) // 4, (W + 3) // 4
    cases = list(FEATURES.values())
    cases += [dict(predictor=(2, np.full((th, tw), m))) for m in range(16)]
    cases += [dict(predictor=(3, rng.randint(0, 16, ((H + 7) // 8,
                                                     (W + 7) // 8)))),
              dict(cross_color=(2, rng.randint(0, 256, (th, tw, 3)))),
              dict(groups=rng.randint(0, 3, th * tw), group_bits=2),
              dict(predictor=(2, rng.randint(0, 14, (th, tw))),
                   cross_color=(2, rng.randint(0, 256, (th, tw, 3))),
                   subtract_green=True, cache_bits=5, lz77=True,
                   groups=rng.randint(0, 4, th * tw))]
    want = argb.view(np.uint8).reshape(H, W, 4)
    for kw in cases:
        data = write_vp8l(argb, **kw)
        np.testing.assert_array_equal(webp.read_pil(data), want[..., 2::-1])
        assert _check(tmp_path, data, plain=H * W < 200) == (
            len(data) >= 32, True)


@pytest.mark.parametrize("colors", [1, 2, 3, 4, 5, 16, 17, 200])
def test_palettes_bundle_as_cv2_and_pil(tmp_path, colors):
    """Colour indexing at every bundling (8, 4, 2 or 1 indices a pixel),
    alone and under a predictor and subtract-green on the packed image."""
    rng = np.random.RandomState(colors)
    for H, W in ((9, 13), (17, 33), (1, 5)):
        pal = rng.randint(0, 1 << 32, colors, dtype=np.uint64).astype(
            np.uint32)
        img = pal[rng.randint(0, colors, (H, W))]
        bits = 0 if colors > 16 else 1 if colors > 4 else \
            2 if colors > 2 else 3
        pw = (W + (1 << bits) - 1) >> bits
        for kw in ({}, dict(predictor=(2, rng.randint(0, 14, (
                (H + 3) // 4, (pw + 3) // 4))), subtract_green=True)):
            data = write_vp8l(img, palette=pal, **kw)
            np.testing.assert_array_equal(
                webp.read_pil(data),
                img.view(np.uint8).reshape(H, W, 4)[..., 2::-1])
            _check(tmp_path, data)


def test_animations_first_frame(tmp_path):
    """The first frame of an animated lossless file (PIL's writer, frames
    of two sizes), on its canvas."""
    rng = np.random.RandomState(4)
    for k in range(4):
        h, w = rng.randint(2, 30, 2)
        frames = [Image.fromarray(rng.randint(0, 256, (h, w, 3 + k % 2))
                                  .astype(np.uint8)) for _ in range(3)]
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", lossless=True, save_all=True,
                       append_images=frames[1:])
        assert _check(tmp_path, buf.getvalue()) == (True, True)


@pytest.mark.parametrize("how", ["cv2", "pil", "pil alpha", "pil anim"])
def test_lossy_webp_reads_as_cv2_and_pil(tmp_path, how):
    """Lossy WebP (a VP8 frame, with its alpha in ALPH; the first frame of
    an animation) reads as cv2 and PIL read it, under cv2's three flags and
    through ``read_rgb_pil``, the plain decoders too."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    if how == "cv2":
        data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY,
                                           80])[1].tobytes()
    else:
        im = Image.fromarray(img)
        if how == "pil alpha":
            im = Image.fromarray(np.dstack([img, img[..., :1]]))
        buf = io.BytesIO()
        im.save(buf, "WEBP", quality=80, save_all=how == "pil anim",
                append_images=[im] if how == "pil anim" else [])
        data = buf.getvalue()
    assert b"VP8 " in data and b"VP8L" not in data
    assert _check(tmp_path, data) == (True, True)


def test_containers_as_cv2_and_pil(tmp_path):
    """The RIFF container around a VP8L frame: trailing bytes past the
    RIFF data, odd payloads and their padding, a RIFF size past the file,
    chunks after the image, an extended (VP8X) file with metadata chunks,
    a VP8X canvas that differs from the frame, reserved flags, files
    under 32 bytes."""
    import struct

    rng = np.random.RandomState(6)
    argb = _argb(rng, 5, 7)
    data = write_vp8l(argb)
    payload = data[20:20 + struct.unpack("<I", data[16:20])[0]]
    vp8l = b"VP8L" + struct.pack("<I", len(payload)) + payload + \
        b"\0" * (len(payload) & 1)

    def riff(body, size=None):
        return b"RIFF" + struct.pack("<I", size or 4 + len(body)) + \
            b"WEBP" + body

    def vp8x(flags=0, w=7, h=5):
        return b"VP8X" + struct.pack("<I", 10) + bytes([flags, 0, 0, 0]) + \
            (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    meta = b"EXIF" + struct.pack("<I", 3) + b"abc\0"
    cases = [riff(vp8l) + b"trailing", riff(vp8l, 4 + len(vp8l) + 40),
             riff(vp8l + meta), riff(vp8l + b"abc"),
             riff(vp8x(0x08) + meta + vp8l), riff(vp8x(0x08) + vp8l + meta),
             riff(vp8x() + vp8l), riff(vp8x(w=8) + vp8l),
             riff(vp8x(0x01) + vp8l), riff(vp8x() + vp8l + vp8l),
             riff(vp8x(0x02) + vp8l), riff(vp8l)[:31],
             write_vp8l(np.zeros((1, 1), np.uint32))]
    for data in cases:
        _check(tmp_path, data)


def test_cpp_decoder_equals_plain():
    """``webp_vp8l_decode`` against ``vp8l_plain`` on the features' streams
    with random bytes written over their ends (pixels, or the same
    failure)."""
    rng = np.random.RandomState(8)
    for k in range(60):
        H, W = rng.randint(1, 12, 2)
        kw = dict(list(FEATURES.values())[k % len(FEATURES)])
        if k % 3 == 0:
            kw["predictor"] = (2, rng.randint(0, 16, ((H + 3) // 4,
                                                      (W + 3) // 4)))
        data = bytearray(write_vp8l(_argb(rng, H, W), riff=False, **kw))
        if k % 2:
            at = rng.randint(5, len(data))
            data[at:] = rng.randint(0, 256, len(data) - at).astype(
                np.uint8).tobytes()
        out = []
        for plain in (False, True):
            try:
                out.append(webp.decode_vp8l(bytes(data), plain=plain))
            except webp.CorruptWebp:
                out.append(None)
        assert (out[0] is None) == (out[1] is None)
        if out[0] is not None:
            np.testing.assert_array_equal(out[0], out[1])


def test_committed_webp_fixtures_read_as_cv2_and_pil(tmp_path):
    """What chip_smoke.py phase (u1) checks on the card for tests/data/
    webp, here also against cv2 and PIL themselves."""
    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert chip_smoke.check_format_fixtures(root, ("webp",)) == 11 * 7
    directory = os.path.join(root, "tests", "data", "webp")
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            assert _check(tmp_path, f.read(), plain=False) == (True, True)
