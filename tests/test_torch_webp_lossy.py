"""The port's lossy WebP reader (``io/vp8.py`` with ``csrc/vp8_decode.cpp``;
the ALPH chunk by ``io/webp.py`` with ``csrc/webp_decode.cpp``) through
``io/datasets.imread`` against ``cv2.imread`` (OpenCV 5.0 over libwebp;
IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_ANYDEPTH) and through
``read_rgb_pil`` against PIL's ``Image.open(p).convert("RGB")``
(libwebp's WebPAnimDecoder), on the same bytes; the C++ decoders against
their Python versions (``vp8.decode_plain``, ``webp.alph_plain``).

The files: PIL's writer at every quality and method, with and without
alpha, animations; cv2's writer at several qualities; and what the writers
leave out, by ``tests/image_encoders.write_vp8`` (VP8 key frames of random
syntax: segments with and without a map, absolute and delta values, the
simple and normal loop filters, sharpness 0-7, levels 0 and 63, filter
deltas, 2, 4 and 8 token partitions, probability updates, skip flags,
every 16x16, 4x4 and chroma mode, category-6 coefficients, quantisers 0
and 127 with deltas, blocks ended by zero runs) and ``alph_chunk`` (every
compression, filter and pre-processing, and invalid headers); then cut and
corrupt files. Found by probe and held here: cv2's libwebp runs the full
inverse DCT in 16-bit SIMD lanes (large coefficients wrap there); the
demuxer drops the ALPH chunk of a still image without the VP8X alpha flag
(cv2's still decoder uses it), fails a kept ALPH chunk after its image and
a second image chunk after an ALPH-only frame. Bar: bit-equal, None where
cv2 gives None, a raise where PIL raises.
"""

import io
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import (alph_chunk, anmf_chunk, vp8x_chunk,
                                  webp_chunk, webp_file, write_vp8)
from tests.test_torch_webp import _check
from vido_slam_tpu_torch.io import vp8, webp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAIN_PIXELS = 1600     # the plain decoders read files up to this size


def _pil(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _picture(rng, h, w):
    kind = rng.randint(3)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == 1:
        img = cv2.GaussianBlur(img, (5, 5), 2)
    elif kind == 2:
        img = (np.indices((h, w)).sum(0)[..., None] * rng.randint(1, 9, 3)
               % 256).astype(np.uint8)
    return img


def _frame_of(data: bytes) -> bytes:
    """A simple file's VP8 chunk payload."""
    assert data[12:16] == b"VP8 "
    return data[20:20 + struct.unpack("<I", data[16:20])[0]]


@pytest.mark.parametrize("seed", range(5))
def test_pil_writer_files(tmp_path, seed):
    """PIL's lossy files of random, smooth and ramp images from 1x1 to
    80x80 at random quality and method, a third with alpha (raw, VP8L and
    level-reduced ALPH chunks)."""
    rng = np.random.RandomState(seed)
    for k in range(5):
        h, w = rng.randint(1, 81, 2) if k else (1 + seed % 2, 1 + seed)
        img = _picture(rng, h, w)
        kw = dict(quality=int(rng.randint(0, 101)),
                  method=int(rng.randint(0, 7)))
        if rng.rand() < 0.35:
            a = rng.randint(0, 256, (h, w)).astype(np.uint8)
            if rng.rand() < 0.5:
                a = cv2.GaussianBlur(a, (9, 9), 4)
            img = np.dstack([img, a])
            kw["alpha_quality"] = int(rng.choice([100, rng.randint(0, 100)]))
        data = _pil(img, **kw)
        assert b"VP8 " in data
        assert _check(tmp_path, data, plain=h * w <= PLAIN_PIXELS) == \
            (len(data) >= 32, True)


@pytest.mark.parametrize("quality", [1, 25, 80, 100])
def test_cv2_writer_files(tmp_path, quality):
    """cv2's lossy files (IMWRITE_WEBP_QUALITY up to 100), with and without
    alpha."""
    rng = np.random.RandomState(quality)
    for k in range(3):
        h, w = rng.randint(1, 60, 2)
        img = _picture(rng, h, w)
        if k == 2:
            img = np.dstack([img, rng.randint(0, 256, (h, w, 1)).astype(
                np.uint8)])
        data = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY,
                                           quality])[1].tobytes()
        assert b"VP8 " in data
        _check(tmp_path, data, plain=h * w <= PLAIN_PIXELS)


def test_animations_first_frame(tmp_path):
    """The first frame of lossy animations: PIL's (with and without
    alpha), and hand-built ones whose first frame sits at an offset on a
    larger canvas, with and without ALPH, the VP8X alpha flag on and off
    (an animation keeps its frames' alpha either way)."""
    rng = np.random.RandomState(11)
    for k in range(3):
        h, w = rng.randint(2, 40, 2)
        frames = [Image.fromarray(rng.randint(0, 256, (h, w, 3 + k % 2))
                                  .astype(np.uint8)) for _ in range(2)]
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", quality=int(rng.randint(0, 101)),
                       save_all=True, append_images=frames[1:])
        assert _check(tmp_path, buf.getvalue(),
                      plain=h * w <= PLAIN_PIXELS) == (True, True)
    anim = webp_chunk(b"ANIM", bytes(6))
    for k in range(6):
        h, w = (int(v) for v in rng.randint(1, 30, 2))
        vp = webp_chunk(b"VP8 ", write_vp8(rng, w, h))
        alpha = rng.randint(0, 256, (h, w)).astype(np.uint8)
        cw, ch = w + 2 * rng.randint(0, 4), h + 2 * rng.randint(0, 4)
        x, y = 2 * rng.randint(0, (cw - w) // 2 + 1), \
            2 * rng.randint(0, (ch - h) // 2 + 1)
        first = (alph_chunk(alpha, k % 2, k % 4) if k < 4 else b"") + vp
        data = webp_file([vp8x_chunk(cw, ch, 0x12 if k % 3 else 0x02), anim,
                          anmf_chunk(first, x, y, w, h),
                          anmf_chunk(vp, 0, 0, w, h)])
        assert _check(tmp_path, data) == (True, True)


SYNTAX = {
    "segments_map_absolute": dict(segments=[(10, 20), (60, -10), (-5, 40),
                                            (127, 63)], update_map=True,
                                  absolute=True, level=30),
    "segments_deltas_no_map": dict(segments=[(-30, 5), (0, 0), (30, -5),
                                             (90, 30)], update_map=False,
                                   absolute=False),
    "simple_filter": dict(filter_type=0, level=None),
    "normal_filter": dict(filter_type=1, level=None),
    "level_0": dict(level=0),
    "level_63": dict(level=63),
    "filter_deltas": dict(lf_deltas=[20, -3, 5, 1, -20, 2, 0, 7]),
    "partitions_2": dict(partitions=1),
    "partitions_4": dict(partitions=2),
    "partitions_8": dict(partitions=3),
    "probability_updates": dict(updates=0.6),
    "skip_flags": dict(skip_p=150),
    "no_skip_flags": dict(skip_p=None),
    "16x16_modes": dict(i4x4=0.0),
    "4x4_modes": dict(i4x4=1.0),
    "quantiser_0": dict(q=0, dq=[-15, -15, -15, -15, -15]),
    "quantiser_127_category_6": dict(q=127, dq=[15, 15, 15, 15, 15],
                                     cat6=0.3, scale=40.0),
    "zero_runs": dict(run_out=0.5),
}


@pytest.mark.parametrize("name", sorted(SYNTAX))
def test_random_syntax_frames(tmp_path, name):
    """VP8 key frames of random syntax (``write_vp8``) of sizes from 1 to
    40, each syntax element set as named, the rest drawn; sharpness 0-7 in
    turn."""
    rng = np.random.RandomState(sorted(SYNTAX).index(name))
    for k in range(4):
        h, w = (int(v) for v in rng.randint(1, 41, 2))
        kw = dict(SYNTAX[name], sharpness=2 * k + int(rng.randint(2)))
        frame = write_vp8(rng, w, h, **kw)
        assert _check(tmp_path, webp_file([webp_chunk(b"VP8 ", frame)])) \
            == (True, True)


@pytest.mark.parametrize("method", [0, 1])
def test_alph_chunks(tmp_path, method):
    """ALPH chunks raw (method 0) and VP8L-compressed (method 1: plain
    images, palettes, predictors, the colour cache) under each filter and
    pre-processing, with the VP8X alpha flag on and off: the RGB reads are
    cv2's and PIL's, and the alpha plane PIL's RGBA where the demuxer
    keeps the chunk."""
    rng = np.random.RandomState(20 + method)
    path = str(tmp_path / "a.webp")
    for kind in range(4):
        for pre in (0, 1):
            h, w = (int(v) for v in rng.randint(1, 30, 2))
            vp = webp_chunk(b"VP8 ", write_vp8(rng, w, h))
            alpha = (np.indices((h, w)).sum(0) * rng.randint(1, 40)
                     % 256).astype(np.uint8)
            if rng.rand() < 0.5:
                alpha = rng.randint(0, 256, (h, w)).astype(np.uint8)
            opts = {}
            if method and pre:
                from tests.image_encoders import alpha_filter
                opts = dict(palette=[0xFF000000 | int(v) << 8 for v in
                                     np.unique(alpha_filter(alpha, kind))])
            elif method and kind == 2:
                opts = dict(predictor=(2, rng.randint(0, 14, ((h + 3) // 4,
                                                             (w + 3) // 4))))
            elif method and kind == 3:
                opts = dict(cache_bits=int(rng.randint(1, 11)), lz77=True)
            al = alph_chunk(alpha, method, kind, pre, **opts)
            for flags in (0x10, 0x00):
                data = webp_file([vp8x_chunk(w, h, flags), al, vp])
                assert _check(tmp_path, data) == (True, True)
                with open(path, "wb") as f:
                    f.write(data)
                got = webp._canvas(data, False, False)[..., 3]
                ref = np.asarray(Image.open(path).convert("RGBA"))[..., 3]
                np.testing.assert_array_equal(got, ref)
                if flags:
                    np.testing.assert_array_equal(got, alpha)


def test_alph_headers_and_data_that_fail(tmp_path):
    """ALPH headers both libraries fail on, cv2's colour read too
    (compression 2 or 3, pre-processing 2 or 3, a reserved bit, raw data
    marked as VP8L, an empty chunk, raw data short of the frame), and
    garbled or cut VP8L alpha data: cv2 gives None and PIL raises;
    garbled raw alpha reads."""
    rng = np.random.RandomState(30)
    h, w = 11, 19
    vp = webp_chunk(b"VP8 ", write_vp8(rng, w, h))
    alpha = rng.randint(0, 256, (h, w)).astype(np.uint8)

    def file(chunk):
        return webp_file([vp8x_chunk(w, h, 0x10), chunk, vp])
    for header in (0x02, 0x03, 0x20, 0x30, 0x40, 0x80):
        assert _check(tmp_path, file(alph_chunk(alpha, 0, header=header))) \
            == (False, False)
    for chunk in (webp_chunk(b"ALPH", b"\x01" + alpha.tobytes()),
                  webp_chunk(b"ALPH", b""), webp_chunk(b"ALPH", b"\x00"),
                  webp_chunk(b"ALPH", b"\x00" + alpha.tobytes()[:-1])):
        assert _check(tmp_path, file(chunk)) == (False, False)
    raw = bytearray(alph_chunk(alpha))
    raw[20:30] = bytes(10)
    assert _check(tmp_path, file(bytes(raw))) == (True, True)
    lossless = alph_chunk(alpha, 1, 1)
    outcomes = set()
    for k in range(8):
        bad = bytearray(lossless)
        bad[rng.randint(9, len(bad))] ^= 1 << rng.randint(8)
        outcomes.add(_check(tmp_path, file(bytes(bad))))
        cut = webp_chunk(b"ALPH", lossless[8:8 + rng.randint(
            1, len(lossless) - 8)])
        outcomes.add(_check(tmp_path, file(cut)))
    assert (False, False) in outcomes


def test_alph_container_rules(tmp_path):
    """Where the demuxer and cv2's still decoder part: without the VP8X
    alpha flag PIL's read drops the ALPH chunk (a bad header reads) while
    cv2 decodes it (None); two ALPH chunks (cv2 takes the last, the
    demuxer ends the frame at the second); a kept ALPH chunk after its
    image; an ALPH chunk alone, then the image after another chunk; an
    ALPH-only animation frame."""
    rng = np.random.RandomState(40)
    h, w = 9, 14
    vp = webp_chunk(b"VP8 ", write_vp8(rng, w, h))
    good = alph_chunk(rng.randint(0, 256, (h, w)).astype(np.uint8))
    bad = webp_chunk(b"ALPH", b"\x03")
    xmp = webp_chunk(b"XMP ", b"abc")
    anim = webp_chunk(b"ANIM", bytes(6))
    cases = {
        (0x00, good, bad): (False, False), (0x00, bad, vp): (False, True),
        (0x10, good, bad, vp): (False, False),
        (0x10, bad, good, vp): (True, False), (0x10, vp, good): (True, False),
        (0x00, vp, good): (True, True), (0x10, good, xmp, vp): (True, False),
        (0x18, vp, webp_chunk(b"EXIF", b"II*\0" + bytes(10))): (True, True),
    }
    for (flags, *chunks), want in cases.items():
        assert _check(tmp_path, webp_file([vp8x_chunk(w, h, flags)]
                                          + chunks)) == want, (flags, chunks)
    data = webp_file([vp8x_chunk(w, h, 0x12), anim,
                      anmf_chunk(good, 0, 0, w, h),
                      anmf_chunk(vp, 0, 0, w, h)])
    assert _check(tmp_path, data) == (False, False)


def _boundaries(frame: bytes) -> list:
    """The ends of the frame header, partition 0, the partition sizes and
    each token partition."""
    f = vp8._headers(frame)
    plen = (frame[0] | frame[1] << 8 | frame[2] << 16) >> 5
    first = 10 + plen + 3 * (len(f.parts) - 1)
    return [10, 10 + plen, first] + [p.end for p in f.parts]


def test_cut_and_corrupt(tmp_path):
    """Files cut at every partition boundary (and a byte either side) and
    inside each partition, with the RIFF and chunk sizes patched to the cut
    and left as they were, and followed by an EXIF chunk (cv2's still
    decoder reads the file to its end, the demuxer the chunk); partition
    sizes past the data; a partition 0 size past the chunk; bad start
    codes, inter frames, profiles 1-4, a hidden frame; bytes garbled
    anywhere."""
    rng = np.random.RandomState(50)
    frames = [_frame_of(_pil(_picture(rng, 21, 37), quality=90)),
              write_vp8(rng, 33, 19, partitions=2),
              write_vp8(rng, 24, 40, partitions=3, level=40)]
    seen = set()
    for frame in frames:
        full = webp_file([webp_chunk(b"VP8 ", frame)])
        bounds = _boundaries(frame)
        cuts = {b + d for b in bounds for d in (-1, 0, 1)} | {
            int(rng.randint(a, b)) for a, b in zip(bounds, bounds[1:])
            if b > a}
        h, w = vp8._headers(frame).height, vp8._headers(frame).width
        exif = webp_chunk(b"EXIF", b"II*\0" + bytes(rng.randint(
            0, 256, 24).astype(np.uint8)))
        for cut in sorted(c for c in cuts if 1 <= c < len(frame)):
            seen.add(_check(tmp_path, webp_file([
                webp_chunk(b"VP8 ", frame[:cut])])))
            seen.add(_check(tmp_path, full[:20 + cut]))
            seen.add(_check(tmp_path, webp_file([
                vp8x_chunk(w, h, 0x08), webp_chunk(b"VP8 ", frame[:cut]),
                exif])))
        sizes = bounds[1]
        for p in range(len(vp8._headers(frame).parts) - 1):
            big = bytearray(frame)
            big[sizes + 3 * p:sizes + 3 * p + 3] = b"\xff\xff\x0f"
            seen.add(_check(tmp_path, webp_file([webp_chunk(b"VP8 ",
                                                            bytes(big))])))
        for edit in ("start", "inter", "profile", "hidden", "partition0"):
            bad = bytearray(frame)
            if edit == "start":
                bad[3 + rng.randint(3)] ^= 0x10
            elif edit == "inter":
                bad[0] |= 1
            elif edit == "hidden":
                bad[0] &= 0xEF
            elif edit == "partition0":
                bad[0:3] = ((len(frame) << 5) | 0x10).to_bytes(3, "little")
            for profile in ((1, 2, 3, 4) if edit == "profile" else (None,)):
                if profile is not None:
                    bad[0] = (bad[0] & 0xF1) | profile << 1
                seen.add(_check(tmp_path, webp_file([webp_chunk(
                    b"VP8 ", bytes(bad))])))
        for k in range(6):
            bad = bytearray(frame)
            for i in rng.randint(10, len(frame), rng.randint(1, 4)):
                bad[i] = rng.randint(256)
            seen.add(_check(tmp_path, webp_file([webp_chunk(b"VP8 ",
                                                            bytes(bad))])))
    assert {(True, True), (False, False)} <= seen


def test_cpp_decoders_equal_plain():
    """``vp8_decode`` against ``decode_plain`` and ``webp_alph_decode``
    against ``alph_plain`` on random frames and ALPH streams, whole, cut
    and with bytes written over their ends (pixels, or the same
    failure)."""
    rng = np.random.RandomState(60)
    for k in range(40):
        h, w = (int(v) for v in rng.randint(1, 33, 2))
        data = bytearray(write_vp8(rng, w, h) if k % 2 else _frame_of(
            _pil(_picture(rng, h, w), quality=int(rng.randint(101)))))
        if k % 3 == 1:
            data = data[:rng.randint(1, len(data))]
        elif k % 3 == 2:
            at = rng.randint(10, len(data))
            data[at:] = rng.randint(0, 256, len(data) - at).astype(
                np.uint8).tobytes()
        got = vp8.decode(bytes(data))
        want = vp8.decode_plain(bytes(data))
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
        alpha = rng.randint(0, 256, (h, w)).astype(np.uint8)
        chunk = bytearray(alph_chunk(alpha, k % 2, k % 4, (k // 4) % 2)[8:])
        if k % 3 == 1:
            chunk = chunk[:rng.randint(1, len(chunk))]
        elif k % 3 == 2:
            chunk[rng.randint(1, len(chunk))] ^= 0x40
        out = []
        for plain in (False, True):
            try:
                out.append(webp.decode_alph(bytes(chunk), w, h, plain))
            except webp.CorruptWebp:
                out.append(None)
        assert (out[0] is None) == (out[1] is None)
        if out[0] is not None:
            np.testing.assert_array_equal(out[0], out[1])


def test_committed_fixtures_read_as_cv2_and_pil(tmp_path):
    """What chip_smoke.py phase (x1) checks on the card for tests/data/
    webp26d, webp26d_clip and webp26d_kitti (against the digests of cv2's
    and PIL's reads), here also against cv2 and PIL themselves; the
    fixtures cover what the writers make and each syntax element."""
    import chip_smoke

    formats = ("webp26d", "webp26d_clip", "webp26d_kitti")
    counts = {fmt: len(os.listdir(os.path.join(ROOT, "tests", "data", fmt)))
              for fmt in formats}
    assert chip_smoke.check_format_fixtures(ROOT, formats) == \
        7 * counts["webp26d"] + 4 * (counts["webp26d_clip"]
                                     + counts["webp26d_kitti"])
    outcomes = set()
    for fmt in formats:
        directory = os.path.join(ROOT, "tests", "data", fmt)
        for name in sorted(os.listdir(directory)):
            with open(os.path.join(directory, name), "rb") as f:
                outcomes.add(_check(tmp_path, f.read(), plain=False))
    assert outcomes == {(True, True), (False, False)}
    directory = os.path.join(ROOT, "tests", "data", "webp26d")
    seen = set()
    for name in os.listdir(directory):
        with open(os.path.join(directory, name), "rb") as f:
            data = f.read()
        if data[12:16] != b"VP8 ":
            continue
        f = vp8._headers(_frame_of(data))
        if f is None:
            continue
        seen |= {("parts", len(f.parts)), ("filter", f.filter_type),
                 ("map", f.update_map), ("segments", f.use_segment),
                 ("skip", f.skip_p is not None)}
    assert {("parts", n) for n in (1, 2, 4, 8)} | {
        ("filter", t) for t in (0, 1, 2)} | {("map", 1), ("segments", 1),
                                             ("skip", True)} <= seen
