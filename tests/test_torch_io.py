"""The port's dataset readers (``io/datasets.py``, ``io/png.py``,
``io/gt_poses.py``) against cv2 and the JAX package's readers, which read
through cv2.

PNGs written by ``cv2.imwrite`` (compression levels 0, 1 and 9, and each
filter forced) and by chip_smoke.py's writer (every row type in turn, gray +
alpha too) must decode bit-equal in the port, by the C++ unfilter and by
its plain version, to what cv2 and the JAX readers give; the demosaic must
be bit-equal to ``cv2.cvtColor(raw, cv2.COLOR_BayerBG2BGR)``. ``.flo``
files, image lists, the IMU csv and the GT object poses round trip or
agree with the JAX package's (the poses to 1e-12)."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from vido_slam_tpu.io import datasets as jd
from vido_slam_tpu.io import gt_poses as jg
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import gt_poses as tg
from vido_slam_tpu_torch.io import png

torch.set_num_threads(1)

SIZES = [(37, 53), (64, 96), (1, 7), (5, 2)]
KINDS = ["gray8", "gray16", "bgr8", "bgra8"]
# (compression level, forced filter): levels 0/1 pick among all five
# filters, 9 among Sub..Paeth; each filter also forced once
WRITES = [(0, None), (1, None), (9, None),
          (3, cv2.IMWRITE_PNG_FILTER_NONE), (3, cv2.IMWRITE_PNG_FILTER_SUB),
          (3, cv2.IMWRITE_PNG_FILTER_UP), (3, cv2.IMWRITE_PNG_FILTER_AVG),
          (3, cv2.IMWRITE_PNG_FILTER_PAETH)]


def _image(kind, h, w, seed):
    """Half smooth gradient, half noise: filters of every type pay off on
    some rows."""
    rng = np.random.RandomState(seed)
    hi = 65536 if kind == "gray16" else 256
    c = {"gray8": 1, "gray16": 1, "bgr8": 3, "bgra8": 4}[kind]
    smooth = np.add.outer(np.arange(h), np.arange(w)) * 37 % hi
    planes = [np.where(rng.rand(h, w) < 0.5, np.roll(smooth, k, 1),
                       rng.randint(0, hi, (h, w))) for k in range(c)]
    img = np.stack(planes, -1) if c > 1 else planes[0]
    return img.astype(np.uint16 if kind == "gray16" else np.uint8)


def _filter_types(path):
    """The set of row filter types in a PNG file."""
    with open(path, "rb") as f:
        chunks = list(png._chunks(f.read()))
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[0][1][:10])
    raw = zlib.decompress(b"".join(b for t, b in chunks if t == b"IDAT"))
    stride = w * png.CHANNELS[ctype] * depth // 8 + 1
    return {raw[r * stride] for r in range(h)}


def _write_cv2(path, img, level, filt):
    params = [cv2.IMWRITE_PNG_COMPRESSION, level]
    if filt is not None:
        params += [cv2.IMWRITE_PNG_FILTER, filt]
    assert cv2.imwrite(path, img, params)


def _check_reads(path, kind):
    """Every read of ``path`` in the port (both unfilters) against cv2 and
    the JAX readers."""
    ref = {flag: cv2.imread(path, flag) for flag in
           (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR, cv2.IMREAD_ANYDEPTH)}
    assert (td.IMREAD_GRAYSCALE, td.IMREAD_COLOR, td.IMREAD_ANYDEPTH) == (
        cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR, cv2.IMREAD_ANYDEPTH)
    got = td.imread(path, td.IMREAD_COLOR)
    assert got.dtype == ref[cv2.IMREAD_COLOR].dtype
    np.testing.assert_array_equal(got, ref[cv2.IMREAD_COLOR])
    np.testing.assert_array_equal(png.read_png(path).pixels,
                                  png.read_png(path, plain=True).pixels)
    if kind.startswith("gray"):
        for flag in (td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH):
            got = td.imread(path, flag)
            assert got.dtype == ref[flag].dtype
            np.testing.assert_array_equal(got, ref[flag])
        np.testing.assert_array_equal(td.load_depth_png(path),
                                      jd.load_depth_png(path))
        np.testing.assert_array_equal(td.load_mask_png(path),
                                      jd.load_mask_png(path))
        assert td.load_mask_png(path).dtype == np.int32
        assert td.load_depth_png(path).dtype == np.float32
    else:   # libpng's rgb_to_gray weights, as cv2 sets them
        for flag in (td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH):
            got = td.imread(path, flag)
            assert got.dtype == ref[flag].dtype
            np.testing.assert_array_equal(got, ref[flag])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cv2_written_png_bit_equal(tmp_path, kind, size):
    seen = set()
    for i, (level, filt) in enumerate(WRITES):
        img = _image(kind, *size, seed=i)
        path = str(tmp_path / f"w{i}.png")
        _write_cv2(path, img, level, filt)
        seen |= _filter_types(path)
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED).reshape(img.shape), img)
        _check_reads(path, kind)
    # libpng writes a first row's Up as None and its Avg and Paeth as Sub
    assert seen == ({0, 1, 2, 3, 4} if size[0] > 1 else {0, 1})


@pytest.mark.parametrize("kind", KINDS + ["grayalpha8", "grayalpha16",
                                          "bgr16"])
def test_chip_smoke_written_png_bit_equal(tmp_path, kind):
    """chip_smoke.write_png cycles the five filters over the rows; cv2 reads
    back the array written, the port reads what cv2 reads."""
    base = {"grayalpha8": "bgra8", "grayalpha16": "gray16",
            "bgr16": "gray16"}.get(kind, kind)
    img = _image(base, 41, 67, seed=7)
    if kind == "grayalpha8":
        img = img[..., :2]
    elif kind in ("grayalpha16", "bgr16"):
        c = 2 if kind == "grayalpha16" else 3
        img = np.stack([np.roll(img, k, 1) for k in range(c)], -1)
    path = str(tmp_path / "c.png")
    chip_smoke.write_png(path, img)
    assert _filter_types(path) == {0, 1, 2, 3, 4}
    if not kind.startswith("grayalpha"):  # cv2 decodes gray + alpha as BGRA
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_UNCHANGED).reshape(img.shape), img)
    want = img if img.ndim == 3 else img[..., None]
    if want.shape[-1] >= 3:  # the file holds RGB(A)
        want = np.concatenate([want[..., 2::-1], want[..., 3:]], axis=-1)
    np.testing.assert_array_equal(png.read_png(path).pixels, want)
    _check_reads(path, "gray" if kind.startswith("gray") else kind)


def test_unfilter_native_equals_plain_full_frame():
    """The C++ unfilter and its plain version on a 560 x 1280 frame's
    stream, every filter type on random rows."""
    rng = np.random.RandomState(3)
    h, rowbytes = 560, 1280
    stream = rng.randint(0, 256, (h, rowbytes + 1)).astype(np.uint8)
    stream[:, 0] = rng.randint(0, 5, h)
    for bpp in (1, 3):
        np.testing.assert_array_equal(
            png.unfilter(stream, h, rowbytes, bpp),
            png.unfilter_plain(stream, h, rowbytes, bpp))


@pytest.mark.parametrize("plain", [False, True])
def test_bad_filter_type_raises(plain):
    stream = np.zeros((3, 5), np.uint8)
    stream[2, 0] = 5
    fn = png.unfilter_plain if plain else png.unfilter
    with pytest.raises(ValueError, match="row 2 has filter type 5"):
        fn(stream, 3, 4, 1)


def _png_bytes(ihdr, body=b"\x00\x00", plte=None, crc_ok=True, idat=None):
    def chunk(tag, data, ok=True):
        crc = zlib.crc32(tag + data) ^ (0 if ok else 1)
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", crc)
    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr),
                                crc_ok)
    if plte is not None:
        out += chunk(b"PLTE", plte)
    idat = zlib.compress(body) if idat is None else idat
    return out + chunk(b"IDAT", idat) + chunk(b"IEND", b"")


@pytest.mark.parametrize("data,what", [
    (_png_bytes((1, 1, 8, 3, 0, 0, 0), plte=b"\x00\x00\x00"), None),
    (_png_bytes((1, 1, 8, 0, 0, 0, 1)), None),
    (_png_bytes((8, 1, 1, 0, 0, 0, 0)), None),
    (_png_bytes((1, 1, 8, 0, 0, 0, 0), crc_ok=False), "CRC"),
    (_png_bytes((3, 1, 8, 0, 0, 0, 0)), "holds 2 bytes, not 4"),
    (b"GIF89a" + bytes(20), "signature"),
    (_png_bytes((1, 1, 8, 0, 0, 0, 0), body=bytes(5)), "holds 5 bytes, not 2"),
], ids=["palette", "interlace", "depth1", "crc", "short", "not_png",
        "surplus"])
def test_unsupported_png_raises(tmp_path, data, what):
    """The decoder names what it refuses. ``imread`` answers as cv2 does:
    None where cv2 gives None (the bytes are no decodable PNG), and raises
    where cv2 decodes what the port refuses (surplus image data), so that
    no frame is skipped silently. The palette, interlaced and 1-bit
    images, refused before, decode as cv2's."""
    path = str(tmp_path / "u.png")
    with open(path, "wb") as f:
        f.write(data)
    if what is None:
        png.decode_png(data)
        for flag in (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE,
                     td.IMREAD_ANYDEPTH):
            np.testing.assert_array_equal(td.imread(path, flag),
                                          cv2.imread(path, flag))
        return
    with pytest.raises(ValueError, match=what):
        png.decode_png(data)
    if cv2.imread(path, cv2.IMREAD_COLOR) is None:
        assert td.imread(path, td.IMREAD_COLOR) is None
    else:
        with pytest.raises(ValueError, match=what):
            td.imread(path, td.IMREAD_COLOR)


def _corrupt(kind):
    """Bytes cv2.imread gives None for, made from a PNG cv2 wrote."""
    ok, enc = cv2.imencode(".png", _image("gray16", 24, 40, 3))
    enc = bytearray(enc.tobytes())
    if kind == "half":
        return bytes(enc[:len(enc) // 2])
    if kind == "no_iend":
        return bytes(enc[:-12])
    if kind == "crc":
        enc[41] ^= 0xFF     # a byte of the first IDAT chunk's payload
        return bytes(enc)
    if kind == "not_png":
        return b"this is no image\n" * 40
    if kind == "empty":
        return b""
    if kind == "inflate":
        return _png_bytes((1, 1, 8, 0, 0, 0, 0), idat=b"garbage!")
    if kind == "filter":
        return _png_bytes((1, 1, 8, 0, 0, 0, 0), body=b"\x07\x00")
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["half", "no_iend", "crc", "not_png",
                                  "empty", "inflate", "filter"])
@pytest.mark.parametrize("flags", [td.IMREAD_COLOR, td.IMREAD_GRAYSCALE,
                                   td.IMREAD_ANYDEPTH])
def test_undecodable_png_is_none_as_cv2(tmp_path, kind, flags):
    """A file that is no decodable PNG gives None, as cv2.imread gives on
    the same bytes; the depth and mask readers then raise
    FileNotFoundError, as the JAX package's do."""
    path = str(tmp_path / "c.png")
    with open(path, "wb") as f:
        f.write(_corrupt(kind))
    assert cv2.imread(path, flags) is None
    assert td.imread(path, flags) is None
    with pytest.raises(png.CorruptPng):
        png.read_png(path)
    for port_fn, jax_fn in ((td.load_depth_png, jd.load_depth_png),
                            (td.load_mask_png, jd.load_mask_png)):
        with pytest.raises(FileNotFoundError):
            jax_fn(path)
        with pytest.raises(FileNotFoundError):
            port_fn(path)


def test_cv2_bilevel_png_refused(tmp_path):
    """cv2's bilevel writer (a 1-bit gray PNG), refused before, reads as
    cv2 reads it."""
    path = str(tmp_path / "b.png")
    cv2.imwrite(path, (_image("gray8", 9, 16, 0) > 127).astype(np.uint8)
                * 255, [cv2.IMWRITE_PNG_BILEVEL, 1])
    assert _header(path)[2] == 1
    for flag in (td.IMREAD_GRAYSCALE, td.IMREAD_COLOR, td.IMREAD_ANYDEPTH):
        np.testing.assert_array_equal(td.imread(path, flag),
                                      cv2.imread(path, flag))


def test_jpeg_raises_naming_item_10b(tmp_path):
    """A KITTI frame as the reference names it (``.jpg``), refused before,
    decodes bit-equal to cv2 (io/jpeg.py; tests/test_torch_jpeg.py holds
    the decoder to cv2 at length), and a ``.jpg`` holding PNG bytes reads
    as the PNG: the format follows the signature, as in cv2."""
    path = str(tmp_path / "0000000000.jpg")
    cv2.imwrite(path, _image("bgr8", 16, 16, 0))
    png_path = str(tmp_path / "0000000001.jpg")
    _write_cv2(png_path, _image("bgr8", 16, 16, 1), 3, None)
    for p in (path, png_path):
        for flag in (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE,
                     td.IMREAD_ANYDEPTH):
            ref = cv2.imread(p, flag)
            got = td.imread(p, flag)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


def _header(path):
    with open(path, "rb") as f:
        return struct.unpack(">IIBBBBB", list(png._chunks(f.read()))[0][1])


def _pack_rows(samples, depth):
    """(h, n) samples of ``depth`` bits -> (h, rowbytes) packed bytes."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    h, n = samples.shape
    s = np.concatenate([samples, np.zeros((h, -n % per), samples.dtype)], 1)
    shifts = np.arange(8 - depth, -1, -depth)
    return (s.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def _filtered(rows, bpp, first):
    """Rows filtered by types first, first + 1, ... (mod 5)."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for i, r in enumerate(rows.astype(np.int64)):
        kind = (first + i) % 5
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
        pred = [0, a, prev, (a + prev) >> 1,
                np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))][kind]
        out.append(bytes([kind]) + ((r - pred) & 255).astype(np.uint8)
                   .tobytes())
        prev = r
    return b"".join(out)


def write_png_mode(path, samples, depth, ctype, plte=None, trns=None,
                   interlace=0):
    """A PNG of any mode from (h, w, c) samples (palette indices for
    colour type 3), each pass's rows through every filter type."""
    h, w, c = samples.shape
    bits = depth * c
    raw = b""
    for k, (x0, y0, dx, dy) in enumerate(png.ADAM7 if interlace
                                         else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered(_pack_rows(sub.reshape(sub.shape[0], -1), depth),
                             max(1, bits // 8), k)

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data))
    data = png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    for tag, body in ((b"PLTE", plte), (b"tRNS", trns)):
        if body is not None:
            data += chunk(tag, body)
    with open(path, "wb") as f:
        f.write(data + chunk(b"IDAT", zlib.compress(raw)) +
                chunk(b"IEND", b""))


MODES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1], ids=["flat", "adam7"])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"type{m[0]}_{m[1]}")
def test_every_png_mode_bit_equal_to_cv2(tmp_path, mode, interlace):
    """Each colour type at each bit depth, flat and Adam7-interlaced, with
    and without tRNS, at sizes that leave passes empty: IMREAD_COLOR,
    GRAYSCALE (colour through libpng's rgb_to_gray) and ANYDEPTH equal
    cv2's; both unfilters agree. A palette shorter than the indices reads
    past entries as black, as libpng's zero-filled palette does."""
    ctype, depth = mode
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.RandomState(ctype * 100 + depth * 2 + interlace)
    for size in ((13, 17), (1, 1), (9, 3), (40, 33)):
        for trns in (False, True):
            samples = rng.randint(0, 1 << depth, size + (channels,))
            plte = tr = None
            if ctype == 3:
                n = rng.randint(1, min(1 << depth, 256) + 1)
                plte = rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()
                tr = bytes(rng.randint(0, 256, max(1, n // 2))
                           .astype(np.uint8)) if trns else None
            elif trns and ctype in (0, 2):
                tr = struct.pack(">" + "H" * channels,
                                 *map(int, samples[0, 0]))
            path = str(tmp_path / f"m{size[0]}_{trns}.png")
            write_png_mode(path, samples, depth, ctype, plte, tr, interlace)
            for flag in (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE,
                         td.IMREAD_ANYDEPTH):
                ref = cv2.imread(path, flag)
                got = td.imread(path, flag)
                assert got.dtype == ref.dtype and got.shape == ref.shape
                np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(
                png.read_png(path).pixels,
                png.read_png(path, plain=True).pixels)


def test_missing_image_is_none(tmp_path):
    assert td.imread(str(tmp_path / "none.png")) is None
    assert td.imread(str(tmp_path / "none.jpg")) is None
    with pytest.raises(FileNotFoundError):
        td.load_depth_png(str(tmp_path / "none.png"))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("size", [(560, 1280), (375, 1242), (97, 321),
                                  (96, 320), (3, 3), (4, 7), (7, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_demosaic_bit_equal_to_cv2(size, dtype):
    rng = np.random.RandomState(size[0] * 7 + size[1])
    raw = rng.randint(0, np.iinfo(dtype).max + 1, size).astype(dtype)
    want = cv2.cvtColor(raw, cv2.COLOR_BayerBG2BGR)
    got = td.demosaic_bayer_bg2bgr(raw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jd.demosaic_bayer_bg2bgr(raw))


@pytest.mark.parametrize("size", [(1, 5), (2, 2), (5, 2), (2, 9)])
def test_demosaic_small_frames_zero_as_cv2(size):
    raw = np.full(size, 200, np.uint8)
    np.testing.assert_array_equal(td.demosaic_bayer_bg2bgr(raw),
                                  cv2.cvtColor(raw, cv2.COLOR_BayerBG2BGR))


def test_demosaic_of_a_mosaiced_frame_keeps_its_samples():
    """chip_smoke.mosaic_bayer_bg lays R, G, B where the demosaic reads
    them: each site keeps its own colour."""
    rng = np.random.RandomState(1)
    bgr = rng.randint(0, 256, (10, 12, 3)).astype(np.uint8)
    out = td.demosaic_bayer_bg2bgr(chip_smoke.mosaic_bayer_bg(bgr))
    inner = (slice(1, -1), slice(1, -1))
    r_site = np.zeros((10, 12), bool)
    r_site[0::2, 0::2] = True
    b_site = np.zeros((10, 12), bool)
    b_site[1::2, 1::2] = True
    g_site = ~(r_site | b_site)
    for ch, site in ((2, r_site), (0, b_site), (1, g_site)):
        m = site[inner]
        np.testing.assert_array_equal(out[inner][..., ch][m],
                                      bgr[inner][..., ch][m])


def test_flo_round_trips_between_packages(tmp_path):
    rng = np.random.RandomState(0)
    flow = rng.randn(13, 21, 2).astype(np.float32) * 5
    a, b = str(tmp_path / "a.flo"), str(tmp_path / "b.flo")
    jd.write_flo(a, flow)
    td.write_flo(b, flow)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(td.read_flo(a), flow)
    np.testing.assert_array_equal(jd.read_flo(b), flow)
    bad = str(tmp_path / "bad.flo")
    with open(bad, "wb") as f:
        f.write(struct.pack("<f", 1.0) + bytes(8))
    with pytest.raises(ValueError, match="magic"):
        td.read_flo(bad)


def test_image_lists_and_imu_equal_jax(tmp_path):
    kaist = tmp_path / "kaist"
    (kaist / "image").mkdir(parents=True)
    stamps = ["1544590798702863000", "1544590798802863123456", "15445907",
              ""]
    (kaist / "vTimestampsImage.txt").write_text(
        "# header\n" + "\n".join(s + " 1" if s else s for s in stamps) + "\n")
    img_dir = str(kaist / "image")
    assert td.load_kaist_image_list(img_dir) == jd.load_kaist_image_list(
        img_dir)

    kitti = tmp_path / "kitti"
    (kitti / "image_02").mkdir(parents=True)
    (kitti / "times.txt").write_text("header\n0.0\n0.1 x\n\n0.2\n0.3\n")
    d = kitti / "image_02"
    (d / "0000000000.jpg").write_bytes(b"")
    (d / "0000000001.png").write_bytes(b"")
    (d / "0000000002.jpg").write_bytes(b"")
    (d / "0000000002.png").write_bytes(b"")
    got = td.load_kitti_image_list(str(d))
    assert got == jd.load_kitti_image_list(str(d))
    assert [os.path.basename(f.image_path) for f in got] == [
        "0000000000.jpg", "0000000001.png", "0000000002.jpg",
        "0000000003.jpg"]

    rng = np.random.RandomState(0)
    rows = ["# stamp,...", ""]
    for k in range(7):
        vals = rng.randn(13)
        rows.append(",".join([str(1544590798702863000 + k * 5000000)]
                             + [repr(float(v)) for v in vals]))
    rows.append("1,2,3")  # short rows are skipped
    csv = tmp_path / "xsens_imu.csv"
    csv.write_text("\n".join(rows) + "\n")
    for a, b in zip(td.load_kaist_imu(str(csv)), jd.load_kaist_imu(str(csv))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    image = "/data/seq/image/1544590798702863000.png"
    assert td.sibling_input_paths(image) == jd.sibling_input_paths(image)


def test_write_tree_reads_back(tmp_path):
    """chip_smoke.write_tree's KAIST and KITTI trees list and read back as
    written."""
    rng = np.random.RandomState(2)
    frames = [(rng.randint(0, 256, (6, 10, 3)).astype(np.uint8),
               rng.randint(0, 65536, (6, 10)).astype(np.uint16),
               rng.randn(6, 10, 2).astype(np.float32),
               rng.randint(0, 4, (6, 10)).astype(np.uint8), k / 10.0)
              for k in range(3)]
    imu = (np.arange(1, 13) / 200.0, rng.randn(12, 3).astype(np.float32),
           rng.randn(12, 3).astype(np.float32))
    for kind in ("kaist", "kitti"):
        ent = chip_smoke.write_tree(str(tmp_path / kind), kind, frames,
                                    imu=imu if kind == "kaist" else None)
        lister = (td.load_kaist_image_list if kind == "kaist"
                  else td.load_kitti_image_list)
        listed = lister(ent["image_path"])
        assert [f.timestamp for f in listed] == [0.0, 0.1, 0.2]
        for fr, (bgr, depth, flow, mask, _) in zip(listed, frames):
            if kind == "kaist":
                raw = td.imread(fr.image_path, td.IMREAD_GRAYSCALE)
                np.testing.assert_array_equal(
                    raw, chip_smoke.mosaic_bayer_bg(bgr))
            else:
                np.testing.assert_array_equal(
                    td.imread(fr.image_path, td.IMREAD_COLOR), bgr)
            flo_p, dep_p, msk_p = td.sibling_input_paths(fr.image_path)
            np.testing.assert_array_equal(td.read_flo(flo_p), flow)
            np.testing.assert_array_equal(td.load_depth_png(dep_p), depth)
            np.testing.assert_array_equal(td.load_mask_png(msk_p), mask)
    t, acc, gyro = td.load_kaist_imu(str(tmp_path / "kaist" /
                                         "xsens_imu.csv"))
    np.testing.assert_array_equal(t, np.round(imu[0] * 1e9) / 1e9)
    np.testing.assert_array_equal(acc, imu[1])
    np.testing.assert_array_equal(gyro, imu[2])


def test_gt_poses_equal_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        row = rng.randn(12) * [1, 1, 1, 1, 1, 1, 10, 2, 30, 3, 1, 1]
        np.testing.assert_allclose(tg.obj_pose_parsing_kt(row),
                                   jg.obj_pose_parsing_kt(row), rtol=0,
                                   atol=1e-12)
        origin = np.linalg.inv(jg.obj_pose_parsing_kt(rng.randn(12)))
        for o in (None, origin):
            np.testing.assert_allclose(tg.obj_pose_parsing_ox(row, o),
                                       jg.obj_pose_parsing_ox(row, o),
                                       rtol=0, atol=1e-12)
    zero = np.zeros(8)
    np.testing.assert_allclose(tg.obj_pose_parsing_ox(zero),
                               jg.obj_pose_parsing_ox(zero), atol=1e-12)
