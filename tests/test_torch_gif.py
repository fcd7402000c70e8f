"""The port's GIF reader (``io/gif.py`` with ``csrc/gif_decode.cpp``)
through ``io/datasets.imread`` against ``cv2.imread`` (OpenCV 5.0's own GIF
decoder; IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_ANYDEPTH) and through
``read_rgb_pil`` against PIL's ``Image.open(p).convert("RGB")``, on the
same bytes; the C++ LZW decoder against its Python version.

The files: PIL's and cv2's writers, the port's own ``viz`` animation, and
``tests/image_encoders.py``'s ``write_gif``/``gif_frame``/``gif_lzw``/
``gif_pack``: global and local tables of every size, interlaced rows,
frames smaller than their screen (and past it), backgrounds, transparent
indices, disposal methods, minimum code sizes 1-12, the deferred clear,
clears every few codes, extensions and application blocks, animations,
LZW streams cut short, running long, holding codes past the table; cut and
corrupt files. Found by probe and held here: cv2 walks every block to the
trailer before it decodes (a cut file or a missing trailer is None), takes
only NETSCAPE2.0 and XMP application blocks, looks indices up in the local
table written over the global one, fails on a string that crosses the
pixel count (but not on one that starts at it), and reads a table-less file
through a default table; PIL decodes until the frame is full and raises at
an end code or the end of the data before that. Bar: bit-equal, None where
cv2 gives None, a raise where PIL raises.
"""

import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from tests.image_encoders import (gif_blocks, gif_frame, gif_lzw, gif_pack,
                                  write_gif)
from vido_slam_tpu_torch.io import datasets as td
from vido_slam_tpu_torch.io import gif

FLAGS = (td.IMREAD_COLOR, td.IMREAD_GRAYSCALE, td.IMREAD_ANYDEPTH)


def _check(tmp_path, data):
    """The port (C++ and plain LZW) against cv2's three reads and PIL;
    returns (cv2's colour read gave an image, PIL did)."""
    path = str(tmp_path / "x.gif")
    with open(path, "wb") as f:
        f.write(data)
    seen = []
    for flag in FLAGS:
        ref = cv2.imread(path, flag)
        for got in (td.imread(path, flag), gif.read_cv2(data, flag,
                                                        plain=True)):
            if ref is None:
                assert got is None, flag
            else:
                assert got is not None and got.shape == ref.shape, flag
                np.testing.assert_array_equal(got, ref)
        seen.append(ref is not None)
    try:
        ref = np.asarray(Image.open(path).convert("RGB"))
    except (OSError, ValueError, SyntaxError, Image.DecompressionBombError):
        for plain in (False, True):
            with pytest.raises((OSError, ValueError)):
                gif.read_pil(data, plain=plain)
        with pytest.raises((OSError, ValueError)):
            td.read_rgb_pil(path)
        return seen[0], False
    np.testing.assert_array_equal(td.read_rgb_pil(path), ref)
    np.testing.assert_array_equal(gif.read_pil(data, plain=True), ref)
    return seen[0], True


def _random_gif(rng):
    """A GIF of random layout: table sizes, a local table, the frame's
    place on its screen (now and then past it), a transparent index, the
    disposal method, the minimum code size, the clears, extensions, a
    second frame."""
    bits = rng.randint(1, 9)
    npal = 1 << bits
    pal = rng.randint(0, 256, (npal, 3))
    w, h = rng.randint(1, 30, 2)
    top = rng.randint(0, npal if rng.rand() < 0.9 else 256)
    idx = rng.randint(0, max(1, top), (h, w)).astype(np.uint8)
    if rng.rand() < 0.3:
        idx[:] = rng.randint(0, npal)
    sw = w + rng.randint(0, 5) * (rng.rand() < 0.5)
    sh = h + rng.randint(0, 5) * (rng.rand() < 0.5)
    off = (rng.randint(0, sw - w + 1), rng.randint(0, sh - h + 1))
    if rng.rand() < 0.05:
        off = (off[0] + 2, off[1])
    loc = rng.rand() < 0.3
    glob = rng.rand() < 0.85 or not loc
    if rng.rand() < 0.05:
        glob = loc = False
    lpal = rng.randint(0, 256, (1 << rng.randint(1, 9), 3)) if loc else None
    if rng.rand() < 0.1 and glob:
        pal = np.repeat(np.arange(npal)[:, None], 3, 1)     # the gray ramp
    mcs = min(11, max(2, int(idx.max()).bit_length()) + (
        rng.randint(0, 3) if rng.rand() < 0.2 else 0))
    lzw = {}
    if rng.rand() < 0.2:
        lzw["clear_when_full"] = False
    if rng.rand() < 0.1:
        lzw["early_clear"] = int(rng.randint(1, 20))
    tr = int(rng.randint(0, npal)) if rng.rand() < 0.3 else None
    frames = [gif_frame(idx, offset=off, palette=lpal,
                        interlace=rng.rand() < 0.3, min_code_size=mcs,
                        transparency=tr,
                        disposal=int(rng.choice([0, 0, 1, 2, 3, 4])), **lzw)]
    if rng.rand() < 0.2:
        frames.append(gif_frame(rng.randint(0, npal, (h, w)).astype(
            np.uint8)))
    data = write_gif((sw, sh), frames, palette=pal if glob else None,
                     background=int(rng.randint(0, npal + 2 * (
                         rng.rand() < 0.05))))
    at = 13 + (3 * npal if glob else 0)
    ext = [b"", b"!\xfe" + gif_blocks(b"comment"),
           b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"][rng.choice(
               [0, 0, 0, 1, 2])]
    return data[:at] + ext + data[at:]


@pytest.mark.parametrize("seed", range(20))
def test_random_gifs_read_as_cv2_and_pil(tmp_path, seed):
    """Random layouts, each also cut and with bytes overwritten."""
    rng = np.random.RandomState(seed)
    for _ in range(12):
        data = _random_gif(rng)
        _check(tmp_path, data)
        _check(tmp_path, data[:rng.randint(13, len(data))])
        bad = bytearray(data)
        for i in rng.randint(13, len(data), rng.randint(1, 4)):
            bad[i] = rng.randint(256)
        _check(tmp_path, bytes(bad))


PAL = np.array([[i * 30, 255 - i * 30, i * 7] for i in range(8)])


def _codes(tmp_path, codes, w=4, h=2, mcs=3, tail=b""):
    fr = gif_frame(np.zeros((h, w), np.uint8), lzw=gif_pack(codes, mcs)
                   + tail, min_code_size=mcs)
    return _check(tmp_path, write_gif((w, h), [fr], palette=PAL))


@pytest.mark.parametrize("case,codes,want", [
    ("exact", [8, 1, 2, 3, 4, 5, 6, 7, 0, 9], (True, True)),
    ("no clear first", [1, 2, 3, 4, 5, 6, 7, 0, 9], (True, True)),
    ("no end code", [8, 1, 2, 3, 4, 5, 6, 7, 0], (True, True)),
    ("early end", [8, 1, 2, 3, 9], (False, False)),
    ("one more", [8, 1, 2, 3, 4, 5, 6, 7, 0, 1, 9], (True, True)),
    ("two more", [8, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 9], (False, True)),
    ("string across the end", [8, 1, 2, 3, 4, 5, 6, 7, 10, 9],
     (False, True)),
    ("string at the end", [8, 1, 2, 3, 4, 5, 6, 7, 0, 10, 9],
     (True, True)),
    ("code past the table", [8, 1, 12, 2, 9], (False, False)),
    ("table code after a clear", [8, 10, 1, 9], (False, False)),
    ("kwkwk", [8, 1, 10, 11, 2, 3, 9], (True, True)),
    ("end then the rest", [8, 1, 2, 3, 9, 4, 5, 6, 7, 0], (True, False)),
    ("clear mid stream", [8, 1, 2, 3, 4, 10, 8, 5, 6, 9], (True, True)),
    ("double clear", [8, 8, 1, 2, 3, 4, 5, 6, 7, 0, 9], (True, True)),
    ("code past the table once full", [8, 1, 2, 3, 4, 5, 6, 7, 1, 30],
     (True, True)),
    ("two past the table once full", [8, 1, 2, 3, 4, 5, 6, 7, 1, 30, 31],
     (True, True)),
    ("code past the table before full", [8, 1, 2, 3, 4, 5, 6, 7, 30],
     (False, False))])
def test_lzw_streams_end_as_cv2_and_pil_end_them(tmp_path, case, codes,
                                                  want):
    """Code streams that end early, run long, hold codes past the table or
    an end code inside them: each library's own stopping rules (cv2 takes
    a code past the table once the image is full)."""
    assert _codes(tmp_path, codes) == want


@pytest.mark.parametrize("mcs", [1, 2, 5, 8, 11, 12])
def test_minimum_code_sizes(tmp_path, mcs):
    """cv2 takes minimum code sizes 2-11, PIL 1-12."""
    clear = 1 << mcs
    assert _codes(tmp_path, [clear, 1, 0, 1, 1, 0, 0, 1, 0, clear + 1],
                  mcs=mcs) == (2 <= mcs <= 11, True)


@pytest.mark.parametrize("case", [
    "two frames", "comment", "netscape", "xmp", "other application",
    "plain text", "unknown label", "stray byte", "stray byte after",
    "data after trailer", "gce after image", "gce of 5", "gce of 3",
    "two gces", "no image", "no trailer", "empty screen", "empty frame",
    "frame past screen", "background past table", "disposal 4",
    "animation", "interlaced 1 row", "interlaced 9 rows"])
def test_block_structure_as_cv2_and_pil(tmp_path, case):
    """The blocks around the image: what cv2's frame count walk and PIL's
    block loop each accept."""
    idx = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.uint8)
    f1, f2 = gif_frame(idx), gif_frame(idx[::-1].copy())
    head = write_gif((4, 2), [], palette=PAL, trailer=False)
    blocks = {
        "two frames": f1 + f2, "comment": b"!\xfe" + gif_blocks(b"x" * 300)
        + f1, "netscape": b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00" + f1,
        "xmp": b"!\xff\x0bXMP DataXMP" + gif_blocks(b"<x/>") + f1,
        "other application": b"!\xff\x0bANIMEXTS1.0\x03\x01\x00\x00\x00"
        + f1, "plain text": b"!\x01" + gif_blocks(b"x" * 12) + f1,
        "unknown label": b"!\x42" + gif_blocks(b"abc") + f1,
        "stray byte": b"\x00" + f1, "stray byte after": f1 + b"\x00",
        "gce after image": f1 + b"!\xf9\x04\x00\x00\x00\x00\x00",
        "gce of 5": b"!\xf9\x05\x01\x00\x00\x03\x00\x00" + f1,
        "gce of 3": b"!\xf9\x03\x01\x00\x00\x00" + f1,
        "two gces": b"!\xf9\x04\x01\x00\x00\x03\x00!\xf9\x04\x00\x00\x00"
        b"\x00\x00" + f1, "no image": b""}
    if case in blocks:
        data = head + blocks[case] + b";"
    elif case == "data after trailer":
        data = head + f1 + b";garbage"
    elif case == "no trailer":
        data = head + f1
    elif case == "empty screen":
        data = write_gif((0, 0), [f1], palette=PAL)
    elif case == "empty frame":
        data = head + b"\x2c" + bytes(4) + b"\x00\x00\x02\x00\x00\x03" + \
            gif_blocks(gif_lzw(b"", 3)) + b";"
    elif case == "frame past screen":
        data = write_gif((4, 2), [gif_frame(idx, offset=(1, 1))],
                         palette=PAL)
    elif case == "background past table":
        data = write_gif((6, 4), [gif_frame(idx, offset=(1, 1))],
                         palette=PAL, background=200)
    elif case == "disposal 4":
        data = write_gif((4, 2), [gif_frame(idx, disposal=4)], palette=PAL)
    elif case == "animation":
        data = write_gif((4, 2), [gif_frame(idx, transparency=2,
                                            disposal=2), f2, f1],
                         palette=PAL)
    else:
        rows = 1 if case == "interlaced 1 row" else 9
        data = write_gif((3, rows), [gif_frame(
            np.arange(3 * rows).reshape(rows, 3).astype(np.uint8) % 8,
            interlace=True)], palette=PAL)
    _check(tmp_path, data)


@pytest.mark.parametrize("case", [
    "global only", "local over global", "local longer", "local only",
    "no table", "ramp", "index past tables", "transparent outside"])
def test_tables_and_screen_as_cv2_and_pil(tmp_path, case):
    """Which colours the indices take: cv2 writes the local table over the
    global one (its entries past the local table stay) and fails past
    both, fills the screen with the global background colour and leaves
    transparent pixels so; PIL uses the frame's table (black past it; the
    gray ramp or no table gives each index its gray) and fills the screen
    with the transparent index or 0."""
    rng = np.random.RandomState(len(case))
    g = rng.randint(0, 256, (16, 3))
    loc = rng.randint(0, 256, (4, 3))
    idx = rng.randint(0, 16, (5, 7)).astype(np.uint8)
    kw, screen, frame = dict(palette=g, background=5), (9, 8), {}
    if case == "local over global":
        frame = dict(palette=loc)
        idx %= 4
    elif case == "local longer":
        frame = dict(palette=rng.randint(0, 256, (32, 3)))
        kw["palette"] = loc
        idx = rng.randint(0, 32, (5, 7)).astype(np.uint8)
    elif case == "local only":
        frame, kw = dict(palette=rng.randint(0, 256, (16, 3))), {}
    elif case == "no table":
        kw = {}
    elif case == "ramp":
        kw["palette"] = np.repeat(np.arange(16)[:, None], 3, 1)
        idx[0, 0] = 15
    elif case == "index past tables":
        frame = dict(palette=loc, min_code_size=4)
        kw["palette"] = rng.randint(0, 256, (8, 3))
    elif case == "transparent outside":
        frame = dict(transparency=5)
    data = write_gif(screen, [gif_frame(idx, offset=(1, 2), **frame)],
                     **kw)
    _check(tmp_path, data)


def test_writers_and_the_ports_own_animation(tmp_path):
    """GIFs of PIL (RGB quantised, gray, interlaced, with transparency, an
    animation), of cv2's writer and of the port's
    ``viz.render_scene_animation`` (what test_torch_viz.py writes)."""
    rng = np.random.RandomState(2)
    for k in range(4):
        h, w = rng.randint(1, 40, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if k % 2:
            img = cv2.GaussianBlur(img, (5, 5), 2)
        for kw, im in ((dict(), Image.fromarray(img)),
                       (dict(), Image.fromarray(img).convert("L")),
                       (dict(interlace=True, transparency=2),
                        Image.fromarray(img).quantize(8)),
                       (dict(save_all=True, append_images=[
                           Image.fromarray(img[::-1].copy())]),
                        Image.fromarray(img))):
            buf = io.BytesIO()
            im.save(buf, "GIF", **kw)
            assert _check(tmp_path, buf.getvalue()) == (True, True)
        ok, enc = cv2.imencode(".gif", img)
        assert ok and _check(tmp_path, enc.tobytes()) == (True, True)
    import matplotlib

    from tests.test_torch_viz import _map
    from vido_slam_tpu_torch import slam_map, viz

    matplotlib.use("Agg", force=True)
    path = str(tmp_path / "scene.gif")
    viz.render_scene_animation(_map(slam_map), path, stride=2, fps=5,
                               figsize=2.0, dpi=40)
    with open(path, "rb") as f:
        assert _check(tmp_path, f.read()) == (True, True)


def test_cpp_lzw_equals_plain():
    """``gif_lzw_decode`` against ``lzw_decode_plain`` in both modes on
    valid streams and on random bytes (indices and return codes)."""
    rng = np.random.RandomState(5)
    for k in range(200):
        mcs = int(rng.randint(2, 9))
        if k % 2:
            data = gif_blocks(gif_lzw(rng.randint(0, 1 << mcs, rng.randint(
                1, 400)).astype(np.uint8).tobytes(), mcs,
                clear_when_full=bool(k % 3)))
        else:
            data = bytes(rng.randint(0, 256, rng.randint(1, 300)).astype(
                np.uint8))
        npix = int(rng.randint(1, 500))
        img = gif.Image(0, 0, npix, 1, False, None, mcs, 0, None, 0, -1)
        for pil in (False, True):
            a = gif.lzw_decode(data, img, pil)
            b = gif.lzw_decode(data, img, pil, plain=True)
            assert a[1] == b[1]
            np.testing.assert_array_equal(a[0], b[0])


def test_committed_gif_fixtures_read_as_cv2_and_pil(tmp_path):
    """What chip_smoke.py phase (u1) checks on the card for tests/data/gif,
    here also against cv2 and PIL themselves."""
    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert chip_smoke.check_format_fixtures(root, ("gif",)) == 9 * 7
    directory = os.path.join(root, "tests", "data", "gif")
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            _check(tmp_path, f.read())
