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
