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
        reads and of PIL's RGB, as above.

Run from the repository root: ``python tools/make_image_fixtures.py``.
"""

from __future__ import annotations

import hashlib
import os
import sys

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests.image_encoders import (Scan, drop_segments,  # noqa: E402
                                  reencode_jpeg, write_bmp)
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


def digest(img: np.ndarray) -> str:
    """An image's shape and the SHA-256 of its bytes, "h,w[,c]:<hex>"."""
    return ",".join(map(str, img.shape)) + ":" + hashlib.sha256(
        np.ascontiguousarray(img).tobytes()).hexdigest()


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
    paths = [os.path.join(d, f) for sub in ("progressive", "bmp")
             for d, _, fs in os.walk(os.path.join(OUT, sub)) for f in fs]
    total = sum(map(os.path.getsize, paths + [os.path.join(OUT, "bmp.npz")]))
    print(f"fixtures written under {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
