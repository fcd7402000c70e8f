"""Dataset IO of the offline demo without cv2 — counterpart of
``vido_slam_tpu/io/datasets.py`` (the reference's loaders,
run_vido_slam.cc:14-65, 112-137, and run_vido.cc:195-215):

  - KAIST: the image list from vTimestampsImage.txt (nanosecond stamps ->
    "<stamp>.png"), xsens_imu.csv (col 0 stamp ns, gyro cols 8-10, acc
    cols 11-13), and the BayerBG -> BGR demosaic of the raw camera frames;
  - KITTI: the image list from times.txt (10-digit frame names, .jpg else
    .png);
  - Middlebury .flo optical flow (cv::readOpticalFlow);
  - 16-bit depth PNGs and 8-bit mask PNGs (run_vido_slam.cc:118-122),
    or any other file ``cv2.imread`` reads under those names.

Images are read by ``imread`` with the semantics of the ``cv2.imread``
flags the demo passes, the format told by the signature as cv2 tells it
(``image_format``), on the port's own decoders: PNG (``io/png.py``),
JPEG (``io/jpeg.py``), BMP (``io/bmp.py``), PBM/PGM/PPM, PAM and PFM
(``io/pxm.py``), TIFF (``io/tiff.py``), Radiance HDR (``io/hdr.py``), Sun
raster (``io/sunras.py``), GIF (``io/gif.py``) and WebP, lossless and
lossy (``io/webp.py``, ``io/vp8.py``); OpenEXR gives None, as cv2 built
without OpenEXR does. The data pipelines, which the JAX package reads
through PIL, read by ``read_rgb_pil`` on the same decoders, each by PIL's
rules, and on those of the formats PIL opens and cv2 does not (Targa,
PCX, SGI, QOI, XBM, IM, ICO, MSP). JPEG 2000 and AVIF raise ValueError
naming their ROADMAP.md queue 1 item.
"""

from __future__ import annotations

import os
import struct
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from vido_slam_tpu_torch.io import (bmp, gif, hdr, ico, im, jpeg, msp,
                                    pcx, pil_open, png, pxm, qoi, sgi,
                                    sunras, tga, tiff, webp, xbm)

FLO_MAGIC = 202021.25

# cv2's values of the imread flags
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1
IMREAD_ANYDEPTH = 2


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo (the format cv::readOpticalFlow parses): magic f32,
    width i32, height i32, then h*w*2 f32 (u, v) interleaved."""
    with open(path, "rb") as f:
        magic = struct.unpack("<f", f.read(4))[0]
        if abs(magic - FLO_MAGIC) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = struct.unpack("<i", f.read(4))[0]
        h = struct.unpack("<i", f.read(4))[0]
        data = np.frombuffer(f.read(h * w * 2 * 4), dtype="<f4")
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<f", FLO_MAGIC))
        f.write(struct.pack("<i", w))
        f.write(struct.pack("<i", h))
        f.write(np.ascontiguousarray(flow, dtype="<f4").tobytes())


# the formats whose signatures cv2 knows and the port does not decode, by
# the queue 1 item of ROADMAP.md that names each. OpenEXR is not among
# them: the cv2 the port copies is built without it ("OpenEXR: NO") and
# gives None; PIL has no plugin.
REFUSED = {"jpeg2000": ("JPEG 2000", "26b"), "avif": ("AVIF", "28b")}


def _avif(data: bytes) -> bool:
    """libavif's ``avifPeekCompatibleFileType``: an ``ftyp`` box whose
    major or compatible brands name ``avif`` or ``avis``."""
    if len(data) < 16 or data[4:8] != b"ftyp":
        return False
    size = struct.unpack(">I", data[:4])[0]
    if not 16 <= size <= len(data):
        return False
    brands = [data[8:12]] + [data[i:i + 4] for i in range(16, size - 3, 4)]
    return b"avif" in brands or b"avis" in brands


def image_format(data: bytes) -> Optional[str]:
    """The decoder ``cv2.imread`` picks for the bytes: each of OpenCV's
    decoders' ``checkSignature`` in the order ``loadsave.cpp::findDecoder``
    tries them (None where none claims the file, which cv2 does not
    read)."""
    if data[:2] == bmp.SIGNATURE:
        return "bmp"
    if data.startswith(hdr.SIGNATURES):
        return "hdr"
    if data[:3] == jpeg.SIGNATURE + b"\xff":
        return "jpeg"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP" and \
            data[12:16] in (b"VP8 ", b"VP8L", b"VP8X"):
        return "webp"
    if _avif(data):
        return "avif"
    if data[:4] == sunras.SIGNATURE:
        return "sunras"
    if pxm.is_pxm(data):
        return "pxm"
    if pxm.is_pam(data):
        return "pam"
    if pxm.is_pfm(data):
        return "pfm"
    if data[:4] in tiff.SIGNATURES:
        return "tiff"
    if data.startswith(png.SIGNATURE):
        return "png"
    if data.startswith((b"\x00\x00\x00\x0cjP  \r\n\x87\n",
                        b"\xff\x4f\xff\x51")):
        return "jpeg2000"
    if data[:4] == b"\x76\x2f\x31\x01":
        return "openexr"
    if data[:6] in gif.SIGNATURES:
        return "gif"
    return None


def _refuse(path: str, fmt: str) -> None:
    name, item = REFUSED[fmt]
    raise ValueError(f"{path}: {name} images are not supported (ROADMAP.md "
                     f"queue 1 item {item})")


def rgb_to_gray(px: np.ndarray) -> np.ndarray:
    """libpng's ``png_set_rgb_to_gray`` as cv2 sets it (red 0.299, green
    0.587, fixed point: 9797, 19234 and 3737 / 32768): truncated at 8
    bits, rounded at 16, on (..., 3) RGB samples."""
    v = px[..., :3].astype(np.int64)
    s = 9797 * v[..., 0] + 19234 * v[..., 1] + 3737 * v[..., 2]
    if px.dtype == np.uint16:
        return ((s + 16384) >> 15).astype(np.uint16)
    return (s >> 15).astype(np.uint8)


def imread(path: str, flags: int = IMREAD_COLOR) -> Optional[np.ndarray]:
    """``cv2.imread(path, flags)``, bit-equal to it, the format told by the
    file's signature as cv2 tells it (``image_format``, not by the
    extension): PNG, JPEG, BMP, PBM/PGM/PPM, PAM, PFM, TIFF, Radiance HDR,
    Sun raster, GIF and lossless WebP. ``IMREAD_COLOR`` gives (H, W, 3)
    uint8 BGR (gray replicated, alpha dropped, 16-bit samples cut to their
    high byte);
    ``IMREAD_GRAYSCALE`` (H, W) uint8; ``IMREAD_ANYDEPTH`` (H, W) at the
    file's depth (uint16 for 16-bit PNG, PxM and TIFF samples, float32 for
    PFM, HDR and float TIFF), colour turned gray by each decoder's weights
    (libpng's for a PNG, libjpeg's Y plane for a JPEG). A JPEG's or TIFF's
    orientation is applied, as cv2 applies it. A missing file, or one that
    is no decodable image (a bad signature, truncation, CRC, inflate), gives
    None, as in cv2. A valid file of a mode or format the decoders lack
    raises ``ValueError`` naming its ROADMAP.md queue 1 item: cv2 decodes
    it, so returning None would skip a frame silently. OpenEXR gives None,
    as cv2 built without OpenEXR does. A header past cv2's size limits
    (``limits.check_cv2_size``) raises ``ImageTooLarge``, where cv2
    raises too."""
    if not os.path.exists(path):
        return None
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_ANYDEPTH):
        raise ValueError(f"imread flags {flags} are not supported")
    with open(path, "rb") as f:
        data = f.read()
    fmt = image_format(data)
    if fmt in REFUSED:
        _refuse(path, fmt)
    if fmt == "openexr":
        return None
    if fmt == "gif":
        return gif.read_cv2(data, flags)
    if fmt == "webp":
        return webp.read_cv2(data, flags)
    if fmt == "jpeg":
        try:
            return jpeg.decode_jpeg(data, gray=flags != IMREAD_COLOR)
        except jpeg.CorruptJpeg:
            return None
    if fmt == "bmp":
        return bmp.read_cv2(data, color=flags == IMREAD_COLOR)
    if fmt in ("pxm", "pam", "pfm"):
        return pxm.read_cv2(data, flags)
    if fmt == "tiff":
        return tiff.read_cv2(data, flags)
    if fmt == "hdr":
        return hdr.read_cv2(data, flags)
    if fmt == "sunras":
        return sunras.read_cv2(data, flags)
    if fmt != "png":
        return None
    try:
        img = png.decode_png(data, imread_limits=True)
    except png.CorruptPng:
        return None
    px = img.pixels
    gray = px.shape[-1] < 3
    if flags == IMREAD_COLOR:
        px = px >> 8 if img.bit_depth == 16 else px
        px = px.astype(np.uint8)
        if gray:
            return np.repeat(px[..., :1], 3, axis=-1)
        return np.ascontiguousarray(px[..., 2::-1])
    px = px[..., 0] if gray else rgb_to_gray(px)
    if flags == IMREAD_GRAYSCALE and img.bit_depth == 16:
        px = (px >> 8).astype(np.uint8)
    return np.ascontiguousarray(px)


def _jpeg_pil(data: bytes) -> np.ndarray:
    return np.ascontiguousarray(jpeg.decode_jpeg(
        data, exif_orientation=False, strict=True, pil=True)[..., ::-1])


# the reader of each PIL plugin the port reads (``pil_open.PLUGINS``' names)
_PIL_READERS = {"BMP": bmp.read_pil, "DIB": bmp.read_pil_dib,
                "GIF": gif.read_pil, "JPEG": _jpeg_pil, "PPM": pxm.read_pil,
                "PNG": png.read_pil, "PCX": pcx.read_pil,
                "ICO": ico.read_pil, "IM": im.read_pil, "TIFF": tiff.read_pil,
                "MSP": msp.read_pil, "QOI": qoi.read_pil, "SGI": sgi.read_pil,
                "SUN": sunras.read_pil, "TGA": tga.read_pil,
                "WEBP": webp.read_pil, "XBM": xbm.read_pil}
# PIL's plugins of the formats that cv2 reads too and the port refuses
_PIL_REFUSED = {"JPEG2000": "jpeg2000", "AVIF": "avif"}
PIL_ITEM = "ROADMAP.md queue 1 item 29b"


def read_rgb_pil(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))``, bit-equal to PIL:
    (H, W, 3) uint8 RGB. The plugin is the one ``Image.open`` picks
    (``pil_open.pil_format``: PIL's plugins in their order, each by its
    own header tests, not by the extension), and each plugin the port
    reads has its module's ``read_pil``: BMP and DIB, GIF, JPEG (no EXIF
    orientation; CMYK as PIL inverts and converts it), PBM/PGM/PPM and
    ``Pf`` PFM, PNG (16-bit gray clipped at 255), PCX, ICO, IM, TIFF, MSP,
    QOI, SGI, Sun raster, Targa, lossless WebP and XBM. A missing file,
    one no plugin takes ("cannot identify image file"), one past PIL's
    decompression bomb limit (``limits.DecompressionBombError``, from the
    header) or one its plugin fails on raises, as ``Image.open`` and
    ``convert`` do; EPS fails as PIL fails without Ghostscript. Lossy
    WebP, JPEG 2000 and AVIF raise ``ValueError`` naming their queue 1
    item, and the plugins no reader ports (DDS, ICNS, PSD, ...) item
    29b."""
    with open(path, "rb") as f:
        data = f.read()
    fmt = pil_open.pil_format(data)
    if fmt in _PIL_READERS:
        return _PIL_READERS[fmt](data)
    if fmt in _PIL_REFUSED:
        _refuse(path, _PIL_REFUSED[fmt])
    if fmt in pil_open.FAILING:
        raise pil_open.PluginFails(f"{path}: {pil_open.FAILING[fmt]}")
    raise ValueError(f"{path}: PIL's {fmt} images are not supported "
                     f"({PIL_ITEM})")


def demosaic_bayer_bg2bgr(raw: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(raw, cv2.COLOR_BayerBG2BGR)``, bit-equal on every pixel
    (the reference demosaics the KAIST stream so, run_vido_slam.cc:114-117).
    BayerBG: R at (even, even), B at (odd, odd), G elsewhere. Each interior
    pixel keeps its own colour; a colour missing there is the rounded mean
    of its nearest samples: (sum of 4 + 2) >> 2 over the four diagonal or
    the four edge neighbours, (sum of 2 + 1) >> 1 over a horizontal or
    vertical pair. The border copies its inner neighbour: columns 0 and
    W-1 of the interior rows, then rows 0 and H-1 whole. An image with
    fewer than 3 rows or columns comes out zero, as in cv2."""
    raw = np.asarray(raw)
    if raw.ndim != 2 or raw.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"a (H, W) uint8 or uint16 Bayer frame, not "
                         f"{raw.shape} {raw.dtype}")
    H, W = raw.shape
    out = np.zeros((H, W, 3), raw.dtype)
    if H < 3 or W < 3:
        return out
    r = raw.astype(np.int32)
    c = r[1:-1, 1:-1]
    up, down = r[:-2, 1:-1], r[2:, 1:-1]
    left, right = r[1:-1, :-2], r[1:-1, 2:]
    diag = (r[:-2, :-2] + r[:-2, 2:] + r[2:, :-2] + r[2:, 2:] + 2) >> 2
    cross = (up + down + left + right + 2) >> 2
    horiz = (left + right + 1) >> 1
    vert = (up + down + 1) >> 1
    y = (np.arange(1, H - 1) % 2)[:, None]
    x = (np.arange(1, W - 1) % 2)[None, :]
    r_site = (y == 0) & (x == 0)
    b_site = (y == 1) & (x == 1)
    g_in_r_row = (y == 0) & (x == 1)   # left/right red, up/down blue
    g_in_b_row = (y == 1) & (x == 0)   # left/right blue, up/down red
    sites = [r_site, b_site, g_in_r_row, g_in_b_row]
    blue = np.select(sites, [diag, c, vert, horiz])
    green = np.where(r_site | b_site, cross, c)
    red = np.select(sites, [c, diag, horiz, vert])
    out[1:-1, 1:-1] = np.stack([blue, green, red], axis=-1)
    out[1:-1, 0] = out[1:-1, 1]
    out[1:-1, -1] = out[1:-1, -2]
    out[0] = out[1]
    out[-1] = out[-2]
    return out


class KaistFrame(NamedTuple):
    image_path: str
    timestamp: float


def load_kaist_image_list(image_dir: str) -> List[KaistFrame]:
    """LoadKaistImg (run_vido_slam.cc:47-65): stamps from
    <image_dir>/../vTimestampsImage.txt (first line skipped), image file
    name = the stamp's first 19 characters + .png."""
    time_file = os.path.join(image_dir, "..", "vTimestampsImage.txt")
    frames = []
    with open(time_file) as f:
        lines = f.read().splitlines()[1:]
    for line in lines:
        line = line.strip()
        if not line:
            continue
        stamp = line.split()[0]
        name = stamp[:19] + ".png" if len(stamp) >= 19 else stamp + ".png"
        frames.append(KaistFrame(image_path=os.path.join(image_dir, name),
                                 timestamp=float(stamp) / 1e9))
    return frames


def load_kitti_image_list(image_dir: str) -> List[KaistFrame]:
    """LoadKittiImg (run_vido.cc:195-215): stamps in seconds from
    <image_dir>/../times.txt (first line skipped), 10-digit zero-padded
    frame names, .jpg as in the reference, else .png where only that
    exists."""
    time_file = os.path.join(image_dir, "..", "times.txt")
    with open(time_file) as f:
        lines = f.read().splitlines()[1:]
    times = [float(line.split()[0]) for line in lines if line.strip()]
    frames = []
    for i, t in enumerate(times):
        base = os.path.join(image_dir, f"{i:010d}")
        path = base + ".jpg"
        if not os.path.exists(path) and os.path.exists(base + ".png"):
            path = base + ".png"
        frames.append(KaistFrame(image_path=path, timestamp=t))
    return frames


def load_kaist_imu(csv_path: str):
    """LoadIMU (run_vido_slam.cc:14-45): xsens_imu.csv, stamp ns in col 0,
    gyro cols 8-10, acc cols 11-13. Returns (times_s, acc (N, 3), gyro
    (N, 3))."""
    times, accs, gyros = [], [], []
    with open(csv_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            if len(parts) < 14:
                continue
            times.append(float(parts[0]) / 1e9)
            gyros.append([float(parts[8]), float(parts[9]), float(parts[10])])
            accs.append([float(parts[11]), float(parts[12]), float(parts[13])])
    return (np.asarray(times), np.asarray(accs, np.float32),
            np.asarray(gyros, np.float32))


def load_depth_png(path: str) -> np.ndarray:
    """A 16-bit depth PNG -> float32 raw values (metric later, per
    dataset)."""
    d = imread(path, IMREAD_ANYDEPTH)
    if d is None:
        raise FileNotFoundError(path)
    return d.astype(np.float32)


def load_mask_png(path: str) -> np.ndarray:
    """A mask PNG -> int32 labels (8-bit, as cv2's IMREAD_GRAYSCALE)."""
    m = imread(path, IMREAD_GRAYSCALE)
    if m is None:
        raise FileNotFoundError(path)
    return m.astype(np.int32)


def sibling_input_paths(image_path: str) -> Tuple[str, str, str]:
    """The offline demo reads flow, depth and mask as siblings of the image
    (run_vido_slam.cc:118-122): <stem>.flo, <stem>.png and <stem>.png in
    flow/, depth/ and mask/ beside the image directory."""
    d, name = os.path.split(image_path)
    stem = os.path.splitext(name)[0]
    root = os.path.dirname(d)
    return (os.path.join(root, "flow", stem + ".flo"),
            os.path.join(root, "depth", stem + ".png"),
            os.path.join(root, "mask", stem + ".png"))
