"""Write the JPEG fixtures of the port's decoder under tests/data/jpeg/ with
cv2 (libjpeg-turbo), and beside them the arrays ``cv2.imread`` decodes from
them: the card's machine has no cv2, so chip_smoke.py phase (k) holds
``vido_slam_tpu_torch.io.jpeg`` to these committed arrays.

  layouts/<name>.jpg   small frames (45 x 61, quality 90) of each sampling
                       layout (4:4:4, 4:2:2, 4:2:0, 4:4:0), a restart
                       interval, optimised Huffman tables and a gray file;
  layouts.npz          cv2.imread of each with IMREAD_COLOR ("<name>") and
                       IMREAD_GRAYSCALE ("<name>_gray");
  kitti/<10 digits>.jpg  the synthetic KITTI scene of chip_smoke.py (h3)
                       (1242 x 375, chip_smoke.KITTI_CONFIG's camera,
                       rendered on the CPU by io/synthetic.py), quality 95;
  kitti.npz            cv2.imread of frame 0 ("frame0") and the SHA-256 of
                       cv2.imread of every frame ("sha256", in order).

Run from the repository root: ``python tools/make_jpeg_fixtures.py``.
"""

from __future__ import annotations

import hashlib
import os
import sys

import cv2
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "data", "jpeg")
KITTI_FRAMES = 24

# name -> extra cv2.imwrite parameters
LAYOUTS = {
    "s444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111],
    "s422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111],
    "s420": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111],
    "s440": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x121111],
    "restart": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111,
                cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
    "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    "gray": [],
}


def textured(h: int, w: int, seed: int) -> np.ndarray:
    """A BGR frame of gradients, edges and noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 5 + yy * 3) % 256, (yy * 7) % 256,
                     np.where((xx // 8 + yy // 8) % 2, 220, 30)], -1)
    noise = rng.randint(0, 256, (h, w, 3))
    return np.where(rng.rand(h, w, 1) < 0.25, noise, base).astype(np.uint8)


def kitti_frames(n: int):
    """chip_smoke.py's KITTI scene rendered on the CPU, BGR uint8."""
    import chip_smoke
    from vido_slam_tpu_torch.io.synthetic import render_rgb

    seq = chip_smoke.offline_sequence(n, "cpu", chip_smoke.KITTI_CONFIG)
    for fr in seq.frames:
        rgb = render_rgb(seq.scene, torch.as_tensor(fr.Tcw_gt),
                         [torch.as_tensor(p) for p in fr.box_poses])
        yield torch.round(rgb.flip(-1)).to(torch.uint8).numpy()


def main() -> None:
    os.makedirs(os.path.join(OUT, "layouts"), exist_ok=True)
    os.makedirs(os.path.join(OUT, "kitti"), exist_ok=True)
    arrays = {}
    for i, (name, extra) in enumerate(LAYOUTS.items()):
        img = textured(45, 61, i)
        if name == "gray":
            img = img[..., 1]
        path = os.path.join(OUT, "layouts", name + ".jpg")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 90] + extra)
        arrays[name] = cv2.imread(path, cv2.IMREAD_COLOR)
        arrays[name + "_gray"] = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.savez_compressed(os.path.join(OUT, "layouts.npz"), **arrays)
    digests, frame0 = [], None
    for k, bgr in enumerate(kitti_frames(KITTI_FRAMES)):
        path = os.path.join(OUT, "kitti", f"{k:010d}.jpg")
        assert cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, 95])
        dec = cv2.imread(path, cv2.IMREAD_COLOR)
        digests.append(hashlib.sha256(dec.tobytes()).hexdigest())
        frame0 = dec if frame0 is None else frame0
    np.savez_compressed(os.path.join(OUT, "kitti.npz"), frame0=frame0,
                        sha256=np.array(digests))
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(OUT) for f in fs)
    print(f"fixtures written under {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
