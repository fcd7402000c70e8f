"""Monocular self-supervision data pipeline — the port's copy of
``vido_slam_tpu/data/mono_dataset.py`` (the reference's vendored
MonoDepth2 dataset stack and option set, src/thirdparty/mono_depth2/src/
depricated/{datasets/mono_dataset.py, datasets/kitti_dataset.py,
options.py}).

Semantics kept from mono_dataset.py:
  - each item is a (prev, cur, next) frame triplet (frame_ids 0/-1/1),
    resized to (width, height) (:129-161);
  - 50% random horizontal flip, 50% random color jitter with
    brightness/contrast/saturation 0.2 and hue 0.1 (:77-80, 140-141); the
    SAME jitter is applied to every frame of an item (:175-186) and the
    un-jittered frames are kept for the photometric loss;
  - intrinsics come as a resolution-NORMALISED K scaled by the actual
    width/height (kitti_dataset.py:25-30, mono_dataset.py:163-173).

The loader is host numpy, as the JAX package's is, with PIL and
matplotlib replaced by bit-equal rewrites: frames are read by
``io/datasets.py::read_rgb_pil`` (``Image.open(p).convert("RGB")``),
resized by ``image_ops.resize_lanczos_u8`` and hue-shifted by
``image_ops.rgb_to_hsv``/``hsv_to_rgb``. The draws come from one
``np.random.RandomState(seed)`` in the JAX package's order (flip, aug,
the four jitter factors, then each epoch's shuffle), so an item equals
JAX's draw for draw. ``batch`` gives the port's ``SelfSupBatch`` (NCHW)
on ``device`` (``cuda`` unless the caller passes ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from vido_slam_tpu_torch.data.image_ops import (hsv_to_rgb, resize_lanczos_u8,
                                                rgb_to_hsv)
from vido_slam_tpu_torch.io.datasets import read_rgb_pil
from vido_slam_tpu_torch.models.monodepth2_train import SelfSupBatch
from vido_slam_tpu_torch.utils.device import resolve_device

# KITTI-normalised intrinsics (kitti_dataset.py:25-29): K[0] *= width,
# K[1] *= height at load time.
KITTI_K_NORM = np.array([
    [0.58, 0.0, 0.5, 0.0],
    [0.0, 1.92, 0.5, 0.0],
    [0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
], dtype=np.float32)


@dataclasses.dataclass
class SelfSupOptions:
    """The training options subset of depricated/options.py (defaults kept:
    192x640, scales 0-3, frame_ids 0/-1/1, depth bounds 0.1-100, smoothness
    1e-3, Adam 1e-4, batch 12, 20 epochs)."""
    height: int = 192
    width: int = 640
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    frame_ids: Tuple[int, ...] = (0, -1, 1)
    min_depth: float = 0.1
    max_depth: float = 100.0
    disparity_smoothness: float = 1e-3
    learning_rate: float = 1e-4
    batch_size: int = 12
    num_epochs: int = 20
    scheduler_step_size: int = 15   # lr /10 after this many epochs
    use_stereo: bool = False


def _resize_rgb(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """The antialiased resize of torchvision's Resize(ANTIALIAS)
    (mono_dataset.py:85-86): a float frame goes back to 8 bits by
    truncation (as the JAX package's ``astype(np.uint8)`` does), is
    LANCZOS-resized and returns to [0, 1] float32. A frame at the target
    size is only cast."""
    if img.shape[:2] == (h, w):
        return img.astype(np.float32)
    u8 = (np.clip(img * 255.0, 0, 255).astype(np.uint8)
          if img.dtype != np.uint8 else img)
    return np.asarray(resize_lanczos_u8(u8, h, w), np.float32) / 255.0


def color_jitter(
    img: np.ndarray, brightness: float, contrast: float, saturation: float,
    hue: float,
) -> np.ndarray:
    """Apply one sampled ColorJitter transform: img (H, W, 3) in [0,1] with
    the given multiplicative brightness/contrast/saturation factors and an
    additive hue shift (torchvision functional semantics)."""
    out = np.clip(img * brightness, 0.0, 1.0)
    mean_gray = np.mean(0.299 * out[..., 0] + 0.587 * out[..., 1]
                        + 0.114 * out[..., 2])
    out = np.clip(mean_gray + contrast * (out - mean_gray), 0.0, 1.0)
    gray = (0.299 * out[..., 0] + 0.587 * out[..., 1]
            + 0.114 * out[..., 2])[..., None]
    out = np.clip(gray + saturation * (out - gray), 0.0, 1.0)
    if hue != 0.0:
        hsv = rgb_to_hsv(out)
        hsv[..., 0] = (hsv[..., 0] + hue) % 1.0
        out = hsv_to_rgb(hsv)
    return out.astype(np.float32)


def sample_jitter_params(rng: np.random.RandomState):
    """ColorJitter.get_params with the mono_dataset.py ranges
    (brightness/contrast/saturation 0.2 -> U[0.8, 1.2]; hue 0.1 ->
    U[-0.1, 0.1])."""
    return (rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2),
            rng.uniform(0.8, 1.2), rng.uniform(-0.1, 0.1))


class MonoSequenceDataset:
    """Frame-triplet dataset over a directory (or explicit list) of
    time-ordered images — the KITTIRAWDataset counterpart for generic image
    sequences. Index i addresses the i-th INTERIOR frame (it needs both
    temporal neighbours)."""

    def __init__(
        self,
        images,                      # dir path or list of file paths/arrays
        height: int = 192,
        width: int = 640,
        K_norm: np.ndarray = KITTI_K_NORM,
        is_train: bool = True,
        seed: int = 0,
    ):
        if isinstance(images, str):
            exts = (".png", ".jpg", ".jpeg", ".bmp", ".npy")
            images = sorted(
                p for p in glob.glob(os.path.join(images, "*"))
                if p.lower().endswith(exts))
        self.items: List = list(images)
        if len(self.items) < 3:
            raise ValueError("need at least 3 frames for triplets")
        self.height, self.width = height, width
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)
        K = K_norm.copy()
        K[0] *= width
        K[1] *= height
        # under do_flip the IMAGE is mirrored and K kept, exactly like
        # mono_dataset.py get_color(..., do_flip)
        self.K = K
        self.inv_K = np.linalg.inv(K)

    def __len__(self) -> int:
        return len(self.items) - 2

    def _load(self, i: int) -> np.ndarray:
        it = self.items[i]
        if isinstance(it, np.ndarray):
            arr = it.astype(np.float32)
            if arr.max() > 1.5:
                arr = arr / 255.0
        elif isinstance(it, str) and it.endswith(".npy"):
            arr = np.load(it).astype(np.float32)
            if arr.max() > 1.5:
                arr = arr / 255.0
        else:
            arr = np.asarray(read_rgb_pil(it), np.float32) / 255.0
        return _resize_rgb(arr, self.height, self.width)

    def get_item(self, idx: int):
        """Returns dict with clean + augmented triplet and K/inv_K."""
        i = idx + 1
        frames = [self._load(i - 1), self._load(i), self._load(i + 1)]
        do_flip = self.is_train and self.rng.rand() > 0.5
        do_aug = self.is_train and self.rng.rand() > 0.5
        if do_flip:
            frames = [f[:, ::-1].copy() for f in frames]
        if do_aug:
            b, c, s, h = sample_jitter_params(self.rng)
            aug = [color_jitter(f, b, c, s, h) for f in frames]
        else:
            aug = frames
        return {
            "prev": frames[0], "color": frames[1], "next": frames[2],
            "prev_aug": aug[0], "color_aug": aug[1], "next_aug": aug[2],
            "K": self.K, "inv_K": self.inv_K,
        }

    def batch(self, indices: Sequence[int], device=None) -> SelfSupBatch:
        """Stack items into a SelfSupBatch: frames (N, 3, H, W), K and
        inv_K (N, 4, 4), on ``device``."""
        dev = resolve_device(device)
        its = [self.get_item(i) for i in indices]

        def stack(k):
            x = np.stack([it[k] for it in its])
            if x.ndim == 4:
                x = x.transpose(0, 3, 1, 2)
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        return SelfSupBatch(
            color=stack("color"), prev=stack("prev"), next=stack("next"),
            K=stack("K"), inv_K=stack("inv_K"),
            color_aug=stack("color_aug"), prev_aug=stack("prev_aug"),
            next_aug=stack("next_aug"),
        )

    def epoch_batches(self, batch_size: int, shuffle: bool = True,
                      device=None):
        """Iterate one epoch of SelfSupBatches on ``device`` (drop_last,
        like the reference DataLoader)."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield self.batch(order[i:i + batch_size].tolist(), device)
