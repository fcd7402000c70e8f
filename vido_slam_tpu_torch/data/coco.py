"""COCO-format detection dataset — the port's copy of
``vido_slam_tpu/data/coco.py`` (maskrcnn_benchmark's COCODataset, data/
datasets/coco.py) without torchvision, pycocotools or PIL.

Reference semantics kept:
  - images sorted by id; images without valid annotations dropped
    (coco.py:21-56 `has_valid_annotation`: empty, or all boxes with a side
    <= 1 in xywh);
  - crowd annotations filtered per image (coco.py:73);
  - category ids remapped to contiguous 1..C (coco.py:60-65);
  - xywh -> xyxy box conversion (BoxList(mode="xywh").convert("xyxy"):
    x2 = x + max(w - 1, 0)).

Images are read by the port's ``io/datasets.py::read_rgb_pil``, bit-equal
to the JAX package's ``Image.open(path).convert("RGB")`` on PNG and
baseline JPEG (no EXIF orientation applied, a 16-bit gray PNG clipped at
255), and ``.npy`` images are loaded as they are. The JPEG decoder refuses
progressive, arithmetic, lossless and 12-bit JPEGs (``ValueError``) that
PIL decodes: re-encode such files as baseline JPEG or PNG.

Fixed-shape deltas of the JAX package: every sample is FIXED SHAPE — the image is resized with
a preserved aspect ratio onto a static (input_h, input_w) canvas (the
reference's Resize(min_size, max_size) + pad-to-divisible collate,
transforms/transforms.py + collate_batch), and targets are padded to
`max_boxes` with a validity mask instead of ragged BoxLists.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from vido_slam_tpu_torch.io.datasets import read_rgb_pil

# caffe2 / Detectron preprocessing (reference config defaults:
# PIXEL_MEAN [102.9801, 115.9465, 122.7717], BGR, no std scaling)
PIXEL_MEAN_BGR = (102.9801, 115.9465, 122.7717)


class DetectionSample(NamedTuple):
    image: np.ndarray      # (H, W, 3) float32, preprocessed, padded canvas
    boxes: np.ndarray      # (max_boxes, 4) xyxy in CANVAS coords
    labels: np.ndarray     # (max_boxes,) int32 contiguous ids, 0 = pad
    valid: np.ndarray      # (max_boxes,) bool
    image_id: int
    scale: float           # canvas = original * scale
    orig_hw: Tuple[int, int]
    masks: Optional[np.ndarray] = None  # (max_boxes, Hm, Wm) binary
    # (max_boxes, 17, 3) [x, y, v] in CANVAS coords; v = COCO visibility
    # (reference structures/keypoint.py PersonKeypoints); None when the
    # json carries no keypoint annotations
    keypoints: Optional[np.ndarray] = None


def rasterize_polygons(
    polys: List[List[float]], out_hw: Tuple[int, int],
    src_hw: Tuple[int, int],
) -> np.ndarray:
    """COCO polygon segmentation -> binary mask of out_hw (even-odd
    scanline fill, the SegmentationMask/pycocotools frPyObjects semantics at
    the data pipeline's fidelity)."""
    Hm, Wm = out_hw
    H0, W0 = src_hw
    sy, sx = Hm / H0, Wm / W0
    mask = np.zeros((Hm, Wm), np.float32)
    for poly in polys:
        xs = np.asarray(poly[0::2], np.float64) * sx
        ys = np.asarray(poly[1::2], np.float64) * sy
        if len(xs) < 3:
            continue
        # even-odd fill per pixel-center row
        for r in range(Hm):
            yc = r + 0.5
            x_cross = []
            for i in range(len(xs)):
                x1, y1 = xs[i], ys[i]
                x2, y2 = xs[(i + 1) % len(xs)], ys[(i + 1) % len(xs)]
                if (y1 <= yc) != (y2 <= yc):
                    t = (yc - y1) / (y2 - y1)
                    x_cross.append(x1 + t * (x2 - x1))
            x_cross.sort()
            for a, b in zip(x_cross[0::2], x_cross[1::2]):
                c0 = max(int(np.ceil(a - 0.5)), 0)
                c1 = min(int(np.floor(b - 0.5)), Wm - 1)
                if c1 >= c0:
                    mask[r, c0:c1 + 1] = 1.0
    return mask


def _xywh_to_xyxy(b):
    x, y, w, h = b
    return [x, y, x + max(w - 1.0, 0.0), y + max(h - 1.0, 0.0)]


def _valid_anno(anno: List[dict]) -> bool:
    if len(anno) == 0:
        return False
    if all(any(s <= 1 for s in obj["bbox"][2:]) for obj in anno):
        return False
    return True


class CocoDetectionDataset:
    def __init__(
        self,
        ann_file: str,
        root: str,
        remove_images_without_annotations: bool = True,
        input_hw: Tuple[int, int] = (544, 800),
        max_boxes: int = 64,
        subtract_mean: bool = True,
        mask_hw: Optional[Tuple[int, int]] = None,  # emit training masks
    ):
        with open(ann_file) as f:
            coco = json.load(f)
        self.root = root
        self.input_hw = input_hw
        self.max_boxes = max_boxes
        self.subtract_mean = subtract_mean
        self.mask_hw = mask_hw

        self.images: Dict[int, dict] = {im["id"]: im for im in coco["images"]}
        self.anns_by_image: Dict[int, List[dict]] = {
            im_id: [] for im_id in self.images
        }
        for ann in coco.get("annotations", []):
            if ann["image_id"] in self.anns_by_image:
                self.anns_by_image[ann["image_id"]].append(ann)

        cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        self.json_category_id_to_contiguous_id = {
            v: i + 1 for i, v in enumerate(cat_ids)
        }
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()
        }
        self.categories = {
            c["id"]: c.get("name", str(c["id"]))
            for c in coco.get("categories", [])
        }

        ids = sorted(self.images)
        if remove_images_without_annotations:
            ids = [
                i for i in ids
                if _valid_anno(
                    [a for a in self.anns_by_image[i]
                     if not a.get("iscrowd", 0)]
                )
            ]
        self.ids: List[int] = ids
        self.id_to_img_map = dict(enumerate(self.ids))

    def __len__(self) -> int:
        return len(self.ids)

    # -- raw pieces (host) -------------------------------------------------
    def load_image(self, image_id: int) -> np.ndarray:
        info = self.images[image_id]
        path = os.path.join(self.root, info["file_name"])
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            img = read_rgb_pil(path)
        return img.astype(np.float32)

    def aspect_ratio(self, idx: int) -> float:
        info = self.images[self.ids[idx]]
        return info["width"] / max(info["height"], 1)

    # -- fixed-shape sample ------------------------------------------------
    def __getitem__(self, idx: int) -> DetectionSample:
        image_id = self.ids[idx]
        img = self.load_image(image_id)
        H0, W0 = img.shape[:2]
        Hc, Wc = self.input_hw
        scale = min(Hc / H0, Wc / W0)
        Hs, Ws = int(round(H0 * scale)), int(round(W0 * scale))

        # bilinear resize on host (numpy): sample grid in original coords
        yy = (np.arange(Hs) + 0.5) / scale - 0.5
        xx = (np.arange(Ws) + 0.5) / scale - 0.5
        y0 = np.clip(np.floor(yy).astype(np.int32), 0, H0 - 1)
        x0 = np.clip(np.floor(xx).astype(np.int32), 0, W0 - 1)
        y1 = np.minimum(y0 + 1, H0 - 1)
        x1 = np.minimum(x0 + 1, W0 - 1)
        fy = np.clip(yy - y0, 0.0, 1.0)[:, None, None]
        fx = np.clip(xx - x0, 0.0, 1.0)[None, :, None]
        resized = (
            img[y0][:, x0] * (1 - fy) * (1 - fx)
            + img[y0][:, x1] * (1 - fy) * fx
            + img[y1][:, x0] * fy * (1 - fx)
            + img[y1][:, x1] * fy * fx
        )

        canvas = np.zeros((Hc, Wc, 3), np.float32)
        canvas[:Hs, :Ws] = resized
        if self.subtract_mean:
            # RGB -> BGR + caffe2 mean subtraction (reference
            # transforms.Normalize with TO_BGR255=True)
            canvas = canvas[..., ::-1] - np.asarray(PIXEL_MEAN_BGR, np.float32)

        anno = [a for a in self.anns_by_image[image_id]
                if not a.get("iscrowd", 0)]
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.zeros(self.max_boxes, np.int32)
        valid = np.zeros(self.max_boxes, bool)
        masks = (
            np.zeros((self.max_boxes,) + tuple(self.mask_hw), np.float32)
            if self.mask_hw is not None else None
        )
        has_kp = any("keypoints" in a for a in anno)
        keypoints = (np.zeros((self.max_boxes, 17, 3), np.float32)
                     if has_kp else None)
        for i, obj in enumerate(anno[: self.max_boxes]):
            boxes[i] = np.asarray(_xywh_to_xyxy(obj["bbox"]), np.float32) * scale
            labels[i] = self.json_category_id_to_contiguous_id[obj["category_id"]]
            valid[i] = True
            if keypoints is not None and obj.get("keypoints"):
                kp = np.asarray(obj["keypoints"], np.float32).reshape(-1, 3)
                k = min(len(kp), 17)
                # scale x/y into canvas coords; keep COCO visibility flags
                keypoints[i, :k, :2] = kp[:k, :2] * scale
                keypoints[i, :k, 2] = kp[:k, 2]
            if masks is not None:
                # image-space masks at mask_hw covering the CANVAS extent
                # (the canvas is original*scale placed at the origin)
                seg = obj.get("segmentation")
                src_hw = (Hc / scale, Wc / scale)
                if isinstance(seg, list) and seg:
                    masks[i] = rasterize_polygons(seg, self.mask_hw, src_hw)
                else:
                    # box-filled fallback (no segmentation in the json)
                    Hm, Wm = self.mask_hw
                    b = boxes[i]
                    r0 = int(np.floor(b[1] / Hc * Hm))
                    r1 = int(np.ceil((b[3] + 1) / Hc * Hm))
                    c0 = int(np.floor(b[0] / Wc * Wm))
                    c1 = int(np.ceil((b[2] + 1) / Wc * Wm))
                    masks[i, max(r0, 0):r1, max(c0, 0):c1] = 1.0
        return DetectionSample(
            image=canvas, boxes=boxes, labels=labels, valid=valid,
            image_id=image_id, scale=scale, orig_hw=(H0, W0), masks=masks,
            keypoints=keypoints,
        )

    def batch(self, indices) -> Dict[str, np.ndarray]:
        """Stack fixed-shape samples into numpy arrays (images NHWC, as the
        trainers take them)."""
        samples = [self[i] for i in indices]
        out = {
            "image": np.stack([s.image for s in samples]),
            "boxes": np.stack([s.boxes for s in samples]),
            "labels": np.stack([s.labels for s in samples]),
            "valid": np.stack([s.valid for s in samples]),
            "image_id": np.asarray([s.image_id for s in samples], np.int32),
            "scale": np.asarray([s.scale for s in samples], np.float32),
        }
        if self.mask_hw is not None:
            out["masks"] = np.stack([s.masks for s in samples])
        if all(s.keypoints is not None for s in samples):
            out["keypoints"] = np.stack([s.keypoints for s in samples])
        return out
