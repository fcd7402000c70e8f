"""Single-image and image-pair network inference — counterpart of the JAX
package's ``tools/infer_nets.py`` (the reference's mono_depth2
test_simple.py and flow_net run.py ``__main__``):

  python -m vido_slam_tpu_torch.infer_nets depth --images <dir|file> \\
      --out <dir> [--weights <bundle>] [--height 192 --width 640]
  python -m vido_slam_tpu_torch.infer_nets flow --first a.png \\
      --second b.png --out <dir> [--weights <bundle>]
  python -m vido_slam_tpu_torch.infer_nets detector \\
      --family fbnet|retinanet|maskrcnn --image <file|synthetic> --out <dir>

Each takes ``--device`` (``cuda`` unless given ``cpu``). Images are read
as PIL's ``convert("RGB")`` reads them (``io/datasets.read_rgb_pil``: PNG
and JPEG) and resized by PIL's LANCZOS (``data/image_ops.
resize_lanczos_u8``), to [0, 1].

Outputs, as the JAX CLI writes them: depth -> ``<name>_disp.npy`` (the
scaled disparity at the image's own size) and ``<name>_disp.png``
(``viz.magma_image``, 95th-percentile vmax); flow -> ``flow.flo`` and
``flow.png`` (``viz.flow_to_rgb``); detector -> ``<family>_detections.json``
(boxes rounded to 2 decimals, scores to 4) and ``<family>_annotated.png``
(``viz.draw_detections``).

``--weights`` names a ``.npz`` bundle (without the suffix) of the JAX
package's layout, as ``utils/checkpoint.load_params`` and
``PerceptionModel.from_pretrained`` read it. Without it the nets take the
port's own seeded inits (seed 0), which draw other numbers than the JAX
package's ``PRNGKey(0)``; ``run_detector`` also takes parameters in the
JAX layout.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

import numpy as np
import torch

from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch.data.image_ops import resize_lanczos_u8
from vido_slam_tpu_torch.io.datasets import read_rgb_pil, write_flo
from vido_slam_tpu_torch.io.png import write_png
from vido_slam_tpu_torch.utils.checkpoint import load_params
from vido_slam_tpu_torch.utils.device import resolve_device
from vido_slam_tpu_torch.viz import draw_detections, flow_to_rgb, magma_image


def load_rgb(path: str, h: int, w: int):
    """The image at ``path`` as (h, w, 3) float32 RGB in [0, 1], and its
    own size (W, H), as infer_nets.py:29-35 reads it with PIL."""
    rgb = read_rgb_pil(path)
    orig = (rgb.shape[1], rgb.shape[0])
    return resize_lanczos_u8(rgb, h, w).astype(np.float32) / 255.0, orig


def _nchw(img: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        img.transpose(2, 0, 1)[None])).to(dev)


def _weights(path: str):
    """A bundle's arrays in the JAX layout, as numpy."""
    return {k: v.numpy() for k, v in load_params(path).items()}


def run_depth(args) -> None:
    from vido_slam_tpu_torch.models.monodepth2 import (MonoDepth2,
                                                       disp_to_depth,
                                                       monodepth2_disp)
    from vido_slam_tpu_torch.ops.warp import resize_bilinear

    dev = resolve_device(args.device)
    net = MonoDepth2(seed=0, device=dev)
    if args.weights:
        net.load_state_dict(convert.monodepth2_state_dict_from_numpy(
            _weights(args.weights), device=dev), strict=True)
    if os.path.isdir(args.images):
        paths = sorted(
            p for p in glob.glob(os.path.join(args.images, "*"))
            if p.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    else:
        paths = [args.images]
    os.makedirs(args.out, exist_ok=True)
    for i, p in enumerate(paths):
        img, (ow, oh) = load_rgb(p, args.height, args.width)
        with torch.no_grad():
            disp = monodepth2_disp(net, _nchw(img, dev))
            disp_r = resize_bilinear(disp, oh, ow)[0, 0]
            scaled, _ = disp_to_depth(disp_r, 0.1, 100.0)
        name = os.path.splitext(os.path.basename(p))[0]
        np.save(os.path.join(args.out, f"{name}_disp.npy"),
                scaled.cpu().numpy())
        write_png(os.path.join(args.out, f"{name}_disp.png"),
                  magma_image(disp_r.cpu().numpy()))
        print(f"   Processed {i + 1} of {len(paths)} images")
    print(f"-> Done, saved to {args.out}")


def run_flow(args) -> None:
    from vido_slam_tpu_torch.models.liteflownet import (LiteFlowNet,
                                                        flow_full_resolution)

    dev = resolve_device(args.device)
    net = LiteFlowNet(seed=0, device=dev)
    if args.weights:
        net.load_state_dict(convert.liteflownet_state_dict_from_numpy(
            _weights(args.weights)), strict=True)
    h = args.height - args.height % 32
    w = args.width - args.width % 32
    first, (ow, oh) = load_rgb(args.first, h, w)
    second, _ = load_rgb(args.second, h, w)
    with torch.no_grad():
        flow = net(_nchw(first, dev), _nchw(second, dev))
        full = flow_full_resolution(flow, oh, ow)[0].permute(1, 2, 0)
    full = full.cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    write_flo(os.path.join(args.out, "flow.flo"), full)
    write_png(os.path.join(args.out, "flow.png"), flow_to_rgb(full))
    print(f"-> flow.flo + flow.png saved to {args.out}")


def detector_model(family: str, h: int, w: int, arch: str = "default",
                   device=None, params: Optional[dict] = None):
    """The detector of ``family`` for (h, w) inputs, as the JAX CLI builds
    it (infer_nets.py:148-168): FBNet of ``arch``, RetinaNet on the R-50
    FPN, or Mask R-CNN R-50-FPN; the port's seeded init, or ``params`` (the
    JAX package's parameter dict, numpy, its layout)."""
    from vido_slam_tpu_torch.models.maskrcnn.fbnet import FBNet
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           MaskRCNNConfig)
    from vido_slam_tpu_torch.models.maskrcnn.retinanet import RetinaNet

    dev = resolve_device(device)
    if family == "fbnet":
        model = FBNet(arch=arch, seed=0, device=dev)
    elif family == "retinanet":
        model = RetinaNet(seed=0, device=dev)
    elif family == "maskrcnn":
        model = MaskRCNN(MaskRCNNConfig(input_h=h, input_w=w), seed=0,
                         device=dev)
    else:
        raise ValueError(f"unknown detector family {family!r}")
    if params is not None:
        model.load_state_dict(convert.maskrcnn_state_dict_from_numpy(
            params, device=dev), strict=True)
    return model


def detect(family: str, model, x: torch.Tensor, h: int, w: int):
    """One image (1, 3, h, w) in 0..255 -> the valid detections' boxes,
    scores and labels, as numpy."""
    from vido_slam_tpu_torch.models.maskrcnn.fbnet import fbnet_inference
    from vido_slam_tpu_torch.models.maskrcnn.model import maskrcnn_inference
    from vido_slam_tpu_torch.models.maskrcnn.retinanet import (
        retinanet_inference)

    with torch.no_grad():
        if family == "fbnet":
            det = fbnet_inference(model, x, h, w)
        elif family == "retinanet":
            det = retinanet_inference(model, x, h, w)
        else:
            det = maskrcnn_inference(model, x)
    valid = det.valid.cpu().numpy()
    return (det.boxes.cpu().numpy()[valid], det.scores.cpu().numpy()[valid],
            det.labels.cpu().numpy()[valid].astype(int))


def run_detector(args, params: Optional[dict] = None) -> None:
    """The detector on one image file, or with ``--image synthetic`` the
    first frame of the synthetic driving clip (infer_nets.py:118-190):
    the detections' JSON and the annotated PNG. ``params``: the JAX
    package's parameter dict for the family (see ``detector_model``)."""
    from vido_slam_tpu_torch.system import COCO_LABELS

    dev = resolve_device(args.device)
    h = args.height - args.height % 32
    w = args.width - args.width % 32
    if args.image == "synthetic":
        from vido_slam_tpu_torch.io.synthetic import driving_clip

        img = driving_clip(height=h, width=w, n_frames=1,
                           device=dev)[0].cpu().numpy()
        img = img / 255.0
    else:
        img, _ = load_rgb(args.image, h, w)
    model = detector_model(args.family, h, w, args.arch, dev, params)
    boxes, scores, labels = detect(args.family, model,
                                   _nchw(img * 255.0, dev), h, w)

    def name(label):
        return COCO_LABELS[label] if 0 <= label < len(COCO_LABELS) \
            else str(label)
    os.makedirs(args.out, exist_ok=True)
    recs = [{"box": [round(float(v), 2) for v in b],
             "score": round(float(s), 4), "label": int(lb),
             "category": name(lb)}
            for b, s, lb in zip(boxes, scores, labels)]
    with open(os.path.join(args.out, f"{args.family}_detections.json"),
              "w") as f:
        json.dump({"family": args.family, "n": len(recs),
                   "detections": recs}, f, indent=1)
    annotated, _ = draw_detections(
        (img * 255).astype(np.uint8), boxes,
        [f"{name(lb)}:{s:.2f}" for s, lb in zip(scores, labels)])
    write_png(os.path.join(args.out, f"{args.family}_annotated.png"),
              annotated)
    print(f"-> {args.family}: {len(recs)} detections, saved to {args.out}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("depth")
    d.add_argument("--images", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--weights", default="")
    d.add_argument("--height", type=int, default=192)
    d.add_argument("--width", type=int, default=640)
    f = sub.add_parser("flow")
    f.add_argument("--first", required=True)
    f.add_argument("--second", required=True)
    f.add_argument("--out", required=True)
    f.add_argument("--weights", default="")
    f.add_argument("--height", type=int, default=192)
    f.add_argument("--width", type=int, default=640)
    det = sub.add_parser("detector")
    det.add_argument("--family", required=True,
                     choices=["fbnet", "retinanet", "maskrcnn"])
    det.add_argument("--image", default="synthetic",
                     help="image file, or 'synthetic' for a generated frame")
    det.add_argument("--out", required=True)
    det.add_argument("--arch", default="default",
                     help="FBNet arch name (default/mobilenet_v2/...)")
    det.add_argument("--height", type=int, default=192)
    det.add_argument("--width", type=int, default=640)
    for p in (d, f, det):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    {"depth": run_depth, "flow": run_flow,
     "detector": run_detector}[args.cmd](args)


if __name__ == "__main__":
    main()
