"""Mask R-CNN training CLI — counterpart of ``demo/train_maskrcnn.py`` (the
reference's tools/train_net.py: the model, the SGD solver and the
WarmupMultiStepLR schedule, the loader, the engine/trainer.py loop).

One process on one device (the card unless given ``--device cpu``), or
under torchrun one process a rank on a (dp, tp) mesh (``parallel/mesh.py``:
NCCL on the cards, a card a rank; gloo with ``--device cpu``). ``--dp 0``
means the world size over ``--tp``; dp x tp must be the world size, and
dp must divide ``--batch`` (the global batch). Rank 0 logs and writes the
checkpoints.

Data: a COCO-format dataset (``--ann-file``/``--image-root``, read by
``data/coco.py``: 8-bit PNG, baseline JPEG or ``.npy`` images) or
``--synthetic``, generated boxes and images drawn from
``np.random.RandomState(seed)`` exactly as the JAX CLI draws them, so both
CLIs train on the same batches. Checkpoints are ``.npz`` bundles in the
JAX package's layout (``model_<iter>.npz``, ``model_final.npz``);
``--resume`` reads one.

Examples:
  # smoke (random init: use ~10x lower lr than the pretrained recipe)
  python -m vido_slam_tpu_torch.train_maskrcnn --synthetic --iters 20 \\
      --batch 4 --lr 1e-3 --input-h 128 --input-w 160 --out det_ckpt
  python -m vido_slam_tpu_torch.train_maskrcnn --ann-file ann.json \\
      --image-root imgs/ --iters 180000 --batch 8
  # 4 ranks as dp 2 x tp 2 (one card a rank; --device cpu for gloo)
  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m vido_slam_tpu_torch.train_maskrcnn --synthetic --dp 2 --tp 2 \\
      --batch 4 --iters 20 --lr 1e-3 --out det_ckpt
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ann-file", help="COCO instances json")
    ap.add_argument("--image-root", help="COCO image directory")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on generated data (no dataset needed)")
    ap.add_argument("--iters", type=int, default=180000,
                    help="SOLVER.MAX_ITER (X-101 1x recipe: 180k at batch 8)")
    ap.add_argument("--batch", type=int, default=2,
                    help="images per step (SOLVER.IMS_PER_BATCH)")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel size (0: the world size / tp)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel size")
    ap.add_argument("--lr", type=float, default=0.01, help="SOLVER.BASE_LR")
    ap.add_argument("--warmup-iters", type=int, default=500)
    ap.add_argument("--lr-steps", type=int, nargs="*",
                    default=[120000, 160000])
    ap.add_argument("--checkpoint-period", type=int, default=2500)
    ap.add_argument("--log-period", type=int, default=20)
    ap.add_argument("--out", default="", help="checkpoint output dir")
    ap.add_argument("--resume", default="",
                    help="params checkpoint to load (path without .npz)")
    ap.add_argument("--start-iter", type=int, default=0)
    ap.add_argument("--input-h", type=int, default=544)
    ap.add_argument("--input-w", type=int, default=800)
    ap.add_argument("--max-boxes", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def synthetic_batches(n_batches, batch, h, w, max_boxes, seed=0):
    """Generated detection batches, blob 'objects' with matching boxes,
    drawn as demo/train_maskrcnn.py:58-83 draws them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        imgs = rng.rand(batch, h, w, 3).astype(np.float32) * 30.0
        boxes = np.zeros((batch, max_boxes, 4), np.float32)
        labels = np.zeros((batch, max_boxes), np.int32)
        valid = np.zeros((batch, max_boxes), bool)
        masks = np.zeros((batch, max_boxes, h // 2, w // 2), np.float32)
        for b in range(batch):
            for g in range(rng.randint(1, 4)):
                bw = rng.randint(w // 8, w // 3)
                bh = rng.randint(h // 8, h // 3)
                x0 = rng.randint(0, w - bw)
                y0 = rng.randint(0, h - bh)
                imgs[b, y0:y0 + bh, x0:x0 + bw] += 120.0
                boxes[b, g] = [x0, y0, x0 + bw - 1, y0 + bh - 1]
                labels[b, g] = rng.randint(1, 81)
                valid[b, g] = True
                masks[b, g, y0 // 2:(y0 + bh) // 2,
                      x0 // 2:(x0 + bw) // 2] = 1.0
        out.append({"image": imgs,
                    "targets": {"boxes": boxes, "labels": labels,
                                "masks": masks, "valid": valid}})
    return out


def coco_batches(ds, batch: int, seed: int):
    """Shuffled epochs of ``ds`` in batches, forever (the reference's
    sampler shuffles each epoch)."""
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(len(ds))
        for s in range(0, len(order) - batch + 1, batch):
            b = ds.batch(order[s:s + batch])
            yield {"image": b["image"],
                   "targets": {"boxes": b["boxes"], "labels": b["labels"],
                               "masks": b["masks"], "valid": b["valid"]}}


def main(argv=None, log_fn=print):
    """Runs the CLI; returns the final state dict. Under torchrun
    (``WORLD_SIZE`` set) it starts the process group and ends it."""
    args = parse_args(argv)
    import torch.distributed as dist

    from vido_slam_tpu_torch import convert
    from vido_slam_tpu_torch.models.maskrcnn.model import (
        MaskRCNNConfig, init_maskrcnn_params)
    from vido_slam_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from vido_slam_tpu_torch.parallel.train import run_detection_training
    from vido_slam_tpu_torch.utils.checkpoint import load_params
    from vido_slam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    torchrun = "WORLD_SIZE" in os.environ
    world = int(os.environ["WORLD_SIZE"]) if torchrun else 1
    dp = args.dp or max(world // args.tp, 1)
    if dp * args.tp != world:
        raise ValueError(
            f"--dp {dp} --tp {args.tp} needs {dp * args.tp} ranks, but the "
            f"world has {world}" + ("" if torchrun else
                                    ": run it under torchrun, python -m "
                                    "torch.distributed.run --nproc-per-node "
                                    f"{dp * args.tp} -m "
                                    "vido_slam_tpu_torch.train_maskrcnn ..."))
    if args.batch % dp:
        raise ValueError(f"--batch {args.batch} not divisible by dp={dp}")
    mesh = None
    if torchrun:
        device = init_distributed(device)
        mesh = make_mesh(world, dp=dp, tp=args.tp, device=device)
    cfg = MaskRCNNConfig(input_h=args.input_h, input_w=args.input_w)
    if args.resume:
        params = convert.maskrcnn_state_dict_from_numpy(
            {k: v.numpy() for k, v in load_params(args.resume).items()},
            device="cpu")
        if mesh is None or mesh.rank == 0:
            log_fn(f"resumed {len(params)} tensors from {args.resume}")
    else:
        params = init_maskrcnn_params(torch.Generator().manual_seed(args.seed),
                                      cfg)

    if args.synthetic:
        batches = synthetic_batches(8, args.batch, args.input_h,
                                    args.input_w, args.max_boxes, args.seed)
    else:
        if not (args.ann_file and args.image_root):
            raise SystemExit("need --ann-file + --image-root, or --synthetic")
        from vido_slam_tpu_torch.data.coco import CocoDetectionDataset

        ds = CocoDetectionDataset(
            args.ann_file, args.image_root,
            input_hw=(args.input_h, args.input_w), max_boxes=args.max_boxes,
            mask_hw=(args.input_h // 2, args.input_w // 2))
        batches = coco_batches(ds, args.batch, args.seed)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    try:
        return run_detection_training(
            params, batches, device, cfg,
            num_iters=args.iters, base_lr=args.lr,
            warmup_iters=args.warmup_iters, lr_steps=tuple(args.lr_steps),
            checkpoint_period=args.checkpoint_period,
            log_period=args.log_period, output_dir=args.out or None,
            seed=args.seed, start_iter=args.start_iter, log_fn=log_fn,
            mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
