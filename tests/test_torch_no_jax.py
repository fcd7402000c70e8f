"""The port stands alone: importing every module of vido_slam_tpu_torch (and
chip_smoke) loads neither JAX nor any module of the JAX package, nor cv2,
PIL or matplotlib, which the port does not require. Checked in a fresh
interpreter, since the test session itself imports JAX."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
import vido_slam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "vido_slam_tpu", "cv2",
                                    "PIL", "matplotlib"))
need = {"vido_slam_tpu_torch." + m
        for m in ("estimation.assembly", "estimation.flow_joint",
                  "estimation.flow_joint_kernel", "estimation.full_ba",
                  "estimation.imu_init", "io.datasets", "io.gt_poses",
                  "io.jpeg",
                  "io.png", "run_vido", "utils.host_build", "viz",
                  "estimation.lm", "estimation.lm_kernel",
                  "imu.preintegration",
                  "models.layers", "models.liteflownet", "models.monodepth2",
                  "models.perception", "models.maskrcnn.backbone",
                  "models.maskrcnn.model", "models.maskrcnn.roi_heads",
                  "models.maskrcnn.rpn", "models.maskrcnn.c2_loading",
                  "models.maskrcnn.fbnet", "models.maskrcnn.retinanet",
                  "models.maskrcnn.keypoint_head", "ops.deform_conv",
                  "ops.roi_pool", "ops.orb", "utils.checkpoint", "ops.correlation", "ops.fast",
                  "ops.nms", "ops.regularize", "ops.roi_align", "ops.warp",
                  "system", "tracking", "utils.transfer",
                  "models.maskrcnn.losses", "models.monodepth2_train",
                  "parallel.train", "data.coco", "data.samplers",
                  "train_maskrcnn", "utils.prng", "data.image_ops",
                  "data.mono_dataset", "data.kitti_utils", "data.coco_eval",
                  "parallel.eval", "parallel.slam_eval", "parallel.mesh",
                  "parallel.dryrun", "infer_nets", "make_viz_assets")}
missing = sorted(need - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 88 else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repo (or without a card) exits
    non-zero and prints no result line."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
