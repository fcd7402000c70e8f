"""The slice as a whole on a KITTI tree: the port's CLI against the JAX
package's ``demo/run_vido.py`` with ``ChooseData: 2``, BGR PNG frames
written by chip_smoke.py's writer and times.txt (test_torch_demo.py writes
the tree and holds the result txts to the bars stated there). After the
last frame the StopFrame full batch runs at the JAX defaults (64 frames,
2000 static points, 60 CG iterations, 15 LM iterations) and writes
refined_rgbd_new.txt; its poses are held within 1e-3 m / 1e-3 rad of the
JAX CLI's, and must differ from the initial trajectory. The same tree with
its frames written by cv2 as JPEG (quality 95, as the KITTI layout holds
them): the JAX CLI reads them through cv2, the port through its own
decoder (io/jpeg.py), held to the same bars."""

import os

import cv2
import numpy as np
import torch

from test_torch_demo import _compare, _run_both, _tree, scene_frames  # noqa: F401

torch.set_num_threads(1)


def _cv2_jpg(path, img):
    assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 95])


def _check_full_batch(tmp_path, cfg):
    port_out, jax_out = _run_both(cfg, str(tmp_path / "out"))
    _compare(port_out, jax_out)
    assert not np.array_equal(np.loadtxt(port_out + "refined_rgbd_new.txt"),
                              np.loadtxt(port_out + "initial_rgbd_new.txt"))


def test_kitti_tree_with_the_full_batch(tmp_path, scene_frames):
    _check_full_batch(tmp_path, _tree(tmp_path, scene_frames, "kitti"))


def test_kitti_jpeg_tree_with_the_full_batch(tmp_path, scene_frames):
    cfg = _tree(tmp_path, scene_frames, "kitti", jpg=_cv2_jpg)
    names = sorted(os.listdir(os.path.join(str(tmp_path), "kitti",
                                           "image_02")))
    assert names and all(n.endswith(".jpg") for n in names)
    _check_full_batch(tmp_path, cfg)
