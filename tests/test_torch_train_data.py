"""The port's detection data modules (``data/coco.py``, ``data/samplers.py``)
against the JAX package's on the same inputs: a COCO tree the test writes
(``.npy`` and 8-bit PNG images, polygons, a box-only object, keypoints, a
crowd object, an image without a valid object, non-contiguous category
ids), every sample and batch equal (the PNGs decode to the same pixels:
the port through its own PNG reader, JAX through PIL); the samplers and
the synthetic batches of both CLIs equal. The port's CLI on the CPU
(the full R-50-FPN at 64x96, two iterations of one image) writes
checkpoints in the JAX layout that reload and resume, runs on the card
unless given ``--device cpu``, and refuses a ``--dp``/``--tp`` that is not
the world size (naming torchrun outside it) or a batch that dp does not
divide.
"""

import json
import os
import subprocess
import sys

import re

import numpy as np
import pytest
import torch

from vido_slam_tpu.data import coco as jc
from vido_slam_tpu.data import samplers as js
from vido_slam_tpu_torch.data import coco as tc
from vido_slam_tpu_torch import convert
from vido_slam_tpu_torch import train_maskrcnn as cli
from vido_slam_tpu_torch.data import samplers as ts
from vido_slam_tpu_torch.utils.checkpoint import load_params

import chip_smoke

torch.set_num_threads(1)

LOSS = re.compile(r"iter (\d+)/\d+  loss ([0-9.]+) ")


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    rng = np.random.RandomState(0)
    images, annotations = [], []
    aid = 1
    sizes = [(120, 160), (160, 120), (96, 128), (128, 96), (100, 100)]
    for i, (h, w) in enumerate(sizes):
        if i % 2:
            name = f"img{i}.png"
            chip_smoke.write_png(os.path.join(root, name),
                                 rng.randint(0, 256, (h, w, 3), np.uint8))
        else:
            name = f"img{i}.npy"
            np.save(os.path.join(root, name),
                    (rng.rand(h, w, 3) * 255).astype(np.float32))
        images.append({"id": 20 - i, "file_name": name, "height": h,
                       "width": w})
        if i == 4:          # only a degenerate box: dropped
            annotations.append({"id": aid, "image_id": 20 - i,
                                "category_id": 5, "bbox": [3, 3, 1, 8],
                                "iscrowd": 0})
            aid += 1
            continue
        for k in range(1 + i % 3):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
            ann = {"id": aid, "image_id": 20 - i,
                   "category_id": [5, 9, 42][k], "bbox": [x, y, bw, bh],
                   "iscrowd": 0}
            if k != 1:
                ann["segmentation"] = [[x, y, x + bw, y, x + bw * 0.7,
                                        y + bh, x, y + bh * 0.6]]
            if k == 0:
                kp = np.zeros((17, 3))
                kp[:, 0] = rng.uniform(x, x + bw, 17)
                kp[:, 1] = rng.uniform(y, y + bh, 17)
                kp[:, 2] = rng.randint(0, 3, 17)
                ann["keypoints"] = kp.ravel().tolist()
            annotations.append(ann)
            aid += 1
        annotations.append({"id": aid, "image_id": 20 - i, "category_id": 9,
                            "bbox": [1, 1, 20, 20], "iscrowd": 1})
        aid += 1
    cats = [{"id": c, "name": f"c{c}"} for c in (42, 5, 9)]
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": cats}, f)
    return path, root


@pytest.mark.parametrize("mask_hw", [None, (48, 64)])
def test_coco_samples_and_batch_equal_jax(coco_dir, mask_hw):
    ann, root = coco_dir
    kw = dict(input_hw=(96, 128), max_boxes=4, mask_hw=mask_hw)
    jd = jc.CocoDetectionDataset(ann, root, **kw)
    td = tc.CocoDetectionDataset(ann, root, **kw)
    assert td.ids == jd.ids and len(td) == len(jd) == 4
    assert td.json_category_id_to_contiguous_id == \
        jd.json_category_id_to_contiguous_id
    for i in range(len(jd)):
        a, b = jd[i], td[i]
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if x is None:
                assert y is None, f
            else:
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                              err_msg=f)
        assert td.aspect_ratio(i) == jd.aspect_ratio(i)
    assert any(jd[i].keypoints is not None for i in range(len(jd)))
    jb, tb = jd.batch([2, 0]), td.batch([2, 0])
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_rasterize_polygons_equal_jax():
    rng = np.random.RandomState(5)
    polys = [list(rng.uniform(0, 60, 10)), list(rng.uniform(10, 50, 6)),
             [1.0, 2.0, 3.0, 4.0]]
    np.testing.assert_array_equal(
        tc.rasterize_polygons(polys, (40, 50), (60, 60)),
        jc.rasterize_polygons(polys, (40, 50), (60, 60)))


@pytest.mark.parametrize("shuffle", [True, False])
def test_samplers_equal_jax(shuffle):
    for n, reps in ((10, 3), (7, 2), (5, 1)):
        for rank in range(reps):
            np.testing.assert_array_equal(
                ts.shard_epoch(n, reps, rank, shuffle, seed=3),
                js.shard_epoch(n, reps, rank, shuffle, seed=3))
    ratios = np.random.RandomState(1).uniform(0.5, 2.0, 11)
    idx = np.random.RandomState(2).permutation(11)
    for drop in (False, True):
        got = ts.grouped_batches(ratios, idx, 3, drop)
        want = js.grouped_batches(ratios, idx, 3, drop)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    batches = js.grouped_batches(ratios, idx, 3)
    got = list(ts.iteration_batches(batches, 10, start_iter=2))
    want = list(js.iteration_batches(batches, 10, start_iter=2))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_synthetic_batches_equal_the_jax_clis():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "demo"))
    import train_maskrcnn as jcli
    want = jcli.synthetic_batches(3, 2, 64, 96, 8, seed=4)
    got = cli.synthetic_batches(3, 2, 64, 96, 8, seed=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        for k in w["targets"]:
            np.testing.assert_array_equal(g["targets"][k], w["targets"][k])


def test_cli_writes_and_reloads_checkpoints(tmp_path):
    out = str(tmp_path / "ckpt")
    args = ["--synthetic", "--iters", "2", "--batch", "1", "--input-h", "64",
            "--input-w", "96", "--lr", "1e-3", "--checkpoint-period", "2",
            "--log-period", "1", "--out", out, "--device", "cpu"]
    lines = []
    final = cli.main(args, log_fn=lines.append)
    assert [LOSS.match(x).group(1) for x in lines] == ["1", "2"]
    assert all(np.isfinite(float(LOSS.match(x).group(2))) for x in lines)
    assert sorted(os.listdir(out)) == ["model_0000002.npz", "model_final.npz"]
    saved = load_params(os.path.join(out, "model_final"))
    want = convert.convert_state_dict(final)
    assert set(saved) == set(want)
    for k in want:
        np.testing.assert_array_equal(saved[k].numpy(), want[k])
    # resume: the bundle loads into the detector, and no iteration is left
    again = cli.main(args[:-4] + ["--resume", os.path.join(out, "model_final"),
                                  "--start-iter", "2", "--out",
                                  str(tmp_path / "again"), "--device", "cpu"],
                     log_fn=lines.append)
    assert lines[-1].startswith("resumed ")
    for k, v in final.items():
        assert torch.equal(again[k], v), k


def test_cli_on_a_dp2_tp2_mesh_under_torchrun(tmp_path):
    from vido_slam_tpu_torch.models.maskrcnn.model import (
        MaskRCNNConfig, init_maskrcnn_params)

    args = ["--synthetic", "--iters", "2", "--batch", "2", "--input-h", "64",
            "--input-w", "96", "--lr", "1e-3", "--log-period", "1",
            "--device", "cpu"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=root, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "vido_slam_tpu_torch.train_maskrcnn",
         *args, "--dp", "2", "--tp", "2", "--out", str(tmp_path / "mesh")],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    assert len(re.findall(r"^iter \d/2 ", run.stdout, re.M)) == 2, run.stdout
    assert sorted(os.listdir(tmp_path / "mesh")) == ["model_final.npz"]
    lines = []
    cli.main(args + ["--out", str(tmp_path / "one")], log_fn=lines.append)
    mesh = load_params(str(tmp_path / "mesh" / "model_final"))
    one = load_params(str(tmp_path / "one" / "model_final"))
    init = convert.convert_state_dict(init_maskrcnn_params(
        torch.Generator().manual_seed(0),
        MaskRCNNConfig(input_h=64, input_w=96)))
    assert set(mesh) == set(one) == set(init)
    for k, v in one.items():
        v = v.numpy()
        bar = 1e-5 * np.abs(v - init[k]).max() \
            + 2 * np.spacing(np.abs(v)).max()
        assert np.abs(mesh[k].numpy() - v).max() <= bar, k


def test_cli_device_and_mesh_options(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(["--synthetic", "--dp", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(["--synthetic", "--tp", "2", "--device", "cpu"])
    # under torchrun's variables the checks come before the process group
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="needs 6 ranks, but the world has "
                                         "4$"):
        cli.main(["--synthetic", "--dp", "3", "--tp", "2", "--device",
                  "cpu"])
    with pytest.raises(ValueError, match="--batch 3 not divisible by dp=2"):
        cli.main(["--synthetic", "--tp", "2", "--batch", "3", "--device",
                  "cpu"])
    monkeypatch.delenv("WORLD_SIZE")
    assert cli.parse_args(["--synthetic"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--synthetic", "--iters", "1"])
