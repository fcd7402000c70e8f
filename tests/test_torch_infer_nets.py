"""The port's inference CLI (``python -m vido_slam_tpu_torch.infer_nets``)
against the JAX package's ``tools/infer_nets.py``, both run here on the
same files: two random 70x90 PNGs, a JPEG with EXIF orientation 6 and a
16-bit gray PNG (which PIL reads unrotated and clipped at 255), at
64x96 for the nets and 96x128 for the detectors.

The JAX CLI draws its weights from ``PRNGKey(0)``; the port is given the
same ones (``--weights`` bundles of the JAX inits, and the detector's
parameter dict), since its own seeded inits draw other numbers.

Bars: each ``<name>_disp.npy`` and the ``.flo`` within 1e-5 of max(1,
max |value|); the magma PNG bit-equal to JAX's when fed JAX's disparity,
and the flow PNG when fed JAX's flow; the committed magma table equal to
matplotlib's and the glyph atlas to Pillow's default font; the detections'
JSON equal (FBNet and RetinaNet; Mask R-CNN's random init gives a box
with x1 < x0 on this image, which both CLIs refuse as Pillow does), the
annotated PNG equal outside the label boxes (the glyphs are drawn from the
atlas, not laid out by FreeType: a known deviation).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from vido_slam_tpu_torch import infer_nets, make_viz_assets, viz
from vido_slam_tpu_torch.io.datasets import read_flo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
DH, DW = 96, 128


def jax_cli():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import infer_nets as jax_infer_nets
    finally:
        sys.path.pop(0)
    return jax_infer_nets


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(0)
    for i in range(2):
        Image.fromarray((rng.rand(70, 90, 3) * 255).astype(np.uint8)).save(
            d / f"{i}.png")
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray((rng.rand(48, 64, 3) * 255).astype(np.uint8)).save(
        d / "orient6.jpg", exif=exif.tobytes(), quality=90)
    Image.fromarray((rng.rand(50, 60) * 1000).astype(np.uint16)).save(
        d / "gray16.png")
    return d


@pytest.fixture(scope="module")
def jax_runs(images, tmp_path_factory):
    """JAX's CLI on the files: depth over the directory (its disparities
    before the colormap kept), flow on the two PNGs; and the weights it
    drew, as bundles."""
    import jax

    from vido_slam_tpu.models.liteflownet import init_liteflownet_params
    from vido_slam_tpu.models.monodepth2 import init_monodepth2_params

    cli = jax_cli()
    out = tmp_path_factory.mktemp("jax")
    disps = {}
    save = cli._save_colormapped_disp

    def keep(disp, path):
        disps[os.path.basename(path)] = np.array(disp)
        save(disp, path)
    cli._save_colormapped_disp = keep
    try:
        cli.main(["depth", "--images", str(images), "--out",
                  str(out / "depth"), "--height", str(H), "--width", str(W)])
    finally:
        cli._save_colormapped_disp = save
    cli.main(["flow", "--first", str(images / "0.png"), "--second",
              str(images / "1.png"), "--out", str(out / "flow"), "--height",
              str(H), "--width", str(W)])
    for name, init in (("depth", init_monodepth2_params),
                       ("flow", init_liteflownet_params)):
        np.savez(out / f"{name}_weights.npz",
                 **{k: np.asarray(v) for k, v in
                    init(jax.random.PRNGKey(0)).items()})
    return out, disps


def test_depth_matches_jax(images, jax_runs, tmp_path):
    out, disps = jax_runs
    infer_nets.main(["depth", "--images", str(images), "--out",
                     str(tmp_path), "--height", str(H), "--width", str(W),
                     "--weights", str(out / "depth_weights"), "--device",
                     "cpu"])
    names = sorted(os.path.splitext(p)[0] for p in os.listdir(images))
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{n}_disp.{e}" for n in names for e in ("npy", "png"))
    sizes = {"0": (70, 90), "1": (70, 90), "orient6": (48, 64),
             "gray16": (50, 60)}
    for n in names:
        got = np.load(tmp_path / f"{n}_disp.npy")
        want = np.load(out / "depth" / f"{n}_disp.npy")
        assert got.shape == want.shape == sizes[n]
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= 1e-5 * scale, n
        # the colormap, fed JAX's disparity, gives JAX's PNG to the bit
        png = np.asarray(Image.open(out / "depth" / f"{n}_disp.png"))
        np.testing.assert_array_equal(viz.magma_image(disps[f"{n}_disp.png"]),
                                      png)
        mine = np.asarray(Image.open(tmp_path / f"{n}_disp.png"))
        assert mine.shape == png.shape and mine.dtype == np.uint8


def test_flow_matches_jax(images, jax_runs, tmp_path):
    out, _ = jax_runs
    infer_nets.main(["flow", "--first", str(images / "0.png"), "--second",
                     str(images / "1.png"), "--out", str(tmp_path),
                     "--height", str(H), "--width", str(W), "--weights",
                     str(out / "flow_weights"), "--device", "cpu"])
    got = read_flo(str(tmp_path / "flow.flo"))
    want = read_flo(str(out / "flow" / "flow.flo"))
    assert got.shape == want.shape == (70, 90, 2)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    np.testing.assert_array_equal(
        viz.flow_to_rgb(want), np.asarray(Image.open(out / "flow" /
                                                     "flow.png")))
    np.testing.assert_array_equal(
        viz.flow_to_rgb(got), np.asarray(Image.open(tmp_path / "flow.png")))


def test_committed_tables_equal_matplotlib_and_pillow():
    np.testing.assert_array_equal(np.load(make_viz_assets.MAGMA),
                                  make_viz_assets.magma_table())
    atlas = np.load(make_viz_assets.FONT)
    fresh = make_viz_assets.font_atlas()
    assert set(atlas.files) == set(fresh)
    for k, v in fresh.items():
        np.testing.assert_array_equal(atlas[k], v, err_msg=k)


def jax_detector_params(family):
    """The parameters the JAX CLI draws for ``family`` at DH x DW
    (infer_nets.py:148-168), as numpy."""
    import jax

    if family == "fbnet":
        from vido_slam_tpu.models.maskrcnn.fbnet import init_fbnet_params
        p = init_fbnet_params(jax.random.PRNGKey(0), arch="default")
    elif family == "retinanet":
        from vido_slam_tpu.models.maskrcnn.backbone import ResNetConfig
        from vido_slam_tpu.models.maskrcnn.retinanet import (
            init_retinanet_params)
        p = init_retinanet_params(jax.random.PRNGKey(0), ResNetConfig())
    else:
        from vido_slam_tpu.models.maskrcnn.model import (MaskRCNNConfig,
                                                         init_maskrcnn_params)
        p = init_maskrcnn_params(jax.random.PRNGKey(0),
                                 MaskRCNNConfig(input_h=DH, input_w=DW))
    return {k: np.asarray(v) for k, v in p.items()}


def detector_argv(family, image, out):
    return ["detector", "--family", family, "--image", str(image), "--out",
            str(out), "--height", str(DH), "--width", str(DW)]


@pytest.mark.parametrize("family", ["fbnet", "retinanet"])
def test_detector_matches_jax(family, images, tmp_path):
    cli = jax_cli()
    image = images / "0.png"
    cli.main(detector_argv(family, image, tmp_path / "jax"))
    args = infer_nets.parse_args(detector_argv(family, image,
                                               tmp_path / "port")
                                 + ["--device", "cpu"])
    infer_nets.run_detector(args, params=jax_detector_params(family))
    name = f"{family}_detections.json"
    with open(tmp_path / "jax" / name) as f:
        want = json.load(f)
    with open(tmp_path / "port" / name) as f:
        got = json.load(f)
    assert got == want and want["n"] > 0
    # the annotated PNG: equal outside the label boxes, PIL's and ours
    img, _ = infer_nets.load_rgb(str(image), DH, DW)
    base = (img * 255).astype(np.uint8)
    dets = want["detections"]
    texts = [f"{d['category']}:{d['score']:.2f}" for d in dets]
    boxes = np.asarray([d["box"] for d in dets], np.float64)
    _, mine = viz.draw_detections(base, boxes, texts)
    outside = np.ones((DH, DW), bool)
    draw = ImageDraw.Draw(Image.new("RGB", (DW, DH)))
    for d, text, box in zip(dets, texts, mine):
        x0, y0, x1, y1 = draw.textbbox(
            (d["box"][0] + 1, max(0.0, d["box"][1] - 10)), text)
        outside[max(int(np.floor(y0)), 0):int(np.ceil(y1)),
                max(int(np.floor(x0)), 0):int(np.ceil(x1))] = False
        if box is not None:
            outside[box[1]:box[3], box[0]:box[2]] = False
    want_png = np.asarray(Image.open(tmp_path / "jax" /
                                     f"{family}_annotated.png"))
    got_png = np.asarray(Image.open(tmp_path / "port" /
                                    f"{family}_annotated.png"))
    assert outside.mean() > 0.25   # 0.31 with RetinaNet's 100 labels
    np.testing.assert_array_equal(got_png[outside], want_png[outside])


def test_maskrcnn_detector_refuses_an_inverted_box_as_jax(images,
                                                          tmp_path):
    image = images / "0.png"
    with pytest.raises(ValueError, match="x1 must be greater"):
        jax_cli().main(detector_argv("maskrcnn", image, tmp_path / "jax"))
    args = infer_nets.parse_args(detector_argv("maskrcnn", image,
                                               tmp_path / "port")
                                 + ["--device", "cpu"])
    with pytest.raises(ValueError, match="x1 must be greater"):
        infer_nets.run_detector(args,
                                params=jax_detector_params("maskrcnn"))


def test_synthetic_frame_detections_match_jax(tmp_path):
    """``--image synthetic``: the first frame of the driving clip."""
    jax_cli().main(detector_argv("fbnet", "synthetic", tmp_path / "jax"))
    args = infer_nets.parse_args(detector_argv("fbnet", "synthetic",
                                               tmp_path / "port")
                                 + ["--device", "cpu"])
    infer_nets.run_detector(args, params=jax_detector_params("fbnet"))
    jsons = []
    for side in ("jax", "port"):
        with open(tmp_path / side / "fbnet_detections.json") as f:
            jsons.append(json.load(f))
    assert jsons[0] == jsons[1] and jsons[0]["n"] > 0
    png = np.asarray(Image.open(tmp_path / "port" / "fbnet_annotated.png"))
    assert png.shape == (DH, DW, 3)


def test_entry_points_take_the_card_unless_asked(images, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in (["depth", "--images", str(images), "--out", str(tmp_path)],
                 ["flow", "--first", str(images / "0.png"), "--second",
                  str(images / "1.png"), "--out", str(tmp_path)],
                 detector_argv("fbnet", "synthetic", tmp_path)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer_nets.main(argv)


BLOCKED = r"""
import sys
sys.modules["matplotlib"] = None
sys.modules["PIL"] = None
import numpy as np
from vido_slam_tpu_torch import viz
from vido_slam_tpu_torch.io.png import encode_png
rng = np.random.RandomState(0)
viz.flow_to_rgb(rng.randn(8, 10, 2).astype(np.float32))
viz.magma_image(rng.rand(8, 10).astype(np.float32))
img, boxes = viz.draw_detections(np.zeros((40, 60, 3), np.uint8),
                                 [[5.0, 12.0, 30.0, 35.0]], ["car:0.99"])
encode_png(img)
print("drawn without matplotlib and PIL", boxes)
"""


def test_drawing_needs_neither_matplotlib_nor_pil():
    """The card's machine has neither: ``flow_to_rgb`` took matplotlib's
    ``hsv_to_rgb`` at its call before (now ``data/image_ops``' copy)."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64,
                                   np.int32, np.int16, np.uint8])
def test_magma_image_on_grids_and_ties_equals_jax(dtype, tmp_path):
    """The colormap against the JAX CLI's ``_save_colormapped_disp`` on
    maps where two implementations may part: values on an integer grid
    with ties at the 95th percentile, a constant map, and integer maps
    (matplotlib promotes those to float; the port raised on them)."""
    grid = (np.arange(48).reshape(6, 8) % 7).astype(dtype)
    const = np.full((3, 4), 5, dtype)
    for k, disp in enumerate((grid, const, grid[::-1, ::2])):
        path = str(tmp_path / f"{k}.png")
        jax_cli()._save_colormapped_disp(disp, path)
        np.testing.assert_array_equal(viz.magma_image(disp),
                                      np.asarray(Image.open(path)))
