"""Headless visualization — counterpart of ``vido_slam_tpu/viz.py``:
replaces the reference's Pangolin viewer (vido_slam/src/viewer/
VidoViewer.cc) and cvplot metric plots (Tracking::PlotMetricError,
Tracking.cc:3676-3933) with matplotlib renderings written to disk.
matplotlib (and, for the animation, PIL) is imported at first use, so the
module imports where neither is installed; a plot there raises
``ImportError`` and ``LiveViewer`` is a no-op. The interactive viewer
thread (which gates the reference pipeline on a pause button,
VidoViewer.cc:12/Tracking.cc:729-731) is replaced by a non-blocking
recorder: headless by design.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from vido_slam_tpu_torch.data.image_ops import hsv_to_rgb
from vido_slam_tpu_torch.metrics import camera_centers
from vido_slam_tpu_torch.slam_map import SlamMap


def _mpl():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("vido_slam_tpu_torch.viz needs matplotlib for its "
                          "plots and animations, and it is not installed "
                          "here") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(
    slam_map: SlamMap, path: str, gt: Optional[np.ndarray] = None,
    use_refined: bool = False,
) -> None:
    """Top-down (x-z) trajectory + object tracks — the viewer's birdeye view."""
    plt = _mpl()
    poses = (slam_map.refined_poses if use_refined and
             slam_map.refined_poses is not None else slam_map.poses)
    c = camera_centers(poses)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(c[:, 0], c[:, 2], "b-", label="estimate")
    if gt is not None:
        cg = camera_centers(gt)
        ax.plot(cg[:, 0], cg[:, 2], "k--", label="ground truth")
    # object centroids colored by track id
    for tid in slam_map.track_ids():
        pts = []
        for f in slam_map.frames:
            for ob in f.objects:
                if ob.track_id == tid and ob.status:
                    pts.append(ob.centroid)
        if pts:
            pts = np.stack(pts)
            ax.plot(pts[:, 0], pts[:, 2], "o-", ms=3, label=f"object {tid}")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.grid(True, alpha=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_metric_error(slam_map: SlamMap, path: str) -> Dict[str, float]:
    """PlotMetricError (Tracking.cc:3676-3933): per-frame camera RPE curves
    plus per-object motion error curves; returns the summary means."""
    plt = _mpl()
    gt = slam_map.gt_poses
    if gt is None:
        raise ValueError("no ground-truth poses recorded")
    est = slam_map.poses
    T = est.shape[0]
    t_err, r_err = [], []
    for i in range(1, T):
        rel_e = est[i] @ np.linalg.inv(est[i - 1])
        rel_g = gt[i] @ np.linalg.inv(gt[i - 1])
        dE = np.linalg.inv(rel_g) @ rel_e
        t_err.append(np.linalg.norm(dE[:3, 3]))
        cos = np.clip((np.trace(dE[:3, :3]) - 1) / 2, -1, 1)
        r_err.append(np.degrees(np.arccos(cos)))

    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    axes[0].plot(t_err, "b-")
    axes[0].set_ylabel("RPE trans [m]")
    axes[0].grid(True, alpha=0.3)
    axes[1].plot(r_err, "r-")
    axes[1].set_ylabel("RPE rot [deg]")
    axes[1].set_xlabel("frame")
    axes[1].grid(True, alpha=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return {
        "rpe_trans_mean": float(np.mean(t_err)) if t_err else 0.0,
        "rpe_rot_deg_mean": float(np.mean(r_err)) if r_err else 0.0,
    }


def plot_object_motion_errors(
    slam_map: SlamMap, gt_motions: Dict[int, Dict[int, np.ndarray]],
    path: str, body_frame: bool = True,
) -> Dict[int, Dict[str, float]]:
    """Per-object motion-error curves — the object half of PlotMetricError
    (Tracking.cc:3676-3933). `gt_motions[track_id][frame_id]` is the GT
    world-frame motion H_gt for that frame (build with
    metrics.gt_object_motion from consecutive GT object poses, or parse
    FrameRecord.obj_gt). Errors use metrics.object_motion_error (body-frame
    when an object pose is known is the reference default; here the
    world-frame error unless the caller pre-conjugates). Returns per-object
    mean errors."""
    from vido_slam_tpu_torch.metrics import object_motion_error

    del body_frame  # conjugation is the caller's choice via gt_motions
    plt = _mpl()
    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    summary: Dict[int, Dict[str, float]] = {}
    for tid, gtm in sorted(gt_motions.items()):
        xs, te, re = [], [], []
        for f in slam_map.frames:
            if f.frame_id not in gtm:
                continue
            for ob in f.objects:
                if ob.track_id == tid and ob.status:
                    e = object_motion_error(ob.motion, gtm[f.frame_id])
                    xs.append(f.frame_id)
                    te.append(e["trans_err"])
                    re.append(e["rot_err_deg"])
        if not xs:
            continue
        axes[0].plot(xs, te, "o-", ms=3, label=f"object {tid}")
        axes[1].plot(xs, re, "o-", ms=3, label=f"object {tid}")
        summary[tid] = {"t_mean": float(np.mean(te)),
                        "r_deg_mean": float(np.mean(re))}
    axes[0].set_ylabel("obj motion err t [m]")
    axes[1].set_ylabel("obj motion err R [deg]")
    axes[1].set_xlabel("frame")
    for ax in axes:
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return summary


def save_speed_plot(slam_map: SlamMap, path: str) -> None:
    """Per-object speed over time (the viewer's speed overlay)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 4))
    for tid in slam_map.track_ids():
        xs, ys = [], []
        for f in slam_map.frames:
            for ob in f.objects:
                if ob.track_id == tid and ob.status:
                    xs.append(f.frame_id)
                    ys.append(ob.speed_kmh)
        if xs:
            ax.plot(xs, ys, "o-", ms=3, label=f"object {tid}")
    ax.set_xlabel("frame")
    ax.set_ylabel("speed [km/h]")
    ax.grid(True, alpha=0.3)
    ax.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def _draw_scene(ax, slam_map: SlamMap, upto: Optional[int] = None,
                max_points: int = 2000, box_half: float = 1.2) -> None:
    """Draw trajectory + map points + object boxes up to frame `upto`
    (exclusive; None = all frames) onto a 3D axes."""
    n = len(slam_map.frames) if upto is None else upto
    c = camera_centers(slam_map.poses[:n])
    ax.plot(c[:, 0], c[:, 2], -c[:, 1], "b-", lw=2, label="camera")

    last = slam_map.frames[n - 1]
    pts = last.stat_3d[last.stat_valid][:max_points]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=1, c="gray",
                   alpha=0.4, label="map points")

    edges = [(0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6),
             (6, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
    for tid in slam_map.track_ids():
        cents = []
        for f in slam_map.frames[:n]:
            for ob in f.objects:
                if ob.track_id == tid and ob.status:
                    cents.append(np.asarray(ob.centroid))
        if not cents:
            continue
        cents = np.stack(cents)
        ax.plot(cents[:, 0], cents[:, 2], -cents[:, 1], "o-", ms=2,
                label=f"object {tid}")
        # wireframe box at the latest centroid
        cx, cy, cz = cents[-1]
        corners = np.array([
            [cx + sx * box_half, cy + sy * box_half, cz + sz * box_half]
            for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
        ])
        for a, b in edges:
            ax.plot([corners[a, 0], corners[b, 0]],
                    [corners[a, 2], corners[b, 2]],
                    [-corners[a, 1], -corners[b, 1]], "r-", lw=0.8)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_zlabel("-y [m]")
    ax.legend(loc="upper left", fontsize=8)


def plot_scene_3d(slam_map: SlamMap, path: str,
                  max_points: int = 2000, box_half: float = 1.2) -> None:
    """Headless counterpart of the Pangolin 3D viewer
    (src/viewer/VidoViewer.cc DrawTrajectory/DrawObjects/DrawMapPoints):
    camera trajectory, static map points of the last frame, per-track
    object centroids with wireframe 3D boxes."""
    plt = _mpl()
    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(111, projection="3d")
    _draw_scene(ax, slam_map, None, max_points, box_half)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def render_scene_animation(slam_map: SlamMap, path: str, *,
                           stride: int = 1, fps: int = 10,
                           max_points: int = 2000, box_half: float = 1.2,
                           figsize: float = 6.0, dpi: int = 80) -> int:
    """Animated 3D scene over the sequence — the VidoViewer's continuously
    evolving render (VidoViewer.cc:28-37 SetCurrentPose/SetMapPoints/
    SetObjects per frame) as a headless GIF recording. Each animation frame
    draws the trajectory, the map points and the object boxes as of that
    SLAM frame. Returns the number of rendered frames."""
    plt = _mpl()
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("render_scene_animation writes its GIF with PIL "
                          "(Pillow), which is not installed here") from e

    n = len(slam_map.frames)
    frames = []
    fig = plt.figure(figsize=(figsize, figsize))
    for i in range(1, n + 1, max(stride, 1)):
        fig.clf()
        ax = fig.add_subplot(111, projection="3d")
        _draw_scene(ax, slam_map, i, max_points, box_half)
        ax.set_title(f"frame {i - 1}")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(Image.fromarray(buf.copy()))
    plt.close(fig)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames[0].save(
        path, save_all=True, append_images=frames[1:],
        duration=int(1000 / max(fps, 1)), loop=0)
    return len(frames)


def flow_to_rgb(flow: np.ndarray, normalize: bool = True) -> np.ndarray:
    """Optical-flow visualization with the flow_net runner's HSV recipe
    (reference flow_net/src/run.py:123-166): hue = flow angle (OpenCV
    half-degrees), saturation = min-max-normalised magnitude, value = 255.
    flow (H, W, 2) -> uint8 RGB (H, W, 3); cv2-free."""
    u = np.nan_to_num(np.asarray(flow[..., 0], np.float32))
    v = np.nan_to_num(np.asarray(flow[..., 1], np.float32))
    mag = np.sqrt(u * u + v * v)
    ang = np.arctan2(v, u)          # cv2.cartToPolar range [0, 2pi)
    ang = np.where(ang < 0, ang + 2 * np.pi, ang)
    h_deg = ang * 180.0 / np.pi / 2.0               # [0, 180) like cv2 HSV
    if normalize:
        lo, hi = mag.min(), mag.max()
        sat = (mag - lo) / max(hi - lo, 1e-12) * 255.0
    else:
        sat = np.clip(mag, 0, 255)
    # HSV (cv2 layout: h in [0,180), s/v in [0,255]) -> RGB, by
    # matplotlib's hsv_to_rgb (image_ops' copy: the card has no matplotlib)
    hsv = np.stack([h_deg / 180.0, sat / 255.0, np.ones_like(sat)], axis=-1)
    return (hsv_to_rgb(hsv) * 255.0).astype(np.uint8)


_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def magma_image(disp: np.ndarray) -> np.ndarray:
    """A disparity map (H, W) as the reference's test_simple.py colours it
    (tools/infer_nets.py:38-46 of the JAX package): matplotlib's
    ``Normalize(vmin=min, vmax=95th percentile)`` and the magma colormap's
    ``to_rgba``, times 255, cut to uint8 -> (H, W, 3). The arithmetic is
    matplotlib 3.10's: the normalisation in the data's dtype against float64
    bounds, the index ``int(x * 256)`` with x == 1 on the last colour,
    values above 1 on the last, NaN black. The table is
    ``assets/magma.npy`` (``make_viz_assets``)."""
    lut = np.load(os.path.join(_ASSETS, "magma.npy"))
    n = lut.shape[0]
    x = np.array(disp, copy=True)
    vmin = np.float64(float(x.min()))
    vmax = np.float64(float(np.percentile(x, 95)))
    if vmin == vmax:
        x.fill(0)
    elif vmin > vmax:
        raise ValueError("minvalue must be less than or equal to maxvalue")
    else:
        x -= vmin
        x /= (vmax - vmin)
    x *= n
    x[x == n] = n - 1
    bad = np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = np.clip(x, -1, n).astype(int)
    idx[x < 0] = 0
    idx[x >= n] = n - 1
    idx[bad] = 0
    rgb = lut[idx]
    rgb[bad] = 0.0
    return (rgb * 255).astype(np.uint8)


BOX_COLOUR = (255, 64, 64)
LABEL_COLOUR = (255, 255, 0)


def _hline(img: np.ndarray, x0: int, y: int, x1: int, ink) -> None:
    H, W = img.shape[:2]
    if 0 <= y < H and x0 < W and x1 >= 0:
        img[y, max(x0, 0):min(x1, W - 1) + 1] = ink


def _vline(img: np.ndarray, x: int, y0: int, y1: int, ink) -> None:
    """Pillow's line from (x, y0) to (x, y1): |y1 - y0| pixels from y0
    towards y1, the end left out."""
    H, W = img.shape[:2]
    step = 1 if y1 >= y0 else -1
    for y in range(y0, y1, step):
        if 0 <= x < W and 0 <= y < H:
            img[y, x] = ink


def draw_rectangle(img: np.ndarray, box, ink=BOX_COLOUR) -> None:
    """``ImageDraw.rectangle(box, outline=ink)`` of width 1 on an (H, W, 3)
    uint8 image, in place: the corners cut to int toward zero, the top
    and bottom rows, then the sides between them (Pillow's draw.c). A box
    whose x1 < x0 or y1 < y0 raises ``ValueError``, as Pillow's does."""
    if box[2] < box[0]:
        raise ValueError("x1 must be greater than or equal to x0")
    if box[3] < box[1]:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = (int(v) for v in box)
    _hline(img, x0, y0, x1, ink)
    _hline(img, x0, y1, x1, ink)
    _vline(img, x1, y0 + 1, y1, ink)
    _vline(img, x0, y0 + 1, y1, ink)


def label_font() -> dict:
    """The glyph atlas ``assets/label_font.npz`` (``make_viz_assets``)."""
    with np.load(os.path.join(_ASSETS, "label_font.npz")) as z:
        return {k: z[k] for k in z.files}


def draw_label(img: np.ndarray, xy, text: str, font: dict,
               ink=LABEL_COLOUR):
    """``ImageDraw.text(xy, text, fill=ink)`` with Pillow's default font,
    from its glyph atlas ``font`` (``label_font``): each character's
    coverage m blended over the image as Pillow blends it, (v (255 - m) +
    ink m) / 255 rounded, at the pen's integer position (Pillow lays the
    string out as a whole, at the position's fraction, so its glyph pixels
    differ). In place; returns the (x0, y0, x1, y1) box of the pixels it
    changed (x1, y1 excluded), or None."""
    chars = str(font["chars"])
    H, W = img.shape[:2]
    pen, top = int(xy[0]), int(xy[1])
    ink = np.asarray(ink, np.int32)
    box = None
    for ch in text:
        i = chars.find(ch) if ch in chars else chars.find("?")
        g = font["glyphs"][i].astype(np.int32)
        gx, gy = (int(v) for v in font["offsets"][i])
        x0, y0 = pen + gx, top + gy
        cx0, cy0 = max(x0, 0), max(y0, 0)
        cx1, cy1 = min(x0 + g.shape[1], W), min(y0 + g.shape[0], H)
        if g.any() and cx0 < cx1 and cy0 < cy1:
            m = g[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0, None]
            t = img[cy0:cy1, cx0:cx1].astype(np.int32) * (255 - m) \
                + ink * m + 128
            img[cy0:cy1, cx0:cx1] = ((t >> 8) + t) >> 8
            ys, xs = np.nonzero(m[..., 0])
            if len(ys):
                b = (cx0 + xs.min(), cy0 + ys.min(), cx0 + xs.max() + 1,
                     cy0 + ys.max() + 1)
                box = b if box is None else (
                    min(box[0], b[0]), min(box[1], b[1]),
                    max(box[2], b[2]), max(box[3], b[3]))
        pen += int(font["advances"][i])
    return box


def draw_detections(image: np.ndarray, boxes, texts) -> tuple:
    """tools/infer_nets.py:176-183 of the JAX package without PIL: each
    detection's box outlined (``draw_rectangle``), then its label drawn at
    (x0 + 1, max(0, y0 - 10)) (``draw_label``), one detection after
    another. Returns the annotated copy (H, W, 3) uint8 and the labels'
    boxes."""
    img = np.array(image, np.uint8, copy=True)
    font = label_font()
    label_boxes = []
    for b, text in zip(boxes, texts):
        draw_rectangle(img, b)
        label_boxes.append(draw_label(img, (b[0] + 1, max(0.0, b[1] - 10)),
                                      text, font))
    return img, label_boxes


def draw_frame_overlay(image: np.ndarray, slam_map: SlamMap,
                       frame_idx: int = -1, path: str = None) -> np.ndarray:
    """DisplayDynamicImage equivalent: the input frame annotated with the
    tracked object points (colored per track id) and static features
    (VidoViewer.cc image panel; Tracking.cc's 'Static and Dynamic Features'
    debug view). Returns an (H, W, 3) uint8 array; saves if path given."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img.astype(np.uint8).copy()
    f = slam_map.frames[frame_idx]
    H, W = img.shape[:2]

    def put(uv, color):
        u = np.clip(np.round(uv[:, 0]).astype(int), 1, W - 2)
        v = np.clip(np.round(uv[:, 1]).astype(int), 1, H - 2)
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                img[v + dv, u + du] = color

    put(f.stat_uv[f.stat_valid], (0, 255, 0))
    palette = [(255, 0, 0), (0, 128, 255), (255, 0, 255), (255, 255, 0),
               (0, 255, 255), (128, 0, 255), (255, 128, 0), (0, 0, 255)]
    labs = f.obj_label
    for i, tid in enumerate(sorted(set(labs[labs > 0].tolist()))):
        m = (labs == tid) & f.obj_valid
        put(f.obj_uv[m], palette[i % len(palette)])
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _mpl().imsave(path, img)
    return img


# matplotlib backends with no display window — LiveViewer must no-op on
# all of these, not just "agg" (module:// covers inline/notebook shims)
_NON_INTERACTIVE_BACKENDS = ("agg", "cairo", "pdf", "pgf", "ps", "svg",
                             "template")


class LiveViewer:
    """Minimal interactive live 3D viewer — the on-demand counterpart of
    VidoViewer (VidoViewer.cc Run loop: trajectory + map points + object
    boxes redrawn as the map evolves, plus the annotated video image panel
    via DisplayDynamicImage), with the pause semantics INVERTED as the
    headless design requires (SURVEY section 1): the reference starts
    paused and gates GrabImageRGBD on the viewer's button
    (VidoViewer.cc:12, Tracking.cc:729-731); this viewer starts RUNNING
    and pausing (space key) only freezes the display refresh — the
    pipeline is never blocked.

    Falls back to a no-op when no interactive matplotlib backend is
    available (headless hosts), so `--view` is always safe to pass;
    `disabled_reason` records why (None while healthy).
    """

    def __init__(self, every: int = 5, max_points: int = 2000):
        self.every = max(int(every), 1)
        self.max_points = max_points
        self.paused = False
        self.disabled_reason = None
        self._n = 0
        self._ok = False
        self._img_ax = None
        try:
            import matplotlib
            import matplotlib.pyplot as plt

            backend = matplotlib.get_backend().lower()
            if (backend in _NON_INTERACTIVE_BACKENDS
                    or backend.startswith("module://")):
                raise RuntimeError(f"non-interactive backend {backend!r}")
            plt.ion()
            self._plt = plt
            self._fig = plt.figure(figsize=(12, 7))
            # left: annotated video image (DisplayDynamicImage panel);
            # right: 3D trajectory/points/boxes
            self._img_ax = self._fig.add_subplot(1, 2, 1)
            self._img_ax.set_axis_off()
            self._ax = self._fig.add_subplot(1, 2, 2, projection="3d")
            self._fig.canvas.mpl_connect("key_press_event", self._on_key)
            self._fig.suptitle("vido_slam_tpu_torch live (space: pause/run)")
            self._ok = True
        except Exception as e:  # headless: record why and no-op
            self.disabled_reason = str(e)

    def _on_key(self, event):
        if event.key == " ":
            self.paused = not self.paused

    def update(self, slam_map: SlamMap, image: np.ndarray = None) -> None:
        """Call once per tracked frame; redraws every `every` frames unless
        paused. `image` (H, W[, 3] RGB), when given, is annotated with the
        tracked features (draw_frame_overlay) and shown beside the 3D axes.
        Never raises and never blocks beyond one GUI event tick."""
        self._n += 1
        if not self._ok or self.paused or self._n % self.every:
            return
        try:
            self._ax.cla()
            _draw_scene(self._ax, slam_map, None, self.max_points)
            if image is not None and self._img_ax is not None:
                self._img_ax.cla()
                self._img_ax.set_axis_off()
                self._img_ax.imshow(
                    draw_frame_overlay(image, slam_map))
            self._fig.canvas.draw_idle()
            self._plt.pause(0.001)
        except Exception as e:
            self._ok = False
            self.disabled_reason = str(e)

    def close(self) -> None:
        if self._ok:
            self._plt.ioff()
            self._plt.close(self._fig)
