"""CUDA kernels of the port against their plain PyTorch versions, on the
card. Run there with

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

(--noconftest: tests/conftest.py configures JAX, which the port's tests
here do not use.)
Each test decides inside itself whether a card is present and skips
without one. Every kernel must also give the same bits in two launches on
the same inputs. Bars: those of chip_smoke.py. Kernel 1
(pose LM): per problem |log(T_ref^-1 T)| < 1e-4, |chi2 - chi2_ref| <=
1e-3 max(1, chi2_ref), at most 3 inlier flips. Kernel 2 (joint flow +
pose): per problem |log(T_ref^-1 T)| < 1e-4, inlier sets differing on at
most max(3, 1 %) of the points, flows of common inliers within 1e-2 px.
Kernel 3 (cost volume): max error <= 1e-5 max(1, max |plain|). Kernel 4
(regularization tail): rtol = atol = 1e-5 element by element. Kernel 5
(multilevel ROIAlign): max error <= 1e-5 max(1, max |feature|). Kernel
5b (its backward, atomics: no bit-equal second launch): max error <=
1e-5 max |plain gradient|. Kernels 1-4 refuse a CUDA input that
asks for a gradient."""

import numpy as np
import pytest
import torch

import chip_smoke
from vido_slam_tpu_torch.estimation import flow_joint_kernel, lm_kernel
from vido_slam_tpu_torch.estimation.pose import HUBER_DELTA_POSE, RP_THRES
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.geometry.se3 import inverse_se3, log_se3, make_se3
from vido_slam_tpu_torch.geometry.so3 import exp_so3
from vido_slam_tpu_torch.models.maskrcnn.roi_heads import (POOLER_SCALES,
                                                          assign_fpn_level)
from vido_slam_tpu_torch.ops import correlation, regularize, roi_align

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")


def _cam():
    return Camera.create(fx=816.402, fy=817.38, cx=608.2658, cy=266.688,
                         width=1280, height=560, bf=387.57)


def _problems(B, N, shared, huber, seed):
    rng = np.random.RandomState(seed)
    cam = _cam()

    def pose(w, t):
        return make_se3(exp_so3(torch.tensor(w, dtype=torch.float32)),
                        torch.tensor(t, dtype=torch.float32))

    def points():
        uv = np.stack([rng.uniform(30, 1250, N), rng.uniform(20, 540, N)], -1)
        return cam.backproject(torch.tensor(uv, dtype=torch.float32),
                               torch.tensor(rng.uniform(5, 40, N),
                                            dtype=torch.float32))

    T_pre = pose([0.0, 0.02, 0.0], [0.1, 0.0, -3.0]).expand(B, 4, 4)
    X = points()
    Xs, obs, T0 = [], [], []
    for b in range(B):
        Xb = X if shared else points()
        Tt = pose(rng.normal(0, 0.01, 3), rng.normal(0, 0.3, 3))
        pc = (Xb @ Tt[:3, :3].T + Tt[:3, 3]) @ T_pre[b, :3, :3].T \
            + T_pre[b, :3, 3]
        o = cam.project(pc) + torch.tensor(rng.normal(0, 0.05, (N, 2)),
                                           dtype=torch.float32)
        if huber is not None:
            o[torch.tensor(rng.uniform(size=N) < 0.05)] += 3.0
        Xs.append(Xb)
        obs.append(o)
        T0.append(pose(rng.normal(0, 0.005, 3), rng.normal(0, 0.05, 3)) @ Tt)
    valid = torch.tensor(rng.uniform(size=(B, N)) < 0.9)
    args = (torch.stack(T0), T_pre.contiguous(),
            X if shared else torch.stack(Xs), torch.stack(obs), valid)
    return cam, tuple(a.cuda().contiguous() for a in args)


def _object_batch(B, N, seed):
    """The object batch as the main path lays it out (pose.py
    estimate_object_motions_batched): one (N, 3) point set and one (N, 2)
    observation array shared by all B problems, each object's points picked
    out by a disjoint mask, T_pre = Tcw. Object b is a 600 x 300 px image
    patch 2-10 m away (a near vehicle: smaller or farther patches leave the
    float32 solution itself, against float64, uncertain to a few 1e-5, too
    close to the pose bar) moved by its own motion; a tenth of the points
    belongs to none."""
    rng = np.random.RandomState(seed)
    cam = _cam()

    def pose(w, t):
        return make_se3(exp_so3(torch.tensor(w, dtype=torch.float32)),
                        torch.tensor(t, dtype=torch.float32))

    Tcw = pose([0.0, 0.02, 0.0], [0.1, 0.0, -3.0])
    owner = np.where(rng.uniform(size=N) < 0.1, -1, rng.randint(0, B, N))
    uv = np.zeros((N, 2))
    z = np.zeros(N)
    for b in range(-1, B):
        sel = owner == b
        uv[sel, 0] = rng.uniform(330, 950) + rng.uniform(-300, 300, sel.sum())
        uv[sel, 1] = rng.uniform(170, 390) + rng.uniform(-150, 150, sel.sum())
        z[sel] = rng.uniform(4, 8) + rng.uniform(-2, 2, sel.sum())
    Xc = cam.backproject(torch.tensor(uv, dtype=torch.float32),
                         torch.tensor(z, dtype=torch.float32))
    Twc = inverse_se3(Tcw)
    X = Xc @ Twc[:3, :3].T + Twc[:3, 3]
    obs = torch.zeros(N, 2)
    masks, T0 = [], []
    for b in range(B):
        sel = torch.tensor(owner == b)
        M = Tcw @ pose(rng.normal(0, 0.01, 3), rng.normal(0, 0.3, 3))
        obs[sel] = cam.project(X[sel] @ M[:3, :3].T + M[:3, 3])
        masks.append(sel)
        T0.append(pose(rng.normal(0, 0.005, 3), rng.normal(0, 0.05, 3))
                  @ inverse_se3(Tcw) @ M)
    obs += torch.tensor(rng.normal(0, 0.05, (N, 2)), dtype=torch.float32)
    args = (torch.stack(T0), Tcw.expand(B, 4, 4), X, obs, torch.stack(masks))
    return cam, tuple(a.cuda().contiguous() for a in args)


def _hold_pose_lm(got, ref, valid):
    """Kernel 1 against its plain version: the bars above, per problem."""
    assert torch.isfinite(got.T).all()
    for b in range(valid.shape[0]):
        err = float(torch.linalg.norm(log_se3(inverse_se3(ref.T[b])
                                              @ got.T[b])))
        assert err < 1e-4, (b, err)
        # absolute 1e-3 for inliers; relative for the few-px outliers,
        # whose chi2 moves with the last ~1e-6 of the pose
        tol = 1e-3 * torch.clamp(ref.chi2[b].abs(), min=1.0)
        assert bool(((got.chi2[b] - ref.chi2[b]).abs() <= tol).all()), b
        flips = ((got.chi2[b] <= RP_THRES) != (ref.chi2[b] <= RP_THRES)) \
            & valid[b]
        assert int(flips.sum()) <= 3, b


@pytest.mark.parametrize("B,N,layout,huber", [
    (1, 3000, "own", HUBER_DELTA_POSE),             # the camera solve
    (8, 4000, "main path", None),                   # the object batch
    (8, 4000, "shared points", None),               # per-object observations
    (3, 100, "own", None),
    (2, 12000, "shared points", HUBER_DELTA_POSE),  # 1,500 points a CTA
    (3, 12000, "main path", None),
    (1, 100000, "own", HUBER_DELTA_POSE),           # a CTA's share of N too
])                                                  # large for shared memory
def test_pose_lm_kernel_matches_plain(B, N, layout, huber):
    _need_card()
    if layout == "main path":
        cam, args = _object_batch(B, N, seed=B + N)
    else:
        cam, args = _problems(B, N, layout == "shared points", huber,
                              seed=B * 7 + N)
    if N == 100000:
        # the plan sizes a CTA's share by N; ~2,800 of the points are
        # valid, as the main path's camera solve has them
        keep = torch.arange(N, device="cuda") % 32 == 0
        args = args[:4] + (args[4] & keep,)
    plan = lm_kernel.launch_plan(B, N)
    assert (plan.smem_bytes == 0) == (N == 100000)
    before = lm_kernel.pose_lm_batched.launches
    got = lm_kernel.pose_lm_batched(*args, cam, huber_delta=huber)
    assert lm_kernel.pose_lm_batched.launches == before + 1
    ref = lm_kernel.pose_lm_batched_ref(*args, cam, huber_delta=huber)
    torch.cuda.synchronize()
    assert (got.num_iters > 0).all()
    _hold_pose_lm(got, ref, args[4])


@pytest.mark.parametrize("case", [
    "object with an all-invalid mask",  # the main path's batch, one empty
    "object with 5 valid points",       # fewer than the 6 of the pose
    "N=1",
])
def test_pose_lm_kernel_small_problems(case):
    """Problems with few or no valid points: an all-invalid one takes no
    step (zero cost) and keeps T_init; chi2 still covers every point."""
    _need_card()
    if case.startswith("object"):
        cam, args = _object_batch(8, 4000, seed=41)
        valid = args[4].clone()
        if case.endswith("all-invalid mask"):
            valid[5] = False
        else:
            valid[5] &= torch.cumsum(valid[5].int(), 0) <= 5
            assert int(valid[5].sum()) == 5
        args = args[:4] + (valid,)
    else:
        cam, args = _problems(2, 1, False, None, seed=43)
        args = args[:4] + (torch.ones_like(args[4]),)
    got = lm_kernel.pose_lm_batched(*args, cam)
    ref = lm_kernel.pose_lm_batched_ref(*args, cam)
    torch.cuda.synchronize()
    _hold_pose_lm(got, ref, args[4])
    if case.endswith("all-invalid mask"):
        assert int(got.num_iters[5]) == int(ref.num_iters[5]) == 0
        assert torch.equal(got.T[5], args[0][5])
        assert torch.isfinite(got.chi2[5]).all()


@pytest.mark.parametrize("B,N,layout,huber", [
    (1, 3000, "own", HUBER_DELTA_POSE), (8, 4000, "main path", None)])
def test_pose_lm_kernel_is_deterministic(B, N, layout, huber):
    _need_card()
    if layout == "main path":
        cam, args = _object_batch(B, N, seed=7)
    else:
        cam, args = _problems(B, N, False, huber, seed=7)
    assert lm_kernel.launch_plan(B, N).cluster == 8
    a = lm_kernel.pose_lm_batched(*args, cam, huber_delta=huber)
    b = lm_kernel.pose_lm_batched(*args, cam, huber_delta=huber)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pose_lm_kernel_checks_inputs():
    _need_card()
    cam, args = _problems(2, 64, False, None, seed=1)
    bad = list(args)
    bad[3] = args[3].double()
    with pytest.raises(TypeError):
        lm_kernel.pose_lm_batched(*bad, cam)
    bad = list(args)
    bad[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        lm_kernel.pose_lm_batched(*bad, cam)


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    _need_card()
    cam, args = _problems(1, 500, False, HUBER_DELTA_POSE, seed=2)

    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(lm_kernel, "pose_lm_batched_ref", refuse)
    out = lm_kernel.pose_lm_batched(*args, cam, huber_delta=HUBER_DELTA_POSE)
    torch.cuda.synchronize()
    assert out.T.is_cuda


def _joint_args(B, N, layout, seed):
    """Kernel 2's inputs, made by chip_smoke.py's problem functions: the camera
    solve (B=1) or the object batch in the main path's shared layout."""
    rng = np.random.RandomState(seed)
    cam = _cam()
    if layout == "camera":
        args = chip_smoke.joint_camera_problem(rng, cam, N)
    else:
        Tcw = chip_smoke._pose([0.0, 0.02, 0.0], [0.1, 0.0, -3.0])
        args = chip_smoke.joint_object_problems(rng, cam, B, N, Tcw)
    return cam, tuple(a.cuda().contiguous() for a in args)


def _hold_flow_joint(got, ref, args):
    """Kernel 2 against its plain version: the bars above."""
    B, N = args[4].shape
    assert torch.isfinite(got.T).all() and torch.isfinite(got.flow).all()
    np.testing.assert_array_equal(got.num_inliers.cpu().numpy(),
                                  got.inliers.sum(-1).cpu().numpy())
    for b in range(B):
        err = float(torch.linalg.norm(log_se3(inverse_se3(ref.T[b])
                                              @ got.T[b])))
        assert err < 1e-4, (b, err)
        flips = int((got.inliers[b] != ref.inliers[b]).sum())
        assert flips <= max(3, N // 100), (b, flips)
        both = got.inliers[b] & ref.inliers[b]
        if both.any():
            assert float((got.flow[b] - ref.flow[b]).abs()[both].max()) \
                < 1e-2, b
    # the prior set bounds the inliers
    assert not (got.inliers & ~args[4]).any()


@pytest.mark.parametrize("B,N,layout", [
    (1, 3000, "camera"),          # the camera solve
    (8, 4000, "main path"),       # the object batch
    (3, 300, "main path"),
    (3, 12000, "main path"),      # 1,500 points a CTA of 8
    (1, 40000, "camera"),         # a CTA's share too large for shared memory
])
def test_flow_joint_kernel_matches_plain(B, N, layout):
    _need_card()
    cam, args = _joint_args(B, N, layout, seed=B + N)
    plan = flow_joint_kernel.launch_plan(B, N)
    assert (plan.smem_bytes == 0) == (N == 40000)
    before = flow_joint_kernel.flow_joint_batched.launches
    got = flow_joint_kernel.flow_joint_batched(*args, cam)
    assert flow_joint_kernel.flow_joint_batched.launches == before + 1
    ref = flow_joint_kernel.flow_joint_batched_ref(*args, cam)
    torch.cuda.synchronize()
    assert (got.num_iters >= 1).all()
    _hold_flow_joint(got, ref, args)


@pytest.mark.parametrize("case", [
    "object with an empty mask",     # the main path's batch, one mask empty
    "object with 4 points",          # fewer than MIN_EDGES
    "camera with 200 points",        # fewer than the cluster's threads
    "N=1",
])
def test_flow_joint_kernel_small_problems(case):
    """Problems with few or no points: the plan's clusters still run them,
    and one with fewer than MIN_EDGES active points takes no step and counts
    the plain version's iterations (all rejected: 10 a round)."""
    _need_card()
    if case.startswith("object"):
        cam, args = _joint_args(8, 4000, "main path", seed=41)
        valid = args[4].clone()
        if case.endswith("empty mask"):
            valid[5] = False
        else:
            valid[5] &= torch.cumsum(valid[5].int(), 0) <= 4
        args = args[:4] + (valid,)
        few = [5]
    elif case.startswith("camera"):
        cam, args = _joint_args(1, 3000, "camera", seed=42)
        keep = torch.zeros_like(args[4])
        keep[:, ::15] = True
        args = args[:4] + (args[4] & keep,)
        assert 100 < int(args[4].sum()) < 2 * 256
        few = []
    else:
        cam, args = _joint_args(2, 1, "main path", seed=43)
        args = args[:4] + (torch.ones_like(args[4]),)
        few = [0, 1]
    got = flow_joint_kernel.flow_joint_batched(*args, cam)
    ref = flow_joint_kernel.flow_joint_batched_ref(*args, cam)
    torch.cuda.synchronize()
    _hold_flow_joint(got, ref, args)
    for b in few:
        assert got.num_iters[b].tolist() == ref.num_iters[b].tolist() \
            == [flow_joint_kernel.ROUND_ITERS] * 4, b
        assert torch.equal(got.T[b], args[0][b])
        assert torch.equal(got.flow[b], ref.flow[b])


@pytest.mark.parametrize("B,N,layout", [(1, 3000, "camera"),
                                        (8, 4000, "main path")])
def test_flow_joint_kernel_is_deterministic(B, N, layout):
    _need_card()
    cam, args = _joint_args(B, N, layout, seed=7)
    a = flow_joint_kernel.flow_joint_batched(*args, cam)
    b = flow_joint_kernel.flow_joint_batched(*args, cam)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_launchers_refuse_plans_they_cannot_run():
    """The C launchers check the wrapper's plan and return an error
    (cudaErrorInvalidValue, 1) instead of launching."""
    _need_card()
    f = torch.randn(1, 16, 20, 40, device="cuda")
    out = torch.empty(1, 49, 20, 40, device="cuda")
    plan = correlation.launch_plan(1, 16, 20, 40, 1)
    assert correlation._launch(f, f, 1, plan, out) == 0
    for bad in (dict(split=16, grid=(plan.grid[0] * 4, 1)),
                dict(split=32, grid=(plan.grid[0] * 8, 1)),
                dict(grid=(plan.grid[0] + 1, 1)),
                dict(smem_bytes=plan.smem_bytes - 4), dict(tile_h=6)):
        assert correlation._launch(f, f, 1, plan._replace(**bad), out) == 1, \
            bad

    cam, args = _problems(1, 500, False, None, seed=3)
    out = lm_kernel.empty_batch(1, 500, "cuda")
    plan = lm_kernel.launch_plan(1, 500)
    assert lm_kernel._launch(args, cam, plan, out) == 0
    for bad in (dict(cluster=16), dict(threads=48), dict(threads=512),
                dict(cap=plan.cap // 2), dict(smem_bytes=plan.smem_bytes + 4),
                dict(smem_bytes=0)):   # no scratch given
        assert lm_kernel._launch(args, cam, plan._replace(**bad), out) == 1, \
            bad

    feats, rois, levels, scales, res, s = _roi_args(20, 16, 7, seed=3)
    levels = levels.to(torch.int32).contiguous()
    out = torch.empty(20, 16, 7, 7, device="cuda")
    plan = roi_align.launch_plan(20, 16, 7, 2, roi_align.level_sizes(feats))
    assert roi_align._launch(feats, rois, levels, scales, 7, 2, plan,
                             out) == 0
    for bad in (dict(group=0), dict(group=17), dict(threads=32),
                dict(threads=512), dict(threads=100),
                dict(smem_bytes=plan.smem_bytes + 4),
                dict(smem_bytes=8 * (28 * 28 + 49) - 8)):  # a grid too big
        assert roi_align._launch(feats, rois, levels, scales, 7, 2,
                                 plan._replace(**bad), out) == 1, bad
    assert roi_align._launch(feats, rois, levels, scales, 7, 5, plan,
                             out) == 1   # sampling ratio above 4

    cam, args = _joint_args(1, 500, "camera", seed=3)
    out = flow_joint_kernel.empty_batch(1, 500, "cuda")
    plan = flow_joint_kernel.launch_plan(1, 500)
    assert flow_joint_kernel._launch(args, cam, 10, plan, out) == 0
    for bad in (dict(cluster=16), dict(threads=48), dict(threads=512),
                dict(cap=plan.cap // 2), dict(smem_bytes=plan.smem_bytes + 4),
                dict(smem_bytes=0)):   # no scratch given
        assert flow_joint_kernel._launch(args, cam, 10,
                                         plan._replace(**bad), out) == 1, bad
    torch.cuda.synchronize()


def test_flow_joint_kernel_checks_inputs():
    _need_card()
    cam, args = _joint_args(1, 200, "camera", seed=1)
    bad = list(args)
    bad[3] = args[3].double()
    with pytest.raises(TypeError):
        flow_joint_kernel.flow_joint_batched(*bad, cam)
    bad = list(args)
    bad[2] = args[2].t().contiguous().t()
    with pytest.raises(ValueError):
        flow_joint_kernel.flow_joint_batched(*bad, cam)
    bad = list(args)
    bad[4] = args[4][:, :100].contiguous()
    with pytest.raises(ValueError):
        flow_joint_kernel.flow_joint_batched(*bad, cam)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError):
        flow_joint_kernel.flow_joint_batched(*bad, cam)


def test_flow_joint_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    _need_card()
    cam, args = _joint_args(1, 500, "camera", seed=2)

    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(flow_joint_kernel, "flow_joint_batched_ref", refuse)
    out = flow_joint_kernel.flow_joint_batched(*args, cam)
    torch.cuda.synchronize()
    assert out.T.is_cuda and out.flow.is_cuda


# kernels 3 and 4: LiteFlowNet's cost volume and regularization tail, at
# the five pyramid levels of a 1280x576 pair (chip_smoke.CORR_LEVELS and
# REG_LEVELS) and of the online path's 640x192 pair (down to 6 x 20 at
# level 6), a ragged height and width, and two images
ONLINE_CORR_LEVELS = [(64, 96, 320, 2), (64, 48, 160, 2), (96, 24, 80, 1),
                      (128, 12, 40, 1), (192, 6, 20, 1)]
ONLINE_REG_LEVELS = [(7, 96, 320), (5, 48, 160), (5, 24, 80), (3, 12, 40),
                     (3, 6, 20)]


@pytest.mark.parametrize("N,C,H,W,stride", [
    (1,) + lv for lv in chip_smoke.CORR_LEVELS + ONLINE_CORR_LEVELS] + [
    (1, 64, 37, 53, 2),           # odd H and W at stride 2
    (1, 96, 19, 45, 1),
    (2, 64, 144, 320, 2),
    (2, 8, 13, 7, 1),             # fewer channels than a split of chunks
    (1, 50, 72, 160, 1),          # C not a multiple of split x chunk
    (2, 1, 37, 53, 2),            # C = 1, two images
    (2, 192, 18, 40, 1),          # the level-6 shape, two images
])
def test_correlation_kernel_matches_plain(N, C, H, W, stride):
    _need_card()
    rng = np.random.RandomState(C + H + W + stride)
    f1, f2 = (torch.tensor(rng.randn(N, C, H, W).astype(np.float32)).cuda()
              for _ in range(2))
    before = correlation.correlation.launches
    got = correlation.correlation(f1, f2, stride)
    assert correlation.correlation.launches == before + 1
    ref = correlation.correlation_ref(f1, f2, stride)
    torch.cuda.synchronize()
    assert got.shape == (N, 49, -(-H // stride), -(-W // stride))
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("level", [0, 4])
def test_correlation_kernel_is_deterministic(level):
    _need_card()
    C, H, W, stride = chip_smoke.CORR_LEVELS[level]
    rng = np.random.RandomState(level)
    f1, f2 = (torch.tensor(rng.randn(1, C, H, W).astype(np.float32)).cuda()
              for _ in range(2))
    plan = correlation.launch_plan(1, C, H, W, stride)
    assert plan.split > 1
    a = correlation.correlation(f1, f2, stride)
    b = correlation.correlation(f1, f2, stride)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("N,k,H,W", [
    (1,) + lv for lv in chip_smoke.REG_LEVELS + ONLINE_REG_LEVELS] + [
    (1, 7, 37, 53),               # ragged against the 32 x 8 block
    (2, 5, 144, 320),
    (2, 3, 5, 3),                 # smaller than a block and the window
])
def test_regularize_kernel_matches_plain(N, k, H, W):
    _need_card()
    rng = np.random.RandomState(N + k + H + W)
    K = k * k

    def t(a):
        return torch.tensor(np.asarray(a, np.float32)).cuda()

    args = (t(rng.randn(N, K, H, W)), t(rng.randn(N, 2, H, W) * 3),
            t(rng.randn(K)), t([0.3]), t(rng.randn(K)), t([-0.2]), k)
    before = regularize.dist_weighted_flow.launches
    got = regularize.dist_weighted_flow(*args)
    assert regularize.dist_weighted_flow.launches == before + 1
    ref = regularize.dist_weighted_flow_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (N, 2, H, W)
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all())


def _reg_args(N, k, H, W, seed, scale=1.0):
    """Seeded (dc, flow, wx, bx, wy, by, k) on the card: logits of
    `scale` times unit-normal, flows of a few px."""
    rng = np.random.RandomState(seed)
    K = k * k

    def t(a):
        return torch.tensor(np.asarray(a, np.float32)).cuda()

    return (t(rng.randn(N, K, H, W) * scale), t(rng.randn(N, 2, H, W) * 3),
            t(rng.randn(K)), t([0.3]), t(rng.randn(K)), t([-0.2]), k)


def _shifted(t):
    """A contiguous copy of t that starts one float past a 16-byte
    boundary."""
    store = torch.empty(t.numel() + 1, device=t.device)
    store[1:] = t.reshape(-1)
    return store[1:].view(t.shape)


@pytest.mark.parametrize("case", [
    "peaked level 2",             # dc x 10: one tap takes nearly all
    "peaked level 5",
    "all equal",                  # every tap the same weight
    "ragged width",               # level 2 at 288 x 637: 4-byte copies
    "storage offset",             # dc and flow one float past 16 bytes
])
def test_regularize_kernel_on_hard_inputs(case):
    _need_card()
    if case.startswith("peaked"):
        shape = (7, 288, 640) if case.endswith("2") else (3, 36, 80)
        args = _reg_args(1, *shape, seed=11, scale=10.0)
    elif case == "all equal":
        args = _reg_args(1, 5, 144, 320, seed=12)
        args = (torch.full_like(args[0], 0.7),) + args[1:]
    elif case == "ragged width":
        args = _reg_args(1, 7, 288, 637, seed=13)
    else:
        args = _reg_args(1, 7, 288, 640, seed=14)
        args = (_shifted(args[0]), _shifted(args[1])) + args[2:]
    assert regularize.copy_width(args[1]) == (
        4 if case in ("ragged width", "storage offset") else 16)
    got = regularize.dist_weighted_flow(*args)
    ref = regularize.dist_weighted_flow_ref(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all())


@pytest.mark.parametrize("level", [0, 4])
def test_regularize_kernel_is_deterministic(level):
    _need_card()
    args = _reg_args(1, *chip_smoke.REG_LEVELS[level], seed=level)
    a = regularize.dist_weighted_flow(*args)
    b = regularize.dist_weighted_flow(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_regularize_launcher_refuses_what_it_cannot_run():
    """Kernel 4's C launcher returns cudaErrorInvalidValue (1) instead of
    launching for a copy width or window it has no kernel for, and for
    16-byte flow copies of a flow that is not 16-byte aligned or a W that
    is not a multiple of 4."""
    _need_card()
    args = _reg_args(1, 7, 40, 64, seed=3)
    dc, flow, wx, bx, wy, by, k = args
    out = torch.empty((1, 2, 40, 64), device="cuda")
    assert regularize._launch(dc, flow, wx, bx, wy, by, k, 16, out) == 0
    assert regularize._launch(dc, flow, wx, bx, wy, by, k, 8, out) == 1
    assert regularize._launch(dc, flow, wx, bx, wy, by, 9, 4, out) == 1
    assert regularize._launch(dc, _shifted(flow), wx, bx, wy, by, k, 16,
                              out) == 1
    assert regularize._launch(dc, _shifted(flow), wx, bx, wy, by, k, 4,
                              out) == 0
    assert regularize._launch(_shifted(dc), flow, wx, bx, wy, by, k, 16,
                              out) == 0
    ragged = _reg_args(1, 7, 40, 63, seed=3)
    out = torch.empty((1, 2, 40, 63), device="cuda")
    assert regularize._launch(*ragged[:6], k, 16, out) == 1
    assert regularize._launch(*ragged[:6], k, 4, out) == 0
    torch.cuda.synchronize()


def test_flow_kernels_check_inputs(monkeypatch):
    _need_card()
    f = torch.randn(1, 8, 10, 12, device="cuda")
    with pytest.raises(ValueError):
        correlation.correlation(f, f.cpu(), 1)
    with pytest.raises(TypeError):
        correlation.correlation(f.half(), f.half(), 1)

    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(correlation, "correlation_ref", refuse)
    monkeypatch.setattr(regularize, "dist_weighted_flow_ref", refuse)
    assert correlation.correlation(f, f, 2).is_cuda
    w = torch.randn(9, device="cuda")
    b = torch.zeros(1, device="cuda")
    out = regularize.dist_weighted_flow(
        torch.randn(1, 9, 10, 12, device="cuda"), f[:, :2].contiguous(), w,
        b, w, b, 3)
    torch.cuda.synchronize()
    assert out.is_cuda


# kernel 5: the multilevel ROIAlign, at the heads' two resolutions on the
# P2-P5 of a 1088x800 image (chip_smoke.MASK_LEVELS), one level at a time,
# ragged R, C not a multiple of 64, boxes on and past the borders

def _roi_args(R, C, res, seed, level=None, border=False):
    rng = np.random.RandomState(seed)
    feats = [torch.tensor(rng.randn(1, C, h, w).astype(np.float32)).cuda()
             for h, w in chip_smoke.MASK_LEVELS]
    x1 = rng.uniform(-60, 800, R)
    y1 = rng.uniform(-60, 1088, R)
    ww, hh = np.exp(rng.uniform(np.log(0.3), np.log(1500), (2, R)))
    rois = np.stack([x1, y1, x1 + ww, y1 + hh], 1).astype(np.float32)
    if border:
        # boxes along the image's edges: on them, and reaching past them
        side = rng.uniform(4, 400, R)
        edge = rng.randint(0, 4, R)
        rois[:, :2] = np.where(edge[:, None] < 2, -side[:, None] / 2,
                               [799.0, 1087.0] - side[:, None] / 2)
        rois[:, 2:] = rois[:, :2] + side[:, None]
        rois[::3, :2] = 0.0
        rois[1::3, 2:] = [799.0, 1087.0]
    rois = torch.tensor(rois).cuda()
    levels = assign_fpn_level(rois) if level is None \
        else torch.full((R,), level, dtype=torch.int32).cuda()
    return feats, rois, levels, POOLER_SCALES, res, 2


@pytest.mark.parametrize("R,C,res,level,border", [
    (1000, 256, 7, None, False),     # the box head
    (100, 256, 14, None, False),     # the mask head
    (37, 256, 7, 0, False), (37, 256, 14, 1, False),
    (37, 256, 7, 2, False), (37, 256, 14, 3, False),
    (1, 256, 7, None, False),
    (37, 48, 14, None, False),       # C not a multiple of 64
    (1000, 5, 7, None, False),
    (200, 256, 7, None, True), (50, 256, 14, None, True),
])
def test_roi_align_kernel_matches_plain(R, C, res, level, border):
    _need_card()
    args = _roi_args(R, C, res, seed=R + C + res, level=level, border=border)
    before = roi_align.roi_align_multilevel.launches
    got = roi_align.roi_align_multilevel(*args)
    assert roi_align.roi_align_multilevel.launches == before + 1
    ref = roi_align.roi_align_multilevel_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (R, C, res, res)
    scale = max(1.0, max(float(f.abs().max()) for f in args[0]))
    assert float((got - ref).abs().max()) <= 1e-5 * scale


def test_roi_align_kernel_checks_inputs(monkeypatch):
    _need_card()
    feats, rois, levels, scales, res, s = _roi_args(20, 16, 7, seed=3)
    with pytest.raises(ValueError):
        roi_align.roi_align_multilevel(feats, rois.cpu(), levels, scales)
    with pytest.raises(ValueError):
        roi_align.roi_align_multilevel(feats, rois, levels.cpu(), scales)
    with pytest.raises(TypeError):
        roi_align.roi_align_multilevel([f.half() for f in feats],
                                       rois.half(), levels, scales)

    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(roi_align, "roi_align_multilevel_ref", refuse)
    out = roi_align.roi_align_multilevel(feats, rois, levels.long(), scales,
                                         14)
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == (20, 16, 14, 14)


# kernel 5 at the edges of its staging: the sample grid of a ROI is a
# contiguous window when its samples lie close, else their own lines

def _edge_rois(case):
    """(rois, levels) of one edge case at 1088x800, levels forced where the
    case is about one level."""
    if case == "whole image on each level":
        rois = [[0.0, 0.0, 800.0, 1088.0]] * 4
        return rois, [0, 1, 2, 3]
    if case == "sub-pixel":
        return ([[100.2, 200.3, 100.5, 200.6], [0.0, 0.0, 0.3, 0.2],
                 [799.5, 1087.6, 799.9, 1087.9], [400.0, 500.0, 400.0, 500.0]],
                [0, 0, 0, 1])
    if case == "wholly outside":
        return ([[-500.0, -400.0, -300.0, -200.0],
                 [900.0, 1200.0, 1000.0, 1300.0],
                 [-90.0, 300.0, -20.0, 400.0], [300.0, 1100.0, 400.0, 1180.0]],
                [0, 1, 2, 3])
    if case == "1500x10 elongated":
        return ([[-300.0, 500.0, 1200.0, 510.0], [300.0, -200.0, 310.0, 1300.0],
                 [-300.0, 500.0, 1200.0, 510.0], [300.0, -200.0, 310.0, 1300.0]],
                [0, 0, 1, 3])
    raise ValueError(case)


@pytest.mark.parametrize("case", ["whole image on each level", "sub-pixel",
                                  "wholly outside", "1500x10 elongated"])
@pytest.mark.parametrize("res", [7, 14])
def test_roi_align_kernel_edge_rois(case, res):
    _need_card()
    rng = np.random.RandomState(res)
    feats = [torch.tensor(rng.randn(1, 64, h, w).astype(np.float32)).cuda()
             for h, w in chip_smoke.MASK_LEVELS]
    rois, levels = _edge_rois(case)
    rois = torch.tensor(rois, dtype=torch.float32).cuda()
    levels = torch.tensor(levels, dtype=torch.int32).cuda()
    args = (feats, rois, levels, POOLER_SCALES, res, 2)
    got = roi_align.roi_align_multilevel(*args)
    ref = roi_align.roi_align_multilevel_ref(*args)
    torch.cuda.synchronize()
    scale = max(1.0, max(float(f.abs().max()) for f in feats))
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    if case == "wholly outside":
        assert not got.any()


@pytest.mark.parametrize("R,C,res", [(1000, 200, 7), (300, 37, 14)])
def test_roi_align_kernel_channels_not_a_multiple_of_the_group(R, C, res):
    _need_card()
    args = _roi_args(R, C, res, seed=R + C)
    plan = roi_align.launch_plan(R, C, res, 2, chip_smoke.MASK_LEVELS)
    assert C % plan.group != 0
    got = roi_align.roi_align_multilevel(*args)
    ref = roi_align.roi_align_multilevel_ref(*args)
    torch.cuda.synchronize()
    scale = max(1.0, max(float(f.abs().max()) for f in args[0]))
    assert float((got - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("R,res", [(1000, 7), (100, 14)])
def test_roi_align_kernel_is_deterministic(R, res):
    _need_card()
    args = _roi_args(R, 256, res, seed=9)
    a = roi_align.roi_align_multilevel(*args)
    b = roi_align.roi_align_multilevel(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# kernel 5 at the detector families' shapes (chip_smoke.py phase (m)):
# FBNet's pooler, one level (the stride-16 trunk of 1088x800, 68x50) at
# 6x6 over 200 ROIs with every registered arch's trunk width; the keypoint
# head, P2-P5 at 14x14 over 100 ROIs

@pytest.mark.parametrize("C", [96, 128, 88, 56])
def test_roi_align_kernel_at_the_fbnet_pooler(C):
    _need_card()
    rng = np.random.RandomState(C)
    trunk = torch.tensor(rng.randn(1, C, 68, 50).astype(np.float32)).cuda()
    x1 = rng.uniform(-20, 800, 200)
    y1 = rng.uniform(-20, 1088, 200)
    ww, hh = np.exp(rng.uniform(np.log(0.5), np.log(1100), (2, 200)))
    rois = torch.tensor(np.stack([x1, y1, x1 + ww, y1 + hh], 1)
                        .astype(np.float32)).cuda()
    levels = torch.zeros(200, dtype=torch.int32).cuda()
    args = ([trunk], rois, levels, (1.0 / 16,), 6, 2)
    before = roi_align.roi_align_multilevel.launches
    got = roi_align.roi_align_multilevel(*args)
    again = roi_align.roi_align_multilevel(*args)
    assert roi_align.roi_align_multilevel.launches == before + 2
    ref = roi_align.roi_align_multilevel_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (200, C, 6, 6) and torch.equal(got, again)
    scale = max(1.0, float(trunk.abs().max()))
    assert float((got - ref).abs().max()) <= 1e-5 * scale


def test_roi_align_kernel_at_the_keypoint_head():
    _need_card()
    args = _roi_args(100, 256, 14, seed=17)
    got = roi_align.roi_align_multilevel(*args)
    ref = roi_align.roi_align_multilevel_ref(*args)
    torch.cuda.synchronize()
    scale = max(1.0, max(float(f.abs().max()) for f in args[0]))
    assert float((got - ref).abs().max()) <= 1e-5 * scale


def test_detector_families_pool_through_kernel_5(monkeypatch):
    """FBNet's box head and the keypoint head on the card launch kernel 5
    once each and never its plain version; ROIPool gives the CPU's
    bits."""
    _need_card()
    from vido_slam_tpu_torch.models.maskrcnn import fbnet, keypoint_head
    from vido_slam_tpu_torch.ops.roi_pool import roi_pool

    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(roi_align, "roi_align_multilevel_ref", refuse)
    before = roi_align.roi_align_multilevel.launches
    model = fbnet.FBNet("default", device="cuda")
    det = fbnet.fbnet_inference(model, torch.rand(1, 3, 128, 160,
                                                  device="cuda"), 128, 160)
    assert roi_align.roi_align_multilevel.launches == before + 1
    head = keypoint_head.KeypointHead(device="cuda")
    feats, rois, _, _, _, _ = _roi_args(100, 256, 14, seed=5)
    hm = keypoint_head.keypoint_head_forward(head, feats, rois)
    torch.cuda.synchronize()
    assert roi_align.roi_align_multilevel.launches == before + 2
    assert hm.shape == (100, 17, 56, 56) and bool(torch.isfinite(hm).all())
    assert det.boxes.is_cuda
    pooled = roi_pool(feats[2], rois, 1.0 / 16, 7)
    assert torch.equal(pooled.cpu(), roi_pool(feats[2].cpu(), rois.cpu(),
                                              1.0 / 16, 7))


# ---------------------------------------------------------------------------
# chip_smoke.py phase (i): the single-problem object estimators (kernels 1
# and 2 at B=1) and kernel 5 on the GroupNorm detector's arguments
# ---------------------------------------------------------------------------

def _recording(monkeypatch, module, attr):
    """Stand in for ``module.attr`` with chip_smoke's argument recorder."""
    rec = chip_smoke.KernelArgs(getattr(module, attr))
    monkeypatch.setattr(module, attr, rec)
    return rec


@pytest.mark.parametrize("seed", [1, 2])
def test_single_object_estimators_launch_b1_kernels(monkeypatch, seed):
    """estimate_object_motion (kernel 1, B=1, T_pre = Tcw) and
    estimate_object_motion_joint (kernel 2, B=1) on one object of chip_smoke's
    object layout: one launch each, each held against its plain version."""
    _need_card()
    from vido_slam_tpu_torch.estimation import flow_joint, pose
    from vido_slam_tpu_torch.utils import prng

    cam = _cam()
    rng = np.random.RandomState(seed)
    Tcw = chip_smoke._pose([0.0, 0.02, 0.0], [0.1, 0.0, -3.0])
    M0, X, obs_last, fm, masks = (t.cuda() for t in
                                  chip_smoke.joint_object_problems(
                                      rng, cam, 1, 4000, Tcw))
    Tcw = Tcw.cuda()
    H_mm = inverse_se3(Tcw) @ M0[0]
    key = prng.PRNGKey(seed, "cuda")
    lm_rec = _recording(monkeypatch, pose, "pose_lm_batched")
    fj_rec = _recording(monkeypatch, flow_joint, "flow_joint_batched")
    counts = (lm_kernel.pose_lm_batched.launches,
              flow_joint_kernel.flow_joint_batched.launches)
    est = pose.estimate_object_motion(key, Tcw, X, obs_last + fm, masks[0],
                                      cam, H_mm, True)
    est_j, flow = flow_joint.estimate_object_motion_joint(
        key, Tcw, X, obs_last, obs_last + fm, masks[0], cam, H_mm, True)
    torch.cuda.synchronize()
    assert lm_kernel.pose_lm_batched.launches == counts[0] + 1
    assert flow_joint_kernel.flow_joint_batched.launches == counts[1] + 1
    assert int(est.num_inliers) > 100 and int(est_j.num_inliers) > 100
    assert flow.shape == (4000, 2)
    (args, kw), = lm_rec.calls
    assert args[0].shape == (1, 4, 4) and kw["huber_delta"] is None
    got = lm_kernel.pose_lm_batched(*args, cam, **kw)
    ref = lm_kernel.pose_lm_batched_ref(*args, cam, **kw)
    _hold_pose_lm(got, ref, args[4])
    (args, _), = fj_rec.calls
    assert args[0].shape == (1, 4, 4)
    got = flow_joint_kernel.flow_joint_batched(*args, cam)
    ref = flow_joint_kernel.flow_joint_batched_ref(*args, cam)
    _hold_flow_joint(got, ref, args)


def test_roi_align_kernel_on_the_gn_detector(monkeypatch):
    """Kernel 5 on the arguments the GroupNorm R-50-FPN (seed 0, class 3
    lifted) gives it on one 1280x560 driving-clip frame: both heads. (Its
    random weights give boxes too thin for the paste to fill: the mask is
    held to its shape only.)"""
    _need_card()
    from vido_slam_tpu_torch.io.synthetic import driving_clip
    from vido_slam_tpu_torch.models.maskrcnn import roi_heads
    from vido_slam_tpu_torch.models.maskrcnn.backbone import ResNetConfig
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           MaskRCNNConfig)
    from vido_slam_tpu_torch.models.perception import perception_mask

    c = chip_smoke.OFFLINE_CONFIG
    frame = driving_clip(height=560, width=1280, n_frames=1,
                         fx=c["Camera.fx"], fy=c["Camera.fy"],
                         device="cuda")[0]
    model = chip_smoke.lifted(MaskRCNN(
        MaskRCNNConfig(resnet=ResNetConfig(norm="gn")), seed=0,
        device="cuda"))
    rec = chip_smoke.KernelArgs(roi_heads.roi_align_multilevel, 6)
    monkeypatch.setattr(roi_heads, "roi_align_multilevel", rec)
    mask = perception_mask(model, frame, device="cuda")
    torch.cuda.synchronize()
    assert mask.shape == (560, 1280) and mask.dtype == torch.uint8
    assert [a[0][1].shape[0] for a in rec.calls] == [1000, 100]
    for args, _ in rec.calls:
        got = roi_align.roi_align_multilevel(*args)
        again = roi_align.roi_align_multilevel(*args)
        ref = roi_align.roi_align_multilevel_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        scale = max(1.0, max(float(f.abs().max()) for f in args[0]))
        assert float((got - ref).abs().max()) <= 1e-5 * scale


# the bf16 builds of kernels 3, 4 and 5 (the bf16 perception options)
# against their bf16 plain versions: both compute in float32 from bf16
# inputs and round to bf16 where the JAX package does; only the order of
# the float32 sums differs, by at most the float32 builds' bar (1e-5 of
# the output's scale, where a sum cancels), which moves a rounding to bf16
# by at most one bf16 step beyond it

def _within_bf16_ulp(got, ref):
    assert got.dtype == ref.dtype == torch.bfloat16
    assert got.shape == ref.shape
    d = (got.float() - ref.float()).abs()
    bar = chip_smoke.bf16_bar(ref)
    assert bool((d <= bar).all()), float((d - bar).max())


@pytest.mark.parametrize("N,C,H,W,stride", [
    (1,) + lv for lv in chip_smoke.CORR_LEVELS + ONLINE_CORR_LEVELS] + [
    (1, 64, 37, 53, 2), (2, 8, 13, 7, 1), (2, 1, 37, 53, 2)])
def test_correlation_bf16_build_matches_plain(N, C, H, W, stride):
    _need_card()
    rng = np.random.RandomState(C + H + W + stride)
    f1, f2 = (torch.tensor(rng.randn(N, C, H, W).astype(np.float32)).cuda()
              .to(torch.bfloat16) for _ in range(2))
    before = correlation.correlation.launches
    got = correlation.correlation(f1, f2, stride)
    assert correlation.correlation.launches == before + 1
    again = correlation.correlation(f1, f2, stride)
    ref = correlation.correlation_ref(f1, f2, stride)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _within_bf16_ulp(got, ref)


@pytest.mark.parametrize("N,k,H,W", [
    (1,) + lv for lv in chip_smoke.REG_LEVELS + ONLINE_REG_LEVELS] + [
    (1, 7, 37, 53), (2, 3, 5, 3)])
def test_regularize_bf16_build_matches_plain(N, k, H, W):
    _need_card()
    args = tuple(a.to(torch.bfloat16) if torch.is_tensor(a) else a
                 for a in _reg_args(N, k, H, W, seed=N + k + H + W))
    before = regularize.dist_weighted_flow.launches
    got = regularize.dist_weighted_flow(*args)
    assert regularize.dist_weighted_flow.launches == before + 1
    ref = regularize.dist_weighted_flow_ref(*args)
    torch.cuda.synchronize()
    _within_bf16_ulp(got, ref)


@pytest.mark.parametrize("R,C,res,level,border", [
    (1000, 256, 7, None, False), (100, 256, 14, None, False),
    (37, 256, 7, 0, False), (37, 256, 14, 1, False),
    (37, 256, 7, 2, False), (37, 256, 14, 3, False),
    (37, 48, 14, None, False), (200, 256, 7, None, True),
])
def test_roi_align_bf16_build_matches_plain(R, C, res, level, border):
    _need_card()
    feats, rois, levels, scales, res, s = _roi_args(R, C, res, seed=R + res,
                                                    level=level,
                                                    border=border)
    feats = [f.to(torch.bfloat16) for f in feats]
    before = roi_align.roi_align_multilevel.launches
    got = roi_align.roi_align_multilevel(feats, rois, levels, scales, res, s)
    assert roi_align.roi_align_multilevel.launches == before + 1
    again = roi_align.roi_align_multilevel(feats, rois, levels, scales, res,
                                           s)
    ref = roi_align.roi_align_multilevel_ref(feats, rois, levels, scales,
                                             res, s)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _within_bf16_ulp(got, ref)


def test_kernel_wrappers_refuse_mixed_and_half_dtypes_on_the_card():
    """float16, or float32 beside bf16, raises before any launch; nothing
    is cast quietly."""
    _need_card()
    f = torch.randn(1, 8, 10, 12, device="cuda")
    launches = (correlation.correlation.launches,
                regularize.dist_weighted_flow.launches,
                roi_align.roi_align_multilevel.launches)
    with pytest.raises(TypeError):
        correlation.correlation(f, f.to(torch.bfloat16), 1)
    with pytest.raises(TypeError):
        correlation.correlation(f.half(), f.half(), 1)
    w, b = torch.randn(9, device="cuda"), torch.zeros(1, device="cuda")
    dc = torch.randn(1, 9, 10, 12, device="cuda")
    flow = f[:, :2].contiguous()
    with pytest.raises(TypeError):
        regularize.dist_weighted_flow(dc.to(torch.bfloat16),
                                      flow.to(torch.bfloat16), w, b, w, b, 3)
    with pytest.raises(TypeError):
        regularize.dist_weighted_flow(*(t.half() for t in
                                        (dc, flow, w, b, w, b)), 3)
    feats, rois, levels, scales, _, _ = _roi_args(20, 16, 7, seed=3)
    with pytest.raises(TypeError):
        roi_align.roi_align_multilevel(
            [feats[0].to(torch.bfloat16)] + feats[1:], rois, levels, scales)
    with pytest.raises(TypeError):
        roi_align.roi_align_multilevel([x.to(torch.bfloat16) for x in feats],
                                       rois.to(torch.bfloat16), levels,
                                       scales)
    assert (correlation.correlation.launches,
            regularize.dist_weighted_flow.launches,
            roi_align.roi_align_multilevel.launches) == launches


def _transfer_tree():
    """A StepOutputs-like tree: float, int16 and bool leaves, a nested
    tuple, an empty leaf and a scalar."""
    g = torch.Generator(device="cuda").manual_seed(0)
    return (torch.randn(300, 2, device="cuda", generator=g),
            (torch.arange(7, dtype=torch.int16, device="cuda"),
             torch.rand(1001, device="cuda", generator=g) > 0.5),
            torch.zeros(0, 3, device="cuda"),
            torch.tensor(5, dtype=torch.int32, device="cuda"))


def _leaves_equal(a, b):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)


@pytest.mark.parametrize("in_flight", [1, 2, 4])
def test_async_host_copy_matches_to_host(in_flight):
    """``to_host_async`` gives ``to_host``'s arrays, through pinned buffers,
    one a copy in flight, each back in its pool once read and reused by
    the next copies of the same size."""
    _need_card()
    from vido_slam_tpu_torch.utils import transfer

    tree = _transfer_tree()
    want = transfer.to_host(tree)
    copies = [transfer.to_host_async(tree) for _ in range(in_flight)]
    bufs = [c._buf for c in copies]
    assert all(b.is_pinned() for b in bufs)
    assert len({b.data_ptr() for b in bufs}) == in_flight
    for c in copies:
        got = c.get()
        _leaves_equal(got, want)
        assert c.get() is got
    again = [transfer.to_host_async(tree) for _ in range(in_flight)]
    assert {c._buf.data_ptr() for c in again} <= {b.data_ptr() for b in bufs}
    for c in again:
        _leaves_equal(c.get(), want)


def test_async_host_copy_survives_later_work():
    """The copy reads the step's outputs as they were when it was enqueued:
    later work on the stream that overwrites them does not reach it."""
    _need_card()
    from vido_slam_tpu_torch.utils import transfer

    x = torch.randn(1 << 20, device="cuda")
    want = x.cpu().numpy()
    c = transfer.to_host_async((x,))
    for _ in range(20):
        x.mul_(2.0)
    np.testing.assert_array_equal(c.get()[0], want)


# kernel 5b: the gradient of kernel 5 with respect to the features, the
# backward kernel against the autograd of the plain version on the same
# CUDA tensors. Atomics sum in a run-to-run order, so the bar is 1e-5 of
# max |plain gradient| over the levels, not the bits.

def _roi_grads_plain(feats, rois, levels, scales, res, s, g):
    fs = [f.detach().clone().requires_grad_() for f in feats]
    out = roi_align.roi_align_multilevel_ref(fs, rois, levels, scales, res, s)
    return torch.autograd.grad(out, fs, g, allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("R,C,res,level,border", [
    (1000, 256, 7, None, False),     # the box head
    (64, 256, 14, None, False),      # the mask head of the trainer
    (100, 256, 14, None, False),     # the mask head at inference
    (37, 256, 7, 0, False), (37, 48, 14, 3, False),
    (1, 256, 7, None, False), (200, 256, 7, None, True),
    (50, 5, 14, None, True),
])
def test_roi_align_backward_matches_plain(R, C, res, level, border):
    _need_card()
    feats, rois, levels, scales, res, s = _roi_args(
        R, C, res, seed=R + C + res + 1, level=level, border=border)
    g = torch.randn(R, C, res, res, device="cuda")
    before = roi_align.roi_align_multilevel_backward.launches
    got = roi_align.roi_align_multilevel_backward(
        g, roi_align.level_sizes(feats), rois, levels.to(torch.int32),
        scales, res, s)
    assert roi_align.roi_align_multilevel_backward.launches == before + 1
    ref = _roi_grads_plain(feats, rois, levels, scales, res, s, g)
    torch.cuda.synchronize()
    assert [a.shape for a in got] == [b.shape for b in ref]
    gmax = max(float(b.abs().max()) for b in ref)
    assert gmax > 0
    assert max(float((a - b).abs().max()) for a, b in zip(got, ref)) <= \
        1e-5 * gmax


def test_roi_align_output_carries_a_grad_fn_on_the_card(monkeypatch):
    """On CUDA the pooled features keep their graph: backward launches
    kernel 5b once and the plain version is never called; the ROIs and
    the bf16 build refuse a gradient."""
    _need_card()
    feats, rois, levels, scales, res, s = _roi_args(40, 32, 7, seed=11)

    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    leaves = [f.clone().requires_grad_() for f in feats]
    g = torch.randn(40, 32, 7, 7, device="cuda")
    ref = _roi_grads_plain(feats, rois, levels, scales, res, s, g)
    monkeypatch.setattr(roi_align, "roi_align_multilevel_ref", refuse)
    f0 = roi_align.roi_align_multilevel.launches
    b0 = roi_align.roi_align_multilevel_backward.launches
    out = roi_align.roi_align_multilevel(leaves, rois, levels, scales, res, s)
    assert out.grad_fn is not None
    out.backward(g)
    torch.cuda.synchronize()
    assert roi_align.roi_align_multilevel.launches == f0 + 1
    assert roi_align.roi_align_multilevel_backward.launches == b0 + 1
    gmax = max(float(r.abs().max()) for r in ref)
    assert gmax > 0
    assert max(float((leaf.grad - r).abs().max())
               for leaf, r in zip(leaves, ref)) <= 1e-5 * gmax
    with pytest.raises(RuntimeError, match="ROIs"):
        roi_align.roi_align_multilevel(leaves, rois.clone().requires_grad_(),
                                       levels, scales, res, s)
    bf = [f.to(torch.bfloat16).requires_grad_() for f in feats]
    out = roi_align.roi_align_multilevel(bf, rois, levels, scales, res, s)
    with pytest.raises(NotImplementedError, match="bf16"):
        out.float().sum().backward()


def test_kernels_without_backward_refuse_a_gradient():
    """Kernels 1-4 have no backward (nor have their Pallas counterparts):
    a CUDA input that asks for a gradient raises while autograd records,
    and the same call runs under no_grad."""
    _need_card()
    f = torch.randn(1, 8, 10, 12, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        correlation.correlation(f, f.detach(), 1)
    w = torch.randn(9, device="cuda")
    b = torch.zeros(1, device="cuda")
    dc = torch.randn(1, 9, 10, 12, device="cuda")
    flow = f[:, :2].detach().contiguous().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        regularize.dist_weighted_flow(dc, flow, w, b, w, b, 3)
    cam, args = _problems(2, 300, False, None, seed=5)
    grad_args = (args[0].clone().requires_grad_(),) + args[1:]
    with pytest.raises(RuntimeError, match="no backward"):
        lm_kernel.pose_lm_batched(*grad_args, cam)
    cam2, jargs = _joint_args(2, 300, "main path", seed=6)
    jgrad = (jargs[0].clone().requires_grad_(),) + tuple(jargs[1:])
    with pytest.raises(RuntimeError, match="no backward"):
        flow_joint_kernel.flow_joint_batched(*jgrad, cam2)
    with torch.no_grad():
        assert correlation.correlation(f, f, 1).is_cuda
        assert regularize.dist_weighted_flow(dc, flow, w, b, w, b, 3).is_cuda
        lm_kernel.pose_lm_batched(*grad_args, cam)
        flow_joint_kernel.flow_joint_batched(*jgrad, cam2)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# chip_smoke.py phase (o): kernel 1 under multi_sequence_tracking and kernel
# 5 under sharded_detection_inference
# ---------------------------------------------------------------------------

def test_multi_sequence_tracking_launches_kernel_1(monkeypatch):
    """Two 6-frame sequences of the offline scene at 1280x560 at the JAX
    defaults: kernel 1 twice a tracked frame a sequence, never its plain
    version, and one frame's calls held against the plain version."""
    _need_card()
    from vido_slam_tpu_torch.config import config_from_dict
    from vido_slam_tpu_torch.estimation import pose
    from vido_slam_tpu_torch.parallel.slam_eval import multi_sequence_tracking

    def refuse(*a, **k):
        raise AssertionError("plain version called with CUDA tensors")

    seq = chip_smoke.offline_sequence(9, "cuda")
    frames = [seq.frames[:6], seq.frames[3:9]]

    def stacked(field):
        return torch.stack([torch.stack([torch.as_tensor(getattr(f, field))
                                         for f in fr]) for fr in frames])
    rec = _recording(monkeypatch, pose, "pose_lm_batched")
    monkeypatch.setattr(lm_kernel, "pose_lm_batched_ref", refuse)
    before = lm_kernel.pose_lm_batched.launches
    res = multi_sequence_tracking(
        config_from_dict(chip_smoke.OFFLINE_CONFIG), stacked("depth"),
        stacked("flow"), stacked("mask").to(torch.int32),
        **chip_smoke.MULTI_KW, device="cuda")
    torch.cuda.synchronize()
    assert lm_kernel.pose_lm_batched.launches == before + 2 * 2 * 5
    assert res.Tcw.is_cuda and bool(torch.isfinite(res.Tcw).all())
    monkeypatch.undo()
    (cam_args, cam_kw), (obj_args, obj_kw) = rec.calls[2:4]
    for args, kw in ((cam_args, cam_kw), (obj_args, obj_kw)):
        got = lm_kernel.pose_lm_batched(*args, seq.scene.cam, **kw)
        ref = lm_kernel.pose_lm_batched_ref(*args, seq.scene.cam, **kw)
        _hold_pose_lm(got, ref, args[4])


def test_detection_inference_launches_kernel_5(monkeypatch):
    """``sharded_detection_inference`` of the R-50-FPN (class 3 lifted) at
    320x256 on two 0..1 frames: kernel 5 twice an image, each call held
    against the plain version; the outputs stacked with a leading 2."""
    _need_card()
    from vido_slam_tpu_torch.models.maskrcnn import roi_heads
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           MaskRCNNConfig)
    from vido_slam_tpu_torch.parallel.eval import sharded_detection_inference

    model = chip_smoke.lifted(MaskRCNN(MaskRCNNConfig(input_h=320,
                                                      input_w=256),
                                       seed=0, device="cuda"))
    rec = chip_smoke.KernelArgs(roi_heads.roi_align_multilevel, 6)
    monkeypatch.setattr(roi_heads, "roi_align_multilevel", rec)
    images = torch.rand(2, 3, 320, 256, generator=torch.Generator()
                        .manual_seed(3)).cuda()
    before = roi_align.roi_align_multilevel.launches
    out = sharded_detection_inference(model, images, device="cuda")
    torch.cuda.synchronize()
    assert roi_align.roi_align_multilevel.launches == before + 4
    assert tuple(out.boxes.shape) == (2, 100, 4) and out.valid.any()
    for args, _ in rec.calls:
        got = roi_align.roi_align_multilevel(*args)
        ref = roi_align.roi_align_multilevel_ref(*args)
        torch.cuda.synchronize()
        scale = max(1.0, max(float(f.abs().max()) for f in args[0]))
        assert float((got - ref).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# chip_smoke.py phase (p): the mesh detector step on one NCCL rank
# ---------------------------------------------------------------------------

def test_mesh_detector_step_on_one_nccl_rank_equals_the_step_without():
    """The tiny detector (one block a stage, 64 FPN channels) at 64x96: one
    SGD step of two 0..1 images on a mesh of one NCCL rank, against the
    same step without a mesh on the card: kernels 5 and 5b launched 4
    times each in both, the loss equal to the bit (a one-rank all-reduce
    is the identity), every key's gradient within kernel 5b's bar of 1e-5
    of its max |g| (5b adds with atomics: not the bits)."""
    _need_card()
    import torch.distributed as dist
    from vido_slam_tpu_torch.models.maskrcnn.backbone import ResNetConfig
    from vido_slam_tpu_torch.models.maskrcnn.model import (MaskRCNN,
                                                           MaskRCNNConfig)
    from vido_slam_tpu_torch.parallel import mesh as pmesh
    from vido_slam_tpu_torch.parallel import train as pt
    from vido_slam_tpu_torch.parallel.dryrun import (TINY_DETECTOR,
                                                     detector_batch)
    from vido_slam_tpu_torch.utils import prng

    cfg = MaskRCNNConfig(resnet=ResNetConfig(**TINY_DETECTOR), input_h=64,
                         input_w=96)
    batch = detector_batch(2)
    batch["image"] = batch["image"] / 255.0
    counters = (roi_align.roi_align_multilevel,
                roi_align.roi_align_multilevel_backward)
    own = not dist.is_initialized()
    if own:
        pmesh.init_distributed("cuda")
    try:
        mesh = pmesh.make_mesh(1)
        assert mesh.device.type == "cuda" and dist.get_backend() == "nccl"
        runs = []
        for m in (None, mesh):
            model = MaskRCNN(cfg, seed=4, device="cuda")
            step = pt.make_detection_train_step(model, lr=1e-3, mesh=m)
            before = [c.launches for c in counters]
            loss = float(step(batch, prng.PRNGKey(6)))
            torch.cuda.synchronize()
            runs.append((loss, {k: v.grad.clone() for k, v in
                                pt.trainable_state(model).items()},
                         [c.launches - b for c, b in zip(counters, before)]))
    finally:
        if own:
            dist.destroy_process_group()
    (ref, ref_grads, ref_n), (loss, grads, n) = runs
    assert ref_n == n == [4, 4]
    assert loss == ref
    for k, g in ref_grads.items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((grads[k] - g).abs().max()) <= 1e-5 * scale, k
