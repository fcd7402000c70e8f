"""CUDA kernels of the port against their plain PyTorch versions, on the
card. Run there with

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu

(--noconftest: tests/conftest.py configures JAX, which the port's tests
here do not use.)
Each test decides inside itself whether a card is present and skips
without one. Bars: those of chip_smoke.py (per problem |log(T_ref^-1 T)| <
1e-4, |chi2 - chi2_ref| <= 1e-3 max(1, chi2_ref), at most 3 inlier
flips)."""

import numpy as np
import pytest
import torch

from vido_slam_tpu_torch.estimation import lm_kernel
from vido_slam_tpu_torch.estimation.pose import HUBER_DELTA_POSE, RP_THRES
from vido_slam_tpu_torch.geometry.camera import Camera
from vido_slam_tpu_torch.geometry.se3 import inverse_se3, log_se3, make_se3
from vido_slam_tpu_torch.geometry.so3 import exp_so3

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


@pytest.mark.parametrize("B,N,layout,huber", [
    (1, 3000, "own", HUBER_DELTA_POSE),             # the camera solve
    (8, 4000, "main path", None),                   # the object batch
    (8, 4000, "shared points", None),               # per-object observations
    (3, 100, "own", None),
    (2, 12000, "shared points", HUBER_DELTA_POSE),  # too large for shared
    (3, 12000, "main path", None),                  # memory
])
def test_pose_lm_kernel_matches_plain(B, N, layout, huber):
    _need_card()
    if layout == "main path":
        cam, args = _object_batch(B, N, seed=B + N)
    else:
        cam, args = _problems(B, N, layout == "shared points", huber,
                              seed=B * 7 + N)
    before = lm_kernel.pose_lm_batched.launches
    got = lm_kernel.pose_lm_batched(*args, cam, huber_delta=huber)
    assert lm_kernel.pose_lm_batched.launches == before + 1
    ref = lm_kernel.pose_lm_batched_ref(*args, cam, huber_delta=huber)
    torch.cuda.synchronize()
    assert torch.isfinite(got.T).all() and (got.num_iters > 0).all()
    for b in range(B):
        err = float(torch.linalg.norm(log_se3(inverse_se3(ref.T[b])
                                              @ got.T[b])))
        assert err < 1e-4, (b, err)
        # absolute 1e-3 for inliers; relative for the few-px outliers,
        # whose chi2 moves with the last ~1e-6 of the pose
        tol = 1e-3 * torch.clamp(ref.chi2[b].abs(), min=1.0)
        assert bool(((got.chi2[b] - ref.chi2[b]).abs() <= tol).all())
        flips = ((got.chi2[b] <= RP_THRES) != (ref.chi2[b] <= RP_THRES)) \
            & args[4][b]
        assert int(flips.sum()) <= 3


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
