"""How closely kernel 1 (the pose LM, ``csrc/pose_lm.cu``) follows its plain
version on one GPU, and how closely the plain version in float32 follows
itself in float64.

    python tools/lm_kernel_numerics.py

For each problem of ``tests/test_torch_kernels_gpu.py``'s
``test_pose_lm_kernel_matches_plain`` (the camera solve, the object batch
in the main path's layout, per-object observations of shared points,
12,000-point problems) and chip_smoke.py's two seeded problems, it prints:
the share of points whose chi2 at T_init the kernel and the plain version
give to the same bits (max_iters = 0); each problem's iterations in the
kernel, the plain version and the plain version on float64 inputs; and,
per problem, the pose difference |log(T_a^-1 T_b)| and the chi2 inlier
flips (valid points on different sides of 0.01) of kernel against plain
and of plain float32 against plain float64. The bars of the kernel are
chip_smoke.check_pose_lm's (pose < 1e-4, at most 3 flips). Prints a JSON
summary as its last line. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import chip_smoke  # noqa: E402
import test_torch_kernels_gpu as gpu_tests  # noqa: E402
from vido_slam_tpu_torch.estimation import lm_kernel  # noqa: E402
from vido_slam_tpu_torch.estimation.pose import (  # noqa: E402
    HUBER_DELTA_POSE, RP_THRES)
from vido_slam_tpu_torch.geometry.se3 import inverse_se3, log_se3  # noqa: E402


def problems():
    """(name, cam, args, keywords) of every problem."""
    out = []
    for B, N, layout, huber in [(1, 3000, "own", HUBER_DELTA_POSE),
                                (8, 4000, "main path", None),
                                (8, 4000, "shared points", None),
                                (2, 12000, "shared points", HUBER_DELTA_POSE),
                                (3, 12000, "main path", None)]:
        if layout == "main path":
            cam, args = gpu_tests._object_batch(B, N, seed=B + N)
        else:
            cam, args = gpu_tests._problems(B, N, layout == "shared points",
                                            huber, seed=B * 7 + N)
        out.append((f"B={B} N={N} {layout}", cam, args,
                    dict(huber_delta=huber)))
    rng = np.random.RandomState(0)
    cam = gpu_tests._cam()
    Tcw = chip_smoke._pose([0.0, 0.02, 0.0], [0.1, 0.0, -3.0])
    for name, args, huber in [
            ("seeded camera", chip_smoke.camera_problem(rng, cam, 3000),
             HUBER_DELTA_POSE),
            ("seeded objects", chip_smoke.object_problems(rng, cam, 8, 4000,
                                                          Tcw), None)]:
        out.append((name, cam, tuple(a.cuda().contiguous() for a in args),
                    dict(huber_delta=huber)))
    return out


def apart(a, b, valid):
    """Per problem: (pose difference, chi2 inlier flips) of a against b."""
    rows = []
    for i in range(valid.shape[0]):
        rot = float(torch.linalg.norm(
            log_se3(inverse_se3(b.T[i].float()) @ a.T[i].float())))
        flips = int((((a.chi2[i] <= RP_THRES)
                      != (b.chi2[i].float() <= RP_THRES)) & valid[i]).sum())
        rows.append((rot, flips))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_kernel_numerics: no CUDA device available", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card)
    summary = {"card": card}
    for name, cam, args, kw in problems():
        valid = args[4]
        at0 = dict(kw, max_iters=0)
        same = float((lm_kernel.pose_lm_batched(*args, cam, **at0).chi2
                      == lm_kernel.pose_lm_batched_ref(*args, cam, **at0).chi2)
                     .float().mean())
        got = lm_kernel.pose_lm_batched(*args, cam, **kw)
        ref = lm_kernel.pose_lm_batched_ref(*args, cam, **kw)
        ref64 = lm_kernel.pose_lm_batched_ref(
            *(a.double() if a.is_floating_point() else a for a in args), cam,
            **kw)
        torch.cuda.synchronize()
        kp, pp = apart(got, ref, valid), apart(ref, ref64, valid)
        summary[name] = dict(
            chi2_same_bits=same, iters=got.num_iters.tolist(),
            iters_plain=ref.num_iters.tolist(),
            iters_plain64=ref64.num_iters.tolist(),
            flips=[f for _, f in kp], flips_plain_vs_64=[f for _, f in pp],
            pose=max(r for r, _ in kp), pose_plain_vs_64=max(r for r, _ in pp))
        print(f"{name}: chi2 at T_init same bits {same:.4f}; iterations "
              f"kernel {got.num_iters.tolist()}, plain "
              f"{ref.num_iters.tolist()}, plain float64 "
              f"{ref64.num_iters.tolist()}; kernel vs plain flips "
              f"{[f for _, f in kp]} (pose {max(r for r, _ in kp):.1e}); "
              f"plain vs float64 flips {[f for _, f in pp]} (pose "
              f"{max(r for r, _ in pp):.1e})", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
