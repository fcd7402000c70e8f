"""The IMU math's device rule on the card: ``lm_solve`` and the inertial
init's closed-form stage refuse CUDA tensors instead of copying them to
the host and back (the CPU check with ``meta`` tensors is in
tests/test_torch_imu_init.py). Run on the card with

    python -m pytest --noconftest tests/test_torch_vio_gpu.py -m gpu"""

import pytest
import torch

from vido_slam_tpu_torch.estimation.imu_init import linear_alignment
from vido_slam_tpu_torch.estimation.lm import lm_solve


def _linear_alignment_on(dev):
    N = 6
    g = torch.Generator().manual_seed(0)
    return linear_alignment(
        torch.eye(3).repeat(N, 1, 1).to(dev),
        torch.randn(N, 3, generator=g).to(dev),
        torch.full((N - 1,), 0.1, device=dev),
        torch.randn(N - 1, 3, generator=g).to(dev),
        torch.randn(N - 1, 3, generator=g).to(dev),
        torch.ones(N - 1, dtype=torch.bool, device=dev),
        torch.eye(3, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["lm_solve", "linear_alignment"])
def test_cuda_tensors_are_refused(which):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    with pytest.raises(ValueError, match="CPU"):
        if which == "lm_solve":
            lm_solve(lambda x: x[:, None] * 2.0,
                     torch.zeros(3, device="cuda"))
        else:
            _linear_alignment_on("cuda")


def test_cpu_linear_alignment_runs():
    """The same call on the CPU solves: the refusal is the device's."""
    U, s, Rwg, dg = _linear_alignment_on("cpu")
    assert U.shape == (6, 3) and torch.isfinite(s) and Rwg.shape == (3, 3)
