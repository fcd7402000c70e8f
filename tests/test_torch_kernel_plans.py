"""The launch plans of kernels 2 and 3 (``flow_joint_kernel.launch_plan``,
``correlation.launch_plan``), which each wrapper computes in Python and
the C launcher checks, at the main paths' shapes; and the kernel build's
hash over the headers a source includes. Runs on the CPU: no kernel is
built or launched."""

import pytest

import chip_smoke
from vido_slam_tpu_torch.estimation import flow_joint_kernel as fj
from vido_slam_tpu_torch.ops import correlation as corr
from vido_slam_tpu_torch.utils import cuda_build

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100


@pytest.mark.parametrize("level", range(2, 7))
def test_correlation_plan_at_the_flow_path_levels(level):
    C, H, W, stride = chip_smoke.CORR_LEVELS[level - 2]
    plan = corr.launch_plan(1, C, H, W, stride)
    Ho, Wo = -(-H // stride), -(-W // stride)
    tiles = -(-Wo // corr.TILE_W) * -(-Ho // plan.tile_h)
    assert plan.smem_bytes == corr.smem_bytes(plan.tile_h) <= SMEM_LIMIT
    assert 1 <= plan.split <= 8
    assert plan.grid == (plan.split * tiles, 1)
    assert (plan.tile_h * corr.TILE_W // 2) % 32 == 0   # whole warps
    # the CTA targets: >= 128 at levels 2-5, and at level 6 8x the 6
    # blocks of a grid of one block a tile
    ctas = plan.grid[0] * plan.grid[1]
    assert ctas >= (128 if level < 6 else 48), ctas
    # every rank sums at least one chunk of channels
    assert C // plan.split >= corr.CHUNK


@pytest.mark.parametrize("N,C,H,W,stride", [
    (1,) + lv for lv in chip_smoke.CORR_LEVELS] + [
    (1, 50, 72, 160, 1), (2, 1, 37, 53, 2), (2, 8, 13, 7, 1),
    (2, 192, 18, 40, 1), (3, 7, 5, 3, 1)])
def test_correlation_channel_split_covers_c_exactly(N, C, H, W, stride):
    plan = corr.launch_plan(N, C, H, W, stride)
    # rank r of a cluster sums channels [r C / split, (r+1) C / split)
    ranges = [(r * C // plan.split, (r + 1) * C // plan.split)
              for r in range(plan.split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi > lo for lo, hi in ranges)
    assert plan.grid[1] == N and plan.split <= C


@pytest.mark.parametrize("B,N", [(1, 3000), (8, 4000), (1, 12000),
                                 (3, 12000)])
def test_flow_joint_plan_at_the_main_path_shapes(B, N):
    plan = fj.launch_plan(B, N)
    assert 1 <= plan.cluster <= 8
    assert plan.cluster * B <= fj.SM_COUNT       # one wave of clusters
    assert plan.cap * plan.cluster >= N > (plan.cap - 1) * plan.cluster
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    # the compacted points stay in shared memory, 52 B each
    assert plan.smem_bytes == 52 * plan.cap
    assert plan.smem_bytes + fj.SMEM_RESERVE <= SMEM_LIMIT
    assert plan.scratch_floats == 0
    if (B, N) in ((1, 3000), (8, 4000)):
        assert plan.cluster == 8


def test_flow_joint_plan_takes_the_global_scratch_beyond_shared_memory():
    plan = fj.launch_plan(1, 40000)
    assert plan.cluster == 8 and plan.smem_bytes == 0
    assert plan.scratch_floats == 8 * fj.PLANES * plan.cap
    small = fj.launch_plan(1, 1)
    assert (small.cluster, small.threads, small.cap) == (1, 32, 1)


@pytest.mark.parametrize("B,N", [(1, 3000), (8, 4000), (3, 300), (2, 100)])
def test_flow_joint_compacted_shares_fit_a_cta(B, N):
    """Rank r keeps the compacted points [r n / G, (r+1) n / G) of the n in
    the prior set: for every n <= N the shares tile [0, n) and each fits the
    plan's cap."""
    plan = fj.launch_plan(B, N)
    G = plan.cluster
    for n in range(N + 1):
        bounds = [r * n // G for r in range(G + 1)]
        assert bounds[0] == 0 and bounds[-1] == n
        assert max(b - a for a, b in zip(bounds, bounds[1:])) <= plan.cap


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """An edit to a header that a source includes (through another header)
    renames the library, so it is rebuilt; an unrelated file does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "a.cuh"\nint k;\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text('#pragma once\nint b = 1;\n')
    (csrc / "c.cuh").write_text('int c;\n')
    monkeypatch.setattr(cuda_build, "_PKG", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    assert cuda_build.sources() == ["k"]
    first = cuda_build.library_path("k")
    (csrc / "c.cuh").write_text('int c = 2;\n')
    assert cuda_build.library_path("k") == first
    (csrc / "b.cuh").write_text('#pragma once\nint b = 2;\n')
    assert cuda_build.library_path("k") != first


def test_kernel_sources_and_their_headers():
    names = {n: [p.rsplit("/", 1)[-1] for p in
                 cuda_build._with_headers(cuda_build._source(n))]
             for n in cuda_build.sources()}
    assert names["flow_joint"] == ["flow_joint.cu", "lm_common.cuh"]
    for n in ("pose_lm", "correlation", "regularize", "roi_align"):
        assert names[n] == [f"{n}.cu"]
