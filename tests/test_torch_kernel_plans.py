"""The launch plans of kernels 1, 2, 3 and 5 (``lm_kernel.launch_plan``,
``flow_joint_kernel.launch_plan``, ``correlation.launch_plan``,
``roi_align.launch_plan`` and, for the bf16 builds of kernels 3 and 5,
``correlation.launch_plan_bf16`` and ``roi_align.launch_plan_bf16``), which
each wrapper computes in Python and the C launcher checks, at the main
paths' shapes; kernel 4's flow copy width (``regularize.copy_width``); the
bf16 builds' 16-byte pieces; and the kernel build's hash over the headers
a source includes. Runs on the CPU: no kernel is built or launched."""

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_kernels_gpu import STEP0_CORR, STEP0_REG
from vido_slam_tpu_torch.estimation import flow_joint_kernel as fj
from vido_slam_tpu_torch.estimation import lm_kernel
from vido_slam_tpu_torch.ops import correlation as corr
from vido_slam_tpu_torch.ops import regularize as reg
from vido_slam_tpu_torch.ops import roi_align
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


# kernel 3's bf16 build: the float32 plan's tiles and split, its own ring
# (csrc/correlation.cu's bf16 launcher checks the same shared memory)

@pytest.mark.parametrize("N,C,H,W,stride", [
    (1,) + lv for lv in chip_smoke.CORR_LEVELS + chip_smoke.ONLINE_CORR_LEVELS
] + [(2, 1, 37, 53, 2), (1, 1, 6, 20, 1), (1, 50, 72, 160, 1),
     (2, 13, 24, 80, 1), (3, 7, 5, 3, 1), (1, 24, 30, 50, 3),
     (2, 16, 33, 70, 4), (1, 64, 288, 640, 8)])
def test_correlation_bf16_plan_covers_c_and_fits(N, C, H, W, stride):
    plan = corr.launch_plan_bf16(N, C, H, W, stride)
    f32 = corr.launch_plan(N, C, H, W, stride)
    # the parent build's split: every rank sums the same channels
    assert (plan.tile_h, plan.split, plan.grid) == \
        (f32.tile_h, f32.split, f32.grid)
    ranges = [(r * C // plan.split, (r + 1) * C // plan.split)
              for r in range(plan.split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi > lo for lo, hi in ranges)
    assert 1 <= plan.chunk <= corr.MAX_BF16_CHUNK
    assert plan.taps in corr.TAP_GROUPS
    assert plan.taps == (4 if plan.tile_h == 4 else
                         2 if plan.grid[0] * plan.grid[1] <= 264 else 1)
    assert f32.taps == 1
    assert plan.smem_bytes == corr.smem_bytes_bf16(
        plan.tile_h, stride, plan.chunk) <= SMEM_LIMIT
    # the partial sums reuse the ring; both builds' rule
    part = 4 * corr.TAPS * plan.tile_h * corr.TILE_W
    assert plan.smem_bytes >= part and f32.smem_bytes >= part
    assert plan.smem_bytes % 16 == 0
    # the largest chunk with which the grid stays resident, and no more
    # than a rank's share needs
    ctas = plan.grid[0] * plan.grid[1]
    resident = corr.SM_COUNT * (SMEM_LIMIT // plan.smem_bytes)
    assert plan.chunk in corr.BF16_CHUNKS
    assert ctas <= resident or plan.chunk == 1
    assert plan.chunk == 1 or plan.chunk // 2 < -(-C // plan.split)
    bigger = [c for c in corr.BF16_CHUNKS if c > plan.chunk
              and c // 2 < -(-C // plan.split)]
    for c in bigger:
        smem = corr.smem_bytes_bf16(plan.tile_h, stride, c)
        assert ctas > corr.SM_COUNT * (SMEM_LIMIT // smem)
    if (C, H, W, stride) in chip_smoke.CORR_LEVELS[:3]:
        assert plan.chunk == 4   # the levels of 360 CTAs
    # a chunk ragged at a rank's end where C / split is no multiple of it
    if (C, stride) == (50, 1):
        assert any((hi - lo) % plan.chunk for lo, hi in ranges)


def _pieces(ptr, g, n, stride):
    """A mirror of the bf16 builds' staging of one row (csrc/correlation.cu
    ``stage``, csrc/regularize.cu): the row's n values start at element g
    of a tensor at address ptr and lie `stride` apart. Returns its first
    value's offset in its first 16-byte piece and each piece's first
    element."""
    sh = (ptr // 2 + g) % 8
    span = (n - 1) * stride + 1
    return sh, [g - sh + 8 * j for j in range(corr.row_pieces(n, stride))
                if 8 * j < sh + span]


@pytest.mark.parametrize("offset", [0, 1, 3, 6, 7])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("W", range(41, 49))
def test_bf16_pieces_cover_each_row_at_any_alignment(W, stride, offset):
    """Kernel 3's rows (HALO_W and TILE_W values) and kernel 4's (40), of
    a (2, 3, 9, W) bf16 view at a storage offset of 0-7 elements (W = 41-48:
    rows start at every offset in a piece): every piece starts on a 16-byte
    boundary, every value of the row lies in one, and a piece reaches
    outside the tensor only at its first or last element (it is then
    copied by plain loads). The copy width is 16 bytes at every W, stride
    and offset."""
    N, C, H = 2, 3, 9
    store = torch.zeros(N * C * H * W + offset, dtype=torch.bfloat16)
    f = store[offset:].view(N, C, H, W)
    assert f.is_contiguous()
    ptr, total, plane = f.data_ptr(), f.numel(), H * W
    assert reg.copy_width(f[:, :2].contiguous()) == 16
    Wo = -(-W // stride)
    rows = 0
    for n, c in ((0, 0), (1, C - 1), (0, 1)):
        for a in range(-(-H // stride)):
            for b0, vals in [(x0 - 3, corr.HALO_W) for x0 in
                             range(0, Wo, corr.TILE_W)] + [
                    (x0, corr.TILE_W) for x0 in range(0, Wo, corr.TILE_W)]:
                g = (n * C + c) * plane + (a * W + b0) * stride
                sh, firsts = _pieces(ptr, g, vals, stride)
                assert all((ptr // 2 + e) % 8 == 0 for e in firsts)
                for j in range(vals):
                    if 0 <= b0 + j < Wo:   # a value inside the image
                        e = g + j * stride
                        assert any(p <= e < p + 8 for p in firsts)
                        assert 0 <= e < total
                outside = [p for p in firsts if p < 0 or p + 8 > total]
                assert all(p < 8 or p + 8 > total - 8 for p in outside)
                rows += 1
    assert rows > 0
    # kernel 4 (this view as a flow of 3 images): a staged row of the 40
    # columns from x0 - 4 in at most 6 pieces (48 values a row)
    for p in range(N * C):
        for y in range(H):
            for x0 in range(0, W, 32):
                sh, firsts = _pieces(ptr, p * plane + y * W + x0 - 4, 40, 1)
                assert len(firsts) <= 6 and sh + 40 <= 48
                assert all((ptr // 2 + e) % 8 == 0 for e in firsts)


def test_step0_cases_cover_what_they_are_for():
    """The check of slice 17's inputs (tests/test_torch_kernels_gpu.py
    STEP0_CORR, STEP0_REG): every number of tap groups, strides 3-8,
    planes that are not whole 16-byte pieces, N > 1 with a rank's channels
    not a multiple of the chunk."""
    plans = {c: corr.launch_plan_bf16(*c) for c in STEP0_CORR}
    assert {p.taps for p in plans.values()} == set(corr.TAP_GROUPS)
    assert set(range(3, 9)) <= {c[4] for c in STEP0_CORR}
    odd = [c for c in STEP0_CORR if c[2] * c[3] % 2 and c[1] > 1]
    assert len(odd) >= 4
    ragged = [c for c, p in plans.items() if c[0] > 1 and any(
        ((r + 1) * c[1] // p.split - r * c[1] // p.split) % p.chunk
        for r in range(p.split))]
    assert len(ragged) >= 3
    assert all(h * w % 2 and n > 1 or n == 1 for n, _, h, w in STEP0_REG[:3])


@pytest.mark.parametrize("N,C,H,W,stride", STEP0_CORR)
def test_correlation_bf16_plan_at_the_step0_inputs(N, C, H, W, stride):
    """The float32 plan's tiles and split, every rank's channels covered
    once, a chunk the launcher takes, the shared memory within the limit,
    and each staged row's pieces covering it at every storage offset of a
    plane that is not a whole number of pieces."""
    plan = corr.launch_plan_bf16(N, C, H, W, stride)
    f32 = corr.launch_plan(N, C, H, W, stride)
    assert (plan.tile_h, plan.split, plan.grid) == \
        (f32.tile_h, f32.split, f32.grid)
    bounds = [r * C // plan.split for r in range(plan.split + 1)]
    assert bounds[0] == 0 and bounds[-1] == C
    assert all(b > a for a, b in zip(bounds, bounds[1:]))
    assert 1 <= plan.chunk <= corr.MAX_BF16_CHUNK
    assert plan.smem_bytes == corr.smem_bytes_bf16(plan.tile_h, stride,
                                                   plan.chunk) <= SMEM_LIMIT
    Wo = -(-W // stride)
    for offset in (0, 1, 7):
        ptr = 2 * offset
        for n, c in ((0, 0), (N - 1, C - 1)):
            for a in range(-(-H // stride)):
                for b0, vals in [(x0 - 3, corr.HALO_W) for x0 in
                                 range(0, Wo, corr.TILE_W)] + [
                        (x0, corr.TILE_W) for x0 in range(0, Wo,
                                                          corr.TILE_W)]:
                    g = (n * C + c) * H * W + (a * W + b0) * stride
                    sh, firsts = _pieces(ptr, g, vals, stride)
                    assert all((ptr // 2 + e) % 8 == 0 for e in firsts)
                    for j in range(vals):
                        if 0 <= b0 + j < Wo:
                            e = g + j * stride
                            assert any(p <= e < p + 8 for p in firsts)


@pytest.mark.parametrize("N,k,H,W", STEP0_REG)
def test_regularize_bf16_copies_at_the_step0_inputs(N, k, H, W):
    """Kernel 4's bf16 build copies 16 bytes at any offset, and a staged
    row of its 40 columns from x0 - 4 stays within 6 pieces."""
    for offset in (0, 1, 3):
        store = torch.zeros(N * 2 * H * W + offset, dtype=torch.bfloat16)
        flow = store[offset:].view(N, 2, H, W)
        assert reg.copy_width(flow) == 16
        ptr = flow.data_ptr()
        for p in range(2 * N):
            for y in range(H):
                for x0 in range(0, W, 32):
                    sh, firsts = _pieces(ptr, p * H * W + y * W + x0 - 4,
                                         40, 1)
                    assert len(firsts) <= 6 and sh + 40 <= 48


@pytest.mark.parametrize("W", [640, 637])
def test_regularize_copy_width_follows_the_pointers(W):
    """Kernel 4's 16-byte flow copies need W % 4 == 0 and a 16-byte aligned
    flow; a contiguous view at a storage offset of one float is not."""
    store = torch.zeros(2 * 8 * W + 4)
    flow = store[:2 * 8 * W].view(1, 2, 8, W)
    shifted = store[1:2 * 8 * W + 1].view(1, 2, 8, W)
    assert shifted.is_contiguous()
    assert reg.copy_width(flow) == (16 if W % 4 == 0 else 4)
    assert reg.copy_width(shifted) == 4


@pytest.mark.parametrize("B,N", [(1, 3000), (8, 4000), (1, 12000),
                                 (3, 12000)])
def test_flow_joint_plan_at_the_main_path_shapes(B, N):
    plan = fj.launch_plan(B, N)
    assert 1 <= plan.cluster <= 8
    assert plan.cluster * B <= lm_kernel.SM_COUNT  # one wave of clusters
    assert plan.cap * plan.cluster >= N > (plan.cap - 1) * plan.cluster
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    # the compacted points stay in shared memory, 52 B each
    assert plan.smem_bytes == 52 * plan.cap
    assert plan.smem_bytes + lm_kernel.SMEM_RESERVE <= SMEM_LIMIT
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


@pytest.mark.parametrize("B,N", [(1, 3000), (8, 4000), (3, 12000), (1, 1)])
def test_pose_lm_plan_at_the_main_path_shapes(B, N):
    """Kernel 1: a cluster of up to 8 CTAs a problem, one wave of clusters,
    the compacted valid points in shared memory, 20 B each; for every
    valid count n <= N the ranks' shares [r n / G, (r+1) n / G) tile
    [0, n) and each fits the plan's cap."""
    plan = lm_kernel.launch_plan(B, N)
    G = plan.cluster
    assert 1 <= G <= 8 and G * B <= lm_kernel.SM_COUNT
    assert plan.cap * G >= N > (plan.cap - 1) * G or N == plan.cap == 1
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.smem_bytes == 4 * lm_kernel.PLANES * plan.cap == 20 * plan.cap
    assert plan.smem_bytes + lm_kernel.SMEM_RESERVE <= SMEM_LIMIT
    assert plan.scratch_floats == 0
    assert G == {(1, 3000): 8, (8, 4000): 8, (3, 12000): 8, (1, 1): 1}[B, N]
    for n in range(N + 1):
        bounds = [r * n // G for r in range(G + 1)]
        assert bounds[0] == 0 and bounds[-1] == n
        assert max(b - a for a, b in zip(bounds, bounds[1:])) <= plan.cap


def test_pose_lm_plan_takes_the_global_scratch_beyond_shared_memory():
    plan = lm_kernel.launch_plan(1, 100000)
    assert plan.cluster == 8 and plan.smem_bytes == 0
    assert plan.scratch_floats == 8 * lm_kernel.PLANES * plan.cap
    assert 4 * lm_kernel.PLANES * plan.cap + lm_kernel.SMEM_RESERVE \
        > SMEM_LIMIT
    # kernel 2 keeps its own 13 planes under the same rule
    assert fj.launch_plan(8, 4000) == lm_kernel.cluster_plan(8, 4000, 13)


# the heads of the mask path: P2-P5 of a 1088x800 image at 256 channels
ROI_HEADS = [(1000, 256, 7, 2), (100, 256, 14, 2)]


@pytest.mark.parametrize("R,C,r,s", ROI_HEADS + [
    (37, 48, 14, 2), (1000, 5, 7, 2), (1, 256, 7, 2), (1000, 200, 7, 2),
    (300, 37, 14, 2), (50, 256, 7, 1), (50, 256, 14, 4)])
def test_roi_align_channel_groups_cover_c_exactly(R, C, r, s):
    plan = roi_align.launch_plan(R, C, r, s, chip_smoke.MASK_LEVELS)
    groups = -(-C // plan.group)
    spans = [(g * plan.group, min(C, (g + 1) * plan.group))
             for g in range(groups)]
    assert spans[0][0] == 0 and spans[-1][1] == C
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(hi > lo for lo, hi in spans)
    assert 1 <= plan.group <= C
    assert plan.threads % 32 == 0
    assert roi_align.MIN_THREADS <= plan.threads <= roi_align.MAX_THREADS
    # R = 1000 at 200 channels and R = 300 at 37 leave a ragged last group
    if (R, C) in ((1000, 200), (300, 37)):
        assert C % plan.group != 0


@pytest.mark.parametrize("R,C,r,s", ROI_HEADS)
def test_roi_align_plan_fits_the_sample_grids(R, C, r, s):
    """Each of a block's two buffers holds at least one channel's largest
    sample grid, (2 r s)^2 texels (no level of P2-P5 is narrower than
    2 r s), and its r x r bins; the blocks fill two waves of the SMs, and
    a block computes at most BLOCK_OUTPUTS bins."""
    plan = roi_align.launch_plan(R, C, r, s, chip_smoke.MASK_LEVELS)
    half = plan.smem_bytes // 8
    assert plan.smem_bytes % 8 == 0
    assert half >= (2 * r * s) ** 2 + r * r
    assert half == max(roi_align.BUFFER_FLOATS, (2 * r * s) ** 2 + r * r)
    assert plan.smem_bytes + roi_align.SMEM_RESERVE <= SMEM_LIMIT
    wave = roi_align.SM_COUNT * roi_align.BLOCKS_PER_SM
    assert R * -(-C // plan.group) >= 2 * wave
    assert plan.threads * roi_align.BLOCKS_PER_SM == 2048   # an SM's threads
    assert plan.group * r * r <= roi_align.BLOCK_OUTPUTS
    assert (plan.group, plan.threads, plan.smem_bytes) == {
        7: (32, 256, 24576), 14: (8, 256, 26656)}[r]


@pytest.mark.parametrize("s", [1, 2, 3, 4])
@pytest.mark.parametrize("r", [7, 14])
def test_roi_align_bf16_plan_for_one_roi(r, s):
    """One ROI (R = 1) at every sampling ratio: a block a channel, the bf16
    block size, and buffers that hold one channel's largest footprint."""
    plan = roi_align.launch_plan_bf16(1, 256, r, s, chip_smoke.MASK_LEVELS)
    assert plan.group == 1 and plan.threads == roi_align.BF16_THREADS
    need = roi_align.bf16_channel_bytes(r, s, chip_smoke.MASK_LEVELS)
    assert plan.smem_bytes // 2 >= max(need, roi_align.BF16_BUFFER_BYTES)
    assert plan.smem_bytes % 32 == 0
    assert plan.smem_bytes + roi_align.SMEM_RESERVE <= SMEM_LIMIT


def test_roi_align_grid_is_capped_by_small_levels():
    """A pyramid narrower than 2 r s stages at most its own extent."""
    assert roi_align.grid_lines(7, 2, 40) == 28
    assert roi_align.grid_lines(7, 2, 20) == 20
    assert roi_align.smem_bytes(14, 2, [(20, 9), (10, 5)]) \
        == 8 * roi_align.BUFFER_FLOATS
    assert roi_align.smem_bytes(14, 2, [(60, 57)]) == 8 * (56 * 56 + 196)
    few = roi_align.launch_plan(1, 256, 7, 2, chip_smoke.MASK_LEVELS)
    assert few.group == 1                    # one ROI: 256 blocks


# kernel 5's bf16 build: the float32 build's channel groups, its own
# buffers (bf16 texels, t and bins; ``roi_align.bf16_channel_bytes``)

TINY_LEVELS = [(9, 7), (5, 4), (3, 2), (1, 1)]


@pytest.mark.parametrize("R,C,r,s", ROI_HEADS + [
    (1000, 96, 7, 2), (200, 96, 6, 2), (100, 96, 14, 2), (37, 48, 14, 2),
    (1000, 48, 7, 2), (37, 3, 7, 2), (1, 3, 14, 2), (1, 256, 7, 2),
    (100, 256, 14, 4), (200, 48, 7, 1)])
def test_roi_align_bf16_channel_groups_cover_c_exactly(R, C, r, s):
    plan = roi_align.launch_plan_bf16(R, C, r, s, chip_smoke.MASK_LEVELS)
    spans = [(g * plan.group, min(C, (g + 1) * plan.group))
             for g in range(-(-C // plan.group))]
    assert spans[0][0] == 0 and spans[-1][1] == C
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(hi > lo for lo, hi in spans)
    assert 1 <= plan.group <= C
    assert plan.threads % 32 == 0
    assert roi_align.MIN_THREADS <= plan.threads <= roi_align.MAX_THREADS
    assert plan.group == roi_align.launch_plan(
        R, C, r, s, chip_smoke.MASK_LEVELS).group


@pytest.mark.parametrize("levels", [chip_smoke.MASK_LEVELS, TINY_LEVELS,
                                    [(68, 50)]], ids=["P2-P5", "tiny", "one"])
@pytest.mark.parametrize("r,s", [(7, 2), (14, 2), (6, 2), (14, 4), (7, 1),
                                 (16, 4), (32, 2), (64, 1)])
def test_roi_align_bf16_plan_fits_the_largest_staged_grid(levels, r, s):
    """Each of the two buffers holds one channel's largest footprint, and
    the block's shared memory fits an SM less the static reserve (the
    largest, r s = 64 on P2-P5: 128 rows of 256 texels)."""
    plan = roi_align.launch_plan_bf16(1000, 256, r, s, levels)
    need = roi_align.bf16_channel_bytes(r, s, levels)
    assert plan.smem_bytes % 32 == 0
    assert plan.smem_bytes // 2 >= max(need, roi_align.BF16_BUFFER_BYTES)
    assert plan.smem_bytes + roi_align.SMEM_RESERVE <= SMEM_LIMIT
    rows = roi_align.grid_lines(r, s, max(h for h, _ in levels))
    cols = roi_align.grid_lines(r, s, max(w for _, w in levels))
    assert need >= 2 * (rows * cols + r * r) + 4 * r * cols


@pytest.mark.parametrize("R,C,r,s", ROI_HEADS)
def test_roi_align_bf16_plan_at_the_heads(R, C, r, s):
    """The heads' grids give two waves of blocks; at 7 x 7 the plan's
    buffers are BF16_BUFFER_BYTES, at 14 x 14 one channel's footprint (56
    rows of 112 texels: P2 is wider than 2 r s)."""
    plan = roi_align.launch_plan_bf16(R, C, r, s, chip_smoke.MASK_LEVELS)
    wave = roi_align.SM_COUNT * roi_align.BLOCKS_PER_SM
    assert R * -(-C // plan.group) >= 2 * wave
    assert (plan.group, plan.threads, plan.smem_bytes) == {
        7: (32, 128, 24064), 14: (8, 128, 32320)}[r]


def _staged_lines(lo, hi, size, r, s):
    """A mirror of the bf16 build's staging rule on one axis
    (csrc/roi_align.cu ``setup_bins``, float32 arithmetic step by step):
    each bin's lines, and the lines staged (the window between the first
    and the last line where it spans at most min(2 r s, size) lines, else
    the bins' lines in 2 s slots a bin)."""
    f = np.float32
    lo, hi = f(lo), f(hi)
    bin_ = f(max(f(hi - lo), f(1))) / f(r)
    bins = []
    for p in range(r):
        lines = set()
        for i in range(s):
            pos = lo + (f(p) + f(f(i) + f(0.5)) / f(s)) * bin_
            if -1 <= pos <= size - 1:
                h0 = int(np.floor(min(max(pos, f(0)), f(size - 1))))
                lines |= {h0, min(h0 + 1, size - 1)}
        bins.append(sorted(lines))
    used = [x for b in bins for x in b]
    first, last = (min(used), max(used)) if used else (0, 0)
    if last - first + 1 <= min(2 * r * s, size):
        return bins, list(range(first, last + 1)), True
    return bins, [x for b in bins for x in b + [0] * (2 * s - len(b))], False


@pytest.mark.parametrize("level", range(4))
@pytest.mark.parametrize("r,s", [(7, 2), (14, 2), (7, 1), (14, 4)])
def test_roi_align_bf16_staging_covers_the_weighted_lines(level, r, s):
    """On ROIs like chip_smoke.roi_cases' (sides 0.3 to 1500 px, starts up
    to 60 px outside a 1088 x 800 image) each level in turn: every line
    that the plain version weights above zero is staged, among its bin's
    lines; the staged lines stay within ``grid_lines``, and one channel's
    footprint within ``bf16_channel_bytes``."""
    import torch
    rng = np.random.RandomState(10 * level + r + s)
    H, W = chip_smoke.MASK_LEVELS[level]
    scale = 0.25 / 2 ** level
    R = 300
    x1, y1 = rng.uniform(-60, 800, R), rng.uniform(-60, 1088, R)
    ww, hh = np.exp(rng.uniform(np.log(0.3), np.log(1500), (2, R)))
    rois = np.stack([x1, y1, x1 + ww, y1 + hh], 1).astype(np.float32)
    ry, rx = roi_align._level_weights(torch.from_numpy(rois), scale, H, W,
                                      r, s)
    need = roi_align.bf16_channel_bytes(r, s, chip_smoke.MASK_LEVELS)
    modes = set()
    for i in range(R):
        b = rois[i] * np.float32(scale)
        footprint = []
        for lo, hi, size, w in ((b[1], b[3], H, ry[i]),
                                (b[0], b[2], W, rx[i])):
            bins, staged, window = _staged_lines(lo, hi, size, r, s)
            modes.add(window)
            assert len(staged) <= roi_align.grid_lines(r, s, size)
            for p in range(r):
                weighted = set(torch.nonzero(w[p] > 0)[:, 0].tolist())
                assert weighted <= set(bins[p]) <= set(staged)
            footprint.append((len(staged), window))
        (nr, _), (nc, xwin) = footprint
        pitch = -(-(nc + 7) // 8) * 8 if xwin else -(-2 * nc // 8) * 8
        assert 2 * (nr * pitch + r * r) + 4 * r * (nc | 1) + 32 <= need
    # both rules are reached wherever the level is wider than 2 r s
    H, W = chip_smoke.MASK_LEVELS[level]
    assert modes == ({True, False} if max(H, W) > 2 * r * s else {True})


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
    for n in ("flow_joint", "pose_lm"):
        assert names[n] == [f"{n}.cu", "lm_common.cuh"]
    for n in ("correlation", "regularize", "roi_align"):
        assert names[n] == [f"{n}.cu"]
