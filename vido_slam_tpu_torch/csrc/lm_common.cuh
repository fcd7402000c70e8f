// Device helpers of the port's LM kernels (pose_lm.cu, flow_joint.cu): the
// unrolled 6x6 Cholesky solve and the SE(3) exp-compose step of the Pallas
// helpers (vido_slam_tpu/estimation/flow_joint_pallas.py :: _chol_solve6,
// _exp_se3_compose), and a deterministic sum of 32 per-thread values over a
// thread-block cluster.

#pragma once

#include <cooperative_groups.h>
#include <math.h>

namespace {

namespace cg = cooperative_groups;

// Unrolled Cholesky solve of the 6x6 system S x = rhs (S full, row-major),
// pivots floored as sqrt(max(., 1e-20)) like the Pallas helper. Each pivot
// takes one reciprocal square root and every division is a multiply by it
// (rsqrtf is within 2 ulp; IEEE division and square root branch to a slow
// path, and 6 of them instead of 33 shorten the serial chain).
__device__ __forceinline__ void chol_solve6(const float S[6][6],
                                            const float* rhs, float* x) {
  float L[6][6], inv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = S[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    s = fmaxf(s, 1e-20f);
    inv[j] = rsqrtf(s);
    L[j][j] = s * inv[j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s2 = S[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 -= L[i][k] * L[j][k];
      L[i][j] = s2 * inv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// Tn = exp(d) * T with d = [rho, phi] and T 12 floats (R row-major, then
// t); the series switch of the Pallas _exp_se3_compose (theta^2 < 1e-12).
// One reciprocal square root gives theta and 1/theta, one sincosf both
// sines.
__device__ __forceinline__ void exp_se3_compose(const float* d, const float* T,
                                                float* Tn) {
  const float w0 = d[3], w1 = d[4], w2 = d[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < 1e-12f;
  // outside the series branch th2 >= 1e-12, so the Pallas helper's floors
  // (1e-24 on th2 and th^3) do not bind there
  const float rth = rsqrtf(fmaxf(th2, 1e-24f));
  const float th = fmaxf(th2, 1e-24f) * rth;
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float A = small ? 1.0f - th2 / 6.0f : sn * rth;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - cs) * (rth * rth);
  const float C = small ? 1.0f / 6.0f - th2 / 120.0f
                        : (th - sn) * (rth * rth * rth);
  const float h[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  const float h2[3][3] = {{-(w1 * w1 + w2 * w2), w0 * w1, w0 * w2},
                          {w0 * w1, -(w0 * w0 + w2 * w2), w1 * w2},
                          {w0 * w2, w1 * w2, -(w0 * w0 + w1 * w1)}};
  float Rd[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float I = (i == j) ? 1.0f : 0.0f;
      Rd[i][j] = I + A * h[i][j] + B * h2[i][j];
      V[i][j] = I + B * h[i][j] + C * h2[i][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float td = V[i][0] * d[0] + V[i][1] * d[1] + V[i][2] * d[2];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Tn[3 * i + j] = Rd[i][0] * T[j] + Rd[i][1] * T[3 + j] +
                      Rd[i][2] * T[6 + j];
    Tn[9 + i] = Rd[i][0] * T[9] + Rd[i][1] * T[10] + Rd[i][2] * T[11] + td;
  }
}

// One step of warp_transpose_sum32: a lane keeps W of its 2W values (the
// upper half if its bit W is set) and adds its partner's copy of them.
template <int W>
__device__ __forceinline__ void transpose_step(float (&v)[32], int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float send = upper ? v[k] : v[k + W];
    const float keep = upper ? v[k + W] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Warp transpose-reduce: lane l returns the warp's sum of v[l]. Five
// butterfly steps; in each, a lane keeps half of its values and adds the
// other half of its partner's, so 31 shuffles do what 32 shuffle trees
// (160 shuffles) would. The pairing is fixed, so the sums are
// deterministic. v is clobbered.
__device__ __forceinline__ float warp_transpose_sum32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// Shared memory of cluster_sum32 for blocks of up to 256 threads in
// clusters of up to 8: the warps' sums, and every block's sums in two
// slots used in turn.
constexpr int kSumMaxThreads = 256;
constexpr int kSumMaxBlocks = 8;
struct ClusterSum {
  float warp[kSumMaxThreads / 32][32];
  float block[2][kSumMaxBlocks][32];
};

// Every thread of the cluster gets in v[0..31] the cluster's sums of the
// v[k] of all its threads, added in a fixed order (warps within a block,
// then blocks by rank), so a launch is deterministic. Every thread of
// every block must call it the same number of times; `parity` (0 at the
// start, kept by the caller) picks the slot. Warp 0 of each block stores
// the block's sums into its row of the slot in every block of the cluster
// (remote stores, which do not wait), one cluster barrier publishes them,
// and every warp then reads all rows from its own shared memory: one
// __syncthreads and one cluster barrier. The slots alternate, so a block
// can store its next sums while a slower block still reads these: it can
// only reach the next barrier once every block has passed this one's
// reads. After the barrier no block touches another's shared memory, so
// a block may exit right after its last call.
__device__ __forceinline__ void cluster_sum32(float (&v)[32], ClusterSum& s,
                                              int& parity) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nblocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  s.warp[warp][lane] = warp_transpose_sum32(v);
  __syncthreads();
  if (warp == 0) {
    float t = 0.0f;
    for (int w = 0; w < nwarps; ++w) t += s.warp[w][lane];
    for (int r = 0; r < nblocks; ++r)
      cluster.map_shared_rank(&s.block[parity][rank][0], r)[lane] = t;
  }
  cluster.sync();
  float t = 0.0f;
  for (int r = 0; r < nblocks; ++r) t += s.block[parity][r][lane];
  parity ^= 1;
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = __shfl_sync(0xffffffffu, t, k);
}

}  // namespace
