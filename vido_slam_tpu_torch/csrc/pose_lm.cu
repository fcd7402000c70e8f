// Batched 6-DoF Levenberg-Marquardt reprojection solves on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   vido_slam_tpu/estimation/lm_pallas.py :: pose_lm_batched_pallas
//   (body _pose_lm_kernel, helpers _gram / _chol_solve6 / _exp_se3_compose in
//   vido_slam_tpu/estimation/flow_joint_pallas.py).
//
// What it computes: B independent problems, each N points X with pixel
// observations and a validity mask. The residual of a point is
//   r = pi(T_pre * (T * X)) - obs,   pi guarded at |z| < 1e-6,
// optionally under a Huber kernel (delta = 0.1 for the camera; none for the
// objects, where T_pre = Tcw). Every iteration builds the 6x6 normal
// equations and the gradient from the analytic left-perturbation Jacobian,
// damps them by Marquardt (lam * max(diag, 1e-6 max diag)), solves by an
// unrolled Cholesky and steps by T <- exp(delta) T. The g2o gain-ratio policy
// accepts or rejects the step (ni doubles on a reject); the loop ends on a
// tiny predicted gain, a relative improvement below rel_tol, or exploding
// damping. The rules are the Pallas kernel's, including its non-finite guard
// isfinite(sum(delta)) and its predicted gain 0.5 delta^T (lam D delta - g).
// The chi2 output covers all N points, the invalid ones too.
//
// What bounds it on the card: neither roofline. A problem reads 24 bytes a
// point and does ~190 flops a point per iteration, so one frame's two calls
// (B=1, N=3000 and B=8, N=4000, tens of iterations) are microseconds of
// bytes and of float32 work. The time goes to latency: the iterations are
// serial and data-dependent, each a reduction over the problem's points and
// a 6x6 solve.
//
// Design: kernel 2's machinery (flow_joint.cu, lm_common.cuh), cutting the
// latency of an iteration.
// - A thread-block cluster of G CTAs per problem (grid G x B, cluster G x 1;
//   the wrapper's launch plan sets G <= 8 from B and N), so a problem's
//   points spread over up to 8 SMs.
// - The valid points are compacted at load: every CTA scans the mask (a
//   block prefix sum of per-thread counts) and keeps the compacted points
//   [r n / G, (r+1) n / G) of its rank r, 5 floats (20 B) a point, in shared
//   memory or, when a CTA's share of N does not fit, in a global scratch
//   that the wrapper allocates. An object of the batch iterates over its own
//   few hundred points, not the shared 4000.
// - One pass an iteration: the pass at the trial pose sums H, g and the
//   cost there. On accept they are the next iteration's system; on reject
//   the cached system is solved again with the new lambda.
// - The 28 sums of a pass meet in lm_common.cuh :: cluster_sum32 (a warp
//   transpose-reduce, one __syncthreads, one cluster barrier, added in a
//   fixed order, so a launch is deterministic), and every thread solves the
//   6x6 system and takes the accept decision itself from the cluster sums
//   (identical inputs, identical results), so nothing is broadcast. The
//   solve and the step are lm_common.cuh's, with a reciprocal square root a
//   pivot and one sincosf.
// - A point's transforms, residual and cost round as the plain version's
//   torch ops do on the card (point_terms), so that both versions see the
//   same costs and take the same accept decisions near convergence.
// The final chi2 pass reads the points from global memory: each CTA writes
// the N / G points of its share of the index range.

#include <cuda_runtime.h>
#include <math.h>

#include "lm_common.cuh"

namespace {

constexpr int kMaxCluster = kSumMaxBlocks;  // portable cluster size
constexpr int kMaxThreads = kSumMaxThreads;
constexpr int kPlanes = 5;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kSmemReserve = 4096;  // room for the static shared memory

enum Plane { PX, PY, PZ, OU, OV };
// slots of the 32 sums of a pass: the 21 entries of the upper triangle of H
// (row-major), the 6 of g, the cost
enum Sum { HS = 0, GS = 21, COST = 27 };

struct Params {
  const float* T_init;         // (B, 4, 4)
  const float* T_pre;          // (B, 4, 4)
  const float* pts;            // (B, N, 3) or shared (N, 3): stride pts_bs
  long long pts_bs;
  const float* obs;            // (B, N, 2) or shared (N, 2): stride obs_bs
  long long obs_bs;
  const unsigned char* valid;  // (B, N) bool
  float* T_out;                // (B, 4, 4)
  float* chi2_out;             // (B, N)
  int* iters_out;              // (B,)
  float* scratch;              // (B, G, kPlanes, cap), or null
  int N;
  int cap;                     // points a CTA can hold: >= ceil(N / G)
  float fx, fy, cx, cy;
  float huber, huber2;         // delta <= 0: no robust kernel; delta^2
  int max_iters;
  float init_lambda, gain_tol, rel_tol;
};

// Residual, robust weight and Jacobian rows of point X with observation
// (u, v) at the variable transform T (12 floats: R row-major, then t) and
// the fixed pre-transform P. Returns the unrobustified chi2; kAccumulate
// adds w J^T J, w J^T r and the robust cost into acc. The transforms,
// residual, chi2 and robust cost round every operation as the plain
// version's torch ops do on the card (its matrix products accumulate x, y
// and z in turn by FMA; its elementwise ops round each product and sum):
// the accept decisions near convergence turn on the last bits of the
// points' costs, so a kernel whose costs part from the plain version's by
// an ulp takes other steps there.
__device__ __forceinline__ float affine_row(const float* R, float t, float x,
                                            float y, float z) {
  return __fadd_rn(fmaf(R[2], z, fmaf(R[1], y, __fmul_rn(R[0], x))), t);
}

template <bool kAccumulate>
__device__ __forceinline__ float point_terms(const Params& p,
                                             const float (&T)[12],
                                             const float (&P)[12], float x,
                                             float y, float z, float u,
                                             float v, float (&acc)[32]) {
  const float pwx = affine_row(T, T[9], x, y, z);
  const float pwy = affine_row(T + 3, T[10], x, y, z);
  const float pwz = affine_row(T + 6, T[11], x, y, z);
  const float pcx = affine_row(P, P[9], pwx, pwy, pwz);
  const float pcy = affine_row(P + 3, P[10], pwx, pwy, pwz);
  const float pcz = affine_row(P + 6, P[11], pwx, pwy, pwz);
  const float iz = __fdiv_rn(1.0f, fabsf(pcz) < 1e-6f ? 1e-6f : pcz);
  const float ru =
      __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(p.fx, pcx), iz), p.cx), u);
  const float rv =
      __fsub_rn(__fadd_rn(__fmul_rn(__fmul_rn(p.fy, pcy), iz), p.cy), v);
  const float chi2 = __fadd_rn(__fmul_rn(ru, ru), __fmul_rn(rv, rv));
  if (!kAccumulate) return chi2;

  float w = 1.0f, rho = chi2;
  if (p.huber > 0.0f && chi2 > p.huber2) {
    const float s = sqrtf(fmaxf(chi2, 1e-12f));
    w = __fmul_rn(1.0f / s, p.huber);  // torch's number / tensor
    rho = __fsub_rn(__fmul_rn(2.0f * p.huber, s), p.huber2);
  }
  acc[COST] += rho;

  // rows of Jproj(pc) * Rpre, then [I | -hat(pw)] for the rotation columns
  const float a = p.fx * iz, c = -p.fx * pcx * iz * iz;
  const float e = p.fy * iz, f = -p.fy * pcy * iz * iz;
  const float gu0 = a * P[0] + c * P[6];
  const float gu1 = a * P[1] + c * P[7];
  const float gu2 = a * P[2] + c * P[8];
  const float gv0 = e * P[3] + f * P[6];
  const float gv1 = e * P[4] + f * P[7];
  const float gv2 = e * P[5] + f * P[8];
  const float Ju[6] = {gu0, gu1, gu2, gu2 * pwy - gu1 * pwz,
                       gu0 * pwz - gu2 * pwx, gu1 * pwx - gu0 * pwy};
  const float Jv[6] = {gv0, gv1, gv2, gv2 * pwy - gv1 * pwz,
                       gv0 * pwz - gv2 * pwx, gv1 * pwx - gv0 * pwy};
  int idx = HS;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float wu = w * Ju[j], wv = w * Jv[j];
#pragma unroll
    for (int k = j; k < 6; ++k) acc[idx++] += wu * Ju[k] + wv * Jv[k];
    acc[GS + j] += wu * ru + wv * rv;
  }
  return chi2;
}

// The cluster's sums of H, g and the cost over the problem's valid points
// at T, in acc[0..27] of every thread.
__device__ __forceinline__ void normal_eqs(const Params& p, const float* base,
                                           int own, const float (&T)[12],
                                           const float (&P)[12],
                                           float (&acc)[32], ClusterSum& sums,
                                           int& parity) {
  const int cap = p.cap;
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
  for (int s = threadIdx.x; s < own; s += blockDim.x)
    point_terms<true>(p, T, P, base[PX * cap + s], base[PY * cap + s],
                      base[PZ * cap + s], base[OU * cap + s],
                      base[OV * cap + s], acc);
  cluster_sum32(acc, sums, parity);
}

// kSmem: the points live in shared memory (else in the global scratch), so
// their loads compile to shared-memory loads
template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
pose_lm_kernel(const Params p) {
  extern __shared__ float sm[];  // kPlanes planes of cap floats if kSmem
  __shared__ ClusterSum sums;
  __shared__ int warp_counts[kMaxThreads / 32];

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int N = p.N, cap = p.cap;
  float* base =
      kSmem ? sm : p.scratch + ((long long)b * G + rank) * kPlanes * cap;
  const unsigned char* valid = p.valid + (long long)b * N;
  const float* pts = p.pts + b * p.pts_bs;
  const float* obs = p.obs + b * p.obs_bs;

  // compaction: thread t counts the valid points in its run of ~N/nthr
  // indices; a block prefix sum places each one; this CTA keeps the
  // compacted points [lo, hi)
  const int run = (N + nthr - 1) / nthr;
  const int i0 = min(N, tid * run), i1 = min(N, i0 + run);
  int cnt = 0;
  for (int i = i0; i < i1; ++i) cnt += valid[i] != 0;
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_counts[warp] = incl;
  __syncthreads();
  int n = 0, k = incl - cnt;
  for (int w = 0; w < nwarps; ++w) {
    const int c = warp_counts[w];
    n += c;
    if (w < warp) k += c;
  }
  const int lo = (int)((long long)rank * n / G);
  const int hi = (int)((long long)(rank + 1) * n / G);
  const int own = hi - lo;
  for (int i = i0; i < i1 && k < hi; ++i) {
    if (!valid[i]) continue;
    if (k >= lo) {
      const int s = k - lo;
      base[PX * cap + s] = pts[3LL * i];
      base[PY * cap + s] = pts[3LL * i + 1];
      base[PZ * cap + s] = pts[3LL * i + 2];
      base[OU * cap + s] = obs[2LL * i];
      base[OV * cap + s] = obs[2LL * i + 1];
    }
    ++k;
  }
  float T[12], P[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) {
    const int r = e < 9 ? e / 3 : e - 9;
    const int c = e < 9 ? e % 3 : 3;
    T[e] = p.T_init[16 * b + 4 * r + c];
    P[e] = p.T_pre[16 * b + 4 * r + c];
  }
  __syncthreads();

  // The state below is every thread's own copy; all threads compute it from
  // the same cluster sums, so they agree.
  float acc[32], H[21], g[6];
  int parity = 0;  // cluster_sum32's slot
  const int diag[6] = {0, 6, 11, 15, 18, 20};

  normal_eqs(p, base, own, T, P, acc, sums, parity);
#pragma unroll
  for (int e = 0; e < 21; ++e) H[e] = acc[HS + e];
#pragma unroll
  for (int j = 0; j < 6; ++j) g[j] = acc[GS + j];
  float cost = acc[COST];
  float maxd = H[diag[0]];
#pragma unroll
  for (int j = 1; j < 6; ++j) maxd = fmaxf(maxd, H[diag[j]]);
  const float lam0 = fmaxf(p.init_lambda * maxd, 1e-30f);
  float lam = lam0, ni = 2.0f;
  int it = 0;
  bool done = cost <= p.gain_tol;

  while (!done && it < p.max_iters) {
    // the step from the system at the current pose
    float dscale[6], delta[6];
    {
      float md = H[diag[0]];
#pragma unroll
      for (int j = 1; j < 6; ++j) md = fmaxf(md, H[diag[j]]);
      const float floor_ = 1e-6f * fmaxf(md, 1e-12f);
      float S[6][6], rhs[6];
      int e = 0;
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int c = j; c < 6; ++c) {
          S[j][c] = H[e];
          S[c][j] = H[e];
          ++e;
        }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        dscale[j] = fmaxf(H[diag[j]], floor_);
        S[j][j] += lam * dscale[j];
        rhs[j] = -g[j];
      }
      chol_solve6(S, rhs, delta);
    }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) sum += delta[j];
    const bool bad = !isfinite(sum);
    if (bad) {
#pragma unroll
      for (int j = 0; j < 6; ++j) delta[j] = 0.0f;
    }
    float Tn[12];
    exp_se3_compose(delta, T, Tn);

    // the one pass: cost, H and g at the trial pose
    normal_eqs(p, base, own, Tn, P, acc, sums, parity);

    const float cost_new = acc[COST];
    float pred = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j)
      pred += delta[j] * (lam * dscale[j] * delta[j] - g[j]);
    pred *= 0.5f;
    const float rho = (cost - cost_new) / fmaxf(pred, 1e-20f);
    const bool accept = (cost_new < cost) && !bad;
    const float q = 2.0f * rho - 1.0f;
    const float lam_new =
        accept ? lam * fmaxf(1.0f / 3.0f, 1.0f - q * q * q) : lam * ni;
    const float cmax = fmaxf(cost, 1e-20f);
    bool done_new = accept && (pred < p.gain_tol * cmax);
    done_new = done_new || (accept && (cost - cost_new < p.rel_tol * cmax));
    done_new = done_new || (lam_new > 1e10f * fmaxf(lam0, 1e-30f));
    if (accept) {
#pragma unroll
      for (int e = 0; e < 12; ++e) T[e] = Tn[e];
#pragma unroll
      for (int e = 0; e < 21; ++e) H[e] = acc[HS + e];
#pragma unroll
      for (int j = 0; j < 6; ++j) g[j] = acc[GS + j];
      cost = cost_new;
    }
    ni = accept ? 2.0f : ni * 2.0f;
    lam = lam_new;
    done = done_new;
    ++it;
  }

  // the chi2 of every point of this CTA's 1/G of the index range, valid or
  // not, at the final T
  const int j0 = (int)((long long)rank * N / G);
  const int j1 = (int)((long long)(rank + 1) * N / G);
  for (int i = j0 + tid; i < j1; i += nthr)
    p.chi2_out[(long long)b * N + i] = point_terms<false>(
        p, T, P, pts[3LL * i], pts[3LL * i + 1], pts[3LL * i + 2],
        obs[2LL * i], obs[2LL * i + 1], acc);
  if (rank == 0 && tid == 0) {
    // constant indices, so that T stays in registers
    float* To = p.T_out + 16 * b;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) To[4 * r + c] = T[3 * r + c];
      To[4 * r + 3] = T[9 + r];
      To[12 + r] = 0.0f;
    }
    To[15] = 1.0f;
    p.iters_out[b] = it;
  }
}

}  // namespace

// Launches the B problems with the wrapper's plan: clusters of G CTAs of
// `threads` threads, each holding up to `cap` valid points, in `smem_bytes`
// of dynamic shared memory (kPlanes * 4 * cap), or in `scratch` (B * G *
// kPlanes * cap floats) when smem_bytes is 0. Refuses (cudaErrorInvalidValue)
// a plan it cannot run; otherwise returns the CUDA error of the launch.
extern "C" int pose_lm_batched_launch(
    const float* T_init, const float* T_pre, const float* pts,
    long long pts_bstride, const float* obs, long long obs_bstride,
    const unsigned char* valid, float* T_out, float* chi2_out, int* iters_out,
    float* scratch, int B, int N, int G, int threads, int cap, int smem_bytes,
    float fx, float fy, float cx, float cy, float huber, float huber2,
    int max_iters,
    float init_lambda, float gain_tol, float rel_tol, void* stream) {
  const bool plan_ok =
      B >= 0 && B <= 65535 && N >= 0 && G >= 1 && G <= kMaxCluster &&
      threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
      cap >= 1 && (long long)cap * G >= N &&
      (smem_bytes == 0 ? scratch != nullptr
                       : (long long)smem_bytes == 4LL * kPlanes * cap &&
                             smem_bytes + kSmemReserve <= kSmemLimit);
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Params p;
  p.T_init = T_init;
  p.T_pre = T_pre;
  p.pts = pts;
  p.pts_bs = pts_bstride;
  p.obs = obs;
  p.obs_bs = obs_bstride;
  p.valid = valid;
  p.T_out = T_out;
  p.chi2_out = chi2_out;
  p.iters_out = iters_out;
  p.scratch = scratch;
  p.N = N;
  p.cap = cap;
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.huber = huber;
  p.huber2 = huber2;
  p.max_iters = max_iters;
  p.init_lambda = init_lambda;
  p.gain_tol = gain_tol;
  p.rel_tol = rel_tol;
  auto kernel = smem_bytes > 0 ? pose_lm_kernel<true> : pose_lm_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
