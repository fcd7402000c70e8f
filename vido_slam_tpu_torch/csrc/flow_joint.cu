// Batched joint flow + pose solves on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   vido_slam_tpu/estimation/flow_joint_pallas.py :: flow_joint_batched_pallas
//   (body _fj_kernel; the XLA formulation is flow_joint_optimization in
//   vido_slam_tpu/estimation/flow_joint.py).
//
// What it computes: B independent problems (PoseOptimizationFlow2Cam /
// PoseOptimizationFlow2, Optimizer.cc:2622-2824, 3037-3253), each one SE(3)
// vertex T and one 2-D flow f_i per point. A point has the reprojection edge
//   r1 = obs_last + f - pi(T X)   (information sigma_proj, Huber in rounds
//                                  0-2 on sigma_proj |r1|^2)
// while it is active and z > 1e-3, and the prior edge
//   r2 = f - flow_meas            (information sigma_prior)
// while it is in the initial inlier set `valid`. Four rounds of at most
// `iters` Levenberg iterations; the pose restarts from T_init each round, the
// flows carry over, lambda restarts at 1e-3. Each iteration eliminates every
// point's flow in closed form (its 2x2 block is a scalar times I), solves the
// Schur-reduced 6x6 system damped by S_jj + lam max(S_jj, 1e-6) with an
// unrolled Cholesky, steps T <- exp(dxi) T, updates the flows in closed form
// and accepts on a lower cost (lam * 0.5, else lam * 4). A round ends on the
// iteration cap, on convergence, or at lam >= 1e6, then gates the active set
// by chi2 <= thr0 (round 0) or thr_later (rounds 1-3) and z > 1e-3. The rules
// are the Pallas kernel's, including its isfinite(sum(dxi)) guard.
//
// What bounds it on the card: neither roofline. A problem reads ~40 bytes a
// point and does a few hundred flops a point per iteration, so one frame's
// two calls (B=1, N=3000 and B=8, N=4000) need about a microsecond of bytes
// or float32 work. The time goes to latency: up to 40 serial, data-dependent
// iterations, each a reduction over the problem's points and a 6x6 solve.
//
// Design: the latency of an iteration, cut in four ways.
// - A thread-block cluster of G CTAs per problem (grid G x B, cluster G x 1;
//   the wrapper's launch plan sets G <= 8 from B and N), so a problem's
//   points spread over up to 8 SMs. The partial sums meet through
//   distributed shared memory (lm_common.cuh :: cluster_sum32: each CTA
//   stores its sums into every CTA, then one cluster barrier) and are added
//   in a fixed order, so a launch is deterministic.
// - The prior set is compacted at load: every CTA scans `valid` (a block
//   prefix sum of per-thread counts) and keeps the compacted points
//   [r n / G, (r+1) n / G) of its rank r, in index order, with their original
//   indices: 13 floats (52 B) a point in shared memory, or in a global
//   scratch the wrapper allocates when a CTA's share of N does not fit. The
//   passes touch only the problem's own points (~N/8 of the shared N = 4000
//   for an object of the batch). Each point stays with one thread, so its
//   flows and active flag need no barrier.
// - One pass an iteration: the pass that forms the trial flows at (T, f) also
//   evaluates the trial cost and accumulates the Schur-reduced system at
//   (exp(dxi) T, f_trial). On accept that system is the next iteration's; on
//   reject (T, f) are unchanged and the next step solves the cached system
//   with the new lambda. The round-start pass sums the cost, the active count
//   and the first system. An accepted step swaps the current and trial flow
//   pairs; no copy.
// - A short serial tail: all 28 sums of a pass in one warp transpose-reduce
//   (31 shuffles), one __syncthreads and one cluster barrier a pass, and
//   every thread solves the 6x6 system and takes the accept decision itself
//   from the cluster sums (identical inputs, identical results), so nothing
//   is broadcast. The state stays in registers: every array is indexed by
//   constants, and the points' loads are shared-memory loads (the kernel is
//   compiled once for shared memory and once for the global scratch).
// The last round's gate writes flow, chi2 and inliers for all N points: each
// CTA writes its compacted points and the points outside the prior set in
// its 1/G of the index range.

#include <cuda_runtime.h>
#include <math.h>

#include "lm_common.cuh"

namespace {

constexpr int kMaxCluster = kSumMaxBlocks;  // portable cluster size
constexpr int kMaxThreads = kSumMaxThreads;
constexpr int kPlanes = 13;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kSmemReserve = 4096;  // room for the static shared memory

enum Plane { PX, PY, PZ, OU, OV, FMU, FMV, ACT, FU0, FV0, FU1, FV1, IDX };
// slots of the 32 sums of a pass: cost, active count, the 21 entries of the
// upper triangle of S (row-major), the 6 of the right-hand side
enum Sum { COST = 0, COUNT = 1, SYS = 2, RHS = SYS + 21 };
constexpr int kSys = 27;

struct Params {
  const float* T_init;         // (B, 4, 4)
  const float* pts;            // (B, N, 3) or shared (N, 3): stride pts_bs
  long long pts_bs;
  const float* obs;            // (B, N, 2) or shared (N, 2): stride obs_bs
  long long obs_bs;
  const float* fm;             // (B, N, 2) or shared (N, 2): stride fm_bs
  long long fm_bs;
  const unsigned char* valid;  // (B, N) bool, the initial inlier set
  float* T_out;                // (B, 4, 4)
  float* flow_out;             // (B, N, 2)
  unsigned char* inl_out;      // (B, N) bool
  int* ninl_out;               // (B,)
  float* chi2_out;             // (B, N)
  int* iters_out;              // (B, 4) iterations of each round
  float* scratch;              // (B, G, kPlanes, cap), or null
  int N;
  int cap;                     // points a CTA can hold: >= ceil(N / G)
  float fx, fy, cx, cy;
  float sigma_proj, sigma_prior;
  float huber, huber2;         // delta and delta^2 of the Huber kernel
  float thr0, thr_later;       // round-end chi2 gates
  int min_edges, iters;
};

// A point of the prior set (its sigma_prior weight is the constant one)
struct Pt {
  float x, y, z, ou, ov, fmu, fmv, act;
};

__device__ __forceinline__ Pt load_pt(const float* base, int cap, int s) {
  Pt q;
  q.x = base[PX * cap + s];
  q.y = base[PY * cap + s];
  q.z = base[PZ * cap + s];
  q.ou = base[OU * cap + s];
  q.ov = base[OV * cap + s];
  q.fmu = base[FMU * cap + s];
  q.fmv = base[FMV * cap + s];
  q.act = base[ACT * cap + s];
  return q;
}

// r1 = obs + f - pi(T X) with the |z| < 1e-6 guard; T is 12 floats (R
// row-major, then t). The kernel divides by multiplying with __fdividef's
// reciprocal (within 2 ulp, no slow-path branch).
__device__ __forceinline__ void resid(const Params& p, const float* T, float x,
                                      float y, float z, float ou, float ov,
                                      float fu, float fv, float& pcx,
                                      float& pcy, float& pcz, float& iz,
                                      float& r1u, float& r1v) {
  pcx = T[0] * x + T[1] * y + T[2] * z + T[9];
  pcy = T[3] * x + T[4] * y + T[5] * z + T[10];
  pcz = T[6] * x + T[7] * y + T[8] * z + T[11];
  iz = __fdividef(1.0f, fabsf(pcz) < 1e-6f ? 1e-6f : pcz);
  r1u = ou + fu - (p.fx * pcx * iz + p.cx);
  r1v = ov + fv - (p.fy * pcy * iz + p.cy);
}

// One point at (T, f): its share of the cost (the robust reprojection term
// while active with z > 1e-3, plus the prior term) and of the Schur-reduced
// system.
struct Lin {
  float cost, a, inv_v, r1u, r1v, b_fu, b_fv;  // inv_v = 1 / v
  float Ju[6], Jv[6];  // d pi / d xi (left perturbation); d r1/d xi = -J
};

__device__ __forceinline__ void linearize(const Params& p, const float* T,
                                          const Pt& q, float fu, float fv,
                                          bool huber, Lin& L) {
  float pcx, pcy, pcz, iz;
  resid(p, T, q.x, q.y, q.z, q.ou, q.ov, fu, fv, pcx, pcy, pcz, iz, L.r1u,
        L.r1v);
  const float chi2 = p.sigma_proj * (L.r1u * L.r1u + L.r1v * L.r1v);
  float w = 1.0f, rho = chi2;
  if (huber && !(chi2 <= p.huber2)) {
    const float c = fmaxf(chi2, 1e-12f), r = rsqrtf(c);  // r = 1 / sqrt(c)
    w = p.huber * r;
    rho = 2.0f * p.huber * (c * r) - p.huber2;
  }
  const float gate = q.act * (pcz > 1e-3f ? 1.0f : 0.0f);
  const float r2u = fu - q.fmu, r2v = fv - q.fmv;
  L.cost = rho * gate + p.sigma_prior * (r2u * r2u + r2v * r2v);
  L.a = gate * (p.sigma_proj * w);
  L.inv_v = __fdividef(1.0f, L.a + p.sigma_prior + 1e-12f);
  const float az = p.fx * iz, cz = -p.fx * pcx * iz * iz;
  const float ez = p.fy * iz, fz = -p.fy * pcy * iz * iz;
  L.Ju[0] = az;
  L.Ju[1] = 0.0f;
  L.Ju[2] = cz;
  L.Ju[3] = cz * pcy;
  L.Ju[4] = az * pcz - cz * pcx;
  L.Ju[5] = -az * pcy;
  L.Jv[0] = 0.0f;
  L.Jv[1] = ez;
  L.Jv[2] = fz;
  L.Jv[3] = fz * pcy - ez * pcz;
  L.Jv[4] = -fz * pcx;
  L.Jv[5] = ez * pcx;
  L.b_fu = L.a * L.r1u + p.sigma_prior * r2u;
  L.b_fv = L.a * L.r1v + p.sigma_prior * r2v;
}

// Adds the point's cost, its 21 entries of S and its 6 of the right-hand side
__device__ __forceinline__ void add_point(const Params& p, const Lin& L,
                                          float (&acc)[32]) {
  const float av = L.a * L.inv_v;
  const float coef = av * p.sigma_prior;
  const float ru = L.a * L.r1u - av * L.b_fu;
  const float rv = L.a * L.r1v - av * L.b_fv;
  acc[COST] += L.cost;
  int idx = SYS;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float cu = coef * L.Ju[j], cv = coef * L.Jv[j];
#pragma unroll
    for (int k = j; k < 6; ++k) acc[idx++] += cu * L.Ju[k] + cv * L.Jv[k];
    acc[RHS + j] += L.Ju[j] * ru + L.Jv[j] * rv;
  }
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
}

// kSmem: the points live in shared memory (else in the global scratch), so
// their loads compile to shared-memory loads
template <bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
flow_joint_kernel(const Params p) {
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
  int* idx = reinterpret_cast<int*>(base + IDX * cap);
  const unsigned char* valid = p.valid + (long long)b * N;
  const float* pts = p.pts + b * p.pts_bs;
  const float* obs = p.obs + b * p.obs_bs;
  const float* fm = p.fm + b * p.fm_bs;

  // compaction: thread t counts the prior set in its run of ~N/nthr
  // indices; a block prefix sum places each point; this CTA keeps the
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
      const float mu = fm[2LL * i], mv = fm[2LL * i + 1];
      base[FMU * cap + s] = mu;
      base[FMV * cap + s] = mv;
      base[ACT * cap + s] = 1.0f;
      // both flow pairs start at the measurement
      base[FU0 * cap + s] = base[FU1 * cap + s] = mu;
      base[FV0 * cap + s] = base[FV1 * cap + s] = mv;
      idx[s] = i;
    }
    ++k;
  }
  float T0[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) {
    const int r = e < 9 ? e / 3 : e - 9;
    const int c = e < 9 ? e % 3 : 3;
    T0[e] = p.T_init[16 * b + 4 * r + c];
  }
  __syncthreads();

  // The state below is every thread's own copy; all threads compute it from
  // the same cluster sums, so they agree.
  float acc[32], sys[kSys], T[12], Tn[12], dx[6];
  int cur = 0;     // the flow pair that holds the current flows
  int parity = 0;  // cluster_sum32's slot

  for (int rnd = 0; rnd < 4; ++rnd) {
    const bool huber = rnd < 3;
#pragma unroll
    for (int e = 0; e < 12; ++e) T[e] = T0[e];

    // round start: cost, active count and the system at (T_init, f)
    zero(acc);
    {
      const float* fu = base + (cur ? FU1 : FU0) * cap;
      const float* fv = base + (cur ? FV1 : FV0) * cap;
      for (int s = tid; s < own; s += nthr) {
        const Pt q = load_pt(base, cap, s);
        Lin L;
        linearize(p, T, q, fu[s], fv[s], huber, L);
        add_point(p, L, acc);
        acc[COUNT] += q.act;
      }
    }
    cluster_sum32(acc, sums, parity);
    float cost = acc[COST];
    const bool enough = acc[COUNT] >= (float)p.min_edges;
#pragma unroll
    for (int e = 0; e < kSys; ++e) sys[e] = acc[SYS + e];
    float lam = 1e-3f;
    int it = 0;
    bool more = p.iters > 0;

    while (more) {
      // the step from the system at the current state
      {
        float S[6][6], rhs[6];
        int e = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
          for (int c = j; c < 6; ++c) {
            S[j][c] = sys[e];
            S[c][j] = sys[e];
            ++e;
          }
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          S[j][j] += lam * fmaxf(S[j][j], 1e-6f);
          rhs[j] = sys[21 + j];
        }
        chol_solve6(S, rhs, dx);
      }
      float dsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) dsum += dx[j];
      const bool finite = isfinite(dsum);
      exp_se3_compose(dx, T, Tn);

      // the one pass: trial flows from the linearisation at (T, f), then the
      // trial cost and the system at (Tn, f_trial)
      zero(acc);
      {
        const float* fu = base + (cur ? FU1 : FU0) * cap;
        const float* fv = base + (cur ? FV1 : FV0) * cap;
        float* fu_t = base + (cur ? FU0 : FU1) * cap;
        float* fv_t = base + (cur ? FV0 : FV1) * cap;
        for (int s = tid; s < own; s += nthr) {
          const Pt q = load_pt(base, cap, s);
          const float fu0 = fu[s], fv0 = fv[s];
          Lin L;
          linearize(p, T, q, fu0, fv0, huber, L);
          float jdu = 0.0f, jdv = 0.0f;
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            jdu += L.Ju[j] * dx[j];
            jdv += L.Jv[j] * dx[j];
          }
          const float fu_n = fu0 - (L.b_fu - L.a * jdu) * L.inv_v;
          const float fv_n = fv0 - (L.b_fv - L.a * jdv) * L.inv_v;
          fu_t[s] = fu_n;
          fv_t[s] = fv_n;
          linearize(p, Tn, q, fu_n, fv_n, huber, L);
          add_point(p, L, acc);
        }
      }
      cluster_sum32(acc, sums, parity);

      const float c_new = acc[COST];
      const bool ok = (c_new < cost) && finite && enough;
      bool done = false;
      if (ok) {
        done = cost - c_new < 1e-8f * fmaxf(cost, 1.0f);
#pragma unroll
        for (int e = 0; e < 12; ++e) T[e] = Tn[e];
#pragma unroll
        for (int e = 0; e < kSys; ++e) sys[e] = acc[SYS + e];
        cur ^= 1;
        cost = c_new;
        lam *= 0.5f;
      } else {
        lam *= 4.0f;
      }
      ++it;
      more = (it < p.iters) && !done && (lam < 1e6f);
    }
    if (rank == 0 && tid == 0) p.iters_out[4 * b + rnd] = it;

    // round end: gate the active set at the final pose and flows; the last
    // round writes every point's outputs and counts the inliers
    const bool last = rnd == 3;
    const float thr = rnd == 0 ? p.thr0 : p.thr_later;
    const float* fu = base + (cur ? FU1 : FU0) * cap;
    const float* fv = base + (cur ? FV1 : FV0) * cap;
    zero(acc);
    for (int s = tid; s < own; s += nthr) {
      const Pt q = load_pt(base, cap, s);
      float pcx, pcy, pcz, iz, r1u, r1v;
      resid(p, T, q.x, q.y, q.z, q.ou, q.ov, fu[s], fv[s], pcx, pcy, pcz, iz,
            r1u, r1v);
      const float chi2 = p.sigma_proj * (r1u * r1u + r1v * r1v);
      const float act =
          (chi2 <= thr ? 1.0f : 0.0f) * (pcz > 1e-3f ? 1.0f : 0.0f);
      base[ACT * cap + s] = act;
      if (last) {
        const long long o = (long long)b * N + idx[s];
        p.chi2_out[o] = chi2;
        p.inl_out[o] = act > 0.5f;
        p.flow_out[2 * o] = fu[s];
        p.flow_out[2 * o + 1] = fv[s];
        acc[COUNT] += act;
      }
    }
    if (!last) continue;
    // the points outside the prior set keep a zero flow and are no inliers
    const int j0 = (int)((long long)rank * N / G);
    const int j1 = (int)((long long)(rank + 1) * N / G);
    for (int i = j0 + tid; i < j1; i += nthr) {
      if (valid[i]) continue;
      float pcx, pcy, pcz, iz, r1u, r1v;
      resid(p, T, pts[3LL * i], pts[3LL * i + 1], pts[3LL * i + 2],
            obs[2LL * i], obs[2LL * i + 1], 0.0f, 0.0f, pcx, pcy, pcz, iz,
            r1u, r1v);
      const long long o = (long long)b * N + i;
      p.chi2_out[o] = p.sigma_proj * (r1u * r1u + r1v * r1v);
      p.inl_out[o] = 0;
      p.flow_out[2 * o] = 0.0f;
      p.flow_out[2 * o + 1] = 0.0f;
    }
    cluster_sum32(acc, sums, parity);
    if (rank == 0 && tid == 0) p.ninl_out[b] = (int)acc[COUNT];
  }

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
  }
}

}  // namespace

// Launches the B problems with the wrapper's plan: clusters of G CTAs of
// `threads` threads, each holding up to `cap` points, in `smem_bytes` of
// dynamic shared memory (kPlanes * 4 * cap), or in `scratch` (B * G *
// kPlanes * cap floats) when smem_bytes is 0. Refuses (cudaErrorInvalidValue)
// a plan it cannot run; otherwise returns the CUDA error of the launch.
extern "C" int flow_joint_batched_launch(
    const float* T_init, const float* pts, long long pts_bstride,
    const float* obs, long long obs_bstride, const float* fm,
    long long fm_bstride, const unsigned char* valid, float* T_out,
    float* flow_out, unsigned char* inl_out, int* ninl_out, float* chi2_out,
    int* iters_out, float* scratch, int B, int N, int G, int threads, int cap,
    int smem_bytes, float fx, float fy, float cx, float cy, float sigma_proj,
    float sigma_prior, float huber, float huber2, float thr0, float thr_later,
    int min_edges, int iters, void* stream) {
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
  p.pts = pts;
  p.pts_bs = pts_bstride;
  p.obs = obs;
  p.obs_bs = obs_bstride;
  p.fm = fm;
  p.fm_bs = fm_bstride;
  p.valid = valid;
  p.T_out = T_out;
  p.flow_out = flow_out;
  p.inl_out = inl_out;
  p.ninl_out = ninl_out;
  p.chi2_out = chi2_out;
  p.iters_out = iters_out;
  p.scratch = scratch;
  p.N = N;
  p.cap = cap;
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.sigma_proj = sigma_proj;
  p.sigma_prior = sigma_prior;
  p.huber = huber;
  p.huber2 = huber2;
  p.thr0 = thr0;
  p.thr_later = thr_later;
  p.min_edges = min_edges;
  p.iters = iters;
  auto kernel =
      smem_bytes > 0 ? flow_joint_kernel<true> : flow_joint_kernel<false>;
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
