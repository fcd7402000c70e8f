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
// iterations, each with two block-wide reductions and a single-thread 6x6
// solve.
//
// Design: one thread block per problem, so the rounds and iterations run
// inside the block with no host synchronisation. The point data live in 13
// planes of N floats: px py pz, ou ov, fmu fmv, the prior set val, the active
// set, and two pairs of flow planes. One pair holds the current flows, the
// other the trial flows of the step under test; an accepted step swaps the
// pair (no copy, no recomputation at commit time), at the price of 8 bytes a
// point of shared memory: 52 B a point, 156 KB at N=3000 and 208 KB at
// N=4000, under the 227 KB a block may have. Above ~4,390 points the planes
// go to a global-memory scratch that the wrapper allocates; the code is the
// same. Each iteration makes two passes over the points in the prior set:
// the first sums the 21 entries of S and the 6 of the right-hand side, the
// second re-linearises at the current state, forms the trial flows and sums
// the trial cost. Thread 0 does the 6x6 algebra and the accept rule and
// publishes them through shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 27;  // 21 S (upper triangle, row-major) + 6 rhs
constexpr int kPlanes = 13;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kSmemReserve = 4096;  // room for the static shared memory

enum Plane { PX, PY, PZ, OU, OV, FMU, FMV, VAL, ACT, FU0, FV0, FU1, FV1 };

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
  float* scratch;              // (B, kPlanes, N) unless use_smem
  int N;
  float fx, fy, cx, cy;
  float sigma_proj, sigma_prior;
  float huber, huber2;         // delta and delta^2 of the Huber kernel
  float thr0, thr_later;       // round-end chi2 gates
  int min_edges, iters;
  int use_smem;
};

struct Pt {
  float x, y, z, ou, ov, fmu, fmv, sp, act;  // sp = sigma_prior * val
};

__device__ __forceinline__ Pt load_pt(const Params& p, const float* base,
                                      int i) {
  const int N = p.N;
  Pt q;
  q.x = base[PX * N + i];
  q.y = base[PY * N + i];
  q.z = base[PZ * N + i];
  q.ou = base[OU * N + i];
  q.ov = base[OV * N + i];
  q.fmu = base[FMU * N + i];
  q.fmv = base[FMV * N + i];
  q.sp = p.sigma_prior * base[VAL * N + i];
  q.act = base[ACT * N + i];
  return q;
}

// r1 = obs + f - pi(T X) with the |z| < 1e-6 guard; T is 12 floats (R
// row-major, then t).
__device__ __forceinline__ void resid(const Params& p, const float* T,
                                      const Pt& q, float fu, float fv,
                                      float& pcx, float& pcy, float& pcz,
                                      float& iz, float& r1u, float& r1v) {
  pcx = T[0] * q.x + T[1] * q.y + T[2] * q.z + T[9];
  pcy = T[3] * q.x + T[4] * q.y + T[5] * q.z + T[10];
  pcz = T[6] * q.x + T[7] * q.y + T[8] * q.z + T[11];
  iz = 1.0f / (fabsf(pcz) < 1e-6f ? 1e-6f : pcz);
  r1u = q.ou + fu - (p.fx * pcx * iz + p.cx);
  r1v = q.ov + fv - (p.fy * pcy * iz + p.cy);
}

// One point's share of the cost: the (robust) reprojection term while the
// point is active with z > 1e-3, plus its prior term.
__device__ __forceinline__ float point_cost(const Params& p, const float* T,
                                            const Pt& q, float fu, float fv,
                                            bool huber) {
  float pcx, pcy, pcz, iz, r1u, r1v;
  resid(p, T, q, fu, fv, pcx, pcy, pcz, iz, r1u, r1v);
  const float c1 = p.sigma_proj * (r1u * r1u + r1v * r1v);
  float rho = c1;
  if (huber && !(c1 <= p.huber2))
    rho = 2.0f * p.huber * sqrtf(fmaxf(c1, 1e-12f)) - p.huber2;
  const float gate = q.act * (pcz > 1e-3f ? 1.0f : 0.0f);
  const float r2u = fu - q.fmu, r2v = fv - q.fmv;
  return rho * gate + q.sp * (r2u * r2u + r2v * r2v);
}

// The per-point pieces of the Schur-reduced system at (T, f).
struct Lin {
  float a, v, r1u, r1v, b_fu, b_fv;
  float Ju[6], Jv[6];  // d pi / d xi (left perturbation); d r1/d xi = -J
};

__device__ __forceinline__ void linearize(const Params& p, const float* T,
                                          const Pt& q, float fu, float fv,
                                          bool huber, Lin& L) {
  float pcx, pcy, pcz, iz;
  resid(p, T, q, fu, fv, pcx, pcy, pcz, iz, L.r1u, L.r1v);
  const float chi2 = p.sigma_proj * (L.r1u * L.r1u + L.r1v * L.r1v);
  float w = 1.0f;
  if (huber && !(chi2 <= p.huber2)) w = p.huber / sqrtf(fmaxf(chi2, 1e-12f));
  L.a = q.act * (pcz > 1e-3f ? 1.0f : 0.0f) * (p.sigma_proj * w);
  L.v = L.a + q.sp + 1e-12f;
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
  L.b_fu = L.a * L.r1u + q.sp * (fu - q.fmu);
  L.b_fv = L.a * L.r1v + q.sp * (fv - q.fmv);
}

// Block-wide sums of the first K per-thread partials into tot (valid for
// every thread after the call).
template <int K>
__device__ __forceinline__ void block_reduce(const float* acc,
                                             float (*red)[kAcc], float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// Unrolled Cholesky solve of the 6x6 system S x = rhs (S full, row-major),
// pivots floored as sqrt(max(., 1e-20)) like the Pallas helper.
__device__ void chol_solve6(const float S[6][6], const float* rhs, float* x) {
  float L[6][6];
  for (int j = 0; j < 6; ++j) {
    float s = S[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    const float Ljj = sqrtf(fmaxf(s, 1e-20f));
    L[j][j] = Ljj;
    for (int i = j + 1; i < 6; ++i) {
      float s2 = S[i][j];
      for (int k = 0; k < j; ++k) s2 -= L[i][k] * L[j][k];
      L[i][j] = s2 / Ljj;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = rhs[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// Tn = exp(d) * T with d = [rho, phi]; the series switch of the Pallas
// _exp_se3_compose (theta^2 < 1e-12).
__device__ void exp_se3_compose(const float* d, const float* T, float* Tn) {
  const float w0 = d[3], w1 = d[4], w2 = d[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(fmaxf(th2, 1e-24f));
  const bool small = th2 < 1e-12f;
  const float A = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
  const float B = small ? 0.5f - th2 / 24.0f
                        : (1.0f - cosf(th)) / fmaxf(th2, 1e-24f);
  const float C = small ? 1.0f / 6.0f - th2 / 120.0f
                        : (th - sinf(th)) / fmaxf(th2 * th, 1e-24f);
  const float h[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  const float h2[3][3] = {{-(w1 * w1 + w2 * w2), w0 * w1, w0 * w2},
                          {w0 * w1, -(w0 * w0 + w2 * w2), w1 * w2},
                          {w0 * w2, w1 * w2, -(w0 * w0 + w1 * w1)}};
  float Rd[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float I = (i == j) ? 1.0f : 0.0f;
      Rd[i][j] = I + A * h[i][j] + B * h2[i][j];
      V[i][j] = I + B * h[i][j] + C * h2[i][j];
    }
  for (int i = 0; i < 3; ++i) {
    const float td = V[i][0] * d[0] + V[i][1] * d[1] + V[i][2] * d[2];
    for (int j = 0; j < 3; ++j)
      Tn[3 * i + j] = Rd[i][0] * T[j] + Rd[i][1] * T[3 + j] +
                      Rd[i][2] * T[6 + j];
    Tn[9 + i] = Rd[i][0] * T[9] + Rd[i][1] * T[10] + Rd[i][2] * T[11] + td;
  }
}

__global__ void __launch_bounds__(kThreads)
flow_joint_kernel(const Params p) {
  extern __shared__ float sm[];  // kPlanes planes of N floats when use_smem
  __shared__ float sT0[12], sT[12], sTn[12], sdx[6];
  __shared__ float red[kWarps][kAcc];
  __shared__ float tot[kAcc];
  __shared__ int s_run, s_cur;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = p.N;
  float* base = p.use_smem ? sm : p.scratch + (long long)b * kPlanes * N;

  if (tid < 12) {
    const int r = tid < 9 ? tid / 3 : tid - 9;
    const int c = tid < 9 ? tid % 3 : 3;
    sT0[tid] = p.T_init[16 * b + 4 * r + c];
  }
  if (tid == 0) s_cur = 0;
  for (int i = tid; i < N; i += kThreads) {
    const float* X = p.pts + b * p.pts_bs + 3LL * i;
    const float* o = p.obs + b * p.obs_bs + 2LL * i;
    const float* m = p.fm + b * p.fm_bs + 2LL * i;
    const float val = p.valid[(long long)b * N + i] ? 1.0f : 0.0f;
    base[PX * N + i] = X[0];
    base[PY * N + i] = X[1];
    base[PZ * N + i] = X[2];
    base[OU * N + i] = o[0];
    base[OV * N + i] = o[1];
    base[FMU * N + i] = m[0];
    base[FMV * N + i] = m[1];
    base[VAL * N + i] = val;
    base[ACT * N + i] = val;
    // both flow pairs start at the measurement (0 outside the prior set),
    // so the points the passes skip hold the same value in either pair
    base[FU0 * N + i] = base[FU1 * N + i] = m[0] * val;
    base[FV0 * N + i] = base[FV1 * N + i] = m[1] * val;
  }
  __syncthreads();

  float acc[kAcc];
  // state held by thread 0 only
  float cost = 0.0f, lam = 0.0f;
  int it = 0;
  bool enough = false, finite = false;

  for (int rnd = 0; rnd < 4; ++rnd) {
    const bool huber = rnd < 3;

    // round start: the pose restarts from T_init; cost and active count
    if (tid < 12) sT[tid] = sT0[tid];
    __syncthreads();
    {
      const float* fu = base + (s_cur ? FU1 : FU0) * N;
      const float* fv = base + (s_cur ? FV1 : FV0) * N;
      acc[0] = acc[1] = 0.0f;
      for (int i = tid; i < N; i += kThreads) {
        if (base[VAL * N + i] == 0.0f) continue;
        const Pt q = load_pt(p, base, i);
        acc[0] += point_cost(p, sT, q, fu[i], fv[i], huber);
        acc[1] += q.act;
      }
      block_reduce<2>(acc, red, tot);
    }
    if (tid == 0) {
      cost = tot[0];
      enough = tot[1] >= (float)p.min_edges;
      lam = 1e-3f;
      it = 0;
      s_run = p.iters > 0;
    }
    __syncthreads();

    while (s_run) {
      const float* fu = base + (s_cur ? FU1 : FU0) * N;
      const float* fv = base + (s_cur ? FV1 : FV0) * N;
      float* fu_t = base + (s_cur ? FU0 : FU1) * N;
      float* fv_t = base + (s_cur ? FV0 : FV1) * N;

      // pass 1: the Schur-reduced system and its right-hand side
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
      for (int i = tid; i < N; i += kThreads) {
        if (base[VAL * N + i] == 0.0f) continue;
        const Pt q = load_pt(p, base, i);
        Lin L;
        linearize(p, sT, q, fu[i], fv[i], huber, L);
        const float coef = L.a * q.sp / L.v;
        const float av = L.a / L.v;
        const float ru = L.a * L.r1u - av * L.b_fu;
        const float rv = L.a * L.r1v - av * L.b_fv;
        int idx = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float cu = coef * L.Ju[j], cv = coef * L.Jv[j];
#pragma unroll
          for (int k = j; k < 6; ++k) acc[idx++] += cu * L.Ju[k] + cv * L.Jv[k];
          acc[21 + j] += L.Ju[j] * ru + L.Jv[j] * rv;
        }
      }
      block_reduce<kAcc>(acc, red, tot);

      if (tid == 0) {
        float S[6][6], rhs[6], dx[6];
        int idx = 0;
        for (int j = 0; j < 6; ++j)
          for (int k = j; k < 6; ++k) {
            S[j][k] = tot[idx];
            S[k][j] = tot[idx];
            ++idx;
          }
        for (int j = 0; j < 6; ++j) {
          S[j][j] += lam * fmaxf(S[j][j], 1e-6f);
          rhs[j] = tot[21 + j];
        }
        chol_solve6(S, rhs, dx);
        float sum = 0.0f;
        for (int j = 0; j < 6; ++j) {
          sum += dx[j];
          sdx[j] = dx[j];
        }
        finite = isfinite(sum);
        exp_se3_compose(dx, sT, sTn);
      }
      __syncthreads();

      // pass 2: the flows' closed-form step and the trial cost
      acc[0] = 0.0f;
      for (int i = tid; i < N; i += kThreads) {
        if (base[VAL * N + i] == 0.0f) continue;
        const Pt q = load_pt(p, base, i);
        Lin L;
        linearize(p, sT, q, fu[i], fv[i], huber, L);
        float jdu = 0.0f, jdv = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          jdu += L.Ju[j] * sdx[j];
          jdv += L.Jv[j] * sdx[j];
        }
        const float fu_n = fu[i] + (-(L.b_fu - L.a * jdu) / L.v);
        const float fv_n = fv[i] + (-(L.b_fv - L.a * jdv) / L.v);
        fu_t[i] = fu_n;
        fv_t[i] = fv_n;
        acc[0] += point_cost(p, sTn, q, fu_n, fv_n, huber);
      }
      block_reduce<1>(acc, red, tot);

      if (tid == 0) {
        const float c_new = tot[0];
        const bool ok = (c_new < cost) && finite && enough;
        bool done = false;
        if (ok) {
          done = cost - c_new < 1e-8f * fmaxf(cost, 1.0f);
          for (int k = 0; k < 12; ++k) sT[k] = sTn[k];
          s_cur ^= 1;
          cost = c_new;
          lam *= 0.5f;
        } else {
          lam *= 4.0f;
        }
        ++it;
        s_run = (it < p.iters) && !done && (lam < 1e6f);
      }
      __syncthreads();
    }

    // round end: gate the active set at the final pose and flows
    {
      const bool last = rnd == 3;
      const float thr = rnd == 0 ? p.thr0 : p.thr_later;
      const float* fu = base + (s_cur ? FU1 : FU0) * N;
      const float* fv = base + (s_cur ? FV1 : FV0) * N;
      acc[0] = 0.0f;
      for (int i = tid; i < N; i += kThreads) {
        const float val = base[VAL * N + i];
        if (val == 0.0f && !last) continue;
        const Pt q = load_pt(p, base, i);
        float pcx, pcy, pcz, iz, r1u, r1v;
        resid(p, sT, q, fu[i], fv[i], pcx, pcy, pcz, iz, r1u, r1v);
        const float chi2 = p.sigma_proj * (r1u * r1u + r1v * r1v);
        const float act =
            val * (chi2 <= thr ? 1.0f : 0.0f) * (pcz > 1e-3f ? 1.0f : 0.0f);
        base[ACT * N + i] = act;
        if (last) {
          const long long o = (long long)b * N + i;
          p.chi2_out[o] = chi2;
          p.inl_out[o] = act > 0.5f;
          p.flow_out[2 * o] = fu[i];
          p.flow_out[2 * o + 1] = fv[i];
          acc[0] += act;
        }
      }
      if (last) block_reduce<1>(acc, red, tot);
      if (tid == 0) {
        p.iters_out[4 * b + rnd] = it;
        if (last) p.ninl_out[b] = (int)tot[0];
      }
      __syncthreads();
    }
  }

  if (tid < 16) {
    const int r = tid / 4, c = tid % 4;
    float v;
    if (r == 3) v = (c == 3) ? 1.0f : 0.0f;
    else v = (c == 3) ? sT[9 + r] : sT[3 * r + c];
    p.T_out[16 * b + tid] = v;
  }
}

bool planes_fit_smem(int N) {
  return (long long)kPlanes * N * (long long)sizeof(float) + kSmemReserve <=
         kSmemLimit;
}

}  // namespace

// Floats of global scratch a launch at (B, N) needs: 0 when the planes fit
// in shared memory.
extern "C" long long flow_joint_scratch_floats(int B, int N) {
  return planes_fit_smem(N) ? 0 : (long long)B * kPlanes * N;
}

extern "C" int flow_joint_batched_launch(
    const float* T_init, const float* pts, long long pts_bstride,
    const float* obs, long long obs_bstride, const float* fm,
    long long fm_bstride, const unsigned char* valid, float* T_out,
    float* flow_out, unsigned char* inl_out, int* ninl_out, float* chi2_out,
    int* iters_out, float* scratch, int B, int N, float fx, float fy,
    float cx, float cy, float sigma_proj, float sigma_prior, float huber,
    float huber2, float thr0, float thr_later, int min_edges, int iters,
    void* stream) {
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
  p.use_smem = planes_fit_smem(N) ? 1 : 0;
  if (!p.use_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int dyn = p.use_smem ? (int)(kPlanes * (long long)N * sizeof(float))
                             : 0;
  cudaError_t err = cudaFuncSetAttribute(
      flow_joint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    flow_joint_kernel<<<B, kThreads, dyn, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
