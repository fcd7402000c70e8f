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
//
// What bounds it on the card: neither roofline. A problem reads 24 bytes a
// point and does ~190 flops a point per iteration, so one frame's two calls
// (B=1, N=3000 and B=8, N=4000, tens of iterations) are microseconds of
// bytes and of float32 work. The time goes to latency: the iterations are
// serial and data-dependent, and each one ends in a block-wide reduction and
// a single-thread 6x6 solve.
//
// Design: one thread block per problem, so the data-dependent loop runs
// inside the block with no host synchronisation. The problem's six planes are
// loaded once into shared memory (N=4000 takes 96 KB of the 227 KB a block
// may have) and re-read from there every iteration; a problem too large for
// shared memory reads global memory instead. Each thread accumulates the 21
// upper-triangle entries of H, the 6 of g and the cost over a strided subset
// of the points; the block reduces them by warp shuffles and shared memory,
// and thread 0 does the 6x6 algebra and the accept logic and publishes the
// trial pose through shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;  // 21 H (upper triangle, row-major) + 6 g + 1 cost
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

struct Params {
  const float* T_init;        // (B, 4, 4)
  const float* T_pre;         // (B, 4, 4)
  const float* pts;           // (B, N, 3) or shared (N, 3): stride pts_bs
  long long pts_bs;
  const float* obs;           // (B, N, 2) or shared (N, 2): stride obs_bs
  long long obs_bs;
  const unsigned char* valid; // (B, N) bool
  float* T_out;               // (B, 4, 4)
  float* chi2_out;            // (B, N)
  int* iters_out;             // (B,)
  int N;
  float fx, fy, cx, cy;
  float huber;                // <= 0: no robust kernel
  int max_iters;
  float init_lambda, gain_tol, rel_tol;
  int use_smem;
};

struct Point {
  float x, y, z, u, v, m;
};

__device__ __forceinline__ Point load_point(const Params& p, const float* sm,
                                            int b, int i) {
  Point q;
  if (p.use_smem) {
    const int N = p.N;
    q.x = sm[i];
    q.y = sm[N + i];
    q.z = sm[2 * N + i];
    q.u = sm[3 * N + i];
    q.v = sm[4 * N + i];
    q.m = sm[5 * N + i];
  } else {
    const float* X = p.pts + b * p.pts_bs + 3LL * i;
    const float* o = p.obs + b * p.obs_bs + 2LL * i;
    q.x = X[0];
    q.y = X[1];
    q.z = X[2];
    q.u = o[0];
    q.v = o[1];
    q.m = p.valid[(long long)b * p.N + i] ? 1.0f : 0.0f;
  }
  return q;
}

// Residual, robust weight and Jacobian rows of one point at the variable
// transform T (12 floats: R row-major, then t) and the fixed pre-transform P.
// Adds w J^T J, w J^T r and rho * m into acc; returns the unrobustified chi2.
__device__ __forceinline__ float point_terms(const Params& p, const float* T,
                                             const float* P, const Point& q,
                                             float* acc, bool accumulate) {
  const float pwx = T[0] * q.x + T[1] * q.y + T[2] * q.z + T[9];
  const float pwy = T[3] * q.x + T[4] * q.y + T[5] * q.z + T[10];
  const float pwz = T[6] * q.x + T[7] * q.y + T[8] * q.z + T[11];
  const float pcx = P[0] * pwx + P[1] * pwy + P[2] * pwz + P[9];
  const float pcy = P[3] * pwx + P[4] * pwy + P[5] * pwz + P[10];
  const float pcz = P[6] * pwx + P[7] * pwy + P[8] * pwz + P[11];
  const float iz = 1.0f / (fabsf(pcz) < 1e-6f ? 1e-6f : pcz);
  const float ru = p.fx * pcx * iz + p.cx - q.u;
  const float rv = p.fy * pcy * iz + p.cy - q.v;
  const float chi2 = ru * ru + rv * rv;
  if (!accumulate) return chi2;

  float w_rob = 1.0f, rho = chi2;
  if (p.huber > 0.0f) {
    const float d2 = p.huber * p.huber;
    if (chi2 > d2) {
      const float s = sqrtf(fmaxf(chi2, 1e-12f));
      w_rob = p.huber / s;
      rho = 2.0f * p.huber * s - d2;
    }
  }
  const float w = w_rob * q.m;
  acc[27] += rho * q.m;

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
  int idx = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float wu = w * Ju[j], wv = w * Jv[j];
#pragma unroll
    for (int k = j; k < 6; ++k) acc[idx++] += wu * Ju[k] + wv * Jv[k];
    acc[21 + j] += wu * ru + wv * rv;
  }
  return chi2;
}

// Block-wide sum of the kAcc per-thread partials into tot (valid for every
// thread after the call).
__device__ __forceinline__ void block_reduce(float* acc,
                                             float (*red)[kAcc],
                                             float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// Unrolled Cholesky solve of the 6x6 system S x = rhs (S full, row-major),
// with the same sqrt(max(., 1e-20)) pivot floor as the Pallas helper.
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

// T_new = exp(dxi) * T with dxi = [rho, phi]; the series switch of
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
pose_lm_kernel(const Params p) {
  extern __shared__ float sm[];  // 6 planes of N floats when use_smem
  __shared__ float sT[12], sTn[12], sP[12];
  __shared__ float red[kWarps][kAcc];
  __shared__ float tot[kAcc];
  __shared__ int s_exit;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = p.N;

  if (tid < 12) {
    const int r = tid < 9 ? tid / 3 : tid - 9;
    const int c = tid < 9 ? tid % 3 : 3;
    sT[tid] = p.T_init[16 * b + 4 * r + c];
    sP[tid] = p.T_pre[16 * b + 4 * r + c];
  }
  if (p.use_smem) {
    for (int i = tid; i < N; i += kThreads) {
      const float* X = p.pts + b * p.pts_bs + 3LL * i;
      const float* o = p.obs + b * p.obs_bs + 2LL * i;
      sm[i] = X[0];
      sm[N + i] = X[1];
      sm[2 * N + i] = X[2];
      sm[3 * N + i] = o[0];
      sm[4 * N + i] = o[1];
      sm[5 * N + i] = p.valid[(long long)b * N + i] ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  float acc[kAcc];
  auto accumulate_at = [&](const float* T) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    for (int i = tid; i < N; i += kThreads)
      point_terms(p, T, sP, load_point(p, sm, b, i), acc, true);
    block_reduce(acc, red, tot);
  };

  // state held by thread 0 only
  float H[21], g[6], cost = 0.0f, lam = 0.0f, lam0 = 0.0f, ni = 2.0f;
  int it = 0;
  bool done = false;
  const int diag[6] = {0, 6, 11, 15, 18, 20};

  accumulate_at(sT);
  if (tid == 0) {
    for (int i = 0; i < 21; ++i) H[i] = tot[i];
    for (int j = 0; j < 6; ++j) g[j] = tot[21 + j];
    cost = tot[27];
    float maxd = H[diag[0]];
    for (int j = 1; j < 6; ++j) maxd = fmaxf(maxd, H[diag[j]]);
    lam0 = fmaxf(p.init_lambda * maxd, 1e-30f);
    lam = lam0;
    done = cost <= p.gain_tol;
  }

  float delta[6], dscale[6];
  bool bad = false;
  while (true) {
    if (tid == 0) {
      s_exit = (done || it >= p.max_iters) ? 1 : 0;
      if (!s_exit) {
        float maxd = H[diag[0]];
        for (int j = 1; j < 6; ++j) maxd = fmaxf(maxd, H[diag[j]]);
        const float floor_ = 1e-6f * fmaxf(maxd, 1e-12f);
        float S[6][6], rhs[6];
        int idx = 0;
        for (int j = 0; j < 6; ++j)
          for (int k = j; k < 6; ++k) {
            S[j][k] = H[idx];
            S[k][j] = H[idx];
            ++idx;
          }
        for (int j = 0; j < 6; ++j) {
          dscale[j] = fmaxf(H[diag[j]], floor_);
          S[j][j] += lam * dscale[j];
          rhs[j] = -g[j];
        }
        chol_solve6(S, rhs, delta);
        float sum = 0.0f;
        for (int j = 0; j < 6; ++j) sum += delta[j];
        bad = !isfinite(sum);
        if (bad)
          for (int j = 0; j < 6; ++j) delta[j] = 0.0f;
        exp_se3_compose(delta, sT, sTn);
      }
    }
    __syncthreads();
    if (s_exit) break;

    accumulate_at(sTn);

    if (tid == 0) {
      const float cost_new = tot[27];
      float pred = 0.0f;
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
        for (int i = 0; i < 12; ++i) sT[i] = sTn[i];
        for (int i = 0; i < 21; ++i) H[i] = tot[i];
        for (int j = 0; j < 6; ++j) g[j] = tot[21 + j];
        cost = cost_new;
      }
      ni = accept ? 2.0f : ni * 2.0f;
      lam = lam_new;
      done = done_new;
      ++it;
    }
  }

  // the break follows a __syncthreads, so sT is final for every thread
  for (int i = tid; i < N; i += kThreads)
    p.chi2_out[(long long)b * N + i] =
        point_terms(p, sT, sP, load_point(p, sm, b, i), acc, false);
  if (tid < 16) {
    const int r = tid / 4, c = tid % 4;
    float v;
    if (r == 3) v = (c == 3) ? 1.0f : 0.0f;
    else v = (c == 3) ? sT[9 + r] : sT[3 * r + c];
    p.T_out[16 * b + tid] = v;
  }
  if (tid == 0) p.iters_out[b] = it;
}

}  // namespace

extern "C" int pose_lm_batched_launch(
    const float* T_init, const float* T_pre, const float* pts,
    long long pts_bstride, const float* obs, long long obs_bstride,
    const unsigned char* valid, float* T_out, float* chi2_out, int* iters_out,
    int B, int N, float fx, float fy, float cx, float cy, float huber,
    int max_iters, float init_lambda, float gain_tol, float rel_tol,
    void* stream) {
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
  p.N = N;
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.huber = huber;
  p.max_iters = max_iters;
  p.init_lambda = init_lambda;
  p.gain_tol = gain_tol;
  p.rel_tol = rel_tol;
  // static shared memory is ~1.1 KB; leave it room under the block limit
  const long long plane_bytes = 6LL * N * (long long)sizeof(float);
  p.use_smem = (plane_bytes + 4096 <= kSmemLimit) ? 1 : 0;
  const int dyn = p.use_smem ? (int)plane_bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn > 0 ? dyn : 0);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    pose_lm_kernel<<<B, kThreads, dyn, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
