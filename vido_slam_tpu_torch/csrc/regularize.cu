// The tail of LiteFlowNet's regularization on Hopper (sm_90a): the
// exp-normalised, distance-weighted k x k filter of the flow.
//
// Replaces the Pallas TPU kernel
//   vido_slam_tpu/ops/regularize.py :: dist_weighted_flow_pallas
//   (body _reg_kernel).
//
// What it computes, per pixel of dc (N, K, H, W), K = k*k, and the flow
// (N, 2, H, W) = [u, v], with r = (k-1)/2 and tap t = dy*k + dx:
//   m  = max_t(-dc_t^2),  e_t = exp(-dc_t^2 - m),
//   sx = (sum_t wx_t e_t u[y+dy-r, x+dx-r] + bx) / sum_t e_t
// and sy the same with wy, v and by; the flow is zero outside the image.
// The output is (N, 2, H, W) = [sx, sy].
//
// What bounds it on the card: bytes. It reads K + 2 floats and writes 2 a
// pixel for ~11 K flops: at level 2 of a 1280x576 pair (288 x 640, K = 49)
// 36.1 MB of dc, 0.012 ms at 3.35 TB/s.
//
// Design (a first kernel, right and simple): one thread per pixel, a block of
// 32 x 8 pixels with warps along x, so each read of a dc plane is coalesced.
// The block stages its haloed flow tile, (8 + 2r) x (32 + 2r) of u and of v
// (zero outside the image), and the K weights of x and y in shared memory.
// The window side is a template argument, so a thread keeps its K values of
// -dc^2 in registers: pass 1 takes their max, pass 2 sums the e_t and the two
// weighted window sums, and the epilogue (acc + b) / sum e writes sx and sy.
// exp is expf (no fast-math build).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kThreads = kTX * kTY;

template <int KS>
__global__ void __launch_bounds__(kThreads)
dist_weighted_flow_kernel(const float* __restrict__ dc,
                          const float* __restrict__ flow,
                          const float* __restrict__ wx,
                          const float* __restrict__ bx,
                          const float* __restrict__ wy,
                          const float* __restrict__ by,
                          float* __restrict__ out, int H, int W) {
  constexpr int K = KS * KS;
  constexpr int R = (KS - 1) / 2;
  constexpr int SH = kTY + 2 * R;
  constexpr int SW = kTX + 2 * R;
  __shared__ float su[SH][SW];
  __shared__ float sv[SH][SW];
  __shared__ float swx[K];
  __shared__ float swy[K];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int x = blockIdx.x * kTX + tx;
  const int y = blockIdx.y * kTY + ty;
  const size_t plane = (size_t)H * W;
  const float* un = flow + (size_t)blockIdx.z * 2 * plane;
  const float* vn = un + plane;
  const int y0 = blockIdx.y * kTY - R;
  const int x0 = blockIdx.x * kTX - R;
  for (int e = tid; e < SH * SW; e += kThreads) {
    const int r = e / SW, q = e - r * SW;
    const int yy = y0 + r, xx = x0 + q;
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    const size_t at = in ? (size_t)yy * W + xx : 0;
    su[r][q] = in ? un[at] : 0.f;
    sv[r][q] = in ? vn[at] : 0.f;
  }
  for (int e = tid; e < K; e += kThreads) {
    swx[e] = wx[e];
    swy[e] = wy[e];
  }
  __syncthreads();
  if (y >= H || x >= W) return;

  const float* d = dc + (size_t)blockIdx.z * K * plane + (size_t)y * W + x;
  float nd[K];
  float m = -INFINITY;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float v = d[t * plane];
    nd[t] = -(v * v);
    m = fmaxf(m, nd[t]);
  }
  float sum = 0.f, ax = 0.f, ay = 0.f;
#pragma unroll
  for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      const int t = dy * KS + dx;
      const float e = expf(nd[t] - m);
      sum += e;
      ax += swx[t] * e * su[ty + dy][tx + dx];
      ay += swy[t] * e * sv[ty + dy][tx + dx];
    }
  }
  const float inv = 1.f / sum;
  float* o = out + (size_t)blockIdx.z * 2 * plane + (size_t)y * W + x;
  o[0] = (ax + bx[0]) * inv;
  o[plane] = (ay + by[0]) * inv;
}

template <int KS>
void launch(const float* dc, const float* flow, const float* wx,
            const float* bx, const float* wy, const float* by, float* out,
            int N, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, N);
  const dim3 block(kTX, kTY);
  dist_weighted_flow_kernel<KS><<<grid, block, 0, stream>>>(
      dc, flow, wx, bx, wy, by, out, H, W);
}

}  // namespace

// Launches on `stream`; returns the CUDA error of the launch (0 on success).
// k is the window side, one of 3, 5, 7.
extern "C" int dist_weighted_flow_launch(const float* dc, const float* flow,
                                         const float* wx, const float* bx,
                                         const float* wy, const float* by,
                                         float* out, int N, int H, int W,
                                         int k, void* stream) {
  if (N < 1 || H < 1 || W < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 3: launch<3>(dc, flow, wx, bx, wy, by, out, N, H, W, st); break;
    case 5: launch<5>(dc, flow, wx, bx, wy, by, out, N, H, W, st); break;
    case 7: launch<7>(dc, flow, wx, bx, wy, by, out, N, H, W, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
