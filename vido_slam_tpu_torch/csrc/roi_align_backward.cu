// The gradient of FPN multilevel ROIAlign with respect to the features, on
// Hopper (sm_90a).
//
// The JAX package has no kernel for it: it trains through its XLA
// roi_align_multilevel (vido_slam_tpu/ops/roi_align.py:112-196) and takes
// this gradient from XLA's autodiff of the two contractions out = Ry F Rx^T.
// This is the backward of csrc/roi_align.cu's float32 build:
//
//   grad_F_l[c, h, w] = sum over the ROIs i pooled from level l, their bins
//                       (p, q) and the bins' s x s samples of
//                       wy(h) wx(w) grad_out[i, c, p, q],
//
// where wy, wx are a sample's bilinear weights on its row and column, each
// with the bin's 1/s average folded in (equivalently Ry^T G Rx per ROI).
// The samples are the forward's, operation for operation (axis_sample): a
// sample outside [-1, size - 1] contributes 0, an in-range coordinate is
// clamped to [0, size - 1] first, and ROI i takes level levels[i] clamped
// to [0, L).
//
// Design (correct first, not yet fast): one thread per output element
// (ROI, channel, bin), the bin's r x r elements of one channel on adjacent
// threads. A thread reads its gradient once, works out its bin's s row and
// s column samples, and adds the s^2 samples' four corner contributions to
// the zeroed level gradient with atomicAdd. Atomics sum in an order that
// changes from run to run, so the result matches the plain version to
// rounding, not to the bit. A redesign without atomics (the separable
// Ry^T (G Rx) staged in shared memory) is left for later.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxRatio = 4;             // sampling ratios 1..4
constexpr int kMaxSamples = 64;          // r * s per axis
constexpr int kThreads = 256;

struct Grads {
  float* grad[kMaxLevels];               // (C, h, w) planes, one image
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int levels;
};

struct Sample {
  int i0, i1;                            // clamped texel lines; -1 outside
  float w0, w1;                          // their weights, 0 outside
};

// csrc/roi_align.cu's axis_sample: sample k = p s + i of [lo, hi] on an
// axis of `size` texels, its two lines and weights (1/s folded in)
__device__ Sample axis_sample(float lo, float hi, int size, int r, int s,
                              int k) {
  const float bin = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1.f), (float)r);
  const int p = k / s;
  const int i = k - p * s;
  const float frac = __fdiv_rn(__fadd_rn((float)i, 0.5f), (float)s);
  const float pos = __fadd_rn(lo, __fmul_rn(__fadd_rn((float)p, frac), bin));
  const float top = (float)(size - 1);
  Sample out{-1, -1, 0.f, 0.f};
  if (pos >= -1.f && pos <= top) {       // false for NaN too
    const float c = fminf(fmaxf(pos, 0.f), top);
    out.i0 = (int)floorf(c);
    out.i1 = min(out.i0 + 1, size - 1);
    const float l = __fsub_rn(c, (float)out.i0);
    out.w0 = __fdiv_rn(__fsub_rn(1.f, l), (float)s);
    out.w1 = __fdiv_rn(l, (float)s);
  }
  return out;
}

template <int kS>
__global__ void __launch_bounds__(kThreads)
roi_align_backward_kernel(Grads g, const float* __restrict__ rois,
                          const int* __restrict__ levels,
                          const float* __restrict__ grad_out, int R, int C,
                          int r) {
  const long long total = (long long)R * C * r * r;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int rr = r * r;
  const int bin = (int)(idx % rr);
  const long long rc = idx / rr;
  const int c = (int)(rc % C);
  const int roi = (int)(rc / C);
  const float go = grad_out[idx];
  if (go == 0.f) return;
  const int lv = min(max(levels[roi], 0), g.levels - 1);
  float* grad = lv == 0 ? g.grad[0] : lv == 1 ? g.grad[1]
              : lv == 2 ? g.grad[2] : g.grad[3];
  const int H = lv == 0 ? g.h[0] : lv == 1 ? g.h[1]
              : lv == 2 ? g.h[2] : g.h[3];
  const int W = lv == 0 ? g.w[0] : lv == 1 ? g.w[1]
              : lv == 2 ? g.w[2] : g.w[3];
  const float scale = lv == 0 ? g.scale[0] : lv == 1 ? g.scale[1]
                    : lv == 2 ? g.scale[2] : g.scale[3];
  const float* b = rois + 4 * (size_t)roi;
  const int ph = bin / r, pw = bin - ph * r;
  Sample ys[kS], xs[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    ys[i] = axis_sample(__fmul_rn(b[1], scale), __fmul_rn(b[3], scale), H, r,
                        kS, ph * kS + i);
    xs[i] = axis_sample(__fmul_rn(b[0], scale), __fmul_rn(b[2], scale), W, r,
                        kS, pw * kS + i);
  }
  float* plane = grad + (size_t)c * H * W;
#pragma unroll
  for (int iy = 0; iy < kS; ++iy) {
    if (ys[iy].i0 < 0) continue;
    const float gy0 = go * ys[iy].w0, gy1 = go * ys[iy].w1;
    float* row0 = plane + (size_t)ys[iy].i0 * W;
    float* row1 = plane + (size_t)ys[iy].i1 * W;
#pragma unroll
    for (int ix = 0; ix < kS; ++ix) {
      const Sample& x = xs[ix];
      if (x.i0 < 0) continue;
      if (gy0 != 0.f) {
        atomicAdd(row0 + x.i0, gy0 * x.w0);
        if (x.w1 != 0.f) atomicAdd(row0 + x.i1, gy0 * x.w1);
      }
      if (gy1 != 0.f) {
        atomicAdd(row1 + x.i0, gy1 * x.w0);
        if (x.w1 != 0.f) atomicAdd(row1 + x.i1, gy1 * x.w1);
      }
    }
  }
}

}  // namespace

// Adds the gradient of roi_align_launch's output to the L level gradients,
// which the caller zeroes: grads, hs, ws, scales are host arrays of the
// levels' device pointers (float32 (C, h, w) planes), heights, widths and
// spatial scales; rois (R, 4) float32, levels (R,) int32 and grad_out
// (R, C, r, r) float32 on the device. Runs on `stream`. Refuses
// (cudaErrorInvalidValue) arguments it cannot run; otherwise returns the
// CUDA error of the launch.
extern "C" int roi_align_backward_launch(void* const* grads, const int* hs,
                                         const int* ws, const float* scales,
                                         int L, const float* rois,
                                         const int* levels,
                                         const float* grad_out, int R, int C,
                                         int r, int s, void* stream) {
  if (L < 1 || L > kMaxLevels || R < 1 || R > 65535 || C < 1 || r < 1 ||
      s < 1 || s > kMaxRatio || r * s > kMaxSamples)
    return (int)cudaErrorInvalidValue;
  Grads g{};
  g.levels = L;
  for (int l = 0; l < L; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return (int)cudaErrorInvalidValue;
    g.grad[l] = static_cast<float*>(grads[l]);
    g.h[l] = hs[l];
    g.w[l] = ws[l];
    g.scale[l] = scales[l];
  }
  const long long total = (long long)R * C * r * r;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  void (*kernel)(Grads, const float*, const int*, const float*, int, int,
                 int) =
      s == 1 ? roi_align_backward_kernel<1>
      : s == 2 ? roi_align_backward_kernel<2>
      : s == 3 ? roi_align_backward_kernel<3>
               : roi_align_backward_kernel<4>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g, rois, levels, grad_out, R, C, r);
  return (int)cudaGetLastError();
}
