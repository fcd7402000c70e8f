// FPN multilevel ROIAlign on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   vido_slam_tpu/ops/roi_align.py :: roi_align_fused_pallas
//   (body _roi_fused_kernel),
// which computes out = Ry . F . Rx^T per ROI over the row-stacked P2-P5
// pyramid, with banded weight matrices Ry, Rx built outside the kernel.
//
// What it computes (maskrcnn_benchmark's ROIAlign, Detectron-1 rules, as
// the JAX package's roi_align_multilevel computes it): ROI i, (x1, y1, x2,
// y2) in image coordinates, is pooled only from level l = levels[i] (clamped
// to [0, L)), scaled by that level's spatial_scale, no half-pixel shift. Bin
// (ph, pw) of the r x r output averages s x s bilinear samples at
//   y = y1 + (ph + (iy + 0.5) / s) * max(y2 - y1, 1) / r     (x alike);
// a sample outside [-1, size - 1] contributes 0, an in-range coordinate is
// clamped to [0, size - 1]. Output (R, C, r, r) float32.
//
// What bounds it on the card: bytes. The box head's call (R = 1000, r = 7,
// C = 256) writes 50.2 MB of output; the feature texels its samples touch
// add at most the 74 MB pyramid of a 1088 x 800 image: 0.015-0.037 ms at
// 3.35 TB/s, against 0.5 GFLOP (0.0075 ms at the float32 rate).
//
// Design (a first kernel, right and simple). The TPU kernel's separable
// form exists to feed the MXU; here a direct bilinear gather per bin computes
// the same function and reads only the texels the samples touch. The four
// levels come as four pointers with their sizes (no concatenated copy of
// the pyramid). Block (x, roi) owns a contiguous run of kPerBlock of the
// ROI's C * r * r outputs. Its first 2 r s threads compute the ROI's sample
// rows and columns (two clamped indices and two weights each, the
// inside-test and the 1/s average folded into the weights) once into shared
// memory; every channel shares them. Each thread then takes outputs
// (c, ph, pw) kThreads apart, so a warp writes 32 consecutive floats. The
// sample positions use round-to-nearest multiplies and adds without FMA
// contraction, so a sample lands exactly where the plain version puts it,
// including at -1 and size - 1.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxSamples = 64;          // r * s per axis
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPerBlock = kThreads * kPerThread;

struct Pyramid {
  const float* feat[kMaxLevels];         // (C, h, w) planes, one image
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int levels;
};

struct Sample {
  int i0, i1;                            // clamped texel rows or columns
  float w0, w1;                          // their weights, 0 outside
};

__device__ Sample axis_sample(float lo, float hi, int size, int r, int s,
                              int k) {
  const float bin = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1.f), (float)r);
  const int p = k / s;
  const int i = k - p * s;
  const float frac = __fdiv_rn(__fadd_rn((float)i, 0.5f), (float)s);
  const float pos = __fadd_rn(lo, __fmul_rn(__fadd_rn((float)p, frac), bin));
  const float top = (float)(size - 1);
  Sample out{0, 0, 0.f, 0.f};
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

__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Pyramid pyr, const float* __restrict__ rois,
                 const int* __restrict__ levels, float* __restrict__ out,
                 int C, int r, int s) {
  __shared__ Sample ys[kMaxSamples];
  __shared__ Sample xs[kMaxSamples];
  const int roi = blockIdx.y;
  const int lv = min(max(levels[roi], 0), pyr.levels - 1);
  const int H = pyr.h[lv], W = pyr.w[lv];
  const float scale = pyr.scale[lv];
  const int n = r * s;
  const int t = threadIdx.x;
  if (t < 2 * n) {
    const float* b = rois + 4 * (size_t)roi;
    if (t < n)
      ys[t] = axis_sample(__fmul_rn(b[1], scale), __fmul_rn(b[3], scale), H,
                          r, s, t);
    else
      xs[t - n] = axis_sample(__fmul_rn(b[0], scale), __fmul_rn(b[2], scale),
                              W, r, s, t - n);
  }
  __syncthreads();

  const float* feat = pyr.feat[lv];
  const int rr = r * r;
  const int total = C * rr;
  float* o = out + (size_t)roi * total;
  const int base = blockIdx.x * kPerBlock;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = base + j * kThreads + t;
    if (e >= total) break;
    const int c = e / rr;
    const int bin = e - c * rr;
    const int ph = bin / r;
    const int pw = bin - ph * r;
    const float* f = feat + (size_t)c * H * W;
    float acc = 0.f;
    for (int iy = 0; iy < s; ++iy) {
      const Sample y = ys[ph * s + iy];
      const float* row0 = f + (size_t)y.i0 * W;
      const float* row1 = f + (size_t)y.i1 * W;
      for (int ix = 0; ix < s; ++ix) {
        const Sample x = xs[pw * s + ix];
        const float a = fmaf(x.w1, row0[x.i1], x.w0 * row0[x.i0]);
        const float b = fmaf(x.w1, row1[x.i1], x.w0 * row1[x.i0]);
        acc = fmaf(y.w0, a, acc);
        acc = fmaf(y.w1, b, acc);
      }
    }
    o[e] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns the CUDA error of the launch (0 on success).
// feats, hs, ws, scales: host arrays of the L levels' device pointers,
// heights, widths and spatial scales.
extern "C" int roi_align_launch(const void* const* feats, const int* hs,
                                const int* ws, const float* scales, int L,
                                const float* rois, const int* levels,
                                float* out, int R, int C, int r, int s,
                                void* stream) {
  if (L < 1 || L > kMaxLevels || R < 1 || R > 65535 || C < 1 || r < 1 ||
      s < 1 || r * s > kMaxSamples)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr{};
  pyr.levels = L;
  for (int l = 0; l < L; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return (int)cudaErrorInvalidValue;
    pyr.feat[l] = static_cast<const float*>(feats[l]);
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    pyr.scale[l] = scales[l];
  }
  const long long total = (long long)C * r * r;
  if (total > 2147483647LL - kPerBlock) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((total + kPerBlock - 1) / kPerBlock), R);
  roi_align_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      pyr, rois, levels, out, C, r, s);
  return (int)cudaGetLastError();
}
