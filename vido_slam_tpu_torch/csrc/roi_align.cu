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
// Design: a block pools one ROI over a group of channels (grid groups x R;
// the wrapper's launch plan sets the group, the threads and the shared
// memory), in three steps.
// 1. The ROI's sample grid. Warps 0 and 1 work out the n = r s sample rows
//    and columns (two clamped texel lines and two weights each, the
//    inside-test and the 1/s average folded into the weights) and the texel
//    lines to stage: where a ROI's sampled lines span at most the grid's
//    cap of min(2 n, largest level size) lines, the contiguous window
//    between its first and last (a small ROI, the common case); else the
//    2 n lines of its samples, each read once (a large or elongated ROI,
//    whose samples lie apart; a 1500 x 10 box can span a whole level).
// 2. The channels, a chunk at a time, through two buffers of shared memory:
//    while the bins of chunk k are computed from one buffer, chunk k + 1's
//    grids (staged rows x staged columns a channel, a row of a window being
//    one contiguous run) arrive by cp.async in the other. A chunk is as many
//    channels as a buffer holds at this ROI's grid, so a small ROI moves
//    many channels a chunk and a large one few. A thread owns an output
//    column (c, pw): it x-interpolates each staged row that its bins'
//    samples use once (adjacent samples of a window share rows) and combines
//    the rows along y into the column's r bins, in the buffer.
// 3. The chunk's outputs go out as one contiguous run of its channels'
//    r x r bins in (R, C, r, r) order, one streaming store a float.
// The sample positions use round-to-nearest multiplies and adds without FMA
// contraction, so a sample lands exactly where the plain version puts it,
// including at -1 and size - 1; only the order of the weighted sums differs.
//
// The bf16 build (the detector with mask_dtype or compute_dtype bf16, the
// JAX bench's default) computes the Pallas kernel's function on bf16
// features as the JAX package rounds it (roi_align.py:166-168, 236, 246):
// the weights Ry, Rx rounded to bf16 (each row's or column's weight summed
// over the bin's samples and divided by s in float32 first; a row's hat
// taken at the sample's clamped position plus the level's first row in the
// row-stacked pyramid, against the row's index there, as roi_align.py:
// 154-168 computes it); t = Ry F, the y-contraction, summed in
// float32 and rounded to bf16; out = t Rx^T summed in float32 and rounded
// to bf16. A gather that kept t in float32 would differ from JAX by about a
// bf16 ulp, so the rounding of t is kept. Design (correct first, not yet
// fast): a block pools one ROI over a group of channels; its first warps
// set up each bin's rows and columns (at most 2 s each, ascending) with
// their bf16 weights in shared memory, and each thread computes whole
// outputs (c, ph, pw): for each of the bin's columns the y-contraction over
// the bin's rows, rounded to bf16, then the x-contraction, reading the
// features straight from device memory (2 s x 2 s loads an output, most of
// them from L1 and L2: neighbouring outputs share rows and columns). Every
// product of two bf16 values is exact in float32, so only the order of the
// sums (ascending rows and columns here) can part it from the plain version.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxSamples = 64;          // r * s per axis
constexpr int kMaxRatio = 4;             // sampling ratios 1..4
constexpr int kMinThreads = 64;          // warps 0 and 1 set up the axes
constexpr int kMaxThreads = 256;
constexpr int kSmemLimit = 232448;       // bytes a block may use on sm_90
constexpr int kSmemReserve = 4096;       // room for the static shared memory

struct Pyramid {
  const float* feat[kMaxLevels];         // (C, h, w) planes, one image
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int levels;
};

struct Sample {
  int i0, i1;                            // clamped texel lines; -1 outside
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

// One axis of a ROI: the texel lines (rows or columns) staged, and each
// sample's two slots among them and weights.
struct Axis {
  int line[2 * kMaxSamples];
  int slot0[kMaxSamples], slot1[kMaxSamples];
  float w0[kMaxSamples], w1[kMaxSamples];
  int count;                             // lines staged
};

// Run by one whole warp: the n = r s samples of [lo, hi] on an axis of
// `size` texels, staged in at most `cap` lines. A sample outside the level
// points at slot 0 with weight 0.
__device__ void setup_axis(float lo, float hi, int size, int r, int s,
                           int cap, Axis& ax) {
  const int lane = threadIdx.x & 31;
  const int n = r * s;
  Sample q[2];
  int first = INT_MAX, last = -1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = lane + 32 * h;
    q[h] = k < n ? axis_sample(lo, hi, size, r, s, k)
                 : Sample{-1, -1, 0.f, 0.f};
    if (q[h].i0 >= 0) {
      first = min(first, q[h].i0);
      last = max(last, q[h].i1);
    }
  }
  first = __reduce_min_sync(0xffffffffu, first);
  last = __reduce_max_sync(0xffffffffu, last);
  if (last < 0) first = last = 0;        // no sample inside: one line
  const int span = last - first + 1;
  const bool window = span <= cap;       // else cap == 2 n
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = lane + 32 * h;
    if (k >= n) continue;
    const bool in = q[h].i0 >= 0;
    if (window) {
      ax.slot0[k] = in ? q[h].i0 - first : 0;
      ax.slot1[k] = in ? q[h].i1 - first : 0;
    } else {
      ax.slot0[k] = 2 * k;
      ax.slot1[k] = 2 * k + 1;
      ax.line[2 * k] = in ? q[h].i0 : 0;
      ax.line[2 * k + 1] = in ? q[h].i1 : 0;
    }
    ax.w0[k] = q[h].w0;
    ax.w1[k] = q[h].w1;
  }
  if (window)
    for (int j = lane; j < span; j += 32) ax.line[j] = first + j;
  if (lane == 0) ax.count = window ? span : 2 * n;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// The x-interpolation of staged row t at one output column: its kS samples'
// two texels (slots xa, xb) with their weights
template <int kS>
__device__ __forceinline__ float x_interp(const float* t, const int (&xa)[kS],
                                          const int (&xb)[kS],
                                          const float (&wa)[kS],
                                          const float (&wb)[kS]) {
  float v = 0.f;
#pragma unroll
  for (int ix = 0; ix < kS; ++ix)
    v += fmaf(wb[ix], t[xb[ix]], wa[ix] * t[xa[ix]]);
  return v;
}

// Copies the grids of channels [c0, c0 + n) of the level's planes `feat`
// into grid (one plane of nr x nc floats a channel) by cp.async: a warp
// copies `per` staged rows at a time, `seg` lanes a row, the row's texels
// one a lane.
__device__ __forceinline__ void stage_chunk(const float* feat, size_t chan,
                                           int W, const Axis& ys,
                                           const Axis& xs, int c0, int n,
                                           float* grid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nr = ys.count, nc = xs.count;
  int seg = 32;
  while (seg > 1 && seg / 2 >= nc) seg >>= 1;
  const int per = 32 / seg;
  const int j0 = lane % seg;
  for (int line = warp * per + lane / seg; line < n * nr;
       line += nwarps * per) {
    const int c = line / nr, rs = line - c * nr;
    const float* src = feat + (c0 + c) * chan + (size_t)ys.line[rs] * W;
    float* dst = grid + (c * nr + rs) * nc;
    for (int j = j0; j < nc; j += seg) cp_async4(dst + j, src + xs.line[j]);
  }
}

// kS: the sampling ratio s
template <int kS>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_kernel(Pyramid pyr, const float* __restrict__ rois,
                 const int* __restrict__ levels, float* __restrict__ out,
                 int C, int r, int group, int rows_cap, int cols_cap,
                 int half) {
  extern __shared__ float sm[];  // two buffers of `half` floats: a chunk's
                                 // grids, then its r x r bins a channel
  __shared__ Axis ys, xs;
  const int roi = blockIdx.y;
  const int c0 = blockIdx.x * group;
  const int ng = min(group, C - c0);
  const int lv = min(max(levels[roi], 0), pyr.levels - 1);
  // constant indices into the parameter arrays keep them out of local memory
  const float* feat = lv == 0 ? pyr.feat[0] : lv == 1 ? pyr.feat[1]
                    : lv == 2 ? pyr.feat[2] : pyr.feat[3];
  const int H = lv == 0 ? pyr.h[0] : lv == 1 ? pyr.h[1]
              : lv == 2 ? pyr.h[2] : pyr.h[3];
  const int W = lv == 0 ? pyr.w[0] : lv == 1 ? pyr.w[1]
              : lv == 2 ? pyr.w[2] : pyr.w[3];
  const float scale = lv == 0 ? pyr.scale[0] : lv == 1 ? pyr.scale[1]
                    : lv == 2 ? pyr.scale[2] : pyr.scale[3];
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5;
  const float* b = rois + 4 * (size_t)roi;
  if (warp == 0)
    setup_axis(__fmul_rn(b[1], scale), __fmul_rn(b[3], scale), H, r, kS,
               rows_cap, ys);
  else if (warp == 1)
    setup_axis(__fmul_rn(b[0], scale), __fmul_rn(b[2], scale), W, r, kS,
               cols_cap, xs);
  __syncthreads();

  const int nc = xs.count, plane = ys.count * nc, rr = r * r;
  const int chunk = min(ng, half / (plane + rr));  // >= 1: the plan's check
  const int nchunks = (ng + chunk - 1) / chunk;
  const size_t chan = (size_t)H * W;
  feat += (size_t)c0 * chan;
  float* dst = out + ((size_t)roi * C + c0) * rr;

  stage_chunk(feat, chan, W, ys, xs, 0, chunk, sm);
  for (int k = 0; k < nchunks; ++k) {
    // chunk k has landed, and every thread is done with chunk k - 1's
    // buffer, which chunk k + 1 takes
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int cb = k * chunk, n = min(chunk, ng - cb);
    if (k + 1 < nchunks)
      stage_chunk(feat, chan, W, ys, xs, cb + chunk,
                  min(chunk, ng - cb - chunk), sm + ((k + 1) & 1) * half);
    const float* grid = sm + (k & 1) * half;
    float* res = sm + (k & 1) * half + n * plane;

    // the bins, column by column
    for (int item = tid; item < n * r; item += nthr) {
      const int c = item / r, pw = item - c * r;
      int xa[kS], xb[kS];
      float wa[kS], wb[kS];
#pragma unroll
      for (int ix = 0; ix < kS; ++ix) {
        const int q = pw * kS + ix;
        xa[ix] = xs.slot0[q];
        xb[ix] = xs.slot1[q];
        wa[ix] = xs.w0[q];
        wb[ix] = xs.w1[q];
      }
      const float* g = grid + c * plane;
      float* o = res + c * rr + pw;
      int prev = -1;  // the last row x-interpolated, and its value
      float prev_v = 0.f;
      for (int ph = 0; ph < r; ++ph) {
        float acc = 0.f;
#pragma unroll
        for (int iy = 0; iy < kS; ++iy) {
          const int q = ph * kS + iy;
          const int y0 = ys.slot0[q], y1 = ys.slot1[q];
          const float v0 =
              y0 == prev ? prev_v : x_interp(g + y0 * nc, xa, xb, wa, wb);
          const float v1 =
              y1 == y0 ? v0 : x_interp(g + y1 * nc, xa, xb, wa, wb);
          prev = y1;
          prev_v = v1;
          acc = fmaf(ys.w0[q], v0, acc);
          acc = fmaf(ys.w1[q], v1, acc);
        }
        o[ph * r] = acc;
      }
    }
    __syncthreads();
    // the chunk's outputs, contiguous in (R, C, r, r)
    for (int e = tid; e < n * rr; e += nthr) __stcs(dst + cb * rr + e, res[e]);
  }
}

// ---------------------------------------------------------------------------
// the bf16 build
// ---------------------------------------------------------------------------

constexpr int kBinTaps = 2 * kMaxRatio;  // lines a bin's samples weight

struct BinAxis {
  int line[kMaxSamples][kBinTaps];  // a bin's texel lines, ascending
  float w[kMaxSamples][kBinTaps];   // their weights, rounded to bf16
  int n[kMaxSamples];
};

// Bin p of an axis of `size` texels: the lines its s samples weight and the
// plain version's weight of each,
//   bf16(sum_i max(0, 1 - |(c_i + off) - (line + off)|) / s)
// over the samples i inside [-1, size - 1] (c_i clamped to [0, size - 1];
// off: the level's first row in the stacked pyramid, 0 for columns).
__device__ void setup_bin(float lo, float hi, int size, int off, int r,
                          int s, int p, BinAxis& ax) {
  const float bin = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1.f), (float)r);
  const float top = (float)(size - 1);
  float c[kMaxRatio];
  bool in[kMaxRatio];
  int cand[kBinTaps];
  int n = 0;
  for (int i = 0; i < s; ++i) {
    const float frac = __fdiv_rn(__fadd_rn((float)i, 0.5f), (float)s);
    const float pos =
        __fadd_rn(lo, __fmul_rn(__fadd_rn((float)p, frac), bin));
    in[i] = pos >= -1.f && pos <= top;  // false for NaN too
    c[i] = fminf(fmaxf(pos, 0.f), top);
    if (!in[i]) continue;
    const int h0 = (int)floorf(c[i]);
    for (int h = h0; h <= min(h0 + 1, size - 1); ++h) {
      bool seen = false;
      for (int j = 0; j < n; ++j) seen |= cand[j] == h;
      if (!seen) cand[n++] = h;
    }
  }
  for (int a = 1; a < n; ++a)  // ascending
    for (int j = a; j > 0 && cand[j - 1] > cand[j]; --j) {
      const int t = cand[j];
      cand[j] = cand[j - 1];
      cand[j - 1] = t;
    }
  for (int j = 0; j < n; ++j) {
    float sum = 0.f;
    for (int i = 0; i < s; ++i) {
      const float d =
          __fsub_rn(__fadd_rn(c[i], (float)off), (float)(cand[j] + off));
      const float hat = fmaxf(__fsub_rn(1.f, fabsf(d)), 0.f);
      sum = __fadd_rn(sum, in[i] ? hat : 0.f);
    }
    ax.line[p][j] = cand[j];
    ax.w[p][j] =
        __bfloat162float(__float2bfloat16_rn(__fdiv_rn(sum, (float)s)));
  }
  ax.n[p] = n;
}

struct PyramidBf16 {
  const __nv_bfloat16* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int row0[kMaxLevels];  // the level's first row in the stacked pyramid
  float scale[kMaxLevels];
  int levels;
};

__global__ void __launch_bounds__(kMaxThreads)
roi_align_bf16_kernel(PyramidBf16 pyr, const float* __restrict__ rois,
                      const int* __restrict__ levels,
                      __nv_bfloat16* __restrict__ out, int C, int r, int s,
                      int group) {
  __shared__ BinAxis ys, xs;
  const int roi = blockIdx.y;
  const int c0 = blockIdx.x * group;
  const int ng = min(group, C - c0);
  const int lv = min(max(levels[roi], 0), pyr.levels - 1);
  const __nv_bfloat16* feat = lv == 0 ? pyr.feat[0] : lv == 1 ? pyr.feat[1]
                            : lv == 2 ? pyr.feat[2] : pyr.feat[3];
  const int H = lv == 0 ? pyr.h[0] : lv == 1 ? pyr.h[1]
              : lv == 2 ? pyr.h[2] : pyr.h[3];
  const int W = lv == 0 ? pyr.w[0] : lv == 1 ? pyr.w[1]
              : lv == 2 ? pyr.w[2] : pyr.w[3];
  const float scale = lv == 0 ? pyr.scale[0] : lv == 1 ? pyr.scale[1]
                    : lv == 2 ? pyr.scale[2] : pyr.scale[3];
  const int row0 = lv == 0 ? pyr.row0[0] : lv == 1 ? pyr.row0[1]
                 : lv == 2 ? pyr.row0[2] : pyr.row0[3];
  const float* b = rois + 4 * (size_t)roi;
  const int tid = threadIdx.x;
  if (tid < r)
    setup_bin(__fmul_rn(b[1], scale), __fmul_rn(b[3], scale), H, row0, r, s,
              tid, ys);
  else if (tid < 2 * r)
    setup_bin(__fmul_rn(b[0], scale), __fmul_rn(b[2], scale), W, 0, r, s,
              tid - r, xs);
  __syncthreads();

  const int rr = r * r;
  const size_t chan = (size_t)H * W;
  __nv_bfloat16* dst = out + ((size_t)roi * C + c0) * rr;
  for (int e = tid; e < ng * rr; e += blockDim.x) {
    const int c = e / rr, pq = e - c * rr;
    const int p = pq / r, q = pq - p * r;
    const __nv_bfloat16* f = feat + (size_t)(c0 + c) * chan;
    float acc = 0.f;
    for (int j = 0; j < xs.n[q]; ++j) {
      const int x = xs.line[q][j];
      float t = 0.f;  // Ry F at (ph, x), rounded to bf16
      for (int i = 0; i < ys.n[p]; ++i)
        t = fmaf(ys.w[p][i],
                 __bfloat162float(f[(size_t)ys.line[p][i] * W + x]), t);
      acc = fmaf(xs.w[q][j], __bfloat162float(__float2bfloat16_rn(t)), acc);
    }
    dst[e] = __float2bfloat16_rn(acc);
  }
}

}  // namespace

// The bf16 build: blocks of `threads` threads pooling one ROI over `group`
// channels, no dynamic shared memory. feats: the L levels' bf16 planes;
// rois float32; out (R, C, r, r) bf16. Refuses (cudaErrorInvalidValue)
// arguments it cannot run; otherwise returns the CUDA error of the launch.
extern "C" int roi_align_bf16_launch(const void* const* feats, const int* hs,
                                     const int* ws, const float* scales,
                                     int L, const float* rois,
                                     const int* levels, void* out, int R,
                                     int C, int r, int s, int group,
                                     int threads, void* stream) {
  if (L < 1 || L > kMaxLevels || R < 1 || R > 65535 || C < 1 || r < 1 ||
      s < 1 || s > kMaxRatio || r * s > kMaxSamples || 2 * r > threads ||
      group < 1 || group > C || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || (long long)C * r * r > INT_MAX)
    return (int)cudaErrorInvalidValue;
  PyramidBf16 pyr{};
  pyr.levels = L;
  long long row = 0;
  for (int l = 0; l < L; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return (int)cudaErrorInvalidValue;
    pyr.feat[l] = static_cast<const __nv_bfloat16*>(feats[l]);
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    pyr.row0[l] = (int)row;
    pyr.scale[l] = scales[l];
    row += hs[l];
  }
  if (row > (1 << 24)) return (int)cudaErrorInvalidValue;  // exact floats
  const dim3 grid((unsigned)((C + group - 1) / group), R);
  roi_align_bf16_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      pyr, rois, levels, static_cast<__nv_bfloat16*>(out), C, r, s, group);
  return (int)cudaGetLastError();
}

// Launches on `stream` with the wrapper's plan: blocks of `threads` threads
// pooling one ROI over `group` channels with `smem_bytes` of dynamic shared
// memory, two buffers that must each hold one channel's largest grid and
// bins (rows_cap x cols_cap + r x r floats, a cap being min(2 r s, the
// largest level's height or width)). Refuses (cudaErrorInvalidValue) a plan
// or arguments it cannot run; otherwise returns the CUDA error of the
// launch. feats, hs, ws, scales: host arrays of the L levels' device
// pointers, heights, widths and spatial scales.
extern "C" int roi_align_launch(const void* const* feats, const int* hs,
                                const int* ws, const float* scales, int L,
                                const float* rois, const int* levels,
                                float* out, int R, int C, int r, int s,
                                int group, int threads, int smem_bytes,
                                void* stream) {
  if (L < 1 || L > kMaxLevels || R < 1 || R > 65535 || C < 1 || r < 1 ||
      s < 1 || s > kMaxRatio || r * s > kMaxSamples)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr{};
  pyr.levels = L;
  int max_h = 0, max_w = 0;
  for (int l = 0; l < L; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return (int)cudaErrorInvalidValue;
    pyr.feat[l] = static_cast<const float*>(feats[l]);
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    pyr.scale[l] = scales[l];
    max_h = hs[l] > max_h ? hs[l] : max_h;
    max_w = ws[l] > max_w ? ws[l] : max_w;
  }
  const int rows_cap = 2 * r * s < max_h ? 2 * r * s : max_h;
  const int cols_cap = 2 * r * s < max_w ? 2 * r * s : max_w;
  const int half = smem_bytes / 8;
  const bool plan_ok = group >= 1 && group <= C && threads >= kMinThreads &&
                       threads <= kMaxThreads && threads % 32 == 0 &&
                       smem_bytes % 8 == 0 &&
                       half >= rows_cap * cols_cap + r * r &&
                       smem_bytes + kSmemReserve <= kSmemLimit &&
                       (long long)C * r * r <= INT_MAX;
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  void (*kernel)(Pyramid, const float*, const int*, float*, int, int, int,
                 int, int, int) =
      s == 1 ? roi_align_kernel<1>
      : s == 2 ? roi_align_kernel<2>
      : s == 3 ? roi_align_kernel<3>
               : roi_align_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + group - 1) / group), R);
  kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      pyr, rois, levels, out, C, r, group, rows_cap, cols_cap, half);
  return (int)cudaGetLastError();
}
