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
// bf16 ulp, so the rounding of t is kept. What bounds it: bytes, half of
// the float32 build's, most of them the output (35 of the 38.9 MB of the
// bf16 DCN detector's two heads at 1088 x 800). Design, the float32
// build's staging on bf16 texels:
// 1. Setup once a block: warp 0 takes the rows, warp 1 the columns, a lane
//    a bin: each bin's lines (at most 2 s, ascending) and their bf16
//    weights, and the lines to stage (the window between the ROI's first
//    and last line where it spans at most min(2 r s, the level's size),
//    else each bin's lines in 2 s slots a bin), each bin-line as a slot
//    among them.
// 2. The channels in chunks through two buffers of shared memory filled by
//    cp.async, as the float32 build does, the texels kept in bf16 (a
//    buffer holds twice the float32 build's channels) and widened at use.
//    A row of a window is one run of bf16 texels: it is copied in 16-byte
//    pieces aligned in both address spaces, starting (address / 2) % 8
//    texels into its row of shared memory (the levels' rows start on any
//    texel: P5 is 25 wide); the columns themselves are copied a 4-byte word
//    each, the texel in the word's half that its address gives. A piece
//    that would reach outside its channel's plane is copied texel by
//    texel.
// 3. t in shared memory: a thread takes a bin row (c, p), its lines and
//    weights in registers, and forms t(c, p, x) for every staged column x
//    (split over up to 8 threads a row when a large ROI's chunk has fewer
//    rows than threads): the y-contraction over bin p's rows in ascending
//    order from 0 by fmaf, rounded to bf16; each t is formed once. Then
//    each output (c, p, q) is the x-contraction of t over bin q's columns
//    in ascending order by fmaf, rounded to bf16, into shared memory.
// 4. The chunk's outputs, one contiguous run of (R, C, r, r), go out as
//    16-byte streaming stores (8 bf16) from the run's first 16-byte
//    boundary, with single stores before and after it.
// Each output is written once, by one thread, in a fixed order: no atomics.
// No tensor cores: a bin weights at most 2 s lines an axis, so a dense
// product would multiply mostly zeros, and the rounding of t depends on
// the order of its float32 sums. Every product of two bf16 values is exact
// in float32, and the sums run in the plain version's row and column
// order, so only the plain version's own summation order (a matrix
// product's) can part the two.

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
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

// One axis of a ROI in the bf16 build: the texel lines staged, and each
// bin's lines (at most 2 s, ascending) as slots among them with their
// weights rounded to bf16.
struct BinAxis {
  int line[2 * kMaxSamples];   // the staged lines
  int slot[2 * kMaxSamples];   // bin p's j-th line: slot[p * 2 s + j]
  float w[2 * kMaxSamples];    // and its weight
  int n[kMaxSamples];          // the lines of bin p
  int count;                   // lines staged
  int first;                   // a window's first line
  int window;                  // 1: the window [first, first + count)
};

// Run by one whole warp, a lane a bin: the r bins of [lo, hi] on an axis of
// `size` texels. Bin p weights the lines that its in-range samples' two
// texels cover, each with the plain version's weight
//   bf16(sum_i max(0, 1 - |(c_i + off) - (line + off)|) / s)
// over the samples i inside [-1, size - 1] (c_i clamped to [0, size - 1];
// off: the level's first row in the stacked pyramid, 0 for columns). The
// lines staged are the window between the first and the last line of all
// bins where it spans at most min(2 r s, size) lines, else each bin's own
// lines in 2 s slots a bin (a large or elongated ROI, whose bins lie apart).
template <int kS>
__device__ void setup_bins(float lo, float hi, int size, int off, int r,
                           BinAxis& ax) {
  constexpr int kTaps = 2 * kS;
  const int lane = threadIdx.x & 31;
  const float bin = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1.f), (float)r);
  const float top = (float)(size - 1);
  int first = INT_MAX, last = -1;
  for (int p = lane; p < r; p += 32) {
    float c[kS];
    bool in[kS];
    int cand[kTaps];
    int n = 0;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const float frac = __fdiv_rn(__fadd_rn((float)i, 0.5f), (float)kS);
      const float pos =
          __fadd_rn(lo, __fmul_rn(__fadd_rn((float)p, frac), bin));
      in[i] = pos >= -1.f && pos <= top;  // false for NaN too
      c[i] = fminf(fmaxf(pos, 0.f), top);
      if (!in[i]) continue;
      // the samples' positions ascend with i, so their lines come in
      // ascending order and a line repeats only the last one
      const int h0 = (int)floorf(c[i]);
      if (n == 0 || h0 > cand[n - 1]) cand[n++] = h0;
      if (h0 + 1 <= size - 1 && h0 + 1 > cand[n - 1]) cand[n++] = h0 + 1;
    }
    for (int j = 0; j < n; ++j) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const float d =
            __fsub_rn(__fadd_rn(c[i], (float)off), (float)(cand[j] + off));
        const float hat = fmaxf(__fsub_rn(1.f, fabsf(d)), 0.f);
        sum = __fadd_rn(sum, in[i] ? hat : 0.f);
      }
      ax.slot[p * kTaps + j] = cand[j];  // the line, made a slot below
      ax.w[p * kTaps + j] =
          __bfloat162float(__float2bfloat16_rn(__fdiv_rn(sum, (float)kS)));
    }
    ax.n[p] = n;
    if (n > 0) {
      first = min(first, cand[0]);
      last = max(last, cand[n - 1]);
    }
  }
  first = __reduce_min_sync(0xffffffffu, first);
  last = __reduce_max_sync(0xffffffffu, last);
  if (last < 0) first = last = 0;  // no sample inside: one line
  const int span = last - first + 1;
  const bool window = span <= min(2 * r * kS, size);
  for (int p = lane; p < r; p += 32)
    for (int j = 0; j < kTaps; ++j) {
      const int k = p * kTaps + j;
      if (window) {
        if (j < ax.n[p]) ax.slot[k] -= first;
      } else {
        ax.line[k] = j < ax.n[p] ? ax.slot[k] : 0;
        ax.slot[k] = k;
      }
    }
  if (window)
    for (int j = lane; j < span; j += 32) ax.line[j] = first + j;
  if (lane == 0) {
    ax.count = window ? span : r * kTaps;
    ax.first = first;
    ax.window = window;
  }
}

// blocks of kMaxThreads an SM must fit by registers (64 a thread): the
// bf16 build's phases are short and wait on shared memory, so it needs
// many warps resident
constexpr int kBf16MinBlocks = 4;

static_assert(2 * sizeof(BinAxis) <= kSmemReserve,
              "the bf16 build's static shared memory exceeds the reserve");

struct PyramidBf16 {
  const __nv_bfloat16* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int row0[kMaxLevels];  // the level's first row in the stacked pyramid
  float scale[kMaxLevels];
  int levels;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// floor(a / d) for 0 <= a, d < 2^16 as one multiply-high by
// div16_magic(d) = floor((2^32 - 1) / d) + 1 (exact there: a d < 2^32);
// for d = 1 that wraps to 0, which stands for a / 1
__device__ __forceinline__ unsigned div16_magic(int d) {
  return 0xffffffffu / (unsigned)d + 1u;
}

__device__ __forceinline__ int div16(int a, unsigned magic) {
  return magic ? (int)__umulhi((unsigned)a, magic) : a;
}

// A staged row of the bf16 build in shared memory, `pitch` texels (a
// multiple of 8) from a 16-byte boundary. With a window of columns: the
// row's run of nc texels, copied in 16-byte pieces aligned in both address
// spaces, so the run starts at element (address / 2) % 8 of the row. With
// the columns themselves: one 4-byte word a column, the texel in the word's
// half that its address gives. `base`: the level's address / 2; all
// element offsets below are from the level's first texel.
//
// Stages the grids of channels [c0, c0 + n) of the level `feat` (planes of
// `chan` texels, rows of W) into `grid`, one staged row after another, by
// cp.async. A piece that would reach outside its channel's plane (the
// first or last texels of a plane whose address is not aligned) is copied
// texel by texel instead, so nothing outside the plane is read.
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* feat,
                                           unsigned base, long long chan,
                                           int W, const BinAxis& ys,
                                           const BinAxis& xs, int c0, int n,
                                           int pitch, __nv_bfloat16* grid) {
  const int nr = ys.count, nc = xs.count;
  const unsigned by_nr = div16_magic(nr);
  if (xs.window) {
    const int pieces = pitch / 8;
    const unsigned by_pieces = div16_magic(pieces);
    for (int u = threadIdx.x; u < n * nr * pieces; u += blockDim.x) {
      const int row = div16(u, by_pieces), k = u - row * pieces;
      const int c = div16(row, by_nr), rs = row - c * nr;
      const long long lo = (long long)(c0 + c) * chan;
      const long long run = lo + (long long)ys.line[rs] * W + xs.first;
      const int o = (int)((base + (unsigned)run) & 7u);
      if (8 * k >= o + nc) continue;
      const long long e0 = run - o + 8 * k;
      __nv_bfloat16* dst = grid + row * pitch + 8 * k;
      if (e0 >= lo && e0 + 8 <= lo + chan) {
        cp_async16(dst, feat + e0);
      } else {
        for (int j = 0; j < 8; ++j)
          if (e0 + j >= lo && e0 + j < lo + chan) dst[j] = feat[e0 + j];
      }
    }
  } else {
    const unsigned by_nc = div16_magic(nc);
    for (int u = threadIdx.x; u < n * nr * nc; u += blockDim.x) {
      const int row = div16(u, by_nc), x = u - row * nc;
      const int c = div16(row, by_nr), rs = row - c * nr;
      const long long lo = (long long)(c0 + c) * chan;
      const long long e = lo + (long long)ys.line[rs] * W + xs.line[x];
      const int o = (int)((base + (unsigned)e) & 1u);
      __nv_bfloat16* dst = grid + row * pitch + 2 * x;
      if (e - o >= lo && e - o + 2 <= lo + chan)
        cp_async4(dst, feat + (e - o));
      else
        dst[o] = feat[e];
    }
  }
}

// kS: the sampling ratio s
template <int kS>
__global__ void __launch_bounds__(kMaxThreads, kBf16MinBlocks)
roi_align_bf16_kernel(PyramidBf16 pyr, const float* __restrict__ rois,
                      const int* __restrict__ levels,
                      __nv_bfloat16* __restrict__ out, int C, int r,
                      int group, int half) {
  // two buffers of `half` bytes: a chunk's staged grids, its t and its bins
  extern __shared__ __align__(16) unsigned char sm_bf16[];
  __shared__ BinAxis ys, xs;
  constexpr int kTaps = 2 * kS;
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
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5;
  if (warp == 0)
    setup_bins<kS>(__fmul_rn(b[1], scale), __fmul_rn(b[3], scale), H, row0,
                   r, ys);
  else if (warp == 1)
    setup_bins<kS>(__fmul_rn(b[0], scale), __fmul_rn(b[2], scale), W, 0, r,
                   xs);
  __syncthreads();

  const int nr = ys.count, nc = xs.count, rr = r * r;
  const bool xwin = xs.window;
  const int pitch = xwin ? (nc + 14) & ~7 : (2 * nc + 7) & ~7;
  // t's rows hold an odd number of floats: 32 rows fall in 32 banks
  const int tpitch = nc | 1;
  const int per = 2 * (nr * pitch + rr) + 4 * r * tpitch;  // bytes a channel
  const int chunk = min(ng, (half - 32) / per);  // >= 1: the plan's check
  const int nchunks = (ng + chunk - 1) / chunk;
  const long long chan = (long long)H * W;
  const unsigned base =
      (unsigned)(reinterpret_cast<uintptr_t>(feat) >> 1);
  // a thread that forms a whole row of t starts it at its own column, so
  // that a warp's reads of 32 rows spread over the banks
  const int skew = (2 * (tid & 31)) % nc;
  // the bins: thread tid computes bin column q = tid % r of the bin rows
  // tid / r + k (nthr / r)
  const int oq = tid % r, orow = tid / r, ostep = nthr / r;
  __nv_bfloat16* dst = out + ((size_t)roi * C + c0) * rr;

  stage_bf16(feat, base, chan, W, ys, xs, c0, chunk, pitch,
             reinterpret_cast<__nv_bfloat16*>(sm_bf16));
  for (int k = 0; k < nchunks; ++k) {
    // chunk k has landed, and every thread is done with chunk k - 1's
    // buffer, which chunk k + 1 takes
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int cb = k * chunk, n = min(chunk, ng - cb);
    if (k + 1 < nchunks)
      stage_bf16(feat, base, chan, W, ys, xs, c0 + cb + chunk,
                 min(chunk, ng - cb - chunk), pitch,
                 reinterpret_cast<__nv_bfloat16*>(sm_bf16 +
                                                  ((k + 1) & 1) * half));
    unsigned char* buf = sm_bf16 + (k & 1) * half;
    const __nv_bfloat16* grid = reinterpret_cast<const __nv_bfloat16*>(buf);
    float* t = reinterpret_cast<float*>(buf + 2 * n * nr * pitch);
    __nv_bfloat16* chunk_dst = dst + (size_t)cb * rr;
    const int shift =
        (int)((reinterpret_cast<uintptr_t>(chunk_dst) >> 1) & 7u);
    __nv_bfloat16* res = reinterpret_cast<__nv_bfloat16*>(
        buf + ((2 * n * nr * pitch + 4 * n * r * tpitch + 15) & ~15)) + shift;

    // t = Ry F at (c, p, x) for every staged column x: the y-contraction
    // over bin p's rows in ascending order, rounded to bf16. A bin row
    // (c, p) takes `split` threads (up to 8 when a large ROI's chunk has
    // fewer rows than threads), each every split-th column; a thread keeps
    // its p (the rows, their weights and offsets in registers) over the
    // chunk's channels.
    int lg = 0;
    while (lg < 3 && (n * r << (lg + 1)) <= nthr) ++lg;
    const int split = 1 << lg, sk = lg == 0 ? skew : 0;
    const int per_c = r << lg, cstep = nthr / per_c;
    const int tc = tid / per_c, p = (tid - tc * per_c) >> lg,
              part = tid & (split - 1);
    if (tc < cstep) {
      const int ny = ys.n[p];
      int rowoff[kTaps];
      unsigned lineoff[kTaps];
      float wy[kTaps];
#pragma unroll
      for (int i = 0; i < kTaps; ++i) {
        const int rs = i < ny ? ys.slot[p * kTaps + i] : 0;
        rowoff[i] = rs * pitch;
        lineoff[i] = (unsigned)ys.line[rs] * (unsigned)W +
                     (xwin ? (unsigned)xs.first : 0u);
        wy[i] = i < ny ? ys.w[p * kTaps + i] : 0.f;
      }
      for (int c = tc; c < n; c += cstep) {
        const unsigned plane = base + (unsigned)(c0 + cb + c) * (unsigned)chan;
        const __nv_bfloat16* g = grid + c * nr * pitch;
        float* tr = t + (c * r + p) * tpitch;
        if (xwin) {
          int at[kTaps];
#pragma unroll
          for (int i = 0; i < kTaps; ++i)
            at[i] = rowoff[i] + (int)((plane + lineoff[i]) & 7u);
          for (int j = part; j < nc; j += split) {
            const int x = j + sk < nc ? j + sk : j + sk - nc;
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < kTaps; ++i)
              if (i < ny)
                acc = fmaf(wy[i], __bfloat162float(g[at[i] + x]), acc);
            tr[x] = __bfloat162float(__float2bfloat16_rn(acc));
          }
        } else {  // a word a column, the texel in the half of its parity
          int par[kTaps];
#pragma unroll
          for (int i = 0; i < kTaps; ++i)
            par[i] = (int)((plane + lineoff[i]) & 1u);
          for (int j = part; j < nc; j += split) {
            const int x = j + sk < nc ? j + sk : j + sk - nc;
            const int xp = xs.line[x] & 1;
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < kTaps; ++i)
              if (i < ny)
                acc = fmaf(wy[i],
                           __bfloat162float(
                               g[rowoff[i] + 2 * x + (par[i] ^ xp)]),
                           acc);
            tr[x] = __bfloat162float(__float2bfloat16_rn(acc));
          }
        }
      }
    }
    __syncthreads();
    // the bins: the x-contraction of t over bin q's columns in ascending
    // order, rounded to bf16, the columns' slots and weights in registers
    const int onx = orow < ostep ? xs.n[oq] : 0;
    int oslot[kTaps];
    float ow[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      oslot[j] = j < onx ? xs.slot[oq * kTaps + j] : 0;
      ow[j] = j < onx ? xs.w[oq * kTaps + j] : 0.f;
    }
    for (int row = orow < ostep ? orow : n * r; row < n * r; row += ostep) {
      const float* tr = t + row * tpitch;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kTaps; ++j)
        if (j < onx) acc = fmaf(ow[j], tr[oslot[j]], acc);
      res[row * r + oq] = __float2bfloat16_rn(acc);
    }
    __syncthreads();
    // the chunk's outputs, contiguous in (R, C, r, r): 16-byte streaming
    // stores from the first 16-byte boundary, single texels before and after
    const int total = n * rr;
    const int head = min(total, (8 - shift) & 7);
    const int vecs = (total - head) >> 3;
    for (int u = tid; u < vecs; u += nthr)
      __stcs(reinterpret_cast<int4*>(chunk_dst + head) + u,
             reinterpret_cast<const int4*>(res + head)[u]);
    for (int u = tid; u < total - 8 * vecs; u += nthr) {
      const int e = u < head ? u : u + 8 * vecs;
      chunk_dst[e] = res[e];
    }
  }
}

}  // namespace

// The bf16 build, launched on `stream` with the wrapper's plan: blocks of
// `threads` threads pooling one ROI over `group` channels with `smem_bytes`
// of dynamic shared memory, two buffers that must each hold one channel's
// largest staged grid, its t and its bins (bf16_channel_bytes). feats: the
// L levels' bf16 planes; rois float32; out (R, C, r, r) bf16. Refuses
// (cudaErrorInvalidValue) a plan or arguments it cannot run; otherwise
// returns the CUDA error of the launch.
extern "C" int roi_align_bf16_launch(const void* const* feats, const int* hs,
                                     const int* ws, const float* scales,
                                     int L, const float* rois,
                                     const int* levels, void* out, int R,
                                     int C, int r, int s, int group,
                                     int threads, int smem_bytes,
                                     void* stream) {
  if (L < 1 || L > kMaxLevels || R < 1 || R > 65535 || C < 1 || r < 1 ||
      s < 1 || s > kMaxRatio || r * s > kMaxSamples ||
      (long long)C * r * r > INT_MAX)
    return (int)cudaErrorInvalidValue;
  PyramidBf16 pyr{};
  pyr.levels = L;
  long long row = 0;
  int max_h = 0, max_w = 0;
  for (int l = 0; l < L; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return (int)cudaErrorInvalidValue;
    pyr.feat[l] = static_cast<const __nv_bfloat16*>(feats[l]);
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    pyr.row0[l] = (int)row;
    pyr.scale[l] = scales[l];
    row += hs[l];
    max_h = hs[l] > max_h ? hs[l] : max_h;
    max_w = ws[l] > max_w ? ws[l] : max_w;
  }
  if (row > (1 << 24)) return (int)cudaErrorInvalidValue;  // exact floats
  // a channel's largest footprint in a buffer: staged rows x the widest
  // row pitch (a window's texels from an unaligned start, or a word a
  // column where a level is wider than 2 r s) and the bins in bf16, t's
  // rows in float32 (an odd count a row), plus the alignment of the bins
  const int n = r * s;
  const int rows_cap = 2 * n < max_h ? 2 * n : max_h;
  const int cols_cap = 2 * n < max_w ? 2 * n : max_w;
  const int window_pitch = (cols_cap + 14) & ~7;
  const int lines_pitch = max_w > 2 * n ? (4 * n + 7) & ~7 : 0;
  const int pitch = window_pitch > lines_pitch ? window_pitch : lines_pitch;
  const int need =
      2 * (rows_cap * pitch + r * r) + 4 * r * (cols_cap | 1) + 32;
  const int half = smem_bytes / 2;
  const bool plan_ok = group >= 1 && group <= C && threads >= kMinThreads &&
                       threads <= kMaxThreads && threads % 32 == 0 &&
                       smem_bytes % 32 == 0 && half >= need &&
                       smem_bytes + kSmemReserve <= kSmemLimit;
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  void (*kernel)(PyramidBf16, const float*, const int*, __nv_bfloat16*, int,
                 int, int, int) =
      s == 1 ? roi_align_bf16_kernel<1>
      : s == 2 ? roi_align_bf16_kernel<2>
      : s == 3 ? roi_align_bf16_kernel<3>
               : roi_align_bf16_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + group - 1) / group), R);
  kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      pyr, rois, levels, static_cast<__nv_bfloat16*>(out), C, r, group, half);
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
