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
// What bounds it on the card: bytes, at every level. It reads K + 2 floats
// and writes 2 a pixel for ~11 K flops. At the five LiteFlowNet levels of a
// 1280x576 pair: level 2 (k 7, 288 x 640) 39.1 MB, 0.0117 ms at 3.35 TB/s;
// level 3 (5, 144 x 320) 5.3 MB, 1.6 us; levels 4-6 1.3, 0.15, 0.04 MB, under
// half a microsecond each. Level 2 streams dc through the whole card; levels
// 3-6 fit in one wave of blocks, so their time is the latency of one
// block's trips to memory.
//
// Design: one trip to memory a block. A block of 128 threads computes a
// tile of 4 x 32 pixels, a warp a row and a thread one pixel. Each thread
// first issues the loads of its pixel's K logits into registers (a warp's
// load of a tap is one 128-byte line), then the block copies the weights,
// the biases and its haloed u and v ((4 + 2r) x (32 + 8), zeros outside the
// image) into shared memory by cp.async: 16 bytes a copy where W % 4 == 0
// and the flow's base is 16-byte aligned (a 4-float chunk then lies wholly
// inside or outside the image), else 4 bytes (7 % slower at level 2:
// tools/sweep_kernel_plans.py regularize). One wait, one barrier, and
// all of it was in flight at once; the kernel this replaces staged the flow
// tile, met a barrier and only then loaded the logits.
// The 4 x 32 tile was the fastest of 2 x 32 (64 threads), 4 x 32, 8 x 32
// (128 and 256 threads) at level 2 on an H100 and as fast as any at levels
// 3-6 (PERF.md section 6). Staging the logits in shared
// memory instead (cp.async tiles, read twice, level 2 through a ring of 1-4
// stages on a persistent grid) was built and swept: 0.0177-0.0183 ms at
// level 2, slower than the kernel this replaces (0.0155-0.0164).
// The register budget is K + 32 a thread (__launch_bounds__): at k = 7, 80
// registers and 24 warps an SM.
// The arithmetic of a pixel is the plain version's: -dc^2 is rounded before
// the max and the subtraction (__fmul_rn, never contracted into an FMA: with
// peaked logits, |dc^2| ~ 1e3, an FMA would move a near-maximal tap's
// exponent by ~ulp(1e3) = 6e-5), the sums run in tap order t = 0..K-1 with
// terms (wx_t e_t) u, and exp is expf (no fast-math build).
// The grid is one block a tile; the wrapper (ops/regularize.py) picks the
// copy width and the launcher refuses 16-byte copies it cannot make.
//
// The bf16 build (LiteFlowNet with flow_dtype bf16; the Pallas kernel's
// arithmetic on bf16 inputs, regularize.py:37-62): every input and the
// output are bf16, all arithmetic float32 and the float32 build's after
// the loads, so it gives the bits of a build that converts each value as
// it loads it. It moves half the bytes: level 2 of a 1280x576 pair 19.6
// MB, 0.0058 ms at 3.35 TB/s. It keeps the float32 build's one trip to
// memory a block and its one wait and one barrier:
// - the logits go into registers raw (2-byte loads; a warp's load of a
//   tap is 64 bytes), widened where they are used;
// - the haloed u and v tile is staged raw by cp.async, as the 16-byte
//   pieces (8 values) that cover each row from its first element's offset
//   in its first piece (0-7, from the address: any W, storage offset and
//   N). A piece that reaches past the image's left or right edge is copied
//   all the same, and its elements outside the image are zeroed by the
//   thread that copied it once its copies have landed, before the barrier;
//   only a piece that reaches outside the tensor (its first or last
//   element) is loaded element by element, so nothing outside the tensor
//   is read. Each flow value is widened (a 16-bit shift) as it is read
//   from shared memory;
// - the weights and biases (2 K + 2 values, any alignment) by plain loads,
//   one a thread, stored after the flow's copies are issued.
// Two pixels a thread (a 4 x 64 tile of 128 threads, the two logits of a
// tap in one 4-byte load: a warp's load one 128-byte line) was built and
// swept against one: slower at every level on an H100 (PERF.md), not
// kept.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 4;                   // tile rows: a warp each
constexpr int kCols = 32;                  // tile columns: a warp's lanes
constexpr int kThreads = kRows * kCols;    // a thread a pixel
constexpr int kPad = 4;                    // flow columns staged each side
constexpr int kFlowCols = kCols + 2 * kPad;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zeros when `in` is false (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

// 16 bytes from a 16-byte aligned address (the bf16 build's pieces)
__device__ __forceinline__ void cp_async16_raw(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// blocks an SM for at most K + 32 registers a thread
constexpr int min_blocks(int K) { return 65536 / (kThreads * (K + 32)); }

// the float32 build
template <int KS, bool V16>
__global__ void __launch_bounds__(kThreads, min_blocks(KS * KS))
dist_weighted_flow_kernel(const float* __restrict__ dc,
                          const float* __restrict__ flow,
                          const float* __restrict__ wx,
                          const float* __restrict__ bx,
                          const float* __restrict__ wy,
                          const float* __restrict__ by,
                          float* __restrict__ out, int H, int W, int tiles_x,
                          int tiles_per_image) {
  constexpr int K = KS * KS;
  constexpr int R = (KS - 1) / 2;
  constexpr int FR = kRows + 2 * R;          // flow rows staged
  constexpr int FLOW = FR * kFlowCols;
  static_assert(R <= kPad, "the halo fits the staged columns");
  __shared__ __align__(16) float sw[(2 * K + 2 + 3) / 4 * 4];  // wx_0, wy_0,
                                             // ..., bx, by
  __shared__ __align__(16) float su[2 * FLOW];  // u, then v
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x / tiles_per_image;
  const int rem = blockIdx.x - n * tiles_per_image;
  const int y0 = rem / tiles_x * kRows;
  const int x0 = (rem - rem / tiles_x * tiles_x) * kCols;
  const int y = y0 + warp, x = x0 + lane;
  const bool mine = y < H && x < W;
  const size_t plane = (size_t)H * W;

  // the thread's logits, into registers
  float nd[K];
  {
    const float* src = dc + (size_t)n * K * plane +
                       (mine ? (size_t)y * W + x : 0);
#pragma unroll
    for (int t = 0; t < K; ++t) nd[t] = mine ? __ldg(src + t * plane) : 0.f;
  }
  // the weights and the haloed flow tile, by cp.async
  for (int c = tid; c < 2 * K + 2; c += kThreads) {
    const float* src = c < 2 * K ? (c & 1 ? wy : wx) + (c >> 1)
                                 : c == 2 * K ? bx : by;
    cp_async4(sw + c, src, true);
  }
  const float* u = flow + (size_t)n * 2 * plane;
  if (V16) {
    constexpr int kChunks = FR * (kFlowCols / 4);  // a plane's 16-byte chunks
    for (int c = tid; c < 2 * kChunks; c += kThreads) {
      const int pl = c >= kChunks;
      const int e = c - pl * kChunks;
      const int row = e / (kFlowCols / 4), q = e - row * (kFlowCols / 4);
      const int fy = y0 - R + row, fx = x0 - kPad + 4 * q;
      const bool in = fy >= 0 && fy < H && fx >= 0 && fx < W;
      cp_async16(su + pl * FLOW + row * kFlowCols + 4 * q,
                 u + pl * plane + (in ? (size_t)fy * W + fx : 0), in);
    }
  } else {
    for (int c = tid; c < 2 * FLOW; c += kThreads) {
      const int pl = c >= FLOW;
      const int e = c - pl * FLOW;
      const int row = e / kFlowCols, q = e - row * kFlowCols;
      const int fy = y0 - R + row, fx = x0 - kPad + q;
      const bool in = fy >= 0 && fy < H && fx >= 0 && fx < W;
      cp_async4(su + c, u + pl * plane + (in ? (size_t)fy * W + fx : 0), in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (!mine) return;

  const float2* w2 = reinterpret_cast<const float2*>(sw);
  const float* fu = su + warp * kFlowCols + lane + kPad - R;
  const float* fv = fu + FLOW;
  float m = -INFINITY;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    nd[t] = -__fmul_rn(nd[t], nd[t]);
    m = fmaxf(m, nd[t]);
  }
  float sum = 0.f, ax = 0.f, ay = 0.f;
#pragma unroll
  for (int dy = 0; dy < KS; ++dy) {
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      const int t = dy * KS + dx;
      const float2 w = w2[t];
      const float e = expf(nd[t] - m);
      const int f = dy * kFlowCols + dx;
      sum += e;
      ax += w.x * e * fu[f];
      ay += w.y * e * fv[f];
    }
  }
  const float2 b = w2[K];
  const float inv = 1.f / sum;
  float* o = out + (size_t)n * 2 * plane + (size_t)y * W + x;
  *o = (ax + b.x) * inv;
  o[plane] = (ay + b.y) * inv;
}

// a bf16 value (the low 16 bits of `raw`) as float: exact
__device__ __forceinline__ float widen(uint32_t raw) {
  return __uint_as_float(raw << 16);
}

// the bf16 build: the float32 build's tiles and threads
template <int KS>
__global__ void __launch_bounds__(kThreads, min_blocks(KS * KS))
dist_weighted_flow_bf16_kernel(const __nv_bfloat16* __restrict__ dc,
                               const __nv_bfloat16* __restrict__ flow,
                               const __nv_bfloat16* __restrict__ wx,
                               const __nv_bfloat16* __restrict__ bx,
                               const __nv_bfloat16* __restrict__ wy,
                               const __nv_bfloat16* __restrict__ by,
                               __nv_bfloat16* __restrict__ out, int N, int H,
                               int W, int tiles_x, int tiles_per_image) {
  constexpr int K = KS * KS;
  constexpr int R = (KS - 1) / 2;
  constexpr int FR = kRows + 2 * R;          // flow rows staged
  constexpr int FC = kFlowCols;              // flow columns a row needs
  constexpr int RP = (FC + 14) / 8;          // pieces a row: FC at any offset
  constexpr int RC = 8 * RP;                 // halfwords a staged row
  static_assert(R <= kPad, "the halo fits the staged columns");
  __shared__ __align__(16) float sw[(2 * K + 2 + 3) / 4 * 4];  // wx_0, wy_0,
                                             // ..., bx, by
  __shared__ __align__(16) uint16_t sf[2 * FR * RC];  // u rows, then v rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x / tiles_per_image;
  const int rem = blockIdx.x - n * tiles_per_image;
  const int y0 = rem / tiles_x * kRows;
  const int x0 = (rem - rem / tiles_x * tiles_x) * kCols;
  const int y = y0 + warp, x = x0 + lane;
  const size_t plane = (size_t)H * W;

  // the thread's logits, raw, into registers
  uint32_t lg[K];
  {
    const uint16_t* src = reinterpret_cast<const uint16_t*>(dc) +
                          (size_t)n * K * plane + (size_t)(y < H ? y : 0) * W;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const uint16_t* at = src + t * plane + x;
      lg[t] = y < H && x < W ? (uint32_t)__ldg(at) : 0u;
    }
  }
  // the weights (one a thread: 2 K + 2 <= kThreads), by a plain load
  // stored after the flow's copies are issued
  static_assert(2 * K + 2 <= kThreads, "a weight a thread");
  uint16_t wv = 0;
  if (tid < 2 * K + 2)
    wv = *reinterpret_cast<const uint16_t*>(
        tid < 2 * K ? (tid & 1 ? wy : wx) + (tid >> 1)
                    : tid == 2 * K ? bx : by);
  // the haloed u and v tile, raw: row `row` of a plane holds the flow's
  // columns x0 - kPad - sh ... in 16-byte pieces, sh its first column's
  // offset from a 16-byte boundary. A piece of a row inside the image is
  // copied by cp.async wherever it lies inside the tensor, and its
  // elements outside the image are zeroed by the same thread once its
  // copies have landed; only a piece that reaches outside the tensor (at
  // its first or last element) is loaded element by element, and a row
  // outside the image is zeros.
  const uint16_t* u = reinterpret_cast<const uint16_t*>(flow) +
                      (size_t)n * 2 * plane;
  const unsigned al = (unsigned)(reinterpret_cast<uintptr_t>(u) >> 1) & 7u;
  // the tensor's elements from u: [-n 2 plane, (N - n) 2 plane)
  const long long t_lo = -(long long)n * 2 * plane;
  const long long t_hi = (long long)(N - n) * 2 * plane;
  // piece c of the tile: its place in shared memory, its first element
  // from u and its first column; false where it holds nothing the tile
  // needs
  auto piece = [&](int c, uint16_t*& dst, long long& from, int& fx0,
                   int& fy) {
    const int pl = c >= FR * RP;
    const int e = c - pl * FR * RP;
    const int row = e / RP, j = e - row * RP;
    fy = y0 - R + row;
    const long long at = pl * (long long)plane + (long long)fy * W + x0 - kPad;
    const int sh = (int)((al + (unsigned long long)at) & 7u);
    if (8 * j >= sh + FC) return false;  // past the columns the tile needs
    fx0 = x0 - kPad - sh + 8 * j;
    from = at - sh + 8 * j;
    dst = sf + (pl * FR + row) * RC + 8 * j;
    return true;
  };
  for (int c = tid; c < 2 * FR * RP; c += kThreads) {
    uint16_t* dst;
    long long from;
    int fx0, fy;
    if (!piece(c, dst, from, fx0, fy)) continue;
    if (fy < 0 || fy >= H) {
#pragma unroll
      for (int q = 0; q < 8; ++q) dst[q] = 0;
    } else if (from >= t_lo && from + 8 <= t_hi) {
      cp_async16_raw(dst, u + from);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int fx = fx0 + q;
        dst[q] = fx >= 0 && fx < W ? u[from + q] : (uint16_t)0;
      }
    }
  }
  if (tid < 2 * K + 2) sw[tid] = widen(wv);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // the copied pieces' elements outside the image, zeroed
  if (x0 < kPad + 8 || x0 + FC - kPad > W - 8) {
    for (int c = tid; c < 2 * FR * RP; c += kThreads) {
      uint16_t* dst;
      long long from;
      int fx0, fy;
      if (!piece(c, dst, from, fx0, fy) || fy < 0 || fy >= H ||
          (fx0 >= 0 && fx0 + 8 <= W))
        continue;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (fx0 + q < 0 || fx0 + q >= W) dst[q] = 0;
    }
  }
  __syncthreads();
  if (y >= H || x >= W) return;

  const float2* w2 = reinterpret_cast<const float2*>(sw);
  // row y - R + dy's first column's offset in its first piece is
  // (b0 + dy W) mod 8 in u, (b0 + dy W + plane) mod 8 in v
  const unsigned b0 = al + (unsigned)((y - R) * W + x0 - kPad);
  float m = -INFINITY;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float d = widen(lg[t]);
    m = fmaxf(m, -__fmul_rn(d, d));
  }
  float sum = 0.f, ax = 0.f, ay = 0.f;
#pragma unroll
  for (int dy = 0; dy < KS; ++dy) {
    const unsigned ru = b0 + (unsigned)(dy * W);
    const uint16_t* fu = sf + (warp + dy) * RC + (ru & 7u) + lane + kPad - R;
    const uint16_t* fv = sf + (FR + warp + dy) * RC +
                         ((ru + (unsigned)plane) & 7u) + lane + kPad - R;
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      const int t = dy * KS + dx;
      const float2 w = w2[t];
      const float d = widen(lg[t]);
      const float e = expf(-__fmul_rn(d, d) - m);
      sum += e;
      ax += w.x * e * widen(fu[dx]);
      ay += w.y * e * widen(fv[dx]);
    }
  }
  const float2 b = w2[K];
  const float inv = 1.f / sum;
  __nv_bfloat16* o = out + (size_t)n * 2 * plane + (size_t)y * W + x;
  *o = __float2bfloat16_rn((ax + b.x) * inv);
  o[plane] = __float2bfloat16_rn((ay + b.y) * inv);
}

using F32Kernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*, float*,
                           int, int, int, int);
using B = __nv_bfloat16;
using BF16Kernel = void (*)(const B*, const B*, const B*, const B*, const B*,
                            const B*, B*, int, int, int, int, int);

template <int KS>
F32Kernel pick(bool v16) {
  return v16 ? dist_weighted_flow_kernel<KS, true>
             : dist_weighted_flow_kernel<KS, false>;
}

}  // namespace

// Launches on `stream`: one block of 128 threads a 4 x 32 tile of each of
// the N images. The float32 build (bf16 0) with flow copies of `vec`
// bytes, 16 or 4; the bf16 build (bf16 1, every pointer bf16) with 16-byte
// copies at any alignment (vec 16). k is the window side, 3, 5 or 7.
// Refuses (cudaErrorInvalidValue) arguments it cannot run, including
// 16-byte float32 copies with W % 4 != 0 or a flow base that is not
// 16-byte aligned; otherwise returns the CUDA error of the launch.
extern "C" int dist_weighted_flow_launch(const void* dc, const void* flow,
                                         const void* wx, const void* bx,
                                         const void* wy, const void* by,
                                         void* out, int N, int H, int W,
                                         int k, int vec, int bf16,
                                         void* stream) {
  const bool v16 = vec == 16;
  if (N < 1 || H < 1 || W < 1 || (k != 3 && k != 5 && k != 7) ||
      (bf16 != 0 && bf16 != 1) ||
      (bf16 ? !v16
            : (vec != 4 && !v16) ||
                  (v16 && (W % 4 != 0 ||
                           reinterpret_cast<uintptr_t>(flow) % 16 != 0))))
    return (int)cudaErrorInvalidValue;
  const long long tiles_x = (W + kCols - 1) / kCols;
  const long long per_image = tiles_x * ((H + kRows - 1) / kRows);
  if (N * per_image > INT_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(N * per_image);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    const BF16Kernel kernel = k == 3   ? dist_weighted_flow_bf16_kernel<3>
                              : k == 5 ? dist_weighted_flow_bf16_kernel<5>
                                       : dist_weighted_flow_bf16_kernel<7>;
    kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const B*>(dc), static_cast<const B*>(flow),
        static_cast<const B*>(wx), static_cast<const B*>(bx),
        static_cast<const B*>(wy), static_cast<const B*>(by),
        static_cast<B*>(out), N, H, W, (int)tiles_x, (int)per_image);
  } else {
    const F32Kernel kernel = k == 3 ? pick<3>(v16)
                             : k == 5 ? pick<5>(v16)
                                      : pick<7>(v16);
    kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(dc), static_cast<const float*>(flow),
        static_cast<const float*>(wx), static_cast<const float*>(bx),
        static_cast<const float*>(wy), static_cast<const float*>(by),
        static_cast<float*>(out), H, W, (int)tiles_x, (int)per_image);
  }
  return (int)cudaGetLastError();
}
