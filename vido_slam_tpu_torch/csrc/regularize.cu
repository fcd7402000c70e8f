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
// output are bf16, all arithmetic float32, the same as the float32 build's
// after the loads. Only the loads and stores change: a thread converts its
// logits as it loads them, and the block stages the weights and the haloed
// flow tile converted to float by plain 2-byte loads (cp.async copies 4
// bytes at least), so the shared memory and the arithmetic are the float32
// build's. It moves half the bytes: level 2 of a 1280x576 pair 19.6 MB,
// 0.0058 ms at 3.35 TB/s.

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

// blocks an SM for at most K + 32 registers a thread
constexpr int min_blocks(int K) { return 65536 / (kThreads * (K + 32)); }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// T: the element type (float, or __nv_bfloat16 with plain loads; V16 is
// then false)
template <typename T, int KS, bool V16>
__global__ void __launch_bounds__(kThreads, min_blocks(KS * KS))
dist_weighted_flow_kernel(const T* __restrict__ dc,
                          const T* __restrict__ flow,
                          const T* __restrict__ wx,
                          const T* __restrict__ bx,
                          const T* __restrict__ wy,
                          const T* __restrict__ by,
                          T* __restrict__ out, int H, int W, int tiles_x,
                          int tiles_per_image) {
  constexpr bool kF32 = sizeof(T) == 4;
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
    const T* src = dc + (size_t)n * K * plane +
                   (mine ? (size_t)y * W + x : 0);
#pragma unroll
    for (int t = 0; t < K; ++t)
      nd[t] = mine ? to_float(__ldg(src + t * plane)) : 0.f;
  }
  // the weights and the haloed flow tile, by cp.async (float32) or by plain
  // loads converted to float (bf16)
  for (int c = tid; c < 2 * K + 2; c += kThreads) {
    const T* src = c < 2 * K ? (c & 1 ? wy : wx) + (c >> 1)
                             : c == 2 * K ? bx : by;
    if constexpr (kF32)
      cp_async4(sw + c, reinterpret_cast<const float*>(src), true);
    else
      sw[c] = to_float(*src);
  }
  const T* u = flow + (size_t)n * 2 * plane;
  if constexpr (!kF32) {
    for (int c = tid; c < 2 * FLOW; c += kThreads) {
      const int pl = c >= FLOW;
      const int e = c - pl * FLOW;
      const int row = e / kFlowCols, q = e - row * kFlowCols;
      const int fy = y0 - R + row, fx = x0 - kPad + q;
      const bool in = fy >= 0 && fy < H && fx >= 0 && fx < W;
      su[c] = in ? to_float(u[pl * plane + (size_t)fy * W + fx]) : 0.f;
    }
  } else if (V16) {
    constexpr int kChunks = FR * (kFlowCols / 4);  // a plane's 16-byte chunks
    for (int c = tid; c < 2 * kChunks; c += kThreads) {
      const int pl = c >= kChunks;
      const int e = c - pl * kChunks;
      const int row = e / (kFlowCols / 4), q = e - row * (kFlowCols / 4);
      const int fy = y0 - R + row, fx = x0 - kPad + 4 * q;
      const bool in = fy >= 0 && fy < H && fx >= 0 && fx < W;
      cp_async16(su + pl * FLOW + row * kFlowCols + 4 * q,
                 reinterpret_cast<const float*>(u) + pl * plane +
                     (in ? (size_t)fy * W + fx : 0),
                 in);
    }
  } else {
    for (int c = tid; c < 2 * FLOW; c += kThreads) {
      const int pl = c >= FLOW;
      const int e = c - pl * FLOW;
      const int row = e / kFlowCols, q = e - row * kFlowCols;
      const int fy = y0 - R + row, fx = x0 - kPad + q;
      const bool in = fy >= 0 && fy < H && fx >= 0 && fx < W;
      cp_async4(su + c,
                reinterpret_cast<const float*>(u) + pl * plane +
                    (in ? (size_t)fy * W + fx : 0),
                in);
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
  T* o = out + (size_t)n * 2 * plane + (size_t)y * W + x;
  store(o, (ax + b.x) * inv);
  store(o + plane, (ay + b.y) * inv);
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*,
                        const T*, T*, int, int, int, int);

template <int KS>
Kernel<float> pick(bool v16) {
  return v16 ? dist_weighted_flow_kernel<float, KS, true>
             : dist_weighted_flow_kernel<float, KS, false>;
}

template <typename T>
int launch(Kernel<T> kernel, const void* dc, const void* flow, const void* wx,
           const void* bx, const void* wy, const void* by, void* out, int N,
           int H, int W, void* stream) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const long long tiles_x = (W + kCols - 1) / kCols;
  const long long per_image = tiles_x * ((H + kRows - 1) / kRows);
  if (N * per_image > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(int)(N * per_image), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(dc), static_cast<const T*>(flow),
      static_cast<const T*>(wx), static_cast<const T*>(bx),
      static_cast<const T*>(wy), static_cast<const T*>(by),
      static_cast<T*>(out), H, W, (int)tiles_x, (int)per_image);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`: one block of 128 threads a 4 x 32 tile of each of
// the N images. vec 16 or 4: the float32 build with flow copies of that
// many bytes; vec 2: the bf16 build (every pointer bf16). k is the window
// side, 3, 5 or 7. Refuses (cudaErrorInvalidValue) arguments it cannot run,
// including 16-byte copies with W % 4 != 0 or a flow base that is not
// 16-byte aligned; otherwise returns the CUDA error of the launch.
extern "C" int dist_weighted_flow_launch(const void* dc, const void* flow,
                                         const void* wx, const void* bx,
                                         const void* wy, const void* by,
                                         void* out, int N, int H, int W,
                                         int k, int vec, void* stream) {
  const bool v16 = vec == 16;
  if (N < 1 || H < 1 || W < 1 || (vec != 4 && vec != 2 && !v16) ||
      (v16 && (W % 4 != 0 || reinterpret_cast<uintptr_t>(flow) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  if (vec == 2) {
    using B = __nv_bfloat16;
    const Kernel<B> kernel = k == 3   ? dist_weighted_flow_kernel<B, 3, false>
                             : k == 5 ? dist_weighted_flow_kernel<B, 5, false>
                             : k == 7 ? dist_weighted_flow_kernel<B, 7, false>
                                      : nullptr;
    return launch(kernel, dc, flow, wx, bx, wy, by, out, N, H, W, stream);
  }
  const Kernel<float> kernel = k == 3   ? pick<3>(v16)
                               : k == 5 ? pick<5>(v16)
                               : k == 7 ? pick<7>(v16)
                                        : nullptr;
  return launch(kernel, dc, flow, wx, bx, wy, by, out, N, H, W, stream);
}
