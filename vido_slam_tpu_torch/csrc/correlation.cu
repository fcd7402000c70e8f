// LiteFlowNet's 49-tap cost volume on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   vido_slam_tpu/ops/correlation.py :: correlation_pallas (body _corr_kernel).
//
// What it computes: for f1, f2 (N, C, H, W) float32 and a stride s, the
// output (N, 49, Ho, Wo), Ho = ceil(H/s), Wo = ceil(W/s), holds in channel
// (p+3)*7 + (o+3) at (i, j)
//   (1/C) sum_c f1[c, i*s, j*s] * f2[c, (i+p)*s, (j+o)*s],   p, o in [-3, 3],
// with f2 zero outside the image. Every offset is a multiple of s, so only
// the stride phase of f1 and f2 (rows and columns at multiples of s) is read:
// at s = 2 a quarter of each input.
//
// What bounds it on the card: bytes. At LiteFlowNet's level 2 of a
// 1280x576 pair (C = 64, s = 2, 144 x 320 outputs) a call reads 23.6 MB of
// stride phase and writes 9.0 MB, 0.0097 ms at 3.35 TB/s, against 289
// MFLOP, 0.0043 ms at the float32 rate. The levels are small beside the
// card: 720 to 46,080 outputs, 64 to 192 channels, so a grid of one block a
// tile that walks all channels leaves most of the 132 SMs idle and each
// block runs a long serial channel loop.
//
// Design:
// - The channel sum is split over a thread-block cluster of G <= 8 CTAs
//   (grid G * tiles x N, cluster G x 1): rank r sums channels
//   [r C / G, (r+1) C / G) of one tile of 32 x TY outputs (TY = 8, or 4 at
//   the small levels). The wrapper's launch plan picks TY and G: at a
//   1280x576 pair every level launches >= 80 CTAs, levels 2-5 >= 216.
// - Each rank stages its channels in chunks of 4 through a ring of three
//   buffers filled by cp.async (4-byte copies, zero-filled outside the
//   image), so two chunks' loads are in flight while one is summed, with
//   one __syncthreads a chunk. A channel's copies are the haloed
//   stride-phase f2 tile ((TY + 6) x 38) and the f1 tile (TY x 32), one
//   flat run of shared memory; each thread works out its copies' source
//   offsets once, so a copy costs an add, a select and the cp.async, with
//   no divide or modulo.
// - Each thread computes 2 neighbouring outputs along x, so each f2 value
//   it loads serves up to 14 FMAs. Per channel: its 2 f1 values and, per tap
//   row, the 8 f2 values the row's 14 taps need, all in 8-byte shared loads:
//   29 loads for 98 FMAs (0.30 loads an FMA, 1 in the first kernel). Four
//   outputs a thread would halve that, but take 250 registers and ran
//   slower on the card.
// - The partial sums (49 x TY x 32 a CTA) go to shared memory over the
//   staging buffers; after a cluster barrier rank r adds its 1/G of the
//   partial sums of all G ranks through distributed shared memory, in rank
//   order, scales by 1/C and writes them: every output is summed by one CTA
//   in a fixed order and written once, and the launch is deterministic.
// - No tensor cores: the parity bar is 1e-5 of the output's scale in float32,
//   and TF32 keeps about 3 decimal digits; 3xTF32 (three TF32 products per
//   FMA) would keep float32 accuracy and is left for later.
//
// The bf16 build (LiteFlowNet with flow_dtype bf16): f1, f2 and the output
// are bf16, the arithmetic float32, as the JAX package computes it on bf16
// inputs (correlation.py:51, 120-125: each product cast to float32 before
// the sum, which XLA leaves unrounded; a bf16 x bf16 product is exact in
// float32). It keeps the float32 build's plan: the staged tiles are
// converted to float as they are stored, so the shared memory, the tile
// plan and the arithmetic are the float32 build's, and only the loads from
// device memory (2 bytes a value, by plain loads: cp.async copies 4 bytes
// at least) and the output's stores change. The bytes it must move halve:
// level 2 of a 1280x576 pair 16.3 MB, 0.0049 ms at 3.35 TB/s, beside the
// same 0.0043 ms of float32 operations. A plan re-derived for 2-byte
// staging (twice the channels a stage) is left for a later PR.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kR = 3;                 // displacement radius
constexpr int kD = 2 * kR + 1;
constexpr int kTaps = kD * kD;
constexpr int kTX = 32;               // outputs of a tile along x
constexpr int kXT = kTX / 2;          // threads along x: 2 outputs each
constexpr int kHaloW = kTX + 2 * kR;  // f2 tile columns
constexpr int kCC = 4;                // channels a stage
constexpr int kStages = 3;
constexpr int kMaxSplit = 8;          // portable cluster size
constexpr int kSmemLimit = 232448;    // bytes a block may use on sm_90

template <int TY>
struct Tile {
  static constexpr int threads = kXT * TY;
  static constexpr int f2_floats = (TY + 2 * kR) * kHaloW;  // a channel
  static constexpr int chan_floats = f2_floats + TY * kTX;  // ... with f1
  static constexpr int copies = (chan_floats + threads - 1) / threads;
  static constexpr int stage_floats = kCC * chan_floats;
  static constexpr int part_floats = kTaps * TY * kTX;
  static constexpr int smem_floats = kStages * stage_floats > part_floats
                                         ? kStages * stage_floats
                                         : part_floats;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool inside) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(inside ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// T: the element type, float or __nv_bfloat16
template <typename T, int TY>
__global__ void __launch_bounds__(Tile<TY>::threads)
correlation_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                   T* __restrict__ out, int C, int H, int W, int s, int Ho,
                   int Wo, int tiles_x) {
  using Geo = Tile<TY>;
  constexpr int NT = Geo::threads;
  extern __shared__ __align__(16) float sm[];

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / G;
  const int tile_y = tile / tiles_x;
  const int oy0 = tile_y * TY, ox0 = (tile - tile_y * tiles_x) * kTX;
  const int tid = threadIdx.x;
  const int tx = tid % kXT, ty = tid / kXT;

  const int c_lo = (int)((long long)rank * C / G);
  const int nch = (int)((long long)(rank + 1) * C / G) - c_lo;
  const int nchunks = (nch + kCC - 1) / kCC;
  const size_t plane = (size_t)H * W;
  const T* f1r = f1 + ((size_t)blockIdx.y * C + c_lo) * plane;
  const T* f2r = f2 + ((size_t)blockIdx.y * C + c_lo) * plane;

  // this thread's copies of a channel, e = tid + k NT of the channel's flat
  // run: the offset in the source plane, -1 outside the image (zero fill)
  int src_off[Geo::copies];
#pragma unroll
  for (int k = 0; k < Geo::copies; ++k) {
    const int e = tid + k * NT;
    int off = -1;
    if (e < Geo::f2_floats) {
      const int a = oy0 - kR + e / kHaloW, b = ox0 - kR + e % kHaloW;
      if (a >= 0 && a < Ho && b >= 0 && b < Wo) off = (a * W + b) * s;
    } else if (e < Geo::chan_floats) {
      const int i = oy0 + (e - Geo::f2_floats) / kTX;
      const int j = ox0 + (e - Geo::f2_floats) % kTX;
      if (i < Ho && j < Wo) off = (i * W + j) * s;
    }
    src_off[k] = off;
  }
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(sm));

  auto stage = [&](int k) {
    const int c0 = k * kCC, cc = min(kCC, nch - c0);
    const uint32_t dst = sbase + 4u * (k % kStages) * Geo::stage_floats;
    for (int c = 0; c < cc; ++c) {
      const size_t at = (size_t)(c0 + c) * plane;
#pragma unroll
      for (int q = 0; q < Geo::copies; ++q) {
        const int e = tid + q * NT;
        if (e < Geo::chan_floats) {
          const T* src = (e < Geo::f2_floats ? f2r : f1r) + at;
          if constexpr (sizeof(T) == 4) {
            cp_async4(dst + 4u * (c * Geo::chan_floats + e),
                      reinterpret_cast<const float*>(src) +
                          (src_off[q] < 0 ? 0 : src_off[q]),
                      src_off[q] >= 0);
          } else {
            sm[(k % kStages) * Geo::stage_floats + c * Geo::chan_floats + e] =
                src_off[q] >= 0 ? __bfloat162float(src[src_off[q]]) : 0.f;
          }
        }
      }
    }
  };

  float acc[kTaps][2];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) acc[t][0] = acc[t][1] = 0.0f;

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nchunks) stage(k);
    cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<kStages - 2>();  // chunk k has landed ...
    __syncthreads();  // ... for every thread, and chunk k - 1 is summed
    if (k + kStages - 1 < nchunks) stage(k + kStages - 1);
    cp_async_commit();  // an empty group at the end keeps the count right
    const float* buf = sm + (k % kStages) * Geo::stage_floats;
    const int cc = min(kCC, nch - k * kCC);
#pragma unroll
    for (int c = 0; c < kCC; ++c) {
      if (c < cc) {
        const float* ch = buf + c * Geo::chan_floats;
        const float2 a = lds2(ch + Geo::f2_floats + ty * kTX + 2 * tx);
        const float* t2 = ch + ty * kHaloW + 2 * tx;
#pragma unroll
        for (int p = 0; p < kD; ++p) {
          float w[8];  // the 2 + 6 f2 values of tap row p
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            const float2 v = lds2(t2 + p * kHaloW + e);
            w[e] = v.x;
            w[e + 1] = v.y;
          }
#pragma unroll
          for (int o = 0; o < kD; ++o) {
            acc[p * kD + o][0] = fmaf(a.x, w[o], acc[p * kD + o][0]);
            acc[p * kD + o][1] = fmaf(a.y, w[o + 1], acc[p * kD + o][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every chunk is summed: the buffers are free

  // the partial sums over the staging buffers, [tap][row][column]
  float* part = sm;
#pragma unroll
  for (int t = 0; t < kTaps; ++t)
    *reinterpret_cast<float2*>(part + (t * TY + ty) * kTX + 2 * tx) =
        make_float2(acc[t][0], acc[t][1]);
  cluster.sync();

  // rank r adds its 1/G of the partial sums over the ranks in order
  constexpr int E4 = Geo::part_floats / 4;
  const int e_lo = (int)((long long)rank * E4 / G);
  const int e_hi = (int)((long long)(rank + 1) * E4 / G);
  const float inv_c = 1.f / (float)C;
  const size_t oplane = (size_t)Ho * Wo;
  T* outn = out + (size_t)blockIdx.y * kTaps * oplane;
  for (int e = e_lo + tid; e < e_hi; e += NT) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < G; ++r) {
      const float4 v =
          cluster.map_shared_rank(reinterpret_cast<float4*>(part), r)[e];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int col = (e % (kTX / 4)) * 4;
    const int row = (e / (kTX / 4)) % TY;
    const int t = e / (kTX / 4 * TY);
    const int i = oy0 + row, j = ox0 + col;
    if (i >= Ho) continue;
    T* o = outn + t * oplane + (size_t)i * Wo + j;
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (j + x >= Wo) continue;
      if constexpr (sizeof(T) == 4)
        o[x] = vals[x] * inv_c;
      else
        o[x] = __float2bfloat16_rn(vals[x] * inv_c);
    }
  }
  cluster.sync();  // no CTA leaves while another reads its partial sums
}

template <typename T, int TY>
int launch(const void* f1v, const void* f2v, void* outv, int N, int C, int H,
           int W, int s, int Ho, int Wo, int tiles_x, int G, int grid_x,
           int smem_bytes, cudaStream_t stream) {
  auto kernel = correlation_kernel<T, TY>;
  const T* f1 = static_cast<const T*>(f1v);
  const T* f2 = static_cast<const T*>(f2v);
  T* out = static_cast<T*>(outv);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, N, 1);
  cfg.blockDim = dim3(Tile<TY>::threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, f1, f2, out, C, H, W, s, Ho, Wo,
                           tiles_x);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` with the wrapper's plan: tiles of 32 x tile_h
// outputs, the channels split over clusters of `split` CTAs, grid_x = split
// * tiles, `smem_bytes` of dynamic shared memory; the bf16 build where
// `bf16` is 1 (f1, f2 and out bf16), else the float32 one. Refuses
// (cudaErrorInvalidValue) a plan it cannot run; otherwise returns the CUDA
// error of the launch (0 on success).
extern "C" int correlation_launch(const void* f1, const void* f2, void* out,
                                  int N, int C, int H, int W, int s,
                                  int tile_h, int split, int grid_x,
                                  int smem_bytes, int bf16, void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || s < 1 || N > 65535 ||
      (bf16 != 0 && bf16 != 1) || (long long)H * W * s > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + s - 1) / s, Wo = (W + s - 1) / s;
  const int tiles_x = (Wo + kTX - 1) / kTX;
  const int need = tile_h == 8   ? Tile<8>::smem_floats * 4
                   : tile_h == 4 ? Tile<4>::smem_floats * 4
                                 : -1;
  if (need < 0 || split < 1 || split > kMaxSplit || split > C ||
      (long long)grid_x !=
          (long long)tiles_x * ((Ho + tile_h - 1) / tile_h) * split ||
      smem_bytes != need || smem_bytes > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  using B = __nv_bfloat16;
  if (bf16)
    return tile_h == 8 ? launch<B, 8>(f1, f2, out, N, C, H, W, s, Ho, Wo,
                                      tiles_x, split, grid_x, smem_bytes, st)
                       : launch<B, 4>(f1, f2, out, N, C, H, W, s, Ho, Wo,
                                      tiles_x, split, grid_x, smem_bytes, st);
  return tile_h == 8 ? launch<float, 8>(f1, f2, out, N, C, H, W, s, Ho, Wo,
                                        tiles_x, split, grid_x, smem_bytes, st)
                     : launch<float, 4>(f1, f2, out, N, C, H, W, s, Ho, Wo,
                                        tiles_x, split, grid_x, smem_bytes,
                                        st);
}
