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
// MFLOP, 0.0043 ms at the float32 rate.
//
// Design (a first kernel, right and simple): one thread per output pixel,
// a block of 32 x 8 outputs with warps along x. Each thread keeps its 49 sums
// in registers. The block walks the channels in chunks of 16: it stages the
// chunk's haloed stride-phase tile of f2, (8 + 6) x (32 + 6) per channel and
// zero outside the image, in shared memory (34 KB), and every thread then
// reads its f1 value once per channel from global memory and takes the 49
// taps from the tile. The 1/C scale is applied once at the end.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 3;                 // displacement radius
constexpr int kTaps = (2 * kR + 1) * (2 * kR + 1);
constexpr int kTX = 32;               // outputs per block along x
constexpr int kTY = 8;                // ... and along y
constexpr int kThreads = kTX * kTY;
constexpr int kCC = 16;               // channels per shared-memory chunk
constexpr int kSH = kTY + 2 * kR;     // haloed tile rows
constexpr int kSW = kTX + 2 * kR;     // haloed tile columns

__global__ void __launch_bounds__(kThreads)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int C, int H, int W, int s,
                   int Ho, int Wo) {
  __shared__ float tile[kCC][kSH][kSW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int j = blockIdx.x * kTX + tx;
  const int i = blockIdx.y * kTY + ty;
  const bool live = i < Ho && j < Wo;
  const size_t plane = (size_t)H * W;
  const float* f1n = f1 + (size_t)blockIdx.z * C * plane;
  const float* f2n = f2 + (size_t)blockIdx.z * C * plane;
  // stride-phase coordinates of the tile's first row and column
  const int a0 = blockIdx.y * kTY - kR;
  const int b0 = blockIdx.x * kTX - kR;
  const size_t f1_at = live ? (size_t)(i * s) * W + (size_t)j * s : 0;

  float acc[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) acc[t] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    const int cc = min(kCC, C - c0);
    __syncthreads();  // the previous chunk's taps are done
    for (int e = tid; e < cc * kSH * kSW; e += kThreads) {
      const int c = e / (kSH * kSW);
      const int rem = e - c * (kSH * kSW);
      const int r = rem / kSW;
      const int q = rem - r * kSW;
      const int a = a0 + r, b = b0 + q;
      float v = 0.f;
      if (a >= 0 && a < Ho && b >= 0 && b < Wo)
        v = f2n[(size_t)(c0 + c) * plane + (size_t)(a * s) * W
                + (size_t)b * s];
      tile[c][r][q] = v;
    }
    __syncthreads();
    if (live) {
      for (int c = 0; c < cc; ++c) {
        const float x = f1n[(size_t)(c0 + c) * plane + f1_at];
#pragma unroll
        for (int p = 0; p < 2 * kR + 1; ++p)
#pragma unroll
          for (int o = 0; o < 2 * kR + 1; ++o)
            acc[p * (2 * kR + 1) + o] =
                fmaf(x, tile[c][ty + p][tx + o], acc[p * (2 * kR + 1) + o]);
      }
    }
  }
  if (!live) return;
  const float inv_c = 1.f / (float)C;
  const size_t oplane = (size_t)Ho * Wo;
  float* o = out + (size_t)blockIdx.z * kTaps * oplane + (size_t)i * Wo + j;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) o[t * oplane] = acc[t] * inv_c;
}

}  // namespace

// Launches on `stream`; returns the CUDA error of the launch (0 on success).
extern "C" int correlation_launch(const float* f1, const float* f2,
                                  float* out, int N, int C, int H, int W,
                                  int s, void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || s < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + s - 1) / s, Wo = (W + s - 1) / s;
  const dim3 grid((Wo + kTX - 1) / kTX, (Ho + kTY - 1) / kTY, N);
  const dim3 block(kTX, kTY);
  correlation_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      f1, f2, out, C, H, W, s, Ho, Wo);
  return (int)cudaGetLastError();
}
