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
// float32). The bytes it must move halve: level 2 of a 1280x576 pair 16.3
// MB, 0.0049 ms at 3.35 TB/s, beside the same 0.0043 ms of float32
// operations. It keeps the float32 build's tiles, cluster split, inner
// loop and per-output arithmetic; it stages and shares out the work
// otherwise:
// - cp.async copies 4, 8 or 16 bytes, never one 2-byte value, so a staged
//   row is copied raw, as the 16-byte pieces (8 bf16) that cover its span
//   of (n - 1) s + 1 elements of the image row (n = 38 f2 or 32 f1
//   stride-phase values). The row keeps its first element's offset in its
//   first piece (0-7, from the address; it can differ from row to row and
//   channel to channel), so the pieces serve every W, stride, storage
//   offset and N: row_pieces(n, s) of them, 6 and 5 at s = 1, 11 and 9 at
//   s = 2 (half of each piece unused there, as half of each sector of the
//   float32 build's reads). The pieces of a channel are described once a
//   block in shared memory, and a chunk's (channel, piece) pairs are shared
//   out over all threads. A piece that would reach outside the tensor
//   (only at its first and last elements) is copied by plain loads of the
//   elements inside; rows outside the image are not copied.
// - A ring of 3 raw buffers of `chunk` channels keeps 2 chunks in flight
//   while one is summed. Once chunk k is summed and chunk
//   k + 1 has landed, each thread widens its values of chunk k + 1 (the
//   float32 build's flat layout; values outside the image are zeroed once,
//   in every tile, by the thread that owns them) into one of two float
//   tiles, once a value; chunk k + 1 is then summed from it with the
//   float32 build's inner loop: two __syncthreads a chunk. Widening in the
//   inner loop instead would take a shift per value per tap row and, where
//   a row starts on an odd element, a funnel shift per pair: 5 shared
//   loads, 4 funnel shifts and 8 shifts beside the 14 FMAs of a tap row,
//   against the float32 loop's 4 loads.
// - `taps` groups of threads share out the 7 tap rows of every output
//   (each output's sum is still one thread's, over the rank's channels in
//   order): at the small levels, where a grid is a few dozen CTAs, 4 groups
//   give each SM 4x the warps.
// - The epilogue loads an output's G partial sums before adding them (in
//   rank order, as the float32 build) and stores four bf16 outputs at once.
// - The plan (ops/correlation.py launch_plan_bf16) keeps the float32
//   plan's tile height and split, so every rank sums the channels the
//   parent build summed, in the same order: the same bits, at every chunk,
//   ring depth and number of tap groups. The shared memory is the larger of
//   the ring with the two float tiles and the pieces' descriptions, and
//   the partial sums.

#include <climits>

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
// the bf16 build's channels a stage, at most
constexpr int kMaxChunk = 16;

template <int TY>
struct Tile {
  static constexpr int threads = kXT * TY;
  static constexpr int f2_rows = TY + 2 * kR;
  static constexpr int f2_floats = f2_rows * kHaloW;        // a channel
  static constexpr int chan_floats = f2_floats + TY * kTX;  // ... with f1
  static constexpr int copies = (chan_floats + threads - 1) / threads;
  static constexpr int stage_floats = kCC * chan_floats;
  static constexpr int part_floats = kTaps * TY * kTX;
  static constexpr int smem_floats = kStages * stage_floats > part_floats
                                         ? kStages * stage_floats
                                         : part_floats;
};

// The bf16 build: 16-byte pieces (8 values) that cover a staged row of n
// stride-phase values, (n - 1) s + 1 elements of its image row, from any
// offset (0-7) of its first element in its first piece
__host__ __device__ constexpr int row_pieces(int n, int s) {
  return ((n - 1) * s + 15) / 8;
}

// the bf16 build's pieces of a channel: the f2 rows', then the f1 rows'
template <int TY>
__host__ __device__ constexpr int chan_pieces(int s) {
  return Tile<TY>::f2_rows * row_pieces(kHaloW, s) +
         TY * row_pieces(kTX, s);
}

// the bf16 build's shared memory: two float tiles of `chunk` channels,
// kStages raw buffers of `chunk` channels and a 16-byte description of
// each piece of a channel, or the partial sums that reuse them, whichever
// is larger
template <int TY>
long long bf16_smem_bytes(int s, int chunk) {
  const long long ring = 4LL * 2 * chunk * Tile<TY>::chan_floats +
                         16LL * (kStages * chunk + 1) * chan_pieces<TY>(s);
  const long long part = 4LL * Tile<TY>::part_floats;
  return ring > part ? ring : part;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool inside) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(inside ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One channel of a staged chunk (the float32 build's flat layout: the
// haloed f2 tile, then the f1 tile) into the thread's sums of tap rows
// [p0, p0 + rows), rows <= RPG (all kD of them in the float32 build): its
// 2 f1 values and, per tap row, the 8 f2 values the row's 14 taps need.
template <int TY, int RPG>
__device__ __forceinline__ void sum_channel(const float* ch, int tx, int ty,
                                            int p0, int rows,
                                            float (&acc)[RPG * kD][2]) {
  const float2 a = lds2(ch + Tile<TY>::f2_floats + ty * kTX + 2 * tx);
  const float* t2 = ch + (ty + p0) * kHaloW + 2 * tx;
#pragma unroll
  for (int p = 0; p < RPG; ++p) {
    if (p < rows) {
      float w[8];  // the 2 + 6 f2 values of tap row p0 + p
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

// After the channel loop (every thread past a barrier that follows its
// last shared read): the partial sums of tap rows [p0, p0 + rows) to shared
// memory, [tap][row][column] over the staging buffers; after a cluster
// barrier rank r adds its 1/G of the partial sums of all G ranks through
// distributed shared memory, in rank order, scales by 1/C and writes them
// once. NT threads. kLoadAll: each thread loads an element's G partial
// sums before adding them (the same sums in the same order, without a
// wait a rank).
template <typename T, int TY, int NT, int RPG, bool kLoadAll>
__device__ __forceinline__ void cluster_sum_store(
    float* sm, const float (&acc)[RPG * kD][2], int p0, int rows,
    T* __restrict__ out, int C, int Ho, int Wo, int oy0, int ox0, int tx,
    int ty) {
  using Geo = Tile<TY>;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  float* part = sm;
#pragma unroll
  for (int p = 0; p < RPG; ++p) {
    if (p < rows) {
#pragma unroll
      for (int o = 0; o < kD; ++o)
        *reinterpret_cast<float2*>(
            part + (((p0 + p) * kD + o) * TY + ty) * kTX + 2 * tx) =
            make_float2(acc[p * kD + o][0], acc[p * kD + o][1]);
    }
  }
  cluster.sync();

  constexpr int E4 = Geo::part_floats / 4;
  const int e_lo = (int)((long long)rank * E4 / G);
  const int e_hi = (int)((long long)(rank + 1) * E4 / G);
  const float inv_c = 1.f / (float)C;
  const size_t oplane = (size_t)Ho * Wo;
  T* outn = out + (size_t)blockIdx.y * kTaps * oplane;
  for (int e = e_lo + tid; e < e_hi; e += NT) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kLoadAll) {
      float4 v[kMaxSplit];
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        if (r < G)
          v[r] = cluster.map_shared_rank(reinterpret_cast<float4*>(part),
                                         r)[e];
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r) {
        if (r < G) {
          sum.x += v[r].x;
          sum.y += v[r].y;
          sum.z += v[r].z;
          sum.w += v[r].w;
        }
      }
    } else {
      for (int r = 0; r < G; ++r) {
        const float4 v =
            cluster.map_shared_rank(reinterpret_cast<float4*>(part), r)[e];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    const int col = (e % (kTX / 4)) * 4;
    const int row = (e / (kTX / 4)) % TY;
    const int t = e / (kTX / 4 * TY);
    const int i = oy0 + row, j = ox0 + col;
    if (i >= Ho) continue;
    T* o = outn + t * oplane + (size_t)i * Wo + j;
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
    if constexpr (sizeof(T) == 2) {
      if (j + 3 < Wo && reinterpret_cast<uintptr_t>(o) % 8 == 0) {
        // four bf16 outputs in one 8-byte store
        const __nv_bfloat162 lo = __floats2bfloat162_rn(vals[0] * inv_c,
                                                        vals[1] * inv_c);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(vals[2] * inv_c,
                                                        vals[3] * inv_c);
        uint2 w;
        w.x = *reinterpret_cast<const uint32_t*>(&lo);
        w.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(o) = w;
        continue;
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (j + x >= Wo) continue;
      store(o + x, vals[x] * inv_c);
    }
  }
  cluster.sync();  // no CTA leaves while another reads its partial sums
}

// the float32 build
template <int TY>
__global__ void __launch_bounds__(Tile<TY>::threads)
correlation_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int C, int H, int W, int s,
                   int Ho, int Wo, int tiles_x) {
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
  const float* f1r = f1 + ((size_t)blockIdx.y * C + c_lo) * plane;
  const float* f2r = f2 + ((size_t)blockIdx.y * C + c_lo) * plane;

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
          const float* src = (e < Geo::f2_floats ? f2r : f1r) + at;
          cp_async4(dst + 4u * (c * Geo::chan_floats + e),
                    src + (src_off[q] < 0 ? 0 : src_off[q]),
                    src_off[q] >= 0);
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
    for (int c = 0; c < kCC; ++c)
      if (c < cc)
        sum_channel<TY, kD>(buf + c * Geo::chan_floats, tx, ty, 0, kD, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every chunk is summed: the buffers are free
  cluster_sum_store<float, TY, NT, kD, false>(sm, acc, 0, kD, out, C, Ho,
                                               Wo, oy0, ox0, tx, ty);
}

// the bf16 build: raw 16-byte pieces through a ring of kStages buffers of
// `chunk` channels, widened a chunk ahead of their sums into one of two
// float tiles; TG groups of Tile<TY>::threads threads, group g summing tap
// rows [g kD / TG, (g + 1) kD / TG) of every output (each sum still one
// thread's, over the rank's channels in order)
template <int TY, int TG>
__global__ void __launch_bounds__(Tile<TY>::threads * TG)
correlation_bf16_kernel(const __nv_bfloat16* __restrict__ f1,
                        const __nv_bfloat16* __restrict__ f2,
                        __nv_bfloat16* __restrict__ out, int N, int C, int H,
                        int W, int s, int Ho, int Wo, int tiles_x,
                        int chunk) {
  using Geo = Tile<TY>;
  constexpr int NT = Geo::threads * TG;
  constexpr int F2R = Geo::f2_rows;
  constexpr int RPG = (kD + TG - 1) / TG;  // tap rows a group, at most
  constexpr int CP = (Geo::chan_floats + NT - 1) / NT;  // values a thread
  extern __shared__ __align__(16) float sm[];

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / G;
  const int tile_y = tile / tiles_x;
  const int oy0 = tile_y * TY, ox0 = (tile - tile_y * tiles_x) * kTX;
  const int tid = threadIdx.x;
  const int tg = tid / Geo::threads, gtid = tid - tg * Geo::threads;
  const int tx = gtid % kXT, ty = gtid / kXT;
  const int p0 = tg * kD / TG, rows = (tg + 1) * kD / TG - p0;

  const int c_lo = (int)((long long)rank * C / G);
  const int nch = (int)((long long)(rank + 1) * C / G) - c_lo;
  const int nchunks = (nch + chunk - 1) / chunk;
  const long long plane = (long long)H * W;
  // the rank's first plane as an element of the tensor
  const long long first = ((long long)blockIdx.y * C + c_lo) * plane;
  const uint16_t* f1r = reinterpret_cast<const uint16_t*>(f1) + first;
  const uint16_t* f2r = reinterpret_cast<const uint16_t*>(f2) + first;
  // the element offset of each rank base from a 16-byte boundary
  const unsigned al1 = (unsigned)(reinterpret_cast<uintptr_t>(f1r) >> 1) & 7u;
  const unsigned al2 = (unsigned)(reinterpret_cast<uintptr_t>(f2r) >> 1) & 7u;
  // every channel's rows start at the same offsets where a plane is whole
  // 16-byte pieces
  const bool whole = plane % 8 == 0;

  const int p2 = row_pieces(kHaloW, s), p1 = row_pieces(kTX, s);
  const int pieces = F2R * p2 + TY * p1;  // a channel's: piece q at 8 q
  const int chan_hw = 8 * pieces;         // halfwords a channel
  // two float tiles of `chunk` channels (the float32 build's layout), zero
  // outside the image, then the ring of raw buffers
  float* fbuf = sm;
  uint16_t* raw =
      reinterpret_cast<uint16_t*>(sm + 2 * chunk * Geo::chan_floats);

  // this thread's values of a channel's float tile, e = tid + k NT: where
  // each lies in the channel's raw rows, (halfword of its row's piece 0
  // + s j + the row's first element's offset in it) * 8 + that offset
  // less the channel's share (mod 8), or -1 outside the image (zero in
  // every tile; set while the first chunks' copies are in flight)
  int at[CP];
  auto place_values = [&]() {
#pragma unroll
    for (int k = 0; k < CP; ++k) {
      const int e = tid + k * NT;
      int v = -1;
      if (e < Geo::f2_floats) {
        const int r = e / kHaloW, b = e % kHaloW;
        const int a = oy0 - kR + r;
        if (a >= 0 && a < Ho && ox0 - kR + b >= 0 && ox0 - kR + b < Wo) {
          const int sh = (al2 + (unsigned)((a * W + ox0 - kR) * s)) & 7u;
          v = (8 * p2 * r + s * b + sh) * 8 + sh;
        }
      } else if (e < Geo::chan_floats) {
        const int r = (e - Geo::f2_floats) / kTX;
        const int j = (e - Geo::f2_floats) % kTX;
        const int i = oy0 + r;
        if (i < Ho && ox0 + j < Wo) {
          const int sh = (al1 + (unsigned)((i * W + ox0) * s)) & 7u;
          v = (8 * (F2R * p2 + r * p1) + s * j + sh) * 8 + sh;
        }
      }
      at[k] = v;
      if (v < 0 && e < Geo::chan_floats)
        for (int c = 0; c < 2 * chunk; ++c)
          fbuf[c * Geo::chan_floats + e] = 0.f;
    }
  };

  // a channel's pieces, described once a block in shared memory after the
  // ring: piece q's {g8, t, lim}: g8, its first element plus its row's
  // offset, from the channel's plane (g + 8 j, g the row's first element,
  // j its place in the row); t, the row's offset term ((al + g) mod 8, plus
  // 8 for an f1 row), or -1 for a row outside the image (not staged); lim,
  // 8 j less the row's span (the piece holds none of the row's elements
  // where the offset is at most that)
  int4* desc =
      reinterpret_cast<int4*>(raw + (size_t)kStages * chunk * chan_hw);
  for (int q = tid; q < pieces; q += NT) {
    const bool f2row = q < F2R * p2;
    const int e = f2row ? q : q - F2R * p2;
    const int pr = f2row ? p2 : p1;
    const int r = e / pr, j = e - r * pr;
    const int a = f2row ? oy0 - kR + r : oy0 + r;
    int4 d = make_int4(0, -1, 0, 0);
    if (a >= 0 && a < Ho) {
      const int g = (a * W + (f2row ? ox0 - kR : ox0)) * s;
      d.x = g + 8 * j;
      d.y = (int)(((f2row ? al2 : al1) + (unsigned)g) & 7u) | (f2row ? 0 : 8);
      d.z = 8 * j - ((f2row ? kHaloW : kTX) - 1) * s - 1;
    }
    desc[q] = d;
  }
  __syncthreads();

  // chunk k into raw buffer k % kStages: the pieces of the rows inside the
  // image, the chunk's (channel, piece) pairs shared out over the block, by
  // cp.async where they lie inside the tensor, else the elements inside by
  // plain loads
  const long long total = (long long)N * C * plane;
  auto stage = [&](int k) {
    const int c0 = k * chunk, cc = min(chunk, nch - c0);
    uint16_t* buf = raw + (size_t)(k % kStages) * chunk * chan_hw;
    int c = 0, q = tid;  // pair c pieces + q, from tid on in steps of NT
    while (q >= pieces) q -= pieces, ++c;
    while (c < cc) {
      const int4 d = desc[q];
      const long long cpl = (long long)(c0 + c) * plane;
      const int sh = (d.y + (int)((unsigned long long)cpl & 7u)) & 7;
      if (d.y >= 0 && sh > d.z) {
        const int from = d.x - sh;
        const uint16_t* src = (d.y & 8 ? f1r : f2r) + cpl + from;
        uint16_t* dst = buf + c * chan_hw + 8 * q;
        const long long at0 = first + cpl + from;  // in the tensor
        if (at0 >= 0 && at0 + 8 <= total) {
          cp_async16(dst, src);
        } else {
#pragma unroll
          for (int x = 0; x < 8; ++x)
            if (at0 + x >= 0 && at0 + x < total) dst[x] = src[x];
        }
      }
      for (q += NT; q >= pieces;) q -= pieces, ++c;
    }
  };

  // chunk k's raw buffer into float tile k % 2, a value a thread at a
  // time, all of a channel's loads before its stores
  auto widen = [&](int k) {
    const int c0 = k * chunk, cc = min(chunk, nch - c0);
    const uint16_t* rbuf = raw + (size_t)(k % kStages) * chunk * chan_hw;
    float* fb = fbuf + (k & 1) * chunk * Geo::chan_floats;
    for (int c = 0; c < cc; ++c) {
      const uint16_t* rc = rbuf + c * chan_hw;
      const int cm = (int)((unsigned long long)((c0 + c) * plane) & 7u);
      uint32_t v[CP];
      if (whole) {
#pragma unroll
        for (int q = 0; q < CP; ++q)
          if (at[q] >= 0) v[q] = rc[at[q] >> 3];
      } else {
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const int x = at[q];
          if (x >= 0) v[q] = rc[(x >> 3) - (x & 7) + (((x & 7) + cm) & 7)];
        }
      }
      float* fc = fb + c * Geo::chan_floats;
#pragma unroll
      for (int q = 0; q < CP; ++q)
        if (at[q] >= 0) fc[tid + q * NT] = __uint_as_float(v[q] << 16);
    }
  };

  float acc[RPG * kD][2];
#pragma unroll
  for (int t = 0; t < RPG * kD; ++t) acc[t][0] = acc[t][1] = 0.0f;

  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nchunks) stage(k);
    cp_async_commit();
  }
  place_values();
  cp_async_wait<kStages - 2>();  // chunk 0 has landed ...
  __syncthreads();              // ... for every thread
  widen(0);
  for (int k = 0; k < nchunks; ++k) {
    __syncthreads();  // chunk k is widened, chunk k - 1 summed
    if (k + kStages - 1 < nchunks) stage(k + kStages - 1);
    cp_async_commit();  // an empty group at the end keeps the count right
    const float* buf = fbuf + (k & 1) * chunk * Geo::chan_floats;
    const int cc = min(chunk, nch - k * chunk);
    for (int c = 0; c < cc; ++c)
      sum_channel<TY, RPG>(buf + c * Geo::chan_floats, tx, ty, p0, rows,
                           acc);
    if (k + 1 < nchunks) {
      cp_async_wait<kStages - 2>();  // chunk k + 1 has landed, while
      __syncthreads();              // chunk k was summed
      widen(k + 1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every chunk is summed: the buffers are free
  cluster_sum_store<__nv_bfloat16, TY, NT, RPG, true>(
      sm, acc, p0, rows, out, C, Ho, Wo, oy0, ox0, tx, ty);
}

cudaLaunchAttribute cluster_attr(int G) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = G;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, int N, int G, int grid_x,
           int smem_bytes, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, N, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {cluster_attr(G)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int TY, int TG>
int launch_bf16(const void* f1, const void* f2, void* out, int N, int C,
                int H, int W, int s, int Ho, int Wo, int tiles_x, int G,
                int grid_x, int chunk, int smem_bytes, cudaStream_t st) {
  using B = __nv_bfloat16;
  return launch(correlation_bf16_kernel<TY, TG>, Tile<TY>::threads * TG, N,
                G, grid_x, smem_bytes, st, static_cast<const B*>(f1),
                static_cast<const B*>(f2), static_cast<B*>(out), N, C, H, W,
                s, Ho, Wo, tiles_x, chunk);
}

template <int TY>
int launch_tile(const void* f1, const void* f2, void* out, int N, int C,
                int H, int W, int s, int Ho, int Wo, int tiles_x, int G,
                int grid_x, int chunk, int taps, int smem_bytes, int bf16,
                cudaStream_t st) {
  if (bf16)
    return taps == 1 ? launch_bf16<TY, 1>(f1, f2, out, N, C, H, W, s, Ho, Wo,
                                          tiles_x, G, grid_x, chunk,
                                          smem_bytes, st)
           : taps == 2 ? launch_bf16<TY, 2>(f1, f2, out, N, C, H, W, s, Ho,
                                            Wo, tiles_x, G, grid_x, chunk,
                                            smem_bytes, st)
                       : launch_bf16<TY, 4>(f1, f2, out, N, C, H, W, s, Ho,
                                            Wo, tiles_x, G, grid_x, chunk,
                                            smem_bytes, st);
  return launch(correlation_kernel<TY>, Tile<TY>::threads, N, G, grid_x,
                smem_bytes, st, static_cast<const float*>(f1),
                static_cast<const float*>(f2), static_cast<float*>(out), C,
                H, W, s, Ho, Wo, tiles_x);
}

}  // namespace

// Launches on `stream` with the wrapper's plan: tiles of 32 x tile_h
// outputs, the channels split over clusters of `split` CTAs, grid_x = split
// * tiles, `smem_bytes` of dynamic shared memory, a ring of 3 stages of
// `chunk` channels, `taps` groups of threads over the tap rows; the bf16
// build where `bf16` is 1 (f1, f2 and out bf16: chunk 1-16, taps 1, 2 or
// 4, 16-byte copies), else the float32 one (chunk 4, taps 1, 4-byte
// copies). Refuses (cudaErrorInvalidValue) a plan it cannot run; otherwise
// returns the CUDA error of the launch (0 on success).
extern "C" int correlation_launch(const void* f1, const void* f2, void* out,
                                  int N, int C, int H, int W, int s,
                                  int tile_h, int split, int grid_x,
                                  int chunk, int taps, int smem_bytes,
                                  int bf16, void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || s < 1 || N > 65535 ||
      (bf16 != 0 && bf16 != 1) || (long long)H * W * s > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + s - 1) / s, Wo = (W + s - 1) / s;
  const int tiles_x = (Wo + kTX - 1) / kTX;
  long long need = -1;
  if (bf16) {
    if (chunk >= 1 && chunk <= kMaxChunk &&
        (taps == 1 || taps == 2 || taps == 4))
      need = tile_h == 8   ? bf16_smem_bytes<8>(s, chunk)
             : tile_h == 4 ? bf16_smem_bytes<4>(s, chunk)
                           : -1;
  } else if (chunk == kCC && taps == 1) {
    need = tile_h == 8   ? Tile<8>::smem_floats * 4
           : tile_h == 4 ? Tile<4>::smem_floats * 4
                         : -1;
  }
  if (need < 0 || split < 1 || split > kMaxSplit || split > C ||
      (long long)grid_x !=
          (long long)tiles_x * ((Ho + tile_h - 1) / tile_h) * split ||
      smem_bytes != need || smem_bytes > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return tile_h == 8
             ? launch_tile<8>(f1, f2, out, N, C, H, W, s, Ho, Wo, tiles_x,
                              split, grid_x, chunk, taps, smem_bytes, bf16,
                              st)
             : launch_tile<4>(f1, f2, out, N, C, H, W, s, Ho, Wo, tiles_x,
                              split, grid_x, chunk, taps, smem_bytes, bf16,
                              st);
}
