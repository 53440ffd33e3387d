// NSF sine excitation from frame-rate F0, one launch and no scratch:
//
//   rad[f]   = (f0[f] / sr) mod 1
//   phase    = prefix[f] + rad[f] * (s + 1)      sample s in [0, hop) of frame f
//   prefix[f]= sum_{f' < f} hop * rad[f']        (exclusive, taken mod 1)
//   out      = amp * sin(2 pi phase) if f0[f] > 0 else 0
//
// Replaces the TPU kernel svcc23_fastsvc_tpu/ops/pallas_kernels.py
// sine_excitation (_sine_kernel). That kernel walks 128-frame time blocks in
// grid order and carries the running phase from one block to the next in
// VMEM scratch. Blocks on the H100 run in no order, so nothing carries over.
//
// Here each block of threads owns a tile of `tile` frames of one row and
// finds the tile's exclusive prefix itself: its threads sum the increments
// hop * rad of the frames before the tile (in f64, each reduced mod 1
// first), thread t taking frames t, t + 512, ..., and the block adds the
// threads' sums in a fixed tree. Warp 0 then scans the tile's own
// increments and writes prefix[f] (mod 1, as f32) to shared memory, and
// every thread writes samples. The order of every sum depends on the shape
// alone, so two calls give the same bits; no block waits on another (a
// decoupled look-back would make the f64 sums depend on the schedule).
//
// Reducing mod 1 keeps the f32 phase below 2 and so exact to ~1e-7 cycles
// at any length; the sine is periodic, so nothing changes but the rounding,
// which is the plain version's: products rounded on their own (__fmul_rn,
// __fadd_rn, where the compiler would otherwise fuse an FMA) and
// sinf(phase * 2 pi) * amp.
//
// What bounds it on the H100: the bytes of the output, 4 a sample (f0 is
// 1/hop of that), in principle. Where hop % 4 == 0 (160 in both recipes) a
// thread writes 4 consecutive samples of one frame as one 16-byte store;
// any other hop takes a scalar path in the same kernel. The host picks the
// tile (`sine_tile_frames`): at least 8 frames, grown so the grid stays
// near 4 blocks per SM of 132, at most 256. So (8, 400), (32, 100) and
// (8, 150) frames at hop 160 run 400, 416 and 152 blocks of 8 frames, and
// (8, 3000), a 30 s bucket, 504 blocks of 48, whose re-summed prefixes read
// 0.75 M frames (3 MB, from L2) beside 3.84 M samples (15.4 MB) written.
// In practice the stores are not what it waits on: on the H100 at (8,
// 3000) a variant without the stores took as long, and variants without the
// prefix sums (a division and an f64 add a frame, re-done by every later
// tile) or with __sinf in place of sinf each took about a quarter less.
// Of 128, 256 and 512 threads a block, 512 was fastest; grids of 2 or 8
// blocks per SM were slower than 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinTile = 8;
constexpr int kMaxTile = 256;
constexpr int kTargetBlocks = 4 * 132;
static_assert(kMaxTile <= kThreads, "a thread loads each frame of a tile");

__device__ __forceinline__ float frac(float v) { return v - floorf(v); }

__device__ __forceinline__ double increment(float rad, int hop) {
  return (double)frac(__fmul_rn((float)hop, rad));
}

__device__ __forceinline__ float sample(float pre, float rad, int s, float v,
                                        float amp) {
  const float phase = __fadd_rn(pre, __fmul_rn(rad, (float)s));
  return v > 0.f ? sinf(phase * 6.283185307179586f) * amp : 0.f;
}

__device__ __forceinline__ double warp_inclusive_scan(double v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // in lane 0
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
sine_kernel(const float* __restrict__ f0, float* __restrict__ out, int Tf,
            int hop, int tile, float sr, float amp) {
  __shared__ double warp_sums[kWarps];
  __shared__ float s_f0[kMaxTile], s_rad[kMaxTile], s_pre[kMaxTile];
  const int b = blockIdx.y;
  const int f_begin = blockIdx.x * tile;
  const int nf = min(tile, Tf - f_begin);
  const float* row = f0 + (size_t)b * Tf;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the tile's own frames (nf <= kThreads), loaded first to overlap the sum
  const float own = threadIdx.x < nf ? row[f_begin + threadIdx.x] : 0.f;

  // the increments of the frames before the tile, summed in a fixed order
  double s = 0.0;
  for (int f = threadIdx.x; f < f_begin; f += kThreads)
    s += increment(frac(row[f] / sr), hop);
  s = warp_sum(s);
  if (lane == 0) warp_sums[warp] = s;
  if (threadIdx.x < nf) {
    s_f0[threadIdx.x] = own;
    s_rad[threadIdx.x] = frac(own / sr);
  }
  __syncthreads();

  // warp 0: the tile's exclusive prefix, frame by frame
  if (warp == 0) {
    double base = warp_sum(lane < kWarps ? warp_sums[lane] : 0.0);
    base = __shfl_sync(0xffffffffu, base, 0);
    for (int c = 0; c < nf; c += 32) {
      const int f = c + lane;
      const double inc = f < nf ? increment(s_rad[f], hop) : 0.0;
      const double incl = warp_inclusive_scan(inc, lane);
      const double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      double p = base + (lane > 0 ? excl : 0.0);
      p -= floor(p);
      if (f < nf) s_pre[f] = (float)p;
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();

  float* ob = out + (size_t)b * Tf * hop + (size_t)f_begin * hop;
  if (kVec4) {
    const int hop4 = hop >> 2;
    float4* ob4 = reinterpret_cast<float4*>(ob);
    for (int i = threadIdx.x; i < nf * hop4; i += kThreads) {
      const int f = i / hop4, s0 = (i - f * hop4) * 4;
      const float v = s_f0[f], rad = s_rad[f], pre = s_pre[f];
      float4 o;
      o.x = sample(pre, rad, s0 + 1, v, amp);
      o.y = sample(pre, rad, s0 + 2, v, amp);
      o.z = sample(pre, rad, s0 + 3, v, amp);
      o.w = sample(pre, rad, s0 + 4, v, amp);
      ob4[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < nf * hop; i += kThreads) {
      const int f = i / hop;
      ob[i] = sample(s_pre[f], s_rad[f], i - f * hop + 1, s_f0[f], amp);
    }
  }
}

}  // namespace

// Frames a block of threads takes at (B, Tf): the grid near kTargetBlocks,
// each tile at least kMinTile and at most kMaxTile frames.
extern "C" int sine_tile_frames(int B, int Tf) {
  const long long want =
      ((long long)B * Tf + kTargetBlocks - 1) / kTargetBlocks;
  const int tile = (int)((want + kMinTile - 1) / kMinTile) * kMinTile;
  return tile < kMinTile ? kMinTile : tile > kMaxTile ? kMaxTile : tile;
}

// f0 (B, Tf) f32 contiguous -> out (B, Tf * hop) f32 contiguous.
extern "C" int sine_excitation_f32(const void* f0, void* out, int B, int Tf,
                                   int hop, float sr, float amp,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = sine_tile_frames(B, Tf);
  const dim3 grid((Tf + tile - 1) / tile, B);
  const float* in = static_cast<const float*>(f0);
  float* o = static_cast<float*>(out);
  if (hop % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0)
    sine_kernel<true><<<grid, kThreads, 0, s>>>(in, o, Tf, hop, tile, sr, amp);
  else
    sine_kernel<false><<<grid, kThreads, 0, s>>>(in, o, Tf, hop, tile, sr,
                                                 amp);
  return (int)cudaGetLastError();
}
