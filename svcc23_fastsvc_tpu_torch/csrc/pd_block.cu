// Gated residual blocks of the HN-uSFGAN vocoder, one kernel per block. On
// channels-last (B, T, R) x and (B, T, A) c:
//
//   h[t] = x[m(t)] @ Wm + x[t] @ Wc + x[p(t)] @ Wp + c[t] @ Wa + bg   (G wide)
//   z[t] = tanh(h[t, :G/2]) * sigmoid(h[t, G/2:])    rounded to x's type
//   y[t] = (z[t] @ Wo + bo + x[t]) * sqrt(0.5)        cast to x's type
//
// The two side taps m(t), p(t) are, per kernel:
//
// - adaptive block (pd_adaptive_block_*): m = t - s, p = t + s, s the
//   pitch shift of t's frame (shifts (B, T / hop) int32, clamped to
//   [0, halo] by the caller); a tap outside [0, T) reads zero, for any s.
//   Wm, Wc, Wp are the convP, convC, convF weights and bg = (bC + bP) + bF,
//   summed in the parameter type.
// - fixed block (pd_fixed_block_*): m = t - dil, p = t + dil, reflected at
//   both ends (-k -> k, T-1+k -> T-1-k; needs T > dil): the reflect-padded
//   K=3 dilated conv, its three taps Wm, Wc, Wp.
//
// Replaces the TPU kernels svcc23_fastsvc_tpu/ops/pallas_pd_block.py
// pd_adaptive_block (_kernel, "roll" and "mxu" gathers) and pd_fixed_block
// (_fixed_kernel). Those assemble a [halo | tile | halo] window in VMEM and
// gather the shifted rows by 16-aligned slices plus a roll or a one-hot
// matmul, because Mosaic needs 8-aligned sublane starts; the fixed kernel
// splices host-made reflected edge blocks into it. None of that is needed
// here: a block works out each row's source row for each tap (reflected or
// masked) and copies those rows of x straight from device memory (L2 holds
// x), so there is no halo, no alignment rule and no edge block.
//
// What bounds it on the H100, at 8 x 24000 rows, R 64, G 128, A 62: in
// bf16 the bytes of x, c and y (0.022 ms at 3.35 TB/s; the operations,
// 2 * ((3R + A) * G + G/2 * R) a row, take 0.014 ms at the tensor cores'
// 989 TFLOP/s), in f32 the operations on the CUDA cores (0.21 ms at 67
// TFLOP/s). Both variants are persistent: a grid of one block per SM loads
// the block's weights into shared memory once, in the layout the inner
// loop reads (pd_block.cuh's stage_weights, overlapping the first tile's
// gather), and walks row tiles, the next tile's gather in flight
// (cp.async, zero-filled for taps that read zero) while this one computes.
// Which variant and tile run is ops/pd_block.py::block_plan's choice, from
// dtype and widths alone; the entries refuse a plan no instance here takes.
//
// The three walks are pd_block.cuh's mma_walk (bf16, R a multiple of 8,
// where its shared memory holds the widths: 128-row tiles on the tensor
// cores), ffma_walk (f32, and bf16 at other widths: 256-row tiles, FFMA,
// the features summed in order with the bias first, as the chain's stages
// sum them) and, for widths neither holds (R > 64, G > 128 or 3R + A >
// 272: the whole gate weight in shared memory bounds them), wide_walk (64-
// row tiles, the weights streamed in chunks, z through a per-block scratch
// `zbuf`; the ffma walk's arithmetic). A kernel here walks the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... of x -> y.

#include "pd_block.cuh"

// Every field is 8 bytes, in the order of ops/pd_block.py's _Args, so the
// ctypes structure has the same layout.
struct PdBlockArgs {
  const void* x;
  const void* c;
  const void* shifts;
  PdBlockWeights wt;
  void* y;
  void* zbuf;  // the wide variant's: n_blocks x 64 x G/2 of x's type
  long long B, T, R, A, G, hop, n_frames, dil;
  long long variant, tile_rows, n_blocks;  // the plan (block_plan)
};

namespace {

static_assert(((kMaxFeatures + 15) & ~15) <= kMaxKp, "stage_weights' reach");

// the walk of a block kernel: x -> y at the block's dilation or shifts
inline __device__ PdWalk block_walk(const PdBlockArgs& p) {
  return PdWalk{p.x, p.y, p.c, static_cast<const int*>(p.shifts), (int)p.T,
                (int)p.R, (int)p.A, (int)p.G / 2, (int)p.hop, (int)p.n_frames,
                (int)p.dil, p.zbuf};
}

// tiles blockIdx.x, blockIdx.x + gridDim.x, ... of `rows` rows over every
// utterance (B * T < 2^31: the wrapper's rule), and how many there are
struct GridTiles {
  int T, rows, n_tt;
  __device__ PdTile operator()(int i) const {
    const int j = blockIdx.x + i * gridDim.x;
    const int b = j / n_tt, t0 = (j - b * n_tt) * rows;
    return PdTile{b, t0, min(rows, T - t0), 0, 0};
  }
};
inline __device__ GridTiles grid_tiles(const PdBlockArgs& p, int rows, int& n) {
  const int n_tt = (int)((p.T + rows - 1) / rows);
  const int n_tiles = (int)p.B * n_tt;
  n = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  return GridTiles{(int)p.T, rows, n_tt};
}

template <bool kAdaptive>
__global__ void __launch_bounds__(kThreads, 1)
pd_block_mma_kernel(const __grid_constant__ PdBlockArgs p) {
  extern __shared__ __align__(16) unsigned char pd_smem[];
  int n;
  const GridTiles tiles = grid_tiles(p, kMmaRows, n);
  mma_walk<kAdaptive, false>(block_walk(p), p.wt, tiles, n, pd_smem);
}

template <typename T, bool kAdaptive>
__global__ void __launch_bounds__(kThreads, 1)
pd_block_ffma_kernel(const __grid_constant__ PdBlockArgs p) {
  extern __shared__ float4 pd_smem4[];
  int n;
  const GridTiles tiles = grid_tiles(p, kFfRows, n);
  ffma_walk<T, kAdaptive, false>(block_walk(p), p.wt, tiles, n,
                          reinterpret_cast<float*>(pd_smem4));
}

template <typename T, bool kAdaptive>
__global__ void __launch_bounds__(kThreads, 1)
pd_block_wide_kernel(const __grid_constant__ PdBlockArgs p) {
  extern __shared__ __align__(16) unsigned char pd_smem[];
  int n;
  const GridTiles tiles = grid_tiles(p, kWdRows, n);
  wide_walk<T, kAdaptive, false>(block_walk(p), p.wt, tiles, n, pd_smem);
}

// ---- launches ----------------------------------------------------------

// The plan names the variant and its tile rows; anything else, an mma or
// ffma plan for widths its walk does not hold, or a wide plan without its
// scratch, is refused before any launch.
template <typename T, bool kAdaptive>
int launch(const PdBlockArgs* a, void* stream) {
  if (a->R < 1 || a->G < 2 || a->G % 2 || a->A < 0 || a->R > (1 << 20) ||
      a->A > (1 << 20) || a->G > (1 << 20) || a->T < 1 || a->B < 1 ||
      a->wt.bg[0] == nullptr || a->n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const bool held = a->R <= kMaxR && a->G / 2 <= kMaxHalf &&
                    3 * a->R + a->A <= kMaxFeatures;
  if (kAdaptive ? (a->hop < 1 || a->T % a->hop || a->n_frames != a->T / a->hop)
                : (a->dil < 1 || a->T <= a->dil))
    return (int)cudaErrorInvalidValue;
  const int variant = (int)a->variant, tile_rows = (int)a->tile_rows;
  const int R = (int)a->R, A = (int)a->A;
  // every block of threads has a tile (a walk takes at least one)
  if (tile_rows < 1 || a->n_blocks > a->B * ((a->T + tile_rows - 1) / tile_rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)a->n_blocks);
  if (variant == kPdMma && tile_rows == 128) {
    if constexpr (sizeof(T) == 2) {
      if (R % 8 || !held) return (int)cudaErrorInvalidValue;
      auto kern = pd_block_mma_kernel<kAdaptive>;
      const size_t smem = mma_smem_bytes(R, A);
      if (int e = prepare(kern, smem)) return e;
      kern<<<grid, kThreads, smem, s>>>(*a);
      return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;
  }
  if (variant == kPdFfma && tile_rows == 256) {
    if (!held) return (int)cudaErrorInvalidValue;
    auto kern = pd_block_ffma_kernel<T, kAdaptive>;
    const size_t smem = ffma_smem_bytes(R, A);
    if (int e = prepare(kern, smem)) return e;
    kern<<<grid, kThreads, smem, s>>>(*a);
    return (int)cudaGetLastError();
  }
  if (variant == kPdWide && tile_rows == 64) {
    if (a->zbuf == nullptr) return (int)cudaErrorInvalidValue;
    auto kern = pd_block_wide_kernel<T, kAdaptive>;
    const size_t smem = wide_smem_bytes();
    if (int e = prepare(kern, smem)) return e;
    kern<<<grid, kThreads, smem, s>>>(*a);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pd_adaptive_block_f32(const PdBlockArgs* a, void* stream) {
  return launch<float, true>(a, stream);
}
extern "C" int pd_adaptive_block_bf16(const PdBlockArgs* a, void* stream) {
  return launch<__nv_bfloat16, true>(a, stream);
}
extern "C" int pd_fixed_block_f32(const PdBlockArgs* a, void* stream) {
  return launch<float, false>(a, stream);
}
extern "C" int pd_fixed_block_bf16(const PdBlockArgs* a, void* stream) {
  return launch<__nv_bfloat16, false>(a, stream);
}
