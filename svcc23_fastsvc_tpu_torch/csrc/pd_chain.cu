// A chain of K fixed gated blocks of the HN-uSFGAN vocoder in one kernel:
// block j is the reflect-padded K=3 conv at dilation d_j of pd_block.cu's
// fixed block (its math and arithmetic: pd_block.cuh), applied to block
// j-1's output, with every stage's reflect padding.
//
// Replaces the TPU kernel svcc23_fastsvc_tpu/ops/pallas_pd_block.py
// pd_fixed_chain (_chain_kernel). That kernel keeps the K-1 intermediate
// streams in VMEM: it builds one [halo | tile | halo] window per tile with
// 32-aligned stage offsets (Mosaic's sublane rule; a 160-row halo for the
// (1, 2, 4, 8, 16) prefix), splices host-made reflected edge blocks into
// the first stage and rewrites each later stage's out-of-range rows by an
// antidiagonal-matmul flip. On the H100 the 227 KB of shared memory a block
// of threads has hold one block's weights and its row tiles, not K blocks'
// weights beside K streams, so the stages take turns instead:
//
// * Persistent, one block of threads per SM, each with its own run of the
//   flattened (B * T) rows, `seg_rows` long (a run that crosses utterances
//   is cut into pieces, one per utterance). It applies stage 0 to all of its
//   rows, then stage 1, ...: each stage is one walk of pd_block.cuh (the
//   per-block kernels' own code: mma_walk in bf16, ffma_walk in f32,
//   wide_walk at widths neither holds, as block_plan picks), so it gives
//   the per-block kernels' bits; in the mma and ffma walks the stage loads
//   its block's weights into shared memory once a launch and keeps the
//   next tile's rows and c in flight while a tile computes.
// * The intermediate streams go to a scratch of the block's own in device
//   memory (two ping-pong regions of `region_rows` rows; most of it stays
//   in L2), read back by the next stage's gather exactly as a block kernel
//   reads x. Stage j computes the rows of each piece that the later stages
//   still read, [t0 - H_j, t1 + H_j) inside [0, T) (H_j the sum of the
//   later dilations), and a tap past either end reads the reflected row
//   (-k -> k, T-1+k -> T-1-k), which lies among the rows stage j-1
//   computed; so no row outside [0, T) is ever formed, the reference's
//   per-stage ReflectionPad1d holds by construction, and any reach is
//   taken: the halo rows a block of threads computes twice over are 2 H_j a
//   piece and stage, against its ~1455 rows at 8 x 24000.
//
// What bounds it on the H100: as the block, K times (bf16: the bytes of
// x, c and y once, 0.071 ms at 8 x 24000, R 64, G 128, A 62, with the
// operations at 0.07 ms; f32: the operations, 1.05 ms). What it saves over
// K per-block launches is K-1 launches, their grids' tails and their
// prologues; what it pays is the halo rows.

#include "pd_block.cuh"

namespace {

constexpr int kMaxChain = 16;  // MAX_CHAIN in ops/pd_block.py

}  // namespace

// Every field is 8 bytes, in the order of ops/pd_block.py's _ChainArgs.
struct PdChainArgs {
  const void* x;
  const void* c;
  void* y;
  void* scratch;  // n_blocks x 2 regions of region_rows x R, x's type
  void* zbuf;     // the wide variant's: n_blocks x 64 x G/2, x's type
  long long B, T, R, A, G, K;
  long long variant, tile_rows, n_blocks, seg_rows, region_rows;  // chain_plan
  long long dil[kMaxChain];
  PdBlockWeights blk[kMaxChain];
};

namespace {

// The tiles of stage j over this block's run [u0, u1) of the flattened
// rows: the rows [u0 - rem, u1 + rem), cut at the run's first and last
// utterances' ends (inside the run an utterance's end needs no halo: the
// taps reflect), `rows` at a time. Row u of the stage's input and output
// streams is in the scratch at region + u - (u0 - reach); stage 0 reads x,
// the last writes y (offsets 0).
struct ChainTiles {
  long long lo, hi, src_off, dst_off;
  int rows, T;
  __device__ PdTile operator()(int i) const {
    const long long u = lo + (long long)i * rows;
    const int b = (int)(u / T);
    return PdTile{b, (int)(u - (long long)b * T),
                  (int)min((long long)rows, hi - u), src_off, dst_off};
  }
  __device__ int count() const { return (int)((hi - lo + rows - 1) / rows); }
};

// The stages in turn over this block's run of rows: each one walk (the
// variant's) from x or the scratch region the previous stage wrote into the
// other region, the last one into y.
template <typename T, int kVariant>
__device__ __forceinline__ void chain_stages(const PdChainArgs& p, void* smem) {
  const long long total = p.B * p.T;
  const long long u0 = blockIdx.x * p.seg_rows;
  const long long u1 = min(total, u0 + p.seg_rows);
  if (u0 >= u1) return;
  const int K = (int)p.K;
  int reach = 0;
  for (int j = 0; j < K; ++j) reach += (int)p.dil[j];
  T* scratch = static_cast<T*>(p.scratch);
  // this block's two regions, in rows of the scratch
  const long long region0 = (long long)blockIdx.x * 2 * p.region_rows;
  // the first row of the run's first utterance, and the end of its last
  const long long t_lo = u0 / p.T * p.T, t_hi = (u1 + p.T - 1) / p.T * p.T;
  // scratch row of flattened row u in region 0 or 1: region + u - slot0
  const long long slot0 = u0 - reach;
  int rem = reach;
  for (int j = 0; j < K; ++j) {
    const int d = (int)p.dil[j];
    rem -= d;
    const bool first = j == 0, last = j == K - 1;
    const ChainTiles tiles{
        max(t_lo, u0 - rem), min(t_hi, u1 + rem),
        first ? 0 : region0 + ((j + 1) & 1) * p.region_rows - slot0,
        last ? 0 : region0 + (j & 1) * p.region_rows - slot0,
        kVariant == kPdMma ? kMmaRows : kVariant == kPdFfma ? kFfRows : kWdRows,
        (int)p.T};
    const PdWalk w{first ? p.x : scratch, last ? p.y : scratch, p.c, nullptr,
                   (int)p.T, (int)p.R, (int)p.A, (int)p.G / 2, 1, 0, d,
                   p.zbuf};
    if constexpr (kVariant == kPdMma)
      mma_walk<false, true>(w, p.blk[j], tiles, tiles.count(),
                            static_cast<unsigned char*>(smem));
    else if constexpr (kVariant == kPdFfma)
      ffma_walk<T, false, true>(w, p.blk[j], tiles, tiles.count(),
                                static_cast<float*>(smem));
    else
      wide_walk<T, false, true>(w, p.blk[j], tiles, tiles.count(),
                                static_cast<unsigned char*>(smem));
    // this stage's rows, stored by any thread, before the next stage's
    // gathers read them
    __threadfence_block();
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
pd_chain_mma_kernel(const __grid_constant__ PdChainArgs p) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  chain_stages<bf16, kPdMma>(p, chain_smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
pd_chain_ffma_kernel(const __grid_constant__ PdChainArgs p) {
  extern __shared__ float4 chain_smem4[];
  chain_stages<T, kPdFfma>(p, chain_smem4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
pd_chain_wide_kernel(const __grid_constant__ PdChainArgs p) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  chain_stages<T, kPdWide>(p, chain_smem);
}

// The plan (chain_plan) names the variant, its tile rows, the grid, the run
// each block of threads takes and its scratch regions; anything else, an
// mma or ffma variant for widths its walk does not hold, or a wide one
// without its z scratch, is refused before any launch.
template <typename T>
int launch_chain(const PdChainArgs* a, void* stream) {
  if (a->R < 1 || a->G < 2 || a->G % 2 || a->A < 0 || a->R > (1 << 20) ||
      a->A > (1 << 20) || a->G > (1 << 20) || a->T < 1 || a->B < 1 ||
      a->K < 1 || a->K > kMaxChain || a->n_blocks < 1 || a->seg_rows < 1 ||
      a->n_blocks * a->seg_rows < a->B * a->T ||
      (a->K > 1 && a->scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  long long reach = 0;
  for (int j = 0; j < (int)a->K; ++j) {
    if (a->dil[j] < 1 || a->T <= a->dil[j] || a->blk[j].bg[0] == nullptr)
      return (int)cudaErrorInvalidValue;
    reach += a->dil[j];
  }
  if (a->region_rows < a->seg_rows + 2 * reach) return (int)cudaErrorInvalidValue;
  const bool held = a->R <= kMaxR && a->G / 2 <= kMaxHalf &&
                    3 * a->R + a->A <= kMaxFeatures;
  const int variant = (int)a->variant, tile_rows = (int)a->tile_rows;
  const int R = (int)a->R, A = (int)a->A;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)a->n_blocks);
  if (variant == kPdMma && tile_rows == 128) {
    if constexpr (sizeof(T) == 2) {
      if (R % 8 || !held) return (int)cudaErrorInvalidValue;
      auto kern = pd_chain_mma_kernel;
      const size_t smem = mma_smem_bytes(R, A);
      if (int e = prepare(kern, smem)) return e;
      kern<<<grid, kThreads, smem, s>>>(*a);
      return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;
  }
  if (variant == kPdFfma && tile_rows == 256) {
    if (!held) return (int)cudaErrorInvalidValue;
    auto kern = pd_chain_ffma_kernel<T>;
    const size_t smem = ffma_smem_bytes(R, A);
    if (int e = prepare(kern, smem)) return e;
    kern<<<grid, kThreads, smem, s>>>(*a);
    return (int)cudaGetLastError();
  }
  if (variant == kPdWide && tile_rows == 64) {
    if (a->zbuf == nullptr) return (int)cudaErrorInvalidValue;
    auto kern = pd_chain_wide_kernel<T>;
    const size_t smem = wide_smem_bytes();
    if (int e = prepare(kern, smem)) return e;
    kern<<<grid, kThreads, smem, s>>>(*a);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pd_fixed_chain_f32(const PdChainArgs* a, void* stream) {
  return launch_chain<float>(a, stream);
}
extern "C" int pd_fixed_chain_bf16(const PdChainArgs* a, void* stream) {
  return launch_chain<__nv_bfloat16>(a, stream);
}
