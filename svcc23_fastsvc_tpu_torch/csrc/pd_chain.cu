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
// antidiagonal-matmul flip. Here one block of threads takes one (batch,
// tile of S rows) and keeps the stream rows [t0 - H, t0 + S + H) in shared
// memory, H = sum of d_j, the exact reach (31 rows for (1, 2, 4, 8, 16), 5
// for five d=1 blocks). Stage j computes only rows inside [0, T): the rows
// [t0 - H_j, t0 + S + H_j) that the later stages still read (H_j = the sum
// of the later dilations), and a tap past either end reads the reflected
// row (-k -> k, T-1+k -> T-1-k), which always lies inside the rows stage
// j-1 computed. So no row outside [0, T) is ever formed, and the reference's
// per-stage ReflectionPad1d holds by construction. Each stage's output is
// rounded to the stream type as it is stored (the JAX kernel keeps its
// intermediates in x's dtype), and each stage runs the routine of the
// variant the per-block kernels run at these widths (ops/pd_block.py::
// block_plan, passed in the arguments): so the chain gives the bits of the
// blocks applied one after another, in f32 and in bf16.
//
// * ffma (f32, and bf16 widened): pd_block.cuh's gated_block_rows on f32
//   stream buffers; each 128-row group stages its inputs and each 32
//   features' weights in shared memory.
// * mma (bf16, R a multiple of 8): pd_block.cuh's mma_block_rows on bf16
//   stream buffers. A stage loads its block's weights into shared memory
//   once (stage_weights), and ldmatrix reads each row's three taps
//   straight from the buffer rows (a zero row where a tap reads zero); a
//   group's c rows are staged in the c features' place.
// The conditioning c is read from device memory (L2) by every stage.
//
// What bounds it on the H100: as the block, the operations (K blocks'
// worth) in f32 FFMA, or in bf16 the bytes of x, c and y once. What it
// saves over K per-block launches is the K-1 round trips of the stream
// through device memory; what it pays is the halo rows each stage
// recomputes (S + 2 H_j rows, computed in groups of 128), each stage's
// weight load in every block, and one block of threads per SM (two
// ping-pong stream buffers of (S + 2H) x R beside the weights or the
// staging area). The tile S is chosen at launch to waste the fewest row
// groups per output row.

#include <algorithm>

#include "pd_block.cuh"

namespace {

constexpr int kMaxChain = 16;  // MAX_CHAIN in ops/pd_block.py
constexpr int kMaxReach = 159;  // MAX_CHAIN_REACH: S >= 32 at R = 64
constexpr int kMinTile = 32;
constexpr int kMaxTile = 1024;

}  // namespace

// Every field is 8 bytes, in the order of ops/pd_block.py's _ChainArgs.
struct PdChainArgs {
  const void* x;
  const void* c;
  void* y;
  long long B, T, R, A, G, K;
  long long variant;  // block_plan's variant at these widths
  long long dil[kMaxChain];
  PdBlockWeights blk[kMaxChain];
};

namespace {

// rows of one stage in shared memory: group row r is stream row t0 + r,
// buffer row s is stream row base + s; the last stage stores to y
template <typename T>
struct SharedRows {
  const float* in;
  float* out;
  T* y;
  const T* c;
  int t0, hi, base, R, A;
  __device__ float tap(int s, int f) const { return in[s * R + f]; }
  __device__ bool valid(int r) const { return t0 + r < hi; }
  __device__ float aux(int r, int a) const {
    return to_f32(c[(size_t)(t0 + r) * A + a]);
  }
  __device__ float resid(int r, int o) const {
    return in[(t0 + r - base) * R + o];
  }
  __device__ void store(int r, int o, float v) const {
    if (y != nullptr)
      y[(size_t)(t0 + r) * R + o] = from_f32<T>(v);
    else
      out[(t0 + r - base) * R + o] = round_to<T>(v);
  }
};

size_t chain_smem_bytes(int S, int reach, int R) {
  return kSmemBytes + 2 * (size_t)(S + 2 * reach) * R * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
pd_chain_kernel(const __grid_constant__ PdChainArgs p, int S, int reach) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* src = reinterpret_cast<int*>(smem + kSmemFloats);  // [3][kRows], -1 reads 0
  const int T_len = (int)p.T, R = (int)p.R, A = (int)p.A, K = (int)p.K;
  float* buf[2];
  buf[0] = reinterpret_cast<float*>(src + 3 * kRows);
  buf[1] = buf[0] + (S + 2 * reach) * R;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * S;
  const int base = t0 - reach;  // stream row of buffer row 0
  const T* x = static_cast<const T*>(p.x) + (size_t)b * T_len * R;
  const T* c = static_cast<const T*>(p.c) + (size_t)b * T_len * A;
  T* y = static_cast<T*>(p.y) + (size_t)b * T_len * R;

  // the input rows every stage depends on, inside [0, T)
  const int lo_in = max(0, base), hi_in = min(T_len, t0 + S + reach);
  for (int idx = threadIdx.x; idx < (hi_in - lo_in) * R; idx += kThreads) {
    const int t = lo_in + idx / R, f = idx % R;
    buf[0][(t - base) * R + f] = to_f32(x[(size_t)t * R + f]);
  }
  int rem = reach;
  for (int j = 0; j < K; ++j) {
    const int d = (int)p.dil[j];
    rem -= d;
    const int lo = max(0, t0 - rem), hi = min(T_len, t0 + S + rem);
    const bool last = j == K - 1;
    for (int g0 = lo; g0 < hi; g0 += kRows) {
      // the previous call ended on a barrier after its last read of src
      for (int r = threadIdx.x; r < kRows; r += kThreads) {
        const int t = g0 + r;
        int m = -1, q = -1, n = -1;
        if (t < hi) {
          m = reflect_lo(t, d) - base;
          q = t - base;
          n = reflect_hi(t, d, T_len) - base;
        }
        src[r] = m;
        src[kRows + r] = q;
        src[2 * kRows + r] = n;
      }
      const SharedRows<T> rows{buf[j & 1], buf[(j + 1) & 1],
                               last ? y : nullptr, c, g0, hi, base, R, A};
      gated_block_rows<T>(p.blk[j], rows, R, A, (int)p.G / 2, smem, src);
    }
  }
}

// ---- mma (bf16) ---------------------------------------------------------

// a group's c rows: the c features' place, padded to an odd number of
// 16-byte units
__host__ __device__ constexpr int chain_c_ld(int R, int A) {
  return (mma_kp(R, A) - 3 * R) / 8 % 2 ? mma_kp(R, A) - 3 * R
                                        : mma_kp(R, A) - 3 * R + 8;
}
// stream buffer rows, the same way
__host__ __device__ constexpr int chain_b_ld(int R) { return R / 8 % 2 ? R : R + 8; }

// the weights, biases, a group's c rows and a zero row
size_t chain_mma_fixed_bytes(int R, int A) {
  return (size_t)kGateRows * mma_ld(R, A) * sizeof(bf16) +
         (size_t)kMaxR * kOutLd * sizeof(bf16) +
         (size_t)(kGateRows + kMaxR) * sizeof(float) +
         (size_t)kMmaRows * chain_c_ld(R, A) * sizeof(bf16) + 16;
}

__global__ void __launch_bounds__(kThreads, 1)
pd_chain_mma_kernel(const __grid_constant__ PdChainArgs p, int S, int reach) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const int T_len = (int)p.T, R = (int)p.R, A = (int)p.A, K = (int)p.K;
  const int G2 = (int)p.G / 2, KP = mma_kp(R, A), ld = mma_ld(R, A);
  const int cld = chain_c_ld(R, A), ldb = chain_b_ld(R);
  bf16* wg = reinterpret_cast<bf16*>(chain_smem);  // [kGateRows][ld]
  bf16* wo = wg + kGateRows * ld;                  // [kMaxR][kOutLd]
  float* bg_s = reinterpret_cast<float*>(wo + kMaxR * kOutLd);
  float* bo_s = bg_s + kGateRows;
  bf16* cst = reinterpret_cast<bf16*>(bo_s + kMaxR);  // [kMmaRows][cld]
  bf16* zrow = cst + kMmaRows * cld;                  // 8 zeros
  bf16* buf[2];
  buf[0] = zrow + 8;  // [S + 2 reach][ldb]
  buf[1] = buf[0] + (S + 2 * reach) * ldb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * S;
  const int base = t0 - reach;  // stream row of buffer row 0
  const bf16* x = static_cast<const bf16*>(p.x) + (size_t)b * T_len * R;
  const bf16* c = static_cast<const bf16*>(p.c) + (size_t)b * T_len * A;
  bf16* y = static_cast<bf16*>(p.y) + (size_t)b * T_len * R;

  if (tid < 8) zrow[tid] = __float2bfloat16(0.f);
  // the input rows every stage depends on, inside [0, T), 16 bytes a copy
  const int lo_in = max(0, base), hi_in = min(T_len, t0 + S + reach);
  const int units = R / 8;
  for (int idx = tid; idx < (hi_in - lo_in) * units; idx += kThreads) {
    const int t = lo_in + idx / units, u = idx % units;
    *reinterpret_cast<uint4*>(buf[0] + (t - base) * ldb + u * 8) =
        *reinterpret_cast<const uint4*>(x + (size_t)t * R + u * 8);
  }
  const int creg = KP - 3 * R;  // c's features and their zero padding
  const int fo = (lane >> 4) * 8;  // the lane's feature offset in a k16 step
  int rem = reach;
  for (int j = 0; j < K; ++j) {
    const int d = (int)p.dil[j];
    rem -= d;
    const int lo = max(0, t0 - rem), hi = min(T_len, t0 + S + rem);
    const bool last = j == K - 1;
    const bf16* in = buf[j & 1];
    bf16* out = buf[(j + 1) & 1];
    // every read of the previous stage's weights is done
    __syncthreads();
    stage_weights<bf16, bf16, true>(p.blk[j], R, A, G2, KP, ld, kOutLd, wg, wo,
                                    bg_s, bo_s);
    for (int g0 = lo; g0 < hi; g0 += kMmaRows) {
      for (int idx = tid; idx < kMmaRows * creg; idx += kThreads) {
        const int r = idx / creg, e = idx - r * creg, t = g0 + r;
        cst[r * cld + e] = t < hi && e < A ? c[(size_t)t * A + e]
                                           : __float2bfloat16(0.f);
      }
      __syncthreads();
      const int rw = g0 + warp * 16;  // the warp's first row
      if (rw < hi) {
        // the lane's A row: its three taps' buffer rows (-1 reads zero)
        const int t = rw + (lane & 15);
        int sm = -1, sc = -1, sp = -1;
        if (t < hi) {
          sm = reflect_lo(t, d) - base;
          sc = t - base;
          sp = reflect_hi(t, d, T_len) - base;
        }
        const bf16* crow = cst + (warp * 16 + (lane & 15)) * cld;
        mma_block_rows(
            wg, ld, KP, wo, bg_s, bo_s, R, G2,
            [&](int kc) -> const bf16* {
              const int f = kc + fo;
              if (f >= 3 * R) return crow + (f - 3 * R);
              const int tap = f / R, sr = tap == 0 ? sm : tap == 1 ? sc : sp;
              return sr >= 0 ? in + sr * ldb + (f - tap * R) : zrow;
            },
            [&](int rr, int o) {
              const bf16* row = in + (min(rw + rr, hi - 1) - base) * ldb + o;
              return make_float2(to_f32(row[0]), to_f32(row[1]));
            },
            [&](int rr, int o, float v0, float v1) {
              const int tt = rw + rr;
              if (tt >= hi) return;
              bf16* to = last ? y + (size_t)tt * R + o : out + (tt - base) * ldb + o;
              *reinterpret_cast<__nv_bfloat162*>(to) = __floats2bfloat162_rn(v0, v1);
            });
      }
      // the group's c rows and the stage's rows are read no more
      __syncthreads();
    }
  }
}

// ---- launches ----------------------------------------------------------

// The tile: the S in [kMinTile, min(kMaxTile, the largest that fits)] that
// computes the fewest 128-row groups per output row (the larger on a tie),
// with `room` bytes of shared memory for two buffers of rows of `row_bytes`.
int chain_tile(const PdChainArgs* a, int reach, size_t room, size_t row_bytes) {
  const int s_max = std::min(kMaxTile, (int)(room / (2 * row_bytes)) - 2 * reach);
  int best = 0;
  double best_cost = 0.0;
  for (int S = kMinTile; S <= s_max; ++S) {
    long long groups = 0;
    int rem = reach;
    for (int j = 0; j < (int)a->K; ++j) {
      rem -= (int)a->dil[j];
      groups += (S + 2 * rem + kRows - 1) / kRows;
    }
    const double cost = (double)groups / S;
    if (best == 0 || cost <= best_cost) {
      best = S;
      best_cost = cost;
    }
  }
  return best;
}

template <typename Kern>
int launch_kernel(Kern kern, const PdChainArgs* a, int S, int reach,
                  size_t smem, void* stream) {
  if (S < kMinTile || smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((a->T + S - 1) / S), (unsigned)a->B);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*a, S, reach);
  return (int)cudaGetLastError();
}

// The variant is the per-block kernels' at these widths; anything else, or
// an mma variant for widths it does not take, is refused before any launch.
template <typename T>
int launch_chain(const PdChainArgs* a, void* stream) {
  if (a->R < 1 || a->R > kMaxR || a->G < 2 || a->G % 2 || a->G / 2 > kMaxHalf ||
      a->A < 0 || a->T < 1 || a->B < 1 || a->K < 1 || a->K > kMaxChain)
    return (int)cudaErrorInvalidValue;
  int reach = 0;
  for (int j = 0; j < (int)a->K; ++j) {
    if (a->dil[j] < 1 || a->T <= a->dil[j] || a->blk[j].bg[0] == nullptr)
      return (int)cudaErrorInvalidValue;
    reach += (int)a->dil[j];
  }
  if (reach > kMaxReach) return (int)cudaErrorInvalidValue;
  const int R = (int)a->R, A = (int)a->A;
  if (a->variant == kPdMma) {
    if (sizeof(T) != 2 || R % 8 || mma_kp(R, A) > kMaxKp)
      return (int)cudaErrorInvalidValue;
    const size_t fixed = chain_mma_fixed_bytes(R, A);
    if (fixed >= kMaxSmemBytes) return (int)cudaErrorInvalidValue;
    const size_t row_bytes = chain_b_ld(R) * sizeof(bf16);
    const int S = chain_tile(a, reach, kMaxSmemBytes - fixed, row_bytes);
    return launch_kernel(pd_chain_mma_kernel, a, S, reach,
                         fixed + 2 * (S + 2 * reach) * row_bytes, stream);
  }
  if (a->variant == kPdFfma) {
    const int S = chain_tile(a, reach, kMaxSmemBytes - kSmemBytes,
                             R * sizeof(float));
    return launch_kernel(pd_chain_kernel<T>, a, S, reach,
                         chain_smem_bytes(S, reach, R), stream);
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
