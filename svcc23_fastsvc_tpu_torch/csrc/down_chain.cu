// One FastSVC DownsampleBlock forward in one kernel, channels-last, on the
// nearest-downsampled input x (B, T, Cin):
//
//   h1 = conv1(leaky(x)), h2 = conv2(leaky(h1)), h3 = conv3(leaky(h2))
//   y  = h3 + (x @ Wr + br)
//
// conv_j a K=3 "same" conv at dilation d_j (1, 2, 4) with zero padding,
// leaky slope 0.2 in f32 and rounded to x's type, sums in f32, each h_j
// rounded to x's type; the 1x1 residual stays f32 and is added to the
// rounded h3 before the one final rounding (the JAX kernel's order).
//
// Replaces the TPU kernel svcc23_fastsvc_tpu/ops/pallas_down_chain.py
// down_chain_fwd (_kernel). That kernel builds a [halo | tile | halo] VMEM
// window with 32-aligned stage offsets (a 96-row halo for (1, 2, 4)) and
// zeroes each stage's out-of-[0, T) rows by a position mask. Here one
// block of threads takes one (batch, tile of S rows) and keeps, in shared
// memory, the input rows [t0 - H, t0 + S + H) (H = d1 + d2 + d3 = 7, the
// exact reach; rows outside [0, T) are zero) and two stage buffers. Stage
// j computes the rows the later stages still read and stores them with
// their leaky already applied; a row outside [0, T) is stored as zero,
// which is the zero padding the next stage reads (the TPU kernel's pos_i
// mask). No T % 32 or T >= 2H rule is needed.
//
// What bounds it on the H100: the operations, 2 * 3 * (Cin + 2C) * C + 2 *
// Cin * C per row, in f32 FFMA (about 0.055 ms for each decode block of a
// batch of 8 x 4 s at the published 67 TFLOP/s, 700 W), or at C = 24 the
// bytes of x and y. Each pass is a register-tiled FFMA loop from shared
// memory (4 rows x 4 columns a thread; TCO columns and 32 input channels of
// the weight at a time in shared memory), as the window conv's. What it
// saves over three window-conv launches and a matmul is the round trips of
// the two intermediate streams and the residual through device memory; what
// it pays is the halo rows each stage recomputes, and weights read once per
// tile. The tile S is chosen at launch to waste the fewest row groups per
// output row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// Every field is 8 bytes, in the order of ops/down_chain.py's _Args. The
// weights are conv1, conv2, conv3 (K=3) and the residual (K=1), each a WIO
// (K, C_in, C) tensor addressed by element strides (sk, si, so).
struct DownChainArgs {
  const void* x;
  void* y;
  const void* w[4];
  long long w_sk[4], w_si[4], w_so[4];
  const void* b[4];
  long long B, T, Cin, C;
  long long dil[3];
};

namespace {

constexpr int kThreads = 256;
constexpr int kCI = 32;  // input channels per weight chunk
constexpr int kMinTile = 16;
constexpr int kMaxTile = 256;
constexpr int kMaxChannels = 192;  // MAX_CHANNELS in ops/down_chain.py
constexpr int kMaxReach = 32;      // MAX_REACH
constexpr size_t kMaxSmemBytes = 232448;
constexpr float kSlope = 0.2f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}
template <typename T> __device__ __forceinline__ float act(float v) {
  return round_to<T>(v >= 0.f ? v : kSlope * v);
}

// an odd row length, so that neighbouring rows fall in other banks
__host__ __device__ __forceinline__ int row_len(int c) { return c | 1; }

// stage 1-2 output: zero outside [0, T), else leaky(round(h)), rounded
template <typename T>
struct ActStore {
  float* out;
  int ld, base, T_len;
  __device__ void operator()(int w, int o, float v) const {
    const int t = base + w;
    out[w * ld + o] = t >= 0 && t < T_len ? act<T>(round_to<T>(v)) : 0.f;
  }
};

// stage 3 output: round(h3), read back by the residual pass
template <typename T>
struct PlainStore {
  float* out;
  int ld;
  __device__ void operator()(int w, int o, float v) const {
    out[w * ld + o] = round_to<T>(v);
  }
};

// the residual pass: y = round(h3 + residual), rows inside [0, T)
template <typename T>
struct OutStore {
  const float* h3;
  T* y;
  int ld, base, T_len, C;
  __device__ void operator()(int w, int o, float v) const {
    const int t = base + w;
    if (t < T_len) y[(size_t)t * C + o] = from_f32<T>(h3[w * ld + o] + v);
  }
};

// One conv over window rows [first, first + n) of C output columns: row w
// reads input rows w - (K-1)/2 * dil + k * dil of `in` (Cs channels, row
// length ld), activated on load when kAct. TCO columns per tile; TX
// threads across columns (4 each, strided by TX), TY across rows (4 each,
// strided by TY). Starts with a barrier, so a pass may read what the
// previous one stored.
template <typename T, int TCO, bool kAct, typename Store>
__device__ __forceinline__ void conv_pass(const float* in, int ld, int Cs, int K,
                                          int dil, int first, int n, int C,
                                          const T* w, long long sk, long long si,
                                          long long so, const T* bias,
                                          float* wsm, const Store& store) {
  constexpr int TX = TCO / 4;
  constexpr int TY = kThreads / TX;
  constexpr int TT = 4 * TY;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int lo = (K - 1) / 2 * dil;
  for (int g0 = 0; g0 < n; g0 += TT) {
    // rows past n read the last row, and are not stored
    int rin[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rin[i] = first + min(g0 + ty + TY * i, n - 1) - lo;
    for (int co0 = 0; co0 < C; co0 += TCO) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = co0 + tx + TX * j;
        const float bv = o < C ? to_f32(bias[o]) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = bv;
      }
      for (int ci0 = 0; ci0 < Cs; ci0 += kCI) {
        const int cn = min(kCI, Cs - ci0);
        __syncthreads();
        for (int idx = threadIdx.x; idx < K * kCI * TCO; idx += kThreads) {
          const int o = idx % TCO, c = (idx / TCO) % kCI, k = idx / (TCO * kCI);
          float v = 0.f;
          if (c < cn && co0 + o < C)
            v = to_f32(w[k * sk + (ci0 + c) * si + (co0 + o) * so]);
          wsm[idx] = v;
        }
        __syncthreads();
        for (int k = 0; k < K; ++k) {
          const float* wk = wsm + k * kCI * TCO + tx;
          const float* rows[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) rows[i] = in + (rin[i] + k * dil) * ld + ci0;
#pragma unroll 4
          for (int c = 0; c < cn; ++c) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = kAct ? act<T>(rows[i][c]) : rows[i][c];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = wk[c * TCO + TX * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g0 + ty + TY * i;
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = co0 + tx + TX * j;
          if (o < C) store(first + r, o, acc[i][j]);
        }
      }
    }
  }
}

template <int TCO>
size_t chain_smem_bytes(int S, int reach, int Cin, int C) {
  return (3 * kCI * TCO + (size_t)(S + 2 * reach) * (row_len(Cin) + 2 * row_len(C))) *
         sizeof(float);
}

template <typename T, int TCO>
__global__ void __launch_bounds__(kThreads)
down_chain_kernel(const __grid_constant__ DownChainArgs p, int S) {
  extern __shared__ float4 smem4[];
  const int T_len = (int)p.T, Cin = (int)p.Cin, C = (int)p.C;
  const int d1 = (int)p.dil[0], d2 = (int)p.dil[1], d3 = (int)p.dil[2];
  const int H = d1 + d2 + d3, win = S + 2 * H;
  const int ldx = row_len(Cin), ldc = row_len(C);
  float* wsm = reinterpret_cast<float*>(smem4);  // [3][kCI][TCO]
  float* xs = wsm + 3 * kCI * TCO;               // [win][ldx] the input
  float* ha = xs + win * ldx;                    // [win][ldc] stages 1, 3
  float* hb = ha + win * ldc;                    // [win][ldc] stage 2

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * S;
  const int base = t0 - H;  // stream row of window row 0
  const T* x = static_cast<const T*>(p.x) + (size_t)b * T_len * Cin;
  T* y = static_cast<T*>(p.y) + (size_t)b * T_len * C;
  for (int idx = threadIdx.x; idx < win * Cin; idx += kThreads) {
    const int r = idx / Cin, f = idx % Cin, t = base + r;
    xs[r * ldx + f] = t >= 0 && t < T_len ? to_f32(x[(size_t)t * Cin + f]) : 0.f;
  }
  const T* const* w = reinterpret_cast<const T* const*>(p.w);
  const T* const* bias = reinterpret_cast<const T* const*>(p.b);
  // stage j computes window rows [e_j, win - e_j), e_j = d1 + .. + d_j
  conv_pass<T, TCO, true>(xs, ldx, Cin, 3, d1, d1, win - 2 * d1, C, w[0],
                          p.w_sk[0], p.w_si[0], p.w_so[0], bias[0], wsm,
                          ActStore<T>{ha, ldc, base, T_len});
  conv_pass<T, TCO, false>(ha, ldc, C, 3, d2, d1 + d2, win - 2 * (d1 + d2), C,
                           w[1], p.w_sk[1], p.w_si[1], p.w_so[1], bias[1], wsm,
                           ActStore<T>{hb, ldc, base, T_len});
  conv_pass<T, TCO, false>(hb, ldc, C, 3, d3, H, S, C, w[2], p.w_sk[2],
                           p.w_si[2], p.w_so[2], bias[2], wsm,
                           PlainStore<T>{ha, ldc});
  conv_pass<T, TCO, false>(xs, ldx, Cin, 1, 1, H, S, C, w[3], p.w_sk[3],
                           p.w_si[3], p.w_so[3], bias[3], wsm,
                           OutStore<T>{ha, y, ldc, base, T_len, C});
}

// The tile: the S in [kMinTile, min(kMaxTile, the largest that fits)] that
// computes the fewest (row group x weight chunk) steps per output row (the
// larger on a tie).
template <int TCO>
int chain_tile(int reach, int Cin, int C, const int* dil) {
  constexpr int TT = 4 * (kThreads / (TCO / 4));
  const auto chunks = [](int cs) { return (cs + kCI - 1) / kCI; };
  int best = 0;
  double best_cost = 0.0;
  for (int S = kMinTile; S <= kMaxTile; ++S) {
    if (chain_smem_bytes<TCO>(S, reach, Cin, C) > kMaxSmemBytes) break;
    const int e1 = dil[0], e2 = dil[0] + dil[1];
    const long long steps =
        (long long)((S + 2 * (reach - e1) + TT - 1) / TT) * 3 * chunks(Cin) +
        (long long)((S + 2 * (reach - e2) + TT - 1) / TT) * 3 * chunks(C) +
        (long long)((S + TT - 1) / TT) * (3 * chunks(C) + chunks(Cin));
    const double cost = (double)steps / S;
    if (best == 0 || cost <= best_cost) {
      best = S;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, int TCO>
int launch_tco(const DownChainArgs* a, cudaStream_t stream) {
  const int dil[3] = {(int)a->dil[0], (int)a->dil[1], (int)a->dil[2]};
  const int reach = dil[0] + dil[1] + dil[2];
  const int S = chain_tile<TCO>(reach, (int)a->Cin, (int)a->C, dil);
  if (S < kMinTile) return (int)cudaErrorInvalidValue;
  const size_t smem = chain_smem_bytes<TCO>(S, reach, (int)a->Cin, (int)a->C);
  auto kern = down_chain_kernel<T, TCO>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((a->T + S - 1) / S), (unsigned)a->B);
  kern<<<grid, kThreads, smem, stream>>>(*a, S);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const DownChainArgs* a, void* stream) {
  if (a->B < 1 || a->T < 1 || a->Cin < 1 || a->Cin > kMaxChannels || a->C < 1 ||
      a->C > kMaxChannels)
    return (int)cudaErrorInvalidValue;
  long long reach = 0;
  for (int j = 0; j < 3; ++j) {
    if (a->dil[j] < 1) return (int)cudaErrorInvalidValue;
    reach += a->dil[j];
  }
  for (int j = 0; j < 4; ++j)
    if (a->w[j] == nullptr || a->b[j] == nullptr) return (int)cudaErrorInvalidValue;
  if (reach > kMaxReach) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64-column tiles where they divide C (192), else 32 (24, 48, 96)
  if (a->C % 64 == 0) return launch_tco<T, 64>(a, s);
  return launch_tco<T, 32>(a, s);
}

}  // namespace

extern "C" int down_chain_fwd_f32(const DownChainArgs* a, void* stream) {
  return launch<float>(a, stream);
}
extern "C" int down_chain_fwd_bf16(const DownChainArgs* a, void* stream) {
  return launch<__nv_bfloat16>(a, stream);
}
