// Stride-1 "same" dilated 1-D convolution with an optional fused input
// leaky-relu, channels-last. The forward (window_conv.cu), the input
// gradient (window_conv_grad.cu) and the fused conv's forward
// (fused_conv.cu) all run it:
//
//   y[b, t, o] = bias[o] + sum_k sum_i act(x)[b, t - lo + k*dil, i] * w[k, i, o]
//
// with zeros outside [0, T), act = leaky_relu(., slope) applied in f32 and
// rounded to the stream type (or the identity). f32 and bf16 in and out,
// f32 sums started from the bias, the output rounded once. The window conv
// passes lo = (K-1)/2 * dil; the fused conv any lo in [0, span], span =
// (K-1) * dil. The weight is read through element strides (swk, swi, swo),
// so a caller passes a transposed or K-reversed view (a negative swk from a
// pointer at the last tap) without a copy. An optional epilogue multiplies
// the rounded output by the leaky-relu derivative of a tensor shaped like y
// (where(m >= 0, 1, mask_slope) in f32) and rounds again: the chain rule of
// the input gradient through the forward's fused activation.
//
// Replaces the TPU kernel svcc23_fastsvc_tpu/ops/pallas_window_conv.py
// window_conv_fwd (_fwd_kernel), which streams a [halo | tile | halo] window
// of x into VMEM once and takes the K taps as row offsets into it, with bf16
// dots summed in f32. Each thread block here does the same in shared memory
// for a tile of TM rows and TN output channels, walking Cin in chunks.
//
// What bounds it on the H100: the operations (2*K*Cin*Cout per row) at 48
// channels and up, the bytes of x and y at 24 channels and Cin = 1. Two
// variants, chosen by the caller from dtype and shape alone
// (ops/window_conv.py::fwd_plan):
//
// * mma (bf16, Cin a multiple of 8 and at least 16): the products on the
//   tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32, the exact bf16 dot
//   with f32 sums of the TPU kernel. M is the output rows, N the output
//   channels, the depth Cin. A comes from the shared window by ldmatrix, one
//   row address per lane, so a tap is a shift of k*dil rows at no cost (why
//   mma.sync and not wgmma, whose descriptors want 8-row-aligned core
//   matrices). Shared rows are 80 bytes (five 16-byte units, an odd count),
//   so the eight rows of an ldmatrix fall in eight distinct bank groups
//   whatever the shift. The window chunk comes in by 16-byte cp.async
//   (zero-filled outside [0, T) and past Cin), the activation is applied
//   in place by the thread that copied each segment, and the next chunk's
//   copy overlaps this chunk's MMAs (two stages). A first small kernel
//   reads the weight once through its strides into [k][n][c] rows, the
//   layout of B's fragments (pack_weight_kernel), and each chunk's slab of
//   it rides the same cp.async pipeline.
// * ffma (f32 always, so f32 stays true f32; bf16 at Cin = 1 and widths
//   that are not a multiple of 8): each of 128 threads keeps an 8 x 8
//   register tile (4 x 8 where 8 rows a thread would leave SMs idle), rows
//   strided by TY, columns two runs of four. Per input
//   channel quad it reads each of its rows as one 128-bit shared load and
//   each channel's eight weights as two, 256 FMAs per 16 loads, so shared
//   memory no longer bounds the loop. f32 chunks come in by cp.async (16
//   bytes a segment where Cin is a multiple of 4, else 4 bytes an element)
//   in two stages; bf16 is widened through registers.

#pragma once

#include "device_prims.cuh"

namespace {

// the activated input is rounded to the storage type, as the TPU kernel
// stores it back into its window scratch
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, bf16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// ---- staging rows of a channels-last matrix into shared memory ----------

// How a stage's rows come in: 16-byte async copies (the channel run a
// multiple of 16 bytes), 4-byte async copies (f32), or through registers
// (bf16 widened to f32 for the FFMA loops).
enum { kCopy16 = 0, kCopy4 = 1, kCopyReg = 2 };

// Stage rows [row0, row0 + n_rows) of one utterance's (T_len, ld) matrix,
// channels [c0, c0 + cn), into dst (n_rows x dst_ld), with zeros at rows
// outside [0, T_len) and at channels [cn, cpad). kCopyReg applies the
// activation here (act != 0); the async modes leave it to activate_rows,
// once the copy has landed.
template <int kMode, typename S, typename D, int NT>
__device__ __forceinline__ void stage_rows(D* dst, int dst_ld, const S* src,
                                           int row0, int n_rows, int T_len,
                                           int ld, int c0, int cn, int cpad,
                                           int act, float slope) {
  if constexpr (kMode == kCopy16) {
    constexpr int E = 16 / sizeof(S);
    const int nseg = cpad / E;
    for (int i = threadIdx.x; i < n_rows * nseg; i += NT) {
      const int r = i / nseg, s = i - r * nseg;
      const int t = row0 + r;
      const bool ok = t >= 0 && t < T_len && s * E < cn;
      cp_async16(dst + r * dst_ld + s * E,
                 ok ? src + (size_t)t * ld + c0 + s * E : src, ok);
    }
  } else if constexpr (kMode == kCopy4) {
    for (int i = threadIdx.x; i < n_rows * cpad; i += NT) {
      const int r = i / cpad, c = i - r * cpad;
      const int t = row0 + r;
      const bool ok = t >= 0 && t < T_len && c < cn;
      cp_async4(dst + r * dst_ld + c, ok ? src + (size_t)t * ld + c0 + c : src,
                ok);
    }
  } else {
    // unrolled so that several global loads are in flight at once
#pragma unroll 4
    for (int i = threadIdx.x; i < n_rows * cpad; i += NT) {
      const int r = i / cpad, c = i - r * cpad;
      const int t = row0 + r;
      float v = 0.f;
      if (t >= 0 && t < T_len && c < cn) {
        v = to_f32(src[(size_t)t * ld + c0 + c]);
        if (act) v = round_to(leaky(v, slope), S());
      }
      dst[r * dst_ld + c] = from_f32<D>(v);
    }
  }
}

// The activation, in place, over the segments this thread copied with
// stage_rows (same arguments): cp.async.wait_group has made its own copies
// visible to it, so no barrier is needed between the copy and this pass.
template <int kMode, typename S, int NT>
__device__ __forceinline__ void activate_rows(S* dst, int dst_ld, int row0,
                                              int n_rows, int T_len, int cn,
                                              int cpad, float slope) {
  if constexpr (kMode == kCopy16) {
    constexpr int E = 16 / sizeof(S);
    const int nseg = cpad / E;
    for (int i = threadIdx.x; i < n_rows * nseg; i += NT) {
      const int r = i / nseg, s = i - r * nseg;
      const int t = row0 + r;
      if (t < 0 || t >= T_len || s * E >= cn) continue;
      uint4* p = reinterpret_cast<uint4*>(dst + r * dst_ld + s * E);
      uint4 v = *p;
      S* e = reinterpret_cast<S*>(&v);
#pragma unroll
      for (int j = 0; j < E; ++j) e[j] = from_f32<S>(leaky(to_f32(e[j]), slope));
      *p = v;
    }
  } else if constexpr (kMode == kCopy4) {
    for (int i = threadIdx.x; i < n_rows * cpad; i += NT) {
      const int r = i / cpad, c = i - r * cpad;
      const int t = row0 + r;
      if (t < 0 || t >= T_len || c >= cn) continue;
      S* p = dst + r * dst_ld + c;
      *p = from_f32<S>(leaky(to_f32(*p), slope));
    }
  }
}

// ---- the mma variant (bf16) -------------------------------------------

constexpr int kMmaThreads = 256;
constexpr int kMmaKC = 32;            // input channels per chunk: two k16 steps
constexpr int kMmaLd = kMmaKC + 8;    // 80-byte shared rows, see the header

// The weight in the mma variant's layout, [k][n][c] with c padded with
// zeros to a multiple of kMmaKC, read once through its strides: the main
// kernel then copies each chunk's slab with 16-byte cp.async in its
// pipeline, where a gather through the strides in every block would wait
// on a global load per element.
__global__ void __launch_bounds__(256)
pack_weight_kernel(const bf16* __restrict__ w, bf16* __restrict__ wp, int K,
                   int Cin, int Cout, int cin_pad, long long swk,
                   long long swi, long long swo) {
  const long long total = (long long)K * Cout * cin_pad;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % cin_pad);
  const long long kn = i / cin_pad;
  const int n = (int)(kn % Cout), k = (int)(kn / Cout);
  wp[i] = c < Cin ? w[k * swk + c * swi + n * swo] : __float2bfloat16(0.f);
}

// WM x WN warps, each MT m16 tiles by NT n8 tiles: TM = 16*WM*MT output
// rows, TN = 8*WN*NT output channels per block. kPass (0 forward, 1 input
// gradient, 2 fused conv) only names the instance, so a profile tells the
// three apart.
template <int WM, int WN, int MT, int NT, int kPass>
__global__ void __launch_bounds__(kMmaThreads, MT * NT <= 6 ? 3 : 2)
window_conv_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                       const bf16* __restrict__ bias,
                       const bf16* __restrict__ mask, bf16* __restrict__ y,
                       int T_len, int Cin, int Cout, int K, int dil, int lo,
                       int has_leaky, float slope, float mask_slope) {
  static_assert(WM * WN * 32 == kMmaThreads, "eight warps");
  constexpr int TM = 16 * WM * MT, TN = 8 * WN * NT;
  extern __shared__ __align__(16) unsigned char wc_smem[];
  bf16* smem = reinterpret_cast<bf16*>(wc_smem);
  const int win_rows = TM + (K - 1) * dil;
  const int stage = (win_rows + K * TN) * kMmaLd;
  const int n_chunks = (Cin + kMmaKC - 1) / kMmaKC;
  const int b = blockIdx.z, t0 = blockIdx.x * TM, co0 = blockIdx.y * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const bf16* xb = x + (size_t)b * T_len * Cin;
  const int cin_pad = n_chunks * kMmaKC;

  float acc[MT][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = co0 + wn * NT * 8 + nt * 8 + (lane & 3) * 2;
    const float b0 = (bias != nullptr && col < Cout) ? to_f32(bias[col]) : 0.f;
    const float b1 =
        (bias != nullptr && col + 1 < Cout) ? to_f32(bias[col + 1]) : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][nt][0] = b0; acc[mt][nt][1] = b1;
      acc[mt][nt][2] = b0; acc[mt][nt][3] = b1;
    }
  }

  auto load = [&](int ch, int s) {
    bf16* win = smem + s * stage;
    bf16* wsm = win + win_rows * kMmaLd;
    const int ci0 = ch * kMmaKC, cn = min(kMmaKC, Cin - ci0);
    const int cpad = (cn + 15) & ~15;
    stage_rows<kCopy16, bf16, bf16, kMmaThreads>(
        win, kMmaLd, xb, t0 - lo, win_rows, T_len, Cin, ci0, cn, cpad, 0, 0.f);
    // the weight chunk as [k][n][c] rows from the packed weight (zeros past
    // Cin there), zeros past Cout
    constexpr int kSegs = kMmaKC / 8;
    for (int i = threadIdx.x; i < K * TN * kSegs; i += kMmaThreads) {
      const int kn = i / kSegs, sg = i - kn * kSegs;
      const int k = kn / TN, n = kn - k * TN;
      const bool ok = co0 + n < Cout;
      cp_async16(wsm + kn * kMmaLd + sg * 8,
                 ok ? wp + ((size_t)k * Cout + co0 + n) * cin_pad + ci0 + sg * 8
                    : wp, ok);
    }
    cp_async_commit();
  };

  load(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s = ch & 1;
    if (ch + 1 < n_chunks) {
      load(ch + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int cn = min(kMmaKC, Cin - ch * kMmaKC);
    const int cpad = (cn + 15) & ~15;
    bf16* win = smem + s * stage;
    const bf16* wsm = win + win_rows * kMmaLd;
    if (has_leaky)
      activate_rows<kCopy16, bf16, kMmaThreads>(win, kMmaLd, t0 - lo, win_rows,
                                                T_len, cn, cpad, slope);
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      // A: lanes 0-15 rows 0-15 at channel +0, lanes 16-31 at +8
      const bf16* arow =
          win + (wm * MT * 16 + k * dil + (lane & 15)) * kMmaLd + (lane >> 4) * 8;
      const bf16* wk = wsm + (k * TN + wn * NT * 8) * kMmaLd;
      for (int kc = 0; kc < cpad; kc += 16) {
        uint32_t bfr[NT][2];
#pragma unroll
        for (int nt = 0; nt + 1 < NT; nt += 2) {
          uint32_t r[4];
          ldsm_x4(r, wk + ((nt + (lane >> 4)) * 8 + (lane & 7)) * kMmaLd + kc +
                         ((lane >> 3) & 1) * 8);
          bfr[nt][0] = r[0]; bfr[nt][1] = r[1];
          bfr[nt + 1][0] = r[2]; bfr[nt + 1][1] = r[3];
        }
        if constexpr (NT % 2 == 1) {
          uint32_t r[2];
          ldsm_x2(r, wk + ((NT - 1) * 8 + (lane & 7)) * kMmaLd + kc +
                         ((lane >> 3) & 1) * 8);
          bfr[NT - 1][0] = r[0]; bfr[NT - 1][1] = r[1];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, arow + mt * 16 * kMmaLd + kc);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], a, bfr[nt][0], bfr[nt][1]);
        }
      }
    }
    __syncthreads();
  }

  // accumulator (mt, nt): rows lane/4 and lane/4 + 8, columns 2*(lane%4) + {0, 1}
  const size_t row0 = (size_t)b * T_len;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm * MT * 16 + mt * 16 + (lane >> 2) + 8 * h;
      if (t >= T_len) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + wn * NT * 8 + nt * 8 + (lane & 3) * 2 + e;
          if (co >= Cout) continue;
          const size_t at = (row0 + t) * Cout + co;
          float v = acc[mt][nt][2 * h + e];
          if (mask != nullptr)
            v = round_to(v, bf16()) * (to_f32(mask[at]) >= 0.f ? 1.f : mask_slope);
          y[at] = from_f32<bf16>(v);
        }
      }
    }
  }
}

// ---- the ffma variant (f32, and bf16 where the mma variant does not fit) --

constexpr int kFfThreads = 128;
constexpr int kFfKC = 16;            // input channels per chunk: four quads
constexpr int kFfLd = kFfKC + 4;     // 80-byte shared rows

// TX = TN/8 threads across columns (columns tx*4 + [0,4) and TX*4 + tx*4 +
// [0,4)), TY = 128/TX across rows (rows ty + TY*i, i < RPT): TM = RPT*TY
// rows. RPT = 4 halves the rows of a block, for grids that would not cover
// the SMs with RPT = 8.
template <typename T, int TN, int RPT, int kPass>
__global__ void __launch_bounds__(kFfThreads)
window_conv_ffma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ bias, const T* __restrict__ mask,
                        T* __restrict__ y, int T_len, int Cin, int Cout, int K,
                        int dil, int lo, long long swk, long long swi,
                        long long swo, int has_leaky, float slope,
                        float mask_slope) {
  constexpr int TX = TN / 8, TY = kFfThreads / TX, TM = RPT * TY;
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ float4 wc_smem4[];
  float* smem = reinterpret_cast<float*>(wc_smem4);
  const int win_rows = TM + (K - 1) * dil;
  const int stage = win_rows * kFfLd + K * kFfKC * TN;
  const int n_chunks = (Cin + kFfKC - 1) / kFfKC;
  const int b = blockIdx.z, t0 = blockIdx.x * TM, co0 = blockIdx.y * TN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const T* xb = x + (size_t)b * T_len * Cin;
  const bool vec = Cin % 4 == 0;   // 16-byte window segments (f32)
  const bool n_fast = llabs(swo) < llabs(swi);

  float acc[RPT][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + (j < 4 ? tx * 4 + j : TX * 4 + tx * 4 + j - 4);
    const float bv = (bias != nullptr && co < Cout) ? to_f32(bias[co]) : 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i][j] = bv;
  }

  auto load = [&](int ch, int s) {
    float* win = smem + s * stage;
    float* wsm = win + win_rows * kFfLd;
    const int ci0 = ch * kFfKC, cn = min(kFfKC, Cin - ci0);
    const int cpad = (cn + 3) & ~3;
    if constexpr (kF32) {
      if (vec)
        stage_rows<kCopy16, T, float, kFfThreads>(win, kFfLd, xb, t0 - lo,
                                                  win_rows, T_len, Cin, ci0, cn,
                                                  cpad, 0, 0.f);
      else
        stage_rows<kCopy4, T, float, kFfThreads>(win, kFfLd, xb, t0 - lo,
                                                 win_rows, T_len, Cin, ci0, cn,
                                                 cpad, 0, 0.f);
    } else {
      stage_rows<kCopyReg, T, float, kFfThreads>(win, kFfLd, xb, t0 - lo,
                                                 win_rows, T_len, Cin, ci0, cn,
                                                 cpad, has_leaky, slope);
    }
    // the weight chunk as [k][c][n], zeros past Cin and Cout
    constexpr int per_k = kFfKC * TN;
#pragma unroll 4
    for (int i = threadIdx.x; i < K * per_k; i += kFfThreads) {
      const int k = i / per_k, rem = i - k * per_k;
      int n, c;
      if (n_fast) { c = rem / TN; n = rem - c * TN; }
      else { n = rem / kFfKC; c = rem - n * kFfKC; }
      const bool ok = c < cn && co0 + n < Cout;
      const T* src = ok ? w + (k * swk + (ci0 + c) * swi + (co0 + n) * swo) : w;
      float* dst = wsm + (k * kFfKC + c) * TN + n;
      if constexpr (kF32) cp_async4(dst, src, ok);
      else *dst = ok ? to_f32(*src) : 0.f;
    }
    cp_async_commit();
  };

  load(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s = ch & 1;
    if (ch + 1 < n_chunks) {
      load(ch + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int cn = min(kFfKC, Cin - ch * kFfKC);
    const int nq = (cn + 3) / 4;
    const float* win = smem + s * stage;
    const float* wsm = win + win_rows * kFfLd;
    if constexpr (kF32) {
      if (has_leaky) {
        float* wa = smem + s * stage;
        if (vec)
          activate_rows<kCopy16, float, kFfThreads>(wa, kFfLd, t0 - lo, win_rows,
                                                    T_len, cn, nq * 4, slope);
        else
          activate_rows<kCopy4, float, kFfThreads>(wa, kFfLd, t0 - lo, win_rows,
                                                   T_len, cn, nq * 4, slope);
      }
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      const float* arow = win + (ty + k * dil) * kFfLd;
      const float* wk = wsm + k * kFfKC * TN;
      for (int q = 0; q < nq; ++q) {
        float4 a[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          a[i] = *reinterpret_cast<const float4*>(arow + i * TY * kFfLd + q * 4);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* wc = wk + (q * 4 + cc) * TN;
          const float4 b0 = *reinterpret_cast<const float4*>(wc + tx * 4);
          const float4 b1 = *reinterpret_cast<const float4*>(wc + TX * 4 + tx * 4);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float av = cc == 0 ? a[i].x : cc == 1 ? a[i].y
                           : cc == 2 ? a[i].z : a[i].w;
            acc[i][0] = fmaf(av, b0.x, acc[i][0]);
            acc[i][1] = fmaf(av, b0.y, acc[i][1]);
            acc[i][2] = fmaf(av, b0.z, acc[i][2]);
            acc[i][3] = fmaf(av, b0.w, acc[i][3]);
            acc[i][4] = fmaf(av, b1.x, acc[i][4]);
            acc[i][5] = fmaf(av, b1.y, acc[i][5]);
            acc[i][6] = fmaf(av, b1.z, acc[i][6]);
            acc[i][7] = fmaf(av, b1.w, acc[i][7]);
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t row0 = (size_t)b * T_len;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = t0 + ty + TY * i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + (j < 4 ? tx * 4 + j : TX * 4 + tx * 4 + j - 4);
      if (co >= Cout) continue;
      const size_t at = (row0 + t) * Cout + co;
      float v = acc[i][j];
      if (mask != nullptr)
        v = round_to(v, T()) * (to_f32(mask[at]) >= 0.f ? 1.f : mask_slope);
      y[at] = from_f32<T>(v);
    }
  }
}

// ---- slots of a weight gradient, and their ordered reduce ---------------

// the fixed partition: slot s takes units [n*s/S, n*(s+1)/S)
__device__ __forceinline__ long long part_begin(long long n, int s, int S) {
  return n * s / S;
}

// shared rows of an odd number of 16-byte units hold at least `cols` bf16
__host__ __device__ constexpr int odd_ld(int cols) {
  return 8 * ((cols / 8 + 1) | 1);
}

// The ordered reduce of a weight gradient's slots (#4, #6): a block of
// 32 x J threads sums 32 elements of [dw | db]: thread
// (e, j) adds slots j, j + J, j + 2J, ... in order, then thread (e, 0) adds
// the J partial sums in j order. J = clamp(n_slots / 8, 1, 32) depends on
// the slot count alone, so the order is fixed and two runs give the same
// bits; the J loads in flight per element replace one thread walking all
// the slots alone.
constexpr int kRedMaxJ = 32;
__global__ void __launch_bounds__(32 * kRedMaxJ)
slot_reduce_kernel(const float* __restrict__ part_w,
                   const float* __restrict__ part_b, float* __restrict__ dw,
                   float* __restrict__ db, long long n_w, int Cout,
                   int n_slots) {
  __shared__ float sums[kRedMaxJ][33];
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x;
  const int j = threadIdx.y, J = blockDim.y;
  float s = 0.f;
  if (i < n_w) {
    for (int sp = j; sp < n_slots; sp += J) s += part_w[sp * n_w + i];
  } else if (i < n_w + Cout) {
    const int o = (int)(i - n_w);
    for (int sp = j; sp < n_slots; sp += J) s += part_b[(long long)sp * Cout + o];
  }
  sums[j][threadIdx.x] = s;
  __syncthreads();
  if (j != 0 || i >= n_w + Cout) return;
  float t = 0.f;
  for (int jj = 0; jj < J; ++jj) t += sums[jj][threadIdx.x];
  if (i < n_w) dw[i] = t;
  else db[i - n_w] = t;
}

inline int launch_slot_reduce(const float* part_w, const float* part_b,
                              float* dw, float* db, long long n_w, int Cout,
                              int n_slots, cudaStream_t stream) {
  const long long n = n_w + Cout;
  const int J = n_slots / 8 < 1 ? 1 : n_slots / 8 > kRedMaxJ ? kRedMaxJ
                                                           : n_slots / 8;
  slot_reduce_kernel<<<(unsigned)((n + 31) / 32), dim3(32, J), 0, stream>>>(
      part_w, part_b, dw, db, n_w, Cout, n_slots);
  return (int)cudaGetLastError();
}

// ---- launches ----------------------------------------------------------

// the variant ids the callers pass (ops/window_conv.py::FWD_VARIANTS)
enum { kVariantMma = 0, kVariantFfma = 1 };

struct ConvArgs {
  const void* x; const void* w; const void* b; const void* mask; void* y;
  void* wpack;  // mma: scratch for the packed weight, K * Cout * cin_pad
  int B, T_len, Cin, Cout, K, dil, lo;
  long long swk, swi, swo;
  int has_leaky; float slope, mask_slope;
  cudaStream_t stream;
};

template <int WM, int WN, int MT, int NT, int kPass>
int launch_mma(const ConvArgs& a) {
  constexpr int TM = 16 * WM * MT, TN = 8 * WN * NT;
  const int win_rows = TM + (a.K - 1) * a.dil;
  const int stages = a.Cin > kMmaKC ? 2 : 1;
  const size_t smem =
      (size_t)stages * (win_rows + a.K * TN) * kMmaLd * sizeof(bf16);
  auto kern = window_conv_mma_kernel<WM, WN, MT, NT, kPass>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.wpack == nullptr) return (int)cudaErrorInvalidValue;
  const int cin_pad = (a.Cin + kMmaKC - 1) / kMmaKC * kMmaKC;
  const long long n_pack = (long long)a.K * a.Cout * cin_pad;
  bf16* wp = static_cast<bf16*>(a.wpack);
  pack_weight_kernel<<<(unsigned)((n_pack + 255) / 256), 256, 0, a.stream>>>(
      static_cast<const bf16*>(a.w), wp, a.K, a.Cin, a.Cout, cin_pad, a.swk,
      a.swi, a.swo);
  dim3 grid((a.T_len + TM - 1) / TM, (a.Cout + TN - 1) / TN, a.B);
  kern<<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.x), wp, static_cast<const bf16*>(a.b),
      static_cast<const bf16*>(a.mask), static_cast<bf16*>(a.y), a.T_len,
      a.Cin, a.Cout, a.K, a.dil, a.lo, a.has_leaky, a.slope, a.mask_slope);
  return (int)cudaGetLastError();
}

template <typename T, int TN, int RPT, int kPass>
int launch_ffma(const ConvArgs& a) {
  constexpr int TM = RPT * (kFfThreads / (TN / 8));
  const int win_rows = TM + (a.K - 1) * a.dil;
  const int stages = a.Cin > kFfKC ? 2 : 1;
  const size_t smem =
      (size_t)stages * (win_rows * kFfLd + a.K * kFfKC * TN) * sizeof(float);
  auto kern = window_conv_ffma_kernel<T, TN, RPT, kPass>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.T_len + TM - 1) / TM, (a.Cout + TN - 1) / TN, a.B);
  kern<<<grid, kFfThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<const T*>(a.b), static_cast<const T*>(a.mask),
      static_cast<T*>(a.y), a.T_len, a.Cin, a.Cout, a.K, a.dil, a.lo, a.swk,
      a.swi, a.swo, a.has_leaky, a.slope, a.mask_slope);
  return (int)cudaGetLastError();
}

// The caller's plan names the variant and its tile (tm rows, tn columns);
// a plan that matches no instance, or an mma plan for a shape the variant
// does not take, is refused with cudaErrorInvalidValue before any launch.
template <typename T, int kPass>
int dispatch_window_conv(const ConvArgs& a, int variant, int tm, int tn) {
  if (variant == kVariantMma) {
    if constexpr (sizeof(T) == 2) {
      if (a.Cin % 8 != 0 || a.Cin < 16) return (int)cudaErrorInvalidValue;
      if (tm == 256 && tn == 24) return launch_mma<8, 1, 2, 3, kPass>(a);
      if (tm == 256 && tn == 48) return launch_mma<8, 1, 2, 6, kPass>(a);
      if (tm == 256 && tn == 64) return launch_mma<4, 2, 4, 4, kPass>(a);
      if (tm == 128 && tn == 128) return launch_mma<2, 4, 4, 4, kPass>(a);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (variant == kVariantFfma) {
    if (tm == 256 && tn == 32) return launch_ffma<T, 32, 8, kPass>(a);
    if (tm == 128 && tn == 32) return launch_ffma<T, 32, 4, kPass>(a);
    if (tm == 128 && tn == 64) return launch_ffma<T, 64, 8, kPass>(a);
    if (tm == 64 && tn == 64) return launch_ffma<T, 64, 4, kPass>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
