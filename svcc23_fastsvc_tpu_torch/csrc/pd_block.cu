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
// Holding the whole gate weight in shared memory bounds the widths at
// 3R + A <= 272 (the ffma variant's f32 copy of it).
//
// * mma (bf16, R a multiple of 8, where its shared memory holds the
//   widths): pd_block.cuh's mma_block_rows, both products on the tensor
//   cores. A tile is 128 rows; each row's three tap rows and its
//   conditioning row are gathered into one shared row [x[m] | x[t] | x[p] |
//   c | 0], the features padded with zeros to a multiple of 16: 16-byte
//   copies for the taps, while c's rows (62 or 63 features, not 16-byte
//   aligned) come in as one contiguous run of the tile's rows and are
//   spread into the rows in shared memory. The output goes back through
//   the tile's own (dead) tap rows for 16-byte stores.
// * ffma (f32, and bf16 at other widths, widened): true f32, FFMA, the
//   products summed in the order of the features with the bias first, as
//   pd_block.cuh's gated_block_rows sums them, so the f32 kernels give the
//   bits of pd_chain.cu's stages. A tile is 256 rows, lane l of every warp
//   owns rows l + 32i (i < 8) and warp w the gate pairs 8w..8w+7, a-half
//   and b-half: 128 accumulators, and per four features 8 row loads and 16
//   uniform weight loads (128-bit) feed 512 FMAs (pd_block.cuh's routine
//   feeds 256 from 16). The input features come in chunks of 16
//   (cp.async, two stages); z goes through shared memory for the out
//   product.

#include "pd_block.cuh"

// Every field is 8 bytes, in the order of ops/pd_block.py's _Args, so the
// ctypes structure has the same layout.
struct PdBlockArgs {
  const void* x;
  const void* c;
  const void* shifts;
  PdBlockWeights wt;
  void* y;
  long long B, T, R, A, G, hop, n_frames, dil;
  long long variant, tile_rows, n_blocks;  // the plan (block_plan)
};

namespace {

constexpr int kPdThreads = kThreads;
constexpr int kMaxFeatures = 272;  // 3R + A at most (MAX_FEATURES)
static_assert(((kMaxFeatures + 15) & ~15) <= kMaxKp, "stage_weights' reach");

// the source row of tap m (hi = false) or p (hi = true) for stream row t;
// -1 reads zero
template <bool kAdaptive>
__device__ __forceinline__ int side_row(const PdBlockArgs& p, int b, int t,
                                        int T_len, bool hi) {
  if constexpr (kAdaptive) {
    // any int32 shift: in 64 bits neither tap overflows, and a tap outside
    // [0, T) reads zero, as in the plain gather
    const long long s = static_cast<const int*>(p.shifts)[
        (size_t)b * p.n_frames + t / (int)p.hop];
    const long long u = hi ? t + s : t - s;
    return u >= 0 && u < T_len ? (int)u : -1;
  } else {
    return hi ? reflect_hi(t, (int)p.dil, T_len) : reflect_lo(t, (int)p.dil);
  }
}

// ---- mma (bf16) ---------------------------------------------------------

constexpr int kTapCopies = 3 * kMmaRows * 8 / kPdThreads;  // 16-byte units a thread
constexpr int kShiftRows = 4;  // distinct rows among a thread's tap copies
static_assert(kMmaRows == 128 && kPdThreads == 256, "shifts_of's row map");

// a tile's rows of c as one run of 16-byte units, from the unit holding its
// first byte
__host__ __device__ constexpr int cbuf_bytes(int A) {
  return (kMmaRows * A * 2 + 31) & ~15;
}

size_t mma_smem_bytes(int R, int A) {
  return (size_t)(2 * kMmaRows + kGateRows) * mma_ld(R, A) * sizeof(bf16) +
         (size_t)kMaxR * kOutLd * sizeof(bf16) +
         (size_t)(kGateRows + kMaxR) * sizeof(float) + cbuf_bytes(A);
}

template <bool kAdaptive>
__global__ void __launch_bounds__(kPdThreads, 1)
pd_block_mma_kernel(const __grid_constant__ PdBlockArgs p) {
  extern __shared__ __align__(16) unsigned char pd_smem[];
  const int T_len = (int)p.T, R = (int)p.R, A = (int)p.A, G2 = (int)p.G / 2;
  const int KIN = 3 * R + A, KP = mma_kp(R, A), ld = mma_ld(R, A);
  bf16* stages = reinterpret_cast<bf16*>(pd_smem);  // [2][kMmaRows][ld]
  bf16* wg = stages + 2 * kMmaRows * ld;            // [kGateRows][ld]
  bf16* wo = wg + kGateRows * ld;                   // [kMaxR][kOutLd]
  float* bg_s = reinterpret_cast<float*>(wo + kMaxR * kOutLd);
  float* bo_s = bg_s + kGateRows;
  unsigned char* cbuf = reinterpret_cast<unsigned char*>(bo_s + kMaxR);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tt = (T_len + kMmaRows - 1) / kMmaRows;
  const long long n_tiles = (long long)p.B * n_tt;
  const bf16* x = static_cast<const bf16*>(p.x);
  const unsigned char* cbytes = static_cast<const unsigned char*>(p.c);
  bf16* y = static_cast<bf16*>(p.y);

  // c's bytes of tile j: [S, E) from the start of c
  auto c_range = [&](long long j, size_t& S, size_t& E) {
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * kMmaRows;
    S = ((size_t)b * T_len + t0) * A * sizeof(bf16);
    E = S + (size_t)min(kMmaRows, T_len - t0) * A * sizeof(bf16);
  };
  // the adaptive taps' pitch shifts of tile j's rows, loaded ahead of the
  // copies that need them: copy n of a thread is tap n / 4 of row
  // tid / 8 + 32 (n % 4), so taps m and p share four rows' shifts
  auto shifts_of = [&](long long j, int (&sh)[kShiftRows]) {
    if constexpr (kAdaptive) {
      const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * kMmaRows;
      const int* shifts = static_cast<const int*>(p.shifts) + (size_t)b * p.n_frames;
#pragma unroll
      for (int m = 0; m < kShiftRows; ++m) {
        const int t = t0 + (tid >> 3) + 32 * m;
        sh[m] = t < T_len ? shifts[t / (int)p.hop] : 0;
      }
    }
  };
  // Tile j's tap rows into stage s, 32 lanes copying four rows of one tap
  // (eight 16-byte units a row), and its c rows into cbuf as one run.
  auto gather = [&](long long j, int s, const int (&sh)[kShiftRows]) {
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * kMmaRows;
    bf16* st = stages + s * kMmaRows * ld;
    const bf16* xb = x + (size_t)b * T_len * R;
#pragma unroll
    for (int n = 0; n < kTapCopies; ++n) {
      const int idx = tid + kPdThreads * n;
      const int seg = idx & 7, rt = idx >> 3;
      const int tap = rt >> 7, r = rt & (kMmaRows - 1), t = t0 + r;
      if (seg * 8 >= R) continue;
      int src = -1;
      if (t < T_len) {
        if (tap == 1) {
          src = t;
        } else if constexpr (kAdaptive) {
          const long long u = tap == 2 ? (long long)t + sh[n % kShiftRows]
                                       : (long long)t - sh[n % kShiftRows];
          src = u >= 0 && u < T_len ? (int)u : -1;
        } else {
          src = tap == 2 ? reflect_hi(t, (int)p.dil, T_len)
                         : reflect_lo(t, (int)p.dil);
        }
      }
      cp_async16(st + r * ld + tap * R + seg * 8,
                 src >= 0 ? xb + (size_t)src * R + seg * 8 : xb, src >= 0);
    }
    size_t S, E;
    c_range(j, S, E);
    const size_t u0 = S >> 4;
    const int units = (int)(((E + 15) >> 4) - u0);
    for (int u = tid; u < units; u += kPdThreads) {
      const size_t at = (u0 + u) * 16;
      cp_async16_n(cbuf + u * 16, cbytes + at, (int)min((size_t)16, E - at));
    }
    cp_async_commit();
  };

  int sh[kShiftRows] = {};
  const long long j0 = blockIdx.x;
  // the features past 3R + A of both stages (never copied) are zero
  for (int i = tid; i < 2 * kMmaRows * (KP - KIN); i += kPdThreads) {
    const int r = i / (KP - KIN);
    stages[r * ld + KIN + (i - r * (KP - KIN))] = __float2bfloat16(0.f);
  }
  // the first tile's rows in flight while the weights come in, once per
  // block
  shifts_of(j0, sh);
  gather(j0, 0, sh);
  if (j0 + gridDim.x < n_tiles) shifts_of(j0 + gridDim.x, sh);
  stage_weights<bf16, bf16, true>(p.wt, R, A, G2, KP, ld, kOutLd, wg, wo, bg_s,
                                  bo_s);

  int s = 0;
  for (long long j = j0; j < n_tiles; j += gridDim.x, s ^= 1) {
    cp_async_wait<0>();
    __syncthreads();
    bf16* st = stages + s * kMmaRows * ld;
    // c's rows from the run into the tile's rows (zeros past T), a warp a
    // row, 4-byte words where the run's rows start on them, else elements;
    // each thread's loads all issued before its stores
    {
      const int t0 = (int)(j % n_tt) * kMmaRows;
      const int nv = min(kMmaRows, T_len - t0);
      const int off = (int)((((size_t)(j / n_tt) * T_len + t0) * A * 2) & 15);
      if (A % 2 == 0 && off % 4 == 0 && A <= 64) {
        const int words = A / 2;
        const uint32_t* run = reinterpret_cast<const uint32_t*>(cbuf + off);
        uint32_t v[kMmaRows / 8];
#pragma unroll
        for (int n = 0; n < kMmaRows / 8; ++n) {
          const int r = warp + 8 * n;
          v[n] = r < nv && lane < words ? run[r * words + lane] : 0u;
        }
#pragma unroll
        for (int n = 0; n < kMmaRows / 8; ++n)
          if (lane < words)
            *reinterpret_cast<uint32_t*>(st + (warp + 8 * n) * ld + 3 * R + 2 * lane) = v[n];
      } else {
        const bf16* run = reinterpret_cast<const bf16*>(cbuf + off);
        for (int r = warp; r < kMmaRows; r += kPdThreads / 32)
          for (int e = lane; e < A; e += 32)
            st[r * ld + 3 * R + e] = r < nv ? run[r * A + e] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    if (j + gridDim.x < n_tiles) gather(j + gridDim.x, s ^ 1, sh);

    // the block on the warp's 16 rows; the residual x[t] from the rows'
    // tap-c features, the output into their (dead) tap-m features, then out
    // with 16-byte stores
    const bf16* arow = st + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
    bf16* wrows = st + warp * 16 * ld;
    mma_block_rows(
        wg, ld, KP, wo, bg_s, bo_s, R, G2,
        [&](int kc) { return arow + kc; },
        [&](int rr, int o) {
          const bf16* row = wrows + rr * ld + R + o;
          return make_float2(to_f32(row[0]), to_f32(row[1]));
        },
        [&](int rr, int o, float v0, float v1) {
          *reinterpret_cast<__nv_bfloat162*>(wrows + rr * ld + o) =
              __floats2bfloat162_rn(v0, v1);
        });
    __syncwarp();
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * kMmaRows;
    for (int i = lane; i < 16 * 8; i += 32) {
      const int rr = i >> 3, sg = i & 7, t = t0 + warp * 16 + rr;
      if (sg * 8 < R && t < T_len)
        *reinterpret_cast<uint4*>(y + ((size_t)b * T_len + t) * R + sg * 8) =
            *reinterpret_cast<const uint4*>(st + (warp * 16 + rr) * ld + sg * 8);
    }
    if (j + 2 * (long long)gridDim.x < n_tiles) shifts_of(j + 2 * (long long)gridDim.x, sh);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// ---- ffma (f32, and bf16 widened) ---------------------------------------

constexpr int kFfRows = 256;  // rows of a tile: 32 lanes x 8
constexpr int kFfKC = 16;     // input features per chunk
constexpr int kFfLd = kFfKC + 4;  // 80-byte stage rows
constexpr int kZLd = kMaxHalf + 4;  // z rows, 272 bytes
constexpr int kZRows = 128;   // z rows per pass (half a tile)
constexpr int kFfRowsAThread = kFfRows / (kPdThreads / 4);  // gathered rows

__host__ __device__ constexpr int ff_kw(int R, int A) { return (3 * R + A + 3) & ~3; }

size_t ffma_smem_bytes(int R, int A) {
  return ((size_t)2 * kFfRows * kFfLd + (size_t)kZRows * kZLd +
          (size_t)kGateRows * ff_kw(R, A) + (size_t)kMaxHalf * kMaxR +
          kGateRows + kMaxR) * sizeof(float);
}

template <typename T, bool kAdaptive>
__global__ void __launch_bounds__(kPdThreads, 1)
pd_block_ffma_kernel(const __grid_constant__ PdBlockArgs p) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ float4 pd_smem4[];
  const int T_len = (int)p.T, R = (int)p.R, A = (int)p.A, G2 = (int)p.G / 2;
  const int KIN = 3 * R + A, KW = ff_kw(R, A);
  const int n_chunks = (KIN + kFfKC - 1) / kFfKC;
  float* stages = reinterpret_cast<float*>(pd_smem4);  // [2][kFfRows][kFfLd]
  float* z_s = stages + 2 * kFfRows * kFfLd;            // [kZRows][kZLd]
  float* wg = z_s + kZRows * kZLd;                      // [kGateRows][KW]
  float* wo = wg + kGateRows * KW;                      // [k][o], 64 x 64
  float* bg_s = wo + kMaxHalf * kMaxR;
  float* bo_s = bg_s + kGateRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tt = (T_len + kFfRows - 1) / kFfRows;
  const long long n_tiles = (long long)p.B * n_tt;
  const T* x = static_cast<const T*>(p.x);
  const T* c = static_cast<const T*>(p.c);
  T* y = static_cast<T*>(p.y);

  // the side taps' source rows (m, p) of the thread's rows of tile j, once
  // a tile (-1 reads zero)
  auto side_rows = [&](long long j, int (&sm)[kFfRowsAThread],
                       int (&sp)[kFfRowsAThread]) {
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * kFfRows;
#pragma unroll
    for (int n = 0; n < kFfRowsAThread; ++n) {
      const int t = t0 + (tid >> 2) + (kPdThreads / 4) * n;
      sm[n] = t < T_len ? side_row<kAdaptive>(p, b, t, T_len, false) : -1;
      sp[n] = t < T_len ? side_row<kAdaptive>(p, b, t, T_len, true) : -1;
    }
  };
  // chunk ch of tile j into stage s: thread copies 4-feature segment
  // tid % 4 of row tid / 4 + 64n (its side taps' rows m_src, p_src): one
  // 16-byte copy where the four features are one tap's, two 8-byte ones
  // where they are c's, in f32; the caller commits
  auto gather_row = [&](long long j, int ch, int s, int n, int m_src,
                        int p_src) {
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * kFfRows;
    const T* xb = x + (size_t)b * T_len * R;
    const T* cb = c + (size_t)b * T_len * A;
    const int f0 = ch * kFfKC + (tid & 3) * 4;  // first feature of the segment
    const int tap = f0 < 3 * R ? f0 / R : 3;
    const int r = (tid >> 2) + (kPdThreads / 4) * n, t = t0 + r;
    float* dst = stages + s * kFfRows * kFfLd + r * kFfLd + (tid & 3) * 4;
    auto tap_src = [&](int tp) {
      return t >= T_len ? -1 : tp == 0 ? m_src : tp == 1 ? t : p_src;
    };
    if constexpr (kF32) {
      if (tap < 3 && R % 4 == 0) {
        const int src = tap_src(tap);
        cp_async16(dst, src >= 0 ? xb + (size_t)src * R + (f0 - tap * R) : xb,
                   src >= 0);
        return;
      }
      if (tap == 3 && R % 2 == 0 && A % 2 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = f0 + 2 * h;
          const bool ok = f < KIN && t < T_len;
          cp_async8(dst + 2 * h, ok ? cb + (size_t)t * A + (f - 3 * R) : xb, ok);
        }
        return;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = f0 + e;
      const T* from = nullptr;
      if (f < 3 * R) {
        const int tp = f / R, sr = tap_src(tp);
        if (sr >= 0) from = xb + (size_t)sr * R + (f - tp * R);
      } else if (f < KIN && t < T_len) {
        from = cb + (size_t)t * A + (f - 3 * R);
      }
      if constexpr (kF32) cp_async4(dst + e, from != nullptr ? from : xb, from != nullptr);
      else dst[e] = from != nullptr ? to_f32(*from) : 0.f;
    }
  };

  const long long j0 = blockIdx.x;
  // the first chunk in flight while the weights come in, once per block
  int sm[kFfRowsAThread], sp[kFfRowsAThread];
  side_rows(j0, sm, sp);
#pragma unroll
  for (int n = 0; n < kFfRowsAThread; ++n) gather_row(j0, 0, 0, n, sm[n], sp[n]);
  cp_async_commit();
  stage_weights<T, float, false>(p.wt, R, A, G2, KW, KW, kMaxR, wg, wo, bg_s,
                                 bo_s);
  cp_async_wait<0>();
  __syncthreads();  // the weights and biases, before the accumulators start

  const float* wa_row = wg + (8 * warp) * KW;             // a-half rows
  const float* wb_row = wg + (kMaxHalf + 8 * warp) * KW;  // b-half rows
  int s = 0;
  for (long long j = j0; j < n_tiles; j += gridDim.x) {
    float acc_a[8][8], acc_b[8][8];  // [row i][pair jj]
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float ba = bg_s[8 * warp + jj], bb = bg_s[kMaxHalf + 8 * warp + jj];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc_a[i][jj] = ba;
        acc_b[i][jj] = bb;
      }
    }
    for (int ch = 0; ch < n_chunks; ++ch, s ^= 1) {
      // the next chunk: this tile's, or the next tile's first
      long long jn = j;
      int chn = ch + 1;
      if (chn == n_chunks) {
        jn = j + gridDim.x;
        chn = 0;
      }
      if (jn < n_tiles) {
        if (chn == 0) side_rows(jn, sm, sp);
#pragma unroll
        for (int n = 0; n < kFfRowsAThread; ++n)
          gather_row(jn, chn, s ^ 1, n, sm[n], sp[n]);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* st = stages + s * kFfRows * kFfLd + lane * kFfLd;
      const int k0 = ch * kFfKC;
      const int nq = min(kFfKC, KW - k0) / 4;
      for (int kq = 0; kq < nq; ++kq) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(st + i * 32 * kFfLd + kq * 4);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 wa = *reinterpret_cast<const float4*>(wa_row + jj * KW + k0 + kq * 4);
          const float4 wb = *reinterpret_cast<const float4*>(wb_row + jj * KW + k0 + kq * 4);
          // each accumulator's four features in order, 16 FMAs apart
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc_a[i][jj] = fmaf(a[i].x, wa.x, acc_a[i][jj]);
            acc_b[i][jj] = fmaf(a[i].x, wb.x, acc_b[i][jj]);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc_a[i][jj] = fmaf(a[i].y, wa.y, acc_a[i][jj]);
            acc_b[i][jj] = fmaf(a[i].y, wb.y, acc_b[i][jj]);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc_a[i][jj] = fmaf(a[i].z, wa.z, acc_a[i][jj]);
            acc_b[i][jj] = fmaf(a[i].z, wb.z, acc_b[i][jj]);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc_a[i][jj] = fmaf(a[i].w, wa.w, acc_a[i][jj]);
            acc_b[i][jj] = fmaf(a[i].w, wb.w, acc_b[i][jj]);
          }
        }
      }
      __syncthreads();
    }

    // the gate, z rounded to the stream type; the out product in two
    // passes of 128 rows: lanes 0-15 take output columns 4l.., lanes 16-31
    // the next row, warp w rows 2w + (l >= 16) + 16i
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * kFfRows;
    const int oc = (lane & 15) * 4;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = 4 * pass + i;
        float z[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          z[jj] = round_to<T>(gate(acc_a[ii][jj], acc_b[ii][jj]));
        float4* zp = reinterpret_cast<float4*>(z_s + (lane + 32 * i) * kZLd + 8 * warp);
        zp[0] = make_float4(z[0], z[1], z[2], z[3]);
        zp[1] = make_float4(z[4], z[5], z[6], z[7]);
      }
      __syncthreads();
      float out[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[i][e] = 0.f;
      const float* zr = z_s + ((lane >> 4) + 2 * warp) * kZLd;
      for (int k = 0; k < G2; k += 4) {
        float4 w4[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          w4[kk] = *reinterpret_cast<const float4*>(wo + (k + kk) * kMaxR + oc);
        float4 z4[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          z4[i] = *reinterpret_cast<const float4*>(zr + 16 * i * kZLd + k);
        // each accumulator's four k in order, 32 FMAs apart
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float zv = kk == 0 ? z4[i].x : kk == 1 ? z4[i].y
                           : kk == 2 ? z4[i].z : z4[i].w;
            out[i][0] = fmaf(zv, w4[kk].x, out[i][0]);
            out[i][1] = fmaf(zv, w4[kk].y, out[i][1]);
            out[i][2] = fmaf(zv, w4[kk].z, out[i][2]);
            out[i][3] = fmaf(zv, w4[kk].w, out[i][3]);
          }
      }
      // the residual x[t] of all eight rows first, then the outputs: a
      // load after a store to y would wait for it
      T res[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + kZRows * pass + (lane >> 4) + 2 * warp + 16 * i;
        const size_t at = ((size_t)b * T_len + min(t, T_len - 1)) * R;
#pragma unroll
        for (int e = 0; e < 4; ++e) res[i][e] = x[at + min(oc + e, R - 1)];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + kZRows * pass + (lane >> 4) + 2 * warp + 16 * i;
        if (t >= T_len) continue;
        const size_t at = ((size_t)b * T_len + t) * R;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = oc + e;
          if (o >= R) continue;
          const float v = out[i][e] + bo_s[o];
          y[at + o] = from_f32<T>((v + to_f32(res[i][e])) * kSqrtHalf);
        }
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();
}

// ---- launches ----------------------------------------------------------

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The plan names the variant and its tile rows; anything else, or an mma
// plan for widths the variant does not take, is refused before any launch.
template <typename T, bool kAdaptive>
int launch(const PdBlockArgs* a, void* stream) {
  if (a->R < 1 || a->R > kMaxR || a->G < 2 || a->G % 2 || a->G / 2 > kMaxHalf ||
      a->A < 0 || 3 * a->R + a->A > kMaxFeatures || a->T < 1 || a->B < 1 ||
      a->wt.bg[0] == nullptr || a->n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (kAdaptive ? (a->hop < 1 || a->T % a->hop || a->n_frames != a->T / a->hop)
                : (a->dil < 1 || a->T <= a->dil))
    return (int)cudaErrorInvalidValue;
  const int variant = (int)a->variant, tile_rows = (int)a->tile_rows;
  const int R = (int)a->R, A = (int)a->A;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)a->n_blocks);
  if (variant == kPdMma && tile_rows == 128) {
    if constexpr (sizeof(T) == 2) {
      if (R % 8) return (int)cudaErrorInvalidValue;
      auto kern = pd_block_mma_kernel<kAdaptive>;
      const size_t smem = mma_smem_bytes(R, A);
      if (int e = prepare(kern, smem)) return e;
      kern<<<grid, kPdThreads, smem, s>>>(*a);
      return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;
  }
  if (variant == kPdFfma && tile_rows == 256) {
    auto kern = pd_block_ffma_kernel<T, kAdaptive>;
    const size_t smem = ffma_smem_bytes(R, A);
    if (int e = prepare(kern, smem)) return e;
    kern<<<grid, kPdThreads, smem, s>>>(*a);
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
