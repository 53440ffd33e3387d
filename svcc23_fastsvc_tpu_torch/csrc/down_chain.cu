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
// zeroes each stage's out-of-[0, T) rows by a position mask. Here a block
// of threads takes tiles of S rows and keeps, in shared memory, leaky(x)'s
// rows [t0 - H, t0 + S + H) (H = d1 + d2 + d3 = 7, the exact reach; rows
// outside [0, T) are zero), x's own S rows for the residual, and two stage
// buffers. Stage j computes the rows the later stages still read and
// stores them with their leaky already applied; a row outside [0, T) is
// stored as zero, which is the zero padding the next stage reads (the TPU
// kernel's pos_i mask). No T % 32 or T >= 2H rule is needed. The residual
// turns h3 into y in place, and the tile's rows of y leave as 16-byte
// stores.
//
// What bounds it on the H100: the operations, 2 * (3 Cin + 6 C + Cin) * C a
// row (about 0.056 ms for a decode block of 8 x 4 s in f32 at 67 TFLOP/s,
// 0.004 ms in bf16 at 989), or the bytes of x and y (0.008 ms at C = 24 in
// bf16). Each stage is a GEMM of the tile's rows by C output columns over
// K * C_in features, the taps shifts of the window's rows:
//
// * mma (bf16): #2's fragment loop (window_conv.cuh) on the tensor cores,
//   mma.sync m16n8k16, bf16 stream buffers (each h_j is rounded to bf16
//   anyway, so storing it in bf16 changes no bit). A comes from the
//   window's rows by ldmatrix, a tap a shift of k * d rows; rows of an odd
//   number of 16-byte units keep the eight row addresses of an ldmatrix on
//   distinct banks. Eight warps, WM along the rows by WN along the columns,
//   each at most kMaxMt m16 tiles by NT n8 tiles (C padded to 24, 48, 96 or
//   192 columns: NT 3 at 24, else 6). The residual runs on the same loop
//   into f32 accumulators and is added to the rounded h3 in the epilogue.
// * ffma (f32): a register tile of up to 8 rows by 8 columns a thread (C/8
//   threads across the columns, the rest down the rows), each window row
//   read as 128-bit loads of four channels, each channel's eight weights as
//   two: 64 FMAs per 2.5 shared loads (the old loop's 4 x 4 tile did 16 per
//   4.25).
//
// Both are persistent (a grid of at most one block of threads per SM walks
// the tiles) and stream the four weights in chunks of input channels
// through two shared buffers, the next chunk's copy (cp.async) in flight
// while one computes, across stages and tiles. The chunks come from the
// four weights packed into the chunks' layout, so every chunk is one run of
// 16-byte copies: a separate entry (down_chain_pack_*, one small kernel)
// reads the weights once through their strides into that layout, and the
// wrapper keeps the result for as long as the weights stay unchanged, so a
// forward launches the one kernel. The variant and S are ops/down_chain.py
// ::down_plan's, from dtype, widths and dilations alone; the entry refuses
// a plan no instance here takes.

#include <algorithm>

#include "device_prims.cuh"

// Every field is 8 bytes, in the order of ops/down_chain.py's _Args. The
// weights are conv1, conv2, conv3 (K=3) and the residual (K=1), each a WIO
// (K, C_in, C) tensor addressed by element strides (sk, si, so).
struct DownChainArgs {
  const void* x;
  void* y;
  const void* w[4];
  long long w_sk[4], w_si[4], w_so[4];
  const void* b[4];
  void* wpack;  // the packed weights, pack_elems of x's type
  long long B, T, Cin, C;
  long long dil[3];
  long long variant, tile_rows, n_blocks;  // the plan (down_plan)
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 192;  // MAX_CHANNELS in ops/down_chain.py
constexpr int kMaxReach = 32;      // MAX_REACH
constexpr size_t kMaxSmemBytes = 232448;
constexpr float kSlope = 0.2f;
constexpr int kMaxMt = 3;    // m16 tiles of a warp in a stage (mma)
constexpr int kMaxRpt = 8;   // rows of a thread in a stage (ffma)
constexpr int kMaxTile = 1024;
constexpr int kMmaCh = 32;   // input channels of a weight chunk (mma)
constexpr int kFfCh = 16;    // (ffma)
constexpr int kChLd = kMmaCh + 8;  // an mma chunk's rows: five 16-byte units

// the variant ids the wrapper passes (ops/down_chain.py::DOWN_VARIANTS)
enum { kDcMma = 0, kDcFfma = 1 };

// the output columns a stage computes: C padded to 24, 48, 96 or 192
__host__ __device__ constexpr int dc_np(int C) {
  return C <= 24 ? 24 : C <= 48 ? 48 : C <= 96 ? 96 : 192;
}
// mma: n8 tiles a warp, warps along the columns and along the rows
__host__ __device__ constexpr int dc_nt(int C) { return dc_np(C) == 24 ? 3 : 6; }
__host__ __device__ constexpr int dc_wm(int C) {
  return 8 / (dc_np(C) / 8 / dc_nt(C));
}
// ffma: threads across the columns and down the rows
__host__ __device__ constexpr int dc_ty(int C) { return kThreads / (dc_np(C) / 8); }
// the depth of a stage's features and the row length of a buffer holding
// them: mma 16-deep steps, rows of an odd number of 16-byte units; ffma
// quads, rows four floats longer
__host__ __device__ constexpr int dc_kd(bool mma, int cs) {
  return mma ? (cs + 15) & ~15 : (cs + 3) & ~3;
}
__host__ __device__ constexpr int dc_ld(bool mma, int cs) {
  return mma ? 8 * ((dc_kd(true, cs) / 8) | 1) : dc_kd(false, cs) + 4;
}
__host__ __device__ constexpr int dc_ch(bool mma) { return mma ? kMmaCh : kFfCh; }
__host__ __device__ constexpr int dc_chunks(bool mma, int cs) {
  return (dc_kd(mma, cs) + dc_ch(mma) - 1) / dc_ch(mma);
}
// elements of one chunk of a K-tap weight in the packed layout, and of a
// chunk buffer in shared memory
__host__ __device__ constexpr int dc_chunk_elems(bool mma, int K, int C) {
  return K * dc_np(C) * dc_ch(mma);
}
__host__ __device__ constexpr int dc_buf_elems(bool mma, int C) {
  return mma ? 3 * dc_np(C) * kChLd : 3 * kFfCh * dc_np(C);
}
// the four weights' K and input channels
__host__ __device__ constexpr int dc_k(int p) { return p == 3 ? 1 : 3; }
__host__ __device__ constexpr int dc_cs(int p, int Cin, int C) {
  return p == 0 || p == 3 ? Cin : C;
}
// where weight p's chunks start in the packed weights, and how many
// elements they take together
__host__ __device__ inline long long dc_pack_off(bool mma, int p, int Cin, int C) {
  long long off = 0;
  for (int q = 0; q < p; ++q)
    off += (long long)dc_chunks(mma, dc_cs(q, Cin, C)) *
           dc_chunk_elems(mma, dc_k(q), C);
  return off;
}

// shared memory of a tile of S rows at reach H: x's S rows (the
// residual's input), the buffer that holds leaky(x)'s window for stage 1
// and then h2, the buffer of h1 and then h3 (each 16 rows longer: an m16
// tile may read past its rows), and two chunk buffers
inline size_t dc_smem_bytes(bool mma, int S, int H, int Cin, int C) {
  const size_t rows = S + 2 * H + 16;
  const int ldx = dc_ld(mma, Cin), ldc = dc_ld(mma, C);
  return ((S + 16) * ldx + rows * (std::max(ldx, ldc) + ldc) +
          2 * dc_buf_elems(mma, C)) * (mma ? 2 : 4);
}

// the largest S a block of threads takes: its stage-1 rows, S + 2(d2 + d3),
// within its warps' m16 tiles (mma) or its threads' rows (ffma), and its
// shared memory within the card's
inline int dc_max_tile(bool mma, int Cin, int C, const long long* dil) {
  const int H = (int)(dil[0] + dil[1] + dil[2]);
  const int rows1 = mma ? 16 * kMaxMt * dc_wm(C) : kMaxRpt * dc_ty(C);
  int S = std::min(kMaxTile, rows1 - 2 * (int)(dil[1] + dil[2]));
  while (S >= 1 && dc_smem_bytes(mma, S, H, Cin, C) > kMaxSmemBytes) --S;
  return S;
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}
template <typename T> __device__ __forceinline__ float act(float v) {
  return round_to<T>(v >= 0.f ? v : kSlope * v);
}

// The four weights into the chunks' layout, zeros past C_in and C: mma
// (bf16) [p][chunk][k][n][32], ffma (f32) [p][chunk][k][c (16)][n]; n runs
// over dc_np(C) columns.
template <typename T>
__global__ void __launch_bounds__(256)
down_chain_pack_kernel(const __grid_constant__ DownChainArgs a) {
  constexpr bool mma = sizeof(T) == 2;
  const int Cin = (int)a.Cin, C = (int)a.C, np = dc_np(C), ch = dc_ch(mma);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dc_pack_off(mma, 4, Cin, C)) return;
  int p = 0;
  while (i >= dc_pack_off(mma, p + 1, Cin, C)) ++p;
  const int K = dc_k(p), cs = dc_cs(p, Cin, C);
  long long e = i - dc_pack_off(mma, p, Cin, C);
  const int q = (int)(e / dc_chunk_elems(mma, K, C));
  e -= (long long)q * dc_chunk_elems(mma, K, C);
  int k, n, c;
  if (mma) {  // e = (k * np + n) * 32 + c
    c = (int)(e % ch);
    n = (int)(e / ch % np);
    k = (int)(e / ch / np);
  } else {  // e = (k * 16 + c) * np + n
    n = (int)(e % np);
    c = (int)(e / np % ch);
    k = (int)(e / np / ch);
  }
  c += q * ch;
  const T* w = static_cast<const T*>(a.w[p]);
  T v = from_f32<T>(0.f);
  if (c < cs && n < C) v = w[k * a.w_sk[p] + c * a.w_si[p] + n * a.w_so[p]];
  static_cast<T*>(a.wpack)[i] = v;
}

// A stage: output rows [first, first + n) of the window (stream row base +
// row), from its input buffer (row length ld, cs channels) through K taps
// at dilation dil, "same" padding, weight p, into its output buffer (row
// length out_ld; the residual reads h3 there).
struct Stage {
  int p, K, dil, lo, cs, first, n, ld, out_ld;
};

// Tiles of S rows walked by a persistent grid; per tile x's window comes
// into `u` (then leaky(x) in place) and its S rows into `xs`; stage 1 reads
// u, writes h1 to `h`; stage 2 h -> u (h2); stage 3 u -> h (h3, rounded);
// the residual reads xs and turns h3 into y in place, and the tile's rows
// of y go out as 16-byte stores.
// `Compute` runs one weight chunk of a stage into the accumulators, `Store`
// stores a stage's outputs: both are the variant's.
template <typename T, bool kMma, typename Init, typename Compute, typename Store>
__device__ __forceinline__ void walk_tiles(const DownChainArgs& p,
                                           unsigned char* smem,
                                           const Init& init,
                                           const Compute& compute,
                                           const Store& store) {
  const int T_len = (int)p.T, Cin = (int)p.Cin, C = (int)p.C;
  const int tile = (int)p.tile_rows;
  const int d1 = (int)p.dil[0], d2 = (int)p.dil[1], d3 = (int)p.dil[2];
  const int H = d1 + d2 + d3, win = tile + 2 * H, rows = win + 16;
  const int ldx = dc_ld(kMma, Cin), ldc = dc_ld(kMma, C);
  const int ldu = ldx > ldc ? ldx : ldc;
  const int kdx = dc_kd(kMma, Cin), kdc = dc_kd(kMma, C);
  T* xs = reinterpret_cast<T*>(smem);  // [tile + 16][ldx] x's S rows
  T* u = xs + (tile + 16) * ldx;       // [rows][ldu] leaky(x), then h2
  T* h = u + rows * ldu;               // [rows][ldc] h1, then h3
  T* wbuf = h + rows * ldc;            // [2][dc_buf_elems]
  const int buf_elems = dc_buf_elems(kMma, C);
  const int tid = threadIdx.x;
  const int n_tt = (T_len + tile - 1) / tile;
  const long long n_tiles = p.B * n_tt;
  const T* wpack = static_cast<const T*>(p.wpack);

  // stage s's parameters, in registers (an array indexed at run time would
  // live in local memory, read again after every store)
  auto stage_of = [&](int s) {
    return s == 0 ? Stage{0, 3, d1, d1, Cin, d1, win - 2 * d1, ldu, ldc}
         : s == 1 ? Stage{1, 3, d2, d2, C, d1 + d2, win - 2 * (d1 + d2), ldc, ldu}
         : s == 2 ? Stage{2, 3, d3, d3, C, H, tile, ldu, ldc}
                  : Stage{3, 1, 1, 0, Cin, H, tile, ldx, ldc};
  };

  // chunk q of weight s into chunk buffer `buf`, as one run of 16-byte
  // copies (mma: each [k][n] row of 32 channels into a row of kChLd)
  auto load_chunk = [&](int s, int q, int buf) {
    const int K = dc_k(s);
    const T* src = wpack + dc_pack_off(kMma, s, Cin, C) +
                   (long long)q * dc_chunk_elems(kMma, K, C);
    T* dst = wbuf + buf * buf_elems;
    constexpr int E = 16 / sizeof(T);
    const int units = dc_chunk_elems(kMma, K, C) / E;
    for (int i = tid; i < units; i += kThreads) {
      if constexpr (kMma) {
        const int row = i / (kMmaCh / E), part = i % (kMmaCh / E);
        cp_async16(dst + row * kChLd + part * E, src + i * E, true);
      } else {
        cp_async16(dst + i * E, src + i * E, true);
      }
    }
    cp_async_commit();
  };

  // the pad columns of the h buffer, and of u where x's window is
  // narrower than C's, are zero for good (stores write columns < C only)
  for (int i = tid; i < rows * ldc; i += kThreads)
    if (i % ldc >= C) h[i] = from_f32<T>(0.f);
  for (int i = tid; i < rows * ldu; i += kThreads)
    if (i % ldu >= C) u[i] = from_f32<T>(0.f);
  if ((long long)blockIdx.x < n_tiles) load_chunk(0, 0, 0);
  int buf = 0;
  for (long long j = blockIdx.x; j < n_tiles; j += gridDim.x) {
    const int b = (int)(j / n_tt), t0 = (int)(j % n_tt) * tile;
    const int base = t0 - H;  // stream row of window row 0
    const T* x = static_cast<const T*>(p.x) + (size_t)b * T_len * Cin;
    T* y = static_cast<T*>(p.y) + ((size_t)b * T_len + t0) * C;
    __syncthreads();  // the previous tile is done with xs, u and h
    // x's window into u and its S rows into xs: rows outside [0, T) and
    // channels past Cin are zero
    auto rows_of_x = [&](T* dst, int ld, int first, int n) {
      if (Cin % (16 / (int)sizeof(T)) == 0) {
        constexpr int E = 16 / sizeof(T);
        const int units = kdx / E;
        for (int i = tid; i < n * units; i += kThreads) {
          const int r = i / units, cu = i % units, t = first + r;
          const bool ok = t >= 0 && t < T_len && cu * E < Cin;
          cp_async16(dst + r * ld + cu * E, ok ? x + (size_t)t * Cin + cu * E : x,
                     ok);
        }
      } else {
        // a thread a row: zeros over its kdx channels as 16-byte stores,
        // then its Cin values
        constexpr int E = 16 / sizeof(T);
        for (int r = tid; r < n; r += kThreads) {
          const int t = first + r;
          const bool ok = t >= 0 && t < T_len;
          for (int e = 0; e < kdx; e += E)
            *reinterpret_cast<uint4*>(dst + r * ld + e) = make_uint4(0, 0, 0, 0);
          if (ok)
            for (int c = 0; c < Cin; ++c) dst[r * ld + c] = x[(size_t)t * Cin + c];
        }
      }
    };
    rows_of_x(u, ldu, base, win);
    rows_of_x(xs, ldx, t0, tile);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // leaky(x) in place (the zero channels stay zero)
    for (int i = tid; i < win * Cin; i += kThreads) {
      T* v = u + i / Cin * ldu + i % Cin;
      *v = from_f32<T>(act<T>(to_f32(*v)));
    }
    for (int s = 0; s < 4; ++s) {
      const Stage st = stage_of(s);
      // (the residual's rows [H, H + S) of the window are xs's 0..S-1)
      const T* in = s == 0 ? u : s == 1 ? h : s == 2 ? u : xs - H * ldx;
      init(st);
      const int n_chunks = dc_chunks(kMma, st.cs);
      for (int q = 0; q < n_chunks; ++q, buf ^= 1) {
        cp_async_wait<0>();
        __syncthreads();  // chunk q is in; everyone is done with the other
        // the next chunk: this stage's, the next stage's first, or the
        // next tile's first
        if (q + 1 < n_chunks) load_chunk(s, q + 1, buf ^ 1);
        else if (s + 1 < 4) load_chunk(s + 1, 0, buf ^ 1);
        else if (j + gridDim.x < n_tiles) load_chunk(0, 0, buf ^ 1);
        compute(st, in, wbuf + buf * buf_elems, q);
      }
      if (s == 1 && kdx > C) {
        // leaky(x) filled u's columns up to kdx; h2 needs zeros past C
        for (int i = tid; i < rows * ldu; i += kThreads)
          if (i % ldu >= C) u[i] = from_f32<T>(0.f);
      }
      store(st, base, s == 1 ? u : h);
    }
    // y's rows of the tile, from h, as 16-byte stores where a row is a
    // whole number of them
    __syncthreads();
    const int nv = min(tile, T_len - t0);
    if ((C * (int)sizeof(T)) % 16 == 0) {
      constexpr int E = 16 / sizeof(T);
      const int units = C / E;
      for (int i = tid; i < nv * units; i += kThreads) {
        const int r = i / units, e = (i % units) * E;
        *reinterpret_cast<uint4*>(y + (size_t)r * C + e) =
            *reinterpret_cast<const uint4*>(h + (H + r) * ldc + e);
      }
    } else {
      for (int i = tid; i < nv * C; i += kThreads)
        y[i] = h[(H + i / C) * ldc + i % C];
    }
  }
  cp_async_wait<0>();
}

// ---- mma (bf16) -----------------------------------------------------------

// two blocks of threads an SM at 24 columns (NT 3), where a tile's work is
// small and its barriers and loads want another block's warps beside them
template <int NT>
__global__ void __launch_bounds__(kThreads, NT == 3 ? 2 : 1)
down_chain_mma_kernel(const __grid_constant__ DownChainArgs p) {
  extern __shared__ __align__(16) unsigned char dc_smem[];
  const int T_len = (int)p.T, C = (int)p.C, np = dc_np(C);
  const int WN = np / 8 / NT, WM = 8 / WN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  float acc[kMaxMt][NT][4];

  // accumulators from the bias of weight st.p (f32 sums, bias first)
  auto init = [&](const Stage& st) {
    const bf16* bias = static_cast<const bf16*>(p.b[st.p]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = (wn * NT + nt) * 8 + (lane & 3) * 2;
      const float b0 = col < C ? to_f32(bias[col]) : 0.f;
      const float b1 = col + 1 < C ? to_f32(bias[col + 1]) : 0.f;
#pragma unroll
      for (int i = 0; i < kMaxMt; ++i) {
        acc[i][nt][0] = b0; acc[i][nt][1] = b1;
        acc[i][nt][2] = b0; acc[i][nt][3] = b1;
      }
    }
  };
  // chunk q: channels 32q.. of the K taps; A from the window's rows by
  // ldmatrix (lanes 0-15 rows 0-15 at channel +0, lanes 16-31 at +8), B
  // from the chunk's [k][n] rows
  auto compute = [&](const Stage& st, const bf16* in, const bf16* wch, int q) {
    const int nm = (st.n + 15) / 16;
    const int kd = dc_kd(true, st.cs);
    for (int kc = 0; kc < kMmaCh && q * kMmaCh + kc < kd; kc += 16) {
      for (int k = 0; k < st.K; ++k) {
        uint32_t bfr[NT][2];
        const bf16* wk = wch + (k * np + wn * NT * 8) * kChLd + kc;
#pragma unroll
        for (int nt = 0; nt + 1 < NT; nt += 2) {
          uint32_t r[4];
          ldsm_x4(r, wk + ((nt + (lane >> 4)) * 8 + (lane & 7)) * kChLd +
                         ((lane >> 3) & 1) * 8);
          bfr[nt][0] = r[0]; bfr[nt][1] = r[1];
          bfr[nt + 1][0] = r[2]; bfr[nt + 1][1] = r[3];
        }
        if constexpr (NT % 2 == 1) {
          uint32_t r[2];
          ldsm_x2(r, wk + ((NT - 1) * 8 + (lane & 7)) * kChLd +
                         ((lane >> 3) & 1) * 8);
          bfr[NT - 1][0] = r[0]; bfr[NT - 1][1] = r[1];
        }
        const bf16* arow = in + (st.first - st.lo + k * st.dil + (lane & 15)) * st.ld +
                           q * kMmaCh + kc + (lane >> 4) * 8;
#pragma unroll
        for (int i = 0; i < kMaxMt; ++i) {
          const int mt = wm + WM * i;
          if (mt >= nm) break;
          uint32_t a[4];
          ldsm_x4(a, arow + mt * 16 * st.ld);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[i][nt], a, bfr[nt][0], bfr[nt][1]);
        }
      }
    }
  };
  // accumulator (i, nt): rows lane/4 and lane/4 + 8 of m-tile wm + WM i,
  // columns 2 (lane % 4) + {0, 1} of n-tile wn NT + nt
  auto store = [&](const Stage& st, int base, bf16* out) {
    const int nm = (st.n + 15) / 16;
#pragma unroll
    for (int i = 0; i < kMaxMt; ++i) {
      const int mt = wm + WM * i;
      if (mt >= nm) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = mt * 16 + (lane >> 2) + 8 * hh;
        if (rl >= st.n) continue;
        const int r = st.first + rl, t = base + r;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = (wn * NT + nt) * 8 + (lane & 3) * 2;
          if (col >= C) continue;
          float v0 = acc[i][nt][2 * hh], v1 = acc[i][nt][2 * hh + 1];
          if (st.p < 2) {  // h1, h2: leaky(round(h)), zero outside [0, T)
            const bool in_t = t >= 0 && t < T_len;
            v0 = in_t ? act<bf16>(round_to<bf16>(v0)) : 0.f;
            v1 = in_t ? act<bf16>(round_to<bf16>(v1)) : 0.f;
          }
          // (a column past C is a pad column, where the sums are 0; the
          // residual leaves it alone)
          bf16* o = out + r * st.out_ld + col;
          if (st.p < 3) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
          } else {  // y = round(h3 + residual), in h3's place
            if (col + 1 < C)
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __floats2bfloat162_rn(to_f32(o[0]) + v0, to_f32(o[1]) + v1);
            else
              o[0] = __float2bfloat16(to_f32(o[0]) + v0);
          }
        }
      }
    }
  };
  walk_tiles<bf16, true>(p, dc_smem, init, compute, store);
}

// ---- ffma (f32) -----------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
down_chain_ffma_kernel(const __grid_constant__ DownChainArgs p) {
  extern __shared__ __align__(16) unsigned char dc_smem[];
  const int T_len = (int)p.T, C = (int)p.C, np = dc_np(C);
  const int NG = np / 8, TY = kThreads / NG;
  const int tx = threadIdx.x % NG, ty = threadIdx.x / NG;
  const bool active = threadIdx.x < NG * TY;
  float acc[kMaxRpt][8];

  auto init = [&](const Stage& st) {
    const float* bias = static_cast<const float*>(p.b[st.p]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = tx * 8 + e;
      const float bv = col < C ? bias[col] : 0.f;
#pragma unroll
      for (int i = 0; i < kMaxRpt; ++i) acc[i][e] = bv;
    }
  };
  // chunk q: channels 16q.. of the K taps, four at a time: each row's
  // four as one 128-bit load, each channel's eight weights as two
  auto compute = [&](const Stage& st, const float* in, const float* wch, int q) {
    if (!active) return;
    const int kd = dc_kd(false, st.cs);
    const int nq = min(kFfCh, kd - q * kFfCh) / 4;
    int row[kMaxRpt];  // rows past n read row n - 1 and are not stored
#pragma unroll
    for (int i = 0; i < kMaxRpt; ++i)
      row[i] = st.first + min(ty + TY * i, st.n - 1) - st.lo;
    for (int k = 0; k < st.K; ++k) {
      const float* wk = wch + k * kFfCh * np + tx * 8;
      for (int qq = 0; qq < nq; ++qq) {
        const int c0 = q * kFfCh + 4 * qq;
        float4 a[kMaxRpt];
#pragma unroll
        for (int i = 0; i < kMaxRpt; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              in + (row[i] + k * st.dil) * st.ld + c0);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* wc = wk + (4 * qq + cc) * np;
          const float4 w0 = *reinterpret_cast<const float4*>(wc);
          const float4 w1 = *reinterpret_cast<const float4*>(wc + 4);
#pragma unroll
          for (int i = 0; i < kMaxRpt; ++i) {
            const float av = cc == 0 ? a[i].x : cc == 1 ? a[i].y
                           : cc == 2 ? a[i].z : a[i].w;
            acc[i][0] = fmaf(av, w0.x, acc[i][0]);
            acc[i][1] = fmaf(av, w0.y, acc[i][1]);
            acc[i][2] = fmaf(av, w0.z, acc[i][2]);
            acc[i][3] = fmaf(av, w0.w, acc[i][3]);
            acc[i][4] = fmaf(av, w1.x, acc[i][4]);
            acc[i][5] = fmaf(av, w1.y, acc[i][5]);
            acc[i][6] = fmaf(av, w1.z, acc[i][6]);
            acc[i][7] = fmaf(av, w1.w, acc[i][7]);
          }
        }
      }
    }
  };
  auto store = [&](const Stage& st, int base, float* out) {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < kMaxRpt; ++i) {
      const int rl = ty + TY * i;
      if (rl >= st.n) continue;
      const int r = st.first + rl, t = base + r;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = tx * 8 + e;
        if (col >= C) continue;
        const float v = acc[i][e];
        float* o = out + r * st.out_ld + col;
        if (st.p < 2)
          *o = t >= 0 && t < T_len ? act<float>(v) : 0.f;
        else if (st.p == 2)
          *o = v;
        else  // y = h3 + residual, in h3's place
          *o += v;
      }
    }
  };
  walk_tiles<float, false>(p, dc_smem, init, compute, store);
}

// ---- launches -------------------------------------------------------------

template <typename Kern>
int launch_main(Kern kern, const DownChainArgs* a, size_t smem,
                cudaStream_t stream) {
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)a->n_blocks, kThreads, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// The four weights into the packed layout at wpack (variant: the dtype's):
// the pack entry's one launch.
template <typename T>
int launch_pack(const DownChainArgs* a, void* stream) {
  constexpr bool mma = sizeof(T) == 2;
  if (a->Cin < 1 || a->Cin > kMaxChannels || a->C < 1 || a->C > kMaxChannels ||
      a->wpack == nullptr || a->variant != (mma ? kDcMma : kDcFfma))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < 4; ++j)
    if (a->w[j] == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_pack = dc_pack_off(mma, 4, (int)a->Cin, (int)a->C);
  down_chain_pack_kernel<T><<<(unsigned)((n_pack + 255) / 256), 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

// The plan names the variant (the dtype's), the tile S and the grid; a tile
// past what the variant's registers and shared memory hold, or anything
// else no instance takes, is refused before any launch. wpack holds the
// weights the pack entry packed.
template <typename T>
int launch(const DownChainArgs* a, void* stream) {
  if (a->B < 1 || a->T < 1 || a->Cin < 1 || a->Cin > kMaxChannels || a->C < 1 ||
      a->C > kMaxChannels || a->n_blocks < 1 || a->tile_rows < 1 ||
      a->wpack == nullptr)
    return (int)cudaErrorInvalidValue;
  long long reach = 0;
  for (int j = 0; j < 3; ++j) {
    if (a->dil[j] < 1) return (int)cudaErrorInvalidValue;
    reach += a->dil[j];
  }
  for (int j = 0; j < 4; ++j)
    if (a->w[j] == nullptr || a->b[j] == nullptr) return (int)cudaErrorInvalidValue;
  if (reach > kMaxReach) return (int)cudaErrorInvalidValue;
  const int variant = (int)a->variant, Cin = (int)a->Cin, C = (int)a->C;
  const bool mma = variant == kDcMma;
  if ((variant != kDcMma && variant != kDcFfma) || mma != (sizeof(T) == 2) ||
      a->tile_rows > dc_max_tile(mma, Cin, C, a->dil))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = dc_smem_bytes(mma, (int)a->tile_rows, (int)reach, Cin, C);
  const int nt = dc_nt(C);
  if (variant == kDcMma && nt == 3) return launch_main(down_chain_mma_kernel<3>, a, smem, s);
  if (variant == kDcMma && nt == 6) return launch_main(down_chain_mma_kernel<6>, a, smem, s);
  if (variant == kDcFfma) return launch_main(down_chain_ffma_kernel, a, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int down_chain_fwd_f32(const DownChainArgs* a, void* stream) {
  return launch<float>(a, stream);
}
extern "C" int down_chain_fwd_bf16(const DownChainArgs* a, void* stream) {
  return launch<__nv_bfloat16>(a, stream);
}
extern "C" int down_chain_pack_f32(const DownChainArgs* a, void* stream) {
  return launch_pack<float>(a, stream);
}
extern "C" int down_chain_pack_bf16(const DownChainArgs* a, void* stream) {
  return launch_pack<__nv_bfloat16>(a, stream);
}
